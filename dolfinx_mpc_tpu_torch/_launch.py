"""What a prepared kernel launch needs per call, kept to the least.

A wrapper that launches the same kernel many times on one operator (K2 or
K7 in every DIA matvec, K6 in every blocked one, K8 in every BELL matvec)
prepares the fixed part once: the
ctypes function, the pointers of the operator's tensors, the packed
parameters.  Per call it then allocates the output, reads the current
stream's handle and makes one ctypes call, entering a device context only
when the operator's device is not the current one.  ``LaunchRecord``
records what count_launch adds to the wrappers' counters and adds it
again, for launches made without their wrapper: a captured CUDA graph's
replay."""

from __future__ import annotations

import torch

__all__ = ["LaunchRecord", "count_launch", "launch_check", "on_device"]


def count_launch(wrapper, dtype):
    """One launch of the SpMV wrapper's kernel: its count, and its count
    under the dtype's name in ``wrapper.launches_by_dtype`` ("float32",
    "complex64", ...), so that a run can show which instantiation ran."""
    wrapper.launches += 1
    by = wrapper.launches_by_dtype
    key = str(dtype).removeprefix("torch.")
    by[key] = by.get(key, 0) + 1


class LaunchRecord:
    """The launches that the wrappers' counters gain while the record is
    open (``with rec:``): ``launches``, each dtype's count in
    ``launches_by_dtype`` and, where a wrapper keeps one (K7's), each
    grid's in ``launches_by_grid``.  ``add(times)`` adds them again
    ``times`` times over; a negative number takes them back."""

    _BY = ("launches_by_dtype", "launches_by_grid")

    def __init__(self, wrappers):
        self.wrappers = tuple(wrappers)
        self.delta = {}
        self._before = None

    def _counts(self):
        out = {}
        for w in self.wrappers:
            out[(w, "launches", None)] = w.launches
            for by in self._BY:
                for key, n in getattr(w, by, {}).items():
                    out[(w, by, key)] = n
        return out

    def __enter__(self):
        self._before = self._counts()
        return self

    def __exit__(self, *a):
        before = self._before
        self.delta = {k: n - before.get(k, 0) for k, n in self._counts().items() if n != before.get(k, 0)}

    def add(self, times=1):
        for (w, by, key), n in self.delta.items():
            if key is None:
                w.launches += times * n
            else:
                counts = getattr(w, by)
                counts[key] = counts.get(key, 0) + times * n


def launch_check(rc, name):
    """Raise if a launcher returned a non-zero cudaError_t."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")


def on_device(index, call):
    """call(stream) with the raw handle of the current stream of CUDA
    device `index`; a device context is entered only when `index` is not the
    current device."""
    if torch.cuda.current_device() == index:
        return call(torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return call(torch._C._cuda_getCurrentRawStream(index))
