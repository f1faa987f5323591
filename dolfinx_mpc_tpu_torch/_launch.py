"""What a prepared kernel launch needs per call, kept to the least.

A wrapper that launches the same kernel many times on one operator (K2 or
K7 in every DIA matvec, K6 in every blocked one, K8 in every BELL matvec)
prepares the fixed part once: the
ctypes function, the pointers of the operator's tensors, the packed
parameters.  Per call it then allocates the output, reads the current
stream's handle and makes one ctypes call, entering a device context only
when the operator's device is not the current one."""

from __future__ import annotations

import torch

__all__ = ["count_launch", "launch_check", "on_device"]


def count_launch(wrapper, dtype):
    """One launch of the SpMV wrapper's kernel: its count, and its count
    under the dtype's name in ``wrapper.launches_by_dtype`` ("float32",
    "complex64", ...), so that a run can show which instantiation ran."""
    wrapper.launches += 1
    by = wrapper.launches_by_dtype
    key = str(dtype).removeprefix("torch.")
    by[key] = by.get(key, 0) + 1


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
