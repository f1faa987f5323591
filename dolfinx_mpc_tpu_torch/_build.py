"""Build and load the port's CUDA kernels (``csrc/*.cu``: the lattice kernels
K1-K7 and the BELL SpMV K8) with nvcc + ctypes.

The kernels are compiled on first use, on the machine with the card, into
``build/dolfinx_mpc_tpu_torch/`` at the repository root (git-ignored), as a
shared library with a plain C interface: one nvcc per source, all started
together, then one link.  The library name carries a hash of the sources,
so an edited kernel is rebuilt and a stale one is never loaded.  A missing
nvcc or a failed build raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "REPO_ROOT", "load_kernels"]

PKG_DIR = Path(__file__).resolve().parent
REPO_ROOT = PKG_DIR.parent
BUILD_DIR = REPO_ROOT / "build" / "dolfinx_mpc_tpu_torch"
CSRC = PKG_DIR / "csrc"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v"]


def _nvcc() -> str:
    """nvcc of $CUDA_HOME when it is set, else of /usr/local/cuda, else the
    one on PATH."""
    home = os.environ.get("CUDA_HOME")
    cands = [Path(home, "bin", "nvcc")] if home else [Path("/usr/local/cuda/bin/nvcc")]
    found = next((str(c) for c in cands if c.exists()), None) or (None if home else shutil.which("nvcc"))
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of dolfinx_mpc_tpu_torch "
                           "build only where the CUDA toolkit is installed")
    return found


@functools.cache
def load_kernels() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library.  The
    ptxas resource report of the build lands in ``<library>.log``."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256()
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"liblattice_kernels_{h.hexdigest()[:16]}.so"
    if not so.exists():
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for src, obj in zip(sources, objs)]
        try:
            outs = [proc.communicate(timeout=900) for proc in procs]
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for proc, (out, err) in zip(procs, outs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{out}\n{err}")
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)], capture_output=True, text=True,
                             timeout=900)
        for obj in objs:
            obj.unlink()
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
        # ptxas' per-kernel register / spill report, kept beside the library
        so.with_suffix(".log").write_text("".join(err for _, err in outs))
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    from .la import bell
    from .ops import lattice_kernels

    lattice_kernels.declare_signatures(lib)
    bell.declare_signatures(lib)
    return lib
