"""The port imports without JAX and without the CUDA toolchain, and builds
nothing until a kernel is launched on the card."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(code, **env):
    full_env = {**os.environ, "PYTHONPATH": str(ROOT), **env}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=full_env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


def test_import_does_not_import_jax():
    out = _run(
        "import sys\n"
        "import dolfinx_mpc_tpu_torch\n"
        "import dolfinx_mpc_tpu_torch.utils.interop\n"
        "import dolfinx_mpc_tpu_torch.utils.verification\n"
        "import dolfinx_mpc_tpu_torch.utils.mpc_utils\n"
        "import dolfinx_mpc_tpu_torch.la.amg, dolfinx_mpc_tpu_torch.la.bell, dolfinx_mpc_tpu_torch.la.ell\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not any(m.startswith('dolfinx_mpc_tpu.') or m == 'dolfinx_mpc_tpu'\n"
        "               for m in sys.modules), 'JAX package imported'\n"
        "import torch\n"
        "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
        "assert torch.backends.cudnn.allow_tf32 is False\n"
        "print('ok')\n")
    assert out.strip() == "ok"


def test_kernel_modules_import_without_nvcc():
    """ops/lattice_kernels.py and _build.py import with no nvcc on PATH and
    no CUDA_HOME; nothing is compiled at import time, and asking for the
    kernels there raises instead of falling back."""
    out = _run(
        "import sys\n"
        "from dolfinx_mpc_tpu_torch import _build\n"
        "from dolfinx_mpc_tpu_torch.ops import lattice_kernels\n"
        "assert _build.load_kernels.cache_info().currsize == 0\n"
        "assert 'triton' not in sys.modules\n"
        "try:\n"
        "    _build.load_kernels()\n"
        "except RuntimeError as e:\n"
        "    assert 'nvcc' in str(e), e\n"
        "    print('raised')\n",
        PATH=os.pathsep.join(p for p in os.environ.get("PATH", "").split(os.pathsep)
                             if not Path(p, "nvcc").exists()),
        CUDA_HOME=str(ROOT / "no-such-cuda-home"))
    assert out.strip() == "raised"
