"""The default device of the port's entry points.

Every entry point that places tensors takes ``device="cuda"`` by default: the
port runs on the card unless the caller asks for the CPU (``device="cpu"``,
as the CPU tests do).  Without a card the default raises instead of quietly
running on the CPU."""

from __future__ import annotations

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device) -> torch.device:
    """torch.device(device), raising RuntimeError for a CUDA device when no
    card is available."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested (the default of dolfinx_mpc_tpu_torch's entry points) "
            "but torch.cuda.is_available() is False; pass device='cpu' to run on the CPU")
    return dev
