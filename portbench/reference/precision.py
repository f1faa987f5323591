"""The control's precision: the nearest below the one a configuration
states.  float32 steps to bfloat16: the periodic and contact paths run no
matrix product, so TF32 does not apply to them."""

import torch

LOWER = {"float64": torch.float32, "float32": torch.bfloat16}


def lower(name):
    return LOWER[name]
