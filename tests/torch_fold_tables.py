"""Fold-table helpers shared by the port's assembler tests."""

import dataclasses

import numpy as np


def padded_table(table, extra):
    """`table` on a grid `extra` slots longer per axis at the high end, its
    masks zero there: class grids padded beyond n + 1, where the window
    edges split an axis into 4 segments."""
    factors = keep = bc_ind = None
    if table.factors is not None:
        factors = tuple(np.pad(f, ((0, 0), (0, e))) for f, e in zip(table.factors, 2 * tuple(extra)))
    if table.keep is not None:
        pad = ((0, 0),) + tuple((0, e) for e in extra)
        keep, bc_ind = np.pad(table.keep, pad), np.pad(table.bc_ind, pad)
    return dataclasses.replace(table, vshape=tuple(v + e for v, e in zip(table.vshape, extra)), factors=factors,
                               keep=keep, bc_ind=bc_ind, _on={})
