"""Shared helpers for the stencil ops (counterpart of tpuvof/ops/common.py).

Every op is a function from tensors to new tensors: loop bounds like
``ti.ndrange((i0, i1), (j0, j1))`` become window slices via :func:`win`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as nnf

__all__ = ["win", "win3", "clamp01", "embed2", "embed3", "merge_interior", "merge_region"]


def win(a, ri, rj, di: int = 0, dj: int = 0):
    """Slice ``a`` over the index window ``ri x rj`` shifted by (di, dj);
    ``ri = (i0, i1)`` covers indices i in [i0, i1)."""
    (i0, i1) = ri
    (j0, j1) = rj
    return a[i0 + di : i1 + di, j0 + dj : j1 + dj]


def win3(a, ri, rj, rk, di: int = 0, dj: int = 0, dk: int = 0):
    """The 3-D :func:`win`."""
    (i0, i1) = ri
    (j0, j1) = rj
    (k0, k1) = rk
    return a[i0 + di : i1 + di, j0 + dj : j1 + dj, k0 + dk : k1 + dk]


def clamp01(x):
    """Clip to [0, 1] in strict-select form.

    Not ``torch.clamp``: the values are the same, but under autograd the
    selects pass derivative 1 at exact ties where max/min pass 0.5, which
    the differentiable path depends on.
    """
    return torch.where(x < 0.0, 0.0, torch.where(x > 1.0, 1.0, x))


def embed2(x, lo0: int, hi0: int, lo1: int, hi1: int):
    """Zero-pad a 2-D tensor by lo/hi rows (axis 0) and columns (axis 1)."""
    return nnf.pad(x, (lo1, hi1, lo0, hi0))


def embed3(x, lo0: int, hi0: int, lo1: int, hi1: int, lo2: int, hi2: int):
    """Zero-pad a 3-D tensor by lo/hi cells along each axis."""
    return nnf.pad(x, (lo2, hi2, lo1, hi1, lo0, hi0))


def merge_interior(full, interior_val):
    """A copy of ``full`` with its interior replaced (ghosts kept)."""
    out = full.clone()
    out[1:-1, 1:-1] = interior_val
    return out


def merge_region(full, val, r0: int, r1: int, c0: int, c1: int):
    """A copy of ``full`` with ``full[r0:r1, c0:c1]`` replaced by ``val``."""
    out = full.clone()
    out[r0:r1, c0:c1] = val
    return out
