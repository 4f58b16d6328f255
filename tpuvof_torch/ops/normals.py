"""Youngs-gradient interface normals and curvature (counterpart of
tpuvof/ops/normals.py).

The normal at a cell is the average of the F-gradients at its four
corners, written in the literal four-corner form (a reordered form
changes the rounding, which the interface dynamics amplify); the
curvature is kappa = -div(normal) by central differences.
"""
from __future__ import annotations

import torch

from ..grid import Grid2D
from .common import embed2, win

__all__ = ["young_normals", "curvature_from_normals", "young_normals_curvature"]


def young_normals(g: Grid2D, F):
    """Normalized Youngs normals (mx, my), full shape with zero ghosts."""
    ri = (1, g.nx + 1)
    rj = (1, g.ny + 1)

    def f(di, dj):
        return win(F, ri, rj, di, dj)

    inv2dx = 1.0 / (2.0 * g.dx)
    inv2dy = 1.0 / (2.0 * g.dy)

    # corner k at offsets 1: NE, 2: SE, 3: SW, 4: NW
    mx1 = -inv2dx * (f(1, 1) + f(1, 0) - f(0, 1) - f(0, 0))
    my1 = -inv2dy * (f(1, 1) - f(1, 0) + f(0, 1) - f(0, 0))
    mx2 = -inv2dx * (f(1, 0) + f(1, -1) - f(0, 0) - f(0, -1))
    my2 = -inv2dy * (f(1, 0) - f(1, -1) + f(0, 0) - f(0, -1))
    mx3 = -inv2dx * (f(0, 0) + f(0, -1) - f(-1, 0) - f(-1, -1))
    my3 = -inv2dy * (f(0, 0) - f(0, -1) + f(-1, 0) - f(-1, -1))
    mx4 = -inv2dx * (f(0, 1) + f(0, 0) - f(-1, 1) - f(-1, 0))
    my4 = -inv2dy * (f(0, 1) - f(0, 0) + f(-1, 1) - f(-1, 0))

    mxsum = (mx1 + mx2 + mx3 + mx4) * 0.25
    mysum = (my1 + my2 + my3 + my4) * 0.25

    # degeneracy guard: below 1e-10 in both components the raw sums are kept
    degenerate = (torch.abs(mxsum) < 1e-10) & (torch.abs(mysum) < 1e-10)
    mag_sq = mxsum * mxsum + mysum * mysum
    safe_mag = torch.sqrt(torch.where(degenerate, 1.0, mag_sq))
    mx_int = torch.where(degenerate, mxsum, mxsum / safe_mag)
    my_int = torch.where(degenerate, mysum, mysum / safe_mag)
    return embed2(mx_int, 1, 1, 1, 1), embed2(my_int, 1, 1, 1, 1)


def curvature_from_normals(g: Grid2D, mx, my):
    """kappa = -div(m) by central differences; reads the zero ghosts of the
    normal field at the domain edge, as the reference does."""
    ri = (1, g.nx + 1)
    rj = (1, g.ny + 1)
    inv2dx = 1.0 / (2.0 * g.dx)
    inv2dy = 1.0 / (2.0 * g.dy)
    kap_int = -(
        inv2dx * (win(mx, ri, rj, 1, 0) - win(mx, ri, rj, -1, 0))
        + inv2dy * (win(my, ri, rj, 0, 1) - win(my, ri, rj, 0, -1))
    )
    return embed2(kap_int, 1, 1, 1, 1)


def young_normals_curvature(g: Grid2D, F):
    """Return (mx, my, kappa), full shape with zero ghosts."""
    mx, my = young_normals(g, F)
    return mx, my, curvature_from_normals(g, mx, my)
