"""Youngs interface normals and Brackbill curvature in 3-D, the opt-in csf
physics (counterpart of tpuvof/ops/normals3d.py).

The reference disables 3-D surface tension (its normals kernel is
commented out, 3dvof.py:304-332), so ``csf=False`` keeps kappa at zero.
With csf the cell normal is the mean of the F-gradients at the eight cell
corners, each the mean of the four face-pair differences straddling the
corner; kappa = -div(m-hat) by central differences. The corner-gradient
form stays literal: reassociating it moves cells across the 1e-10
degeneracy guard.
"""
from __future__ import annotations

import torch

from ..grid import Grid3D
from .common import embed3, win3

__all__ = ["young_msum_3d", "normalize_normals_3d", "young_normals_3d",
           "curvature_from_normals_3d", "young_normals_curvature_3d"]


def young_msum_3d(f, dx, dy, dz):
    """Raw Youngs normal sums (mxs, mys, mzs) from an F accessor
    ``f(di, dj, dk)``, in tpuvof's accumulation order."""

    def corner_grad(axis, sx, sy, sz):
        signs = (sx, sy, sz)
        lo = 0 if signs[axis] > 0 else -1
        others = [ax for ax in range(3) if ax != axis]
        acc = None
        for da in (0, signs[others[0]]):
            for db in (0, signs[others[1]]):
                off_hi = [0, 0, 0]
                off_hi[axis] = lo + 1
                off_hi[others[0]] = da
                off_hi[others[1]] = db
                off_lo = list(off_hi)
                off_lo[axis] = lo
                d = f(*off_hi) - f(*off_lo)
                acc = d if acc is None else acc + d
        h = (dx, dy, dz)[axis]
        return -acc / (4.0 * h)

    corners = [(sx, sy, sz) for sx in (1, -1) for sy in (1, -1) for sz in (1, -1)]
    msum = []
    for axis in range(3):
        acc = None
        for c in corners:
            gax = corner_grad(axis, *c)
            acc = gax if acc is None else acc + gax
        msum.append(acc / 8.0)
    return tuple(msum)


def normalize_normals_3d(mxs, mys, mzs):
    """Unit normals; cells where all three sums are below 1e-10 keep the
    raw components."""
    degenerate = ((torch.abs(mxs) < 1e-10) & (torch.abs(mys) < 1e-10)
                  & (torch.abs(mzs) < 1e-10))
    mag_sq = mxs * mxs + mys * mys + mzs * mzs
    safe_mag = torch.sqrt(torch.where(degenerate, 1.0, mag_sq))
    mx = torch.where(degenerate, mxs, mxs / safe_mag)
    my = torch.where(degenerate, mys, mys / safe_mag)
    mz = torch.where(degenerate, mzs, mzs / safe_mag)
    return mx, my, mz


def young_normals_3d(g: Grid3D, F):
    """Normalized Youngs normals (mx, my, mz), full shape, zero ghosts."""
    ri, rj, rk = (1, g.nx + 1), (1, g.ny + 1), (1, g.nz + 1)

    def f(di, dj, dk):
        return win3(F, ri, rj, rk, di, dj, dk)

    mx, my, mz = normalize_normals_3d(*young_msum_3d(f, g.dx, g.dy, g.dz))
    return tuple(embed3(m, 1, 1, 1, 1, 1, 1) for m in (mx, my, mz))


def curvature_from_normals_3d(g: Grid3D, mx, my, mz):
    """kappa = -div(m-hat), full shape, zero ghosts."""
    ri, rj, rk = (1, g.nx + 1), (1, g.ny + 1), (1, g.nz + 1)
    kap = -(
        (win3(mx, ri, rj, rk, 1, 0, 0) - win3(mx, ri, rj, rk, -1, 0, 0)) / (2.0 * g.dx)
        + (win3(my, ri, rj, rk, 0, 1, 0) - win3(my, ri, rj, rk, 0, -1, 0)) / (2.0 * g.dy)
        + (win3(mz, ri, rj, rk, 0, 0, 1) - win3(mz, ri, rj, rk, 0, 0, -1)) / (2.0 * g.dz)
    )
    return embed3(kap, 1, 1, 1, 1, 1, 1)


def young_normals_curvature_3d(g: Grid3D, F):
    """(mx, my, mz, kappa), all full shape with zero ghosts."""
    mx, my, mz = young_normals_3d(g, F)
    return mx, my, mz, curvature_from_normals_3d(g, mx, my, mz)
