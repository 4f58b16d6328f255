"""Simulation state and initial conditions (counterpart of tpuvof/state.py).

The carried state is F, u, v, p, each a (nx+2, ny+2) tensor; in 3-D it is
F, u, v, w, p, each (nx+2, ny+2, nz+2). The initial conditions are computed
in numpy float32 exactly as tpuvof computes them, so F0 is bit-equal to
tpuvof's before it is cast to the requested dtype.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import SimConfig
from .grid import Grid2D, Grid3D

__all__ = ["State", "State3D", "init_state", "initial_volume_fraction", "find_area",
           "find_area_3d", "dam_break_axes_3d", "initial_volume_fraction_3d", "init_state_3d",
           "init_block_3d"]


class State(NamedTuple):
    """2-D solver state; every tensor has shape (nx+2, ny+2)."""

    F: torch.Tensor  # volume fraction (1 = liquid, 0 = gas)
    u: torch.Tensor  # x-velocity on left cell faces
    v: torch.Tensor  # y-velocity on bottom cell faces
    p: torch.Tensor  # pressure at cell centers


class State3D(NamedTuple):
    """3-D solver state; every tensor has shape (nx+2, ny+2, nz+2)."""

    F: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    p: torch.Tensor


def find_area(g: Grid2D, cx: float, cy: float, r: float) -> np.ndarray:
    """Smoothed per-cell liquid fraction of the complement of a circle.

    Cells with all four corners outside the circle get 1.0, fully inside
    get 0.0, and mixed cells get 0.5 + 0.5*(dist_center - r)/(sqrt(2)*dx)
    clipped to [0, 1]. float32 on the host; returns (nx+2, ny+2).
    """
    dx = np.float32(g.dx)
    xc = g.center_x()[:, None]
    yc = g.center_y()[None, :]
    cx = np.float32(cx)
    cy = np.float32(cy)
    r = np.float32(r)

    def dist(ox, oy):
        return np.sqrt((xc + ox - cx) ** 2 + (yc + oy - cy) ** 2, dtype=np.float32)

    h = dx / np.float32(2.0)
    d_ct = dist(np.float32(0.0), np.float32(0.0))
    d_lu = dist(-h, h)
    d_ld = dist(-h, -h)
    d_ru = dist(h, h)
    d_rd = dist(h, -h)

    all_out = (d_lu > r) & (d_ld > r) & (d_ru > r) & (d_rd > r)
    all_in = (d_lu < r) & (d_ld < r) & (d_ru < r) & (d_rd < r)
    smooth = np.clip(
        np.float32(0.5) + np.float32(0.5) * (d_ct - r) / (np.sqrt(np.float32(2.0)) * dx),
        0.0,
        1.0,
    ).astype(np.float32)
    out = np.where(all_out, np.float32(1.0), np.where(all_in, np.float32(0.0), smooth))
    return out.astype(np.float32)


def initial_volume_fraction(g: Grid2D, ic: int) -> np.ndarray:
    """The three canonical initial conditions.

    ic=1 dam break: liquid block x in [0, Lx/3], y in [0, Ly/2] (tested
    against node coordinates). ic=2 rising bubble: gas circle of radius
    Lx/12 centered (Lx/2, 2r). ic=3 dropping liquid: liquid circle at
    (Lx/2, Ly - 3r) above a pool filling y < 0.37*Ly.
    """
    if ic == 1:
        xn = g.node_x()[:, None]
        yn = g.node_y()[None, :]
        cond = (xn >= 0.0) & (xn <= g.Lx / 3) & (yn >= 0.0) & (yn <= g.Ly / 2)
        return np.where(cond, np.float32(1.0), np.float32(0.0))
    elif ic == 2:
        r = g.Lx / 12
        return find_area(g, g.Lx / 2, 2 * r, r)
    elif ic == 3:
        r = g.Lx / 12
        F = (np.float32(1.0) - find_area(g, g.Lx / 2, g.Ly - 3 * r, r)).astype(
            np.float32
        )
        yn = g.node_y()[None, :]
        return np.where(yn < g.Ly * 0.37, np.float32(1.0), F).astype(np.float32)
    raise ValueError(f"unknown initial condition {ic}; expected 1, 2 or 3")


def init_state(cfg: SimConfig, ic: int = 1, device="cuda",
               dtype: torch.dtype = torch.float32) -> State:
    """The state with initial condition ``ic`` on ``device`` in ``dtype``;
    by default the dam break, on the card, in f32."""
    g = cfg.grid
    F = torch.as_tensor(initial_volume_fraction(g, ic), device=device).to(dtype)
    return State(
        F=F,
        u=torch.zeros(g.shape, device=device, dtype=dtype),
        v=torch.zeros(g.shape, device=device, dtype=dtype),
        p=torch.zeros(g.shape, device=device, dtype=dtype),
    )


def find_area_3d(g: Grid3D, cx: float, cy: float, cz: float, r: float,
                 window=None) -> np.ndarray:
    """Smoothed per-cell liquid fraction of the complement of a sphere, the
    3-D extension of ``find_area``: cells with all eight corners outside
    get 1.0, fully inside 0.0, mixed cells 0.5 + 0.5*(dist_center -
    r)/(sqrt(3)*dx) clipped to [0, 1]. float32 on the host; (nx+2, ny+2,
    nz+2), or the ``window`` of it (see ``initial_volume_fraction_3d``)."""
    dx = np.float32(g.dx)
    g2 = g.as_2d()
    (i0, i1), (j0, j1) = window or ((0, g.nx + 2), (0, g.ny + 2))
    xc = g2.center_x()[i0:i1, None, None]
    yc = g2.center_y()[None, j0:j1, None]
    k = np.arange(g.nz + 2, dtype=np.float32)
    zc = (((k - 1.0) * np.float32(g.dz) + np.float32(g.dz) / 2)
          .astype(np.float32))[None, None, :]
    cx, cy, cz, r = (np.float32(v) for v in (cx, cy, cz, r))

    def dist(ox, oy, oz):
        return np.sqrt((xc + ox - cx) ** 2 + (yc + oy - cy) ** 2
                       + (zc + oz - cz) ** 2, dtype=np.float32)

    h = dx / np.float32(2.0)
    d_ct = dist(np.float32(0.0), np.float32(0.0), np.float32(0.0))
    all_out = None
    all_in = None
    for sx in (-h, h):
        for sy in (-h, h):
            for sz in (-h, h):
                d = dist(sx, sy, sz)
                o, i = d > r, d < r
                all_out = o if all_out is None else (all_out & o)
                all_in = i if all_in is None else (all_in & i)
    smooth = np.clip(
        np.float32(0.5)
        + np.float32(0.5) * (d_ct - r) / (np.sqrt(np.float32(3.0)) * dx),
        0.0, 1.0,
    ).astype(np.float32)
    out = np.where(all_out, np.float32(1.0), np.where(all_in, np.float32(0.0), smooth))
    return out.astype(np.float32)


def dam_break_axes_3d(g: Grid3D, window=None) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The 3-D dam break's liquid test along each axis, at node coordinates
    (x in [0, Lx/3], y in [0, Ly/2], z in [0, Lz/3]): three boolean
    vectors whose outer AND is the block, over the ``window`` of planes
    and rows (see ``initial_volume_fraction_3d``)."""
    (i0, i1), (j0, j1) = window or ((0, g.nx + 2), (0, g.ny + 2))
    xn, yn, zn = g.node_x()[i0:i1], g.node_y()[j0:j1], g.node_z()
    return ((xn >= 0.0) & (xn <= g.Lx / 3), (yn >= 0.0) & (yn <= g.Ly / 2),
            (zn >= 0.0) & (zn <= g.Lz / 3))


def initial_volume_fraction_3d(g: Grid3D, ic: int, window=None) -> np.ndarray:
    """3-D initial conditions: ic=1 the reference's dam-break block (x in
    [0, Lx/3], y in [0, Ly/2], z in [0, Lz/3], tested against node
    coordinates); ic=2 a gas bubble of radius Lx/12 at (Lx/2, 2r, Lz/2);
    ic=3 a liquid drop at (Lx/2, Ly - 3r, Lz/2) above a pool filling
    y < 0.37*Ly. ``window`` ((i0, i1), (j0, j1)) gives only those planes
    and rows of the ghosted grid, every z: the same values as the slice
    of the whole field, computed from the window's coordinates alone."""
    if ic == 1:
        mx, my, mz = dam_break_axes_3d(g, window)
        cond = mx[:, None, None] & my[None, :, None] & mz[None, None, :]
        return np.where(cond, np.float32(1.0), np.float32(0.0))
    elif ic == 2:
        r = g.Lx / 12
        return find_area_3d(g, g.Lx / 2, 2 * r, g.Lz / 2, r, window)
    elif ic == 3:
        r = g.Lx / 12
        F = (np.float32(1.0)
             - find_area_3d(g, g.Lx / 2, g.Ly - 3 * r, g.Lz / 2, r, window)).astype(np.float32)
        j0, j1 = window[1] if window else (0, g.ny + 2)
        yn = g.node_y()[None, j0:j1, None]
        return np.where(yn < g.Ly * 0.37, np.float32(1.0), F).astype(np.float32)
    raise ValueError(f"unknown 3-D initial condition ic={ic} (1, 2, or 3)")


def init_state_3d(g: Grid3D, ic: int = 1, device="cuda",
                  dtype: torch.dtype = torch.float32) -> State3D:
    """The 3-D state with initial condition ``ic`` on ``device`` in
    ``dtype``; by default the dam break, on the card, in f32."""
    F = torch.as_tensor(initial_volume_fraction_3d(g, ic), device=device).to(dtype)
    return State3D(F, *(torch.zeros(g.shape, device=device, dtype=dtype)
                        for _ in range(4)))


def init_block_3d(g: Grid3D, ic: int, window, device, dtype: torch.dtype = torch.float32
                  ) -> State3D:
    """The ``window`` ((i0, i1), (j0, j1)) of ``init_state_3d``'s state,
    made for that block alone: the dam break on ``device`` from its
    per-axis tests, the other conditions on the host from the window's
    coordinates; nothing of the rest of the grid is made."""
    (i0, i1), (j0, j1) = window
    if ic == 1:
        mx, my, mz = (torch.as_tensor(m, device=device) for m in dam_break_axes_3d(g, window))
        F = (mx[:, None, None] & my[None, :, None] & mz[None, None, :]).to(dtype)
    else:
        F = torch.as_tensor(initial_volume_fraction_3d(g, ic, window), device=device).to(dtype)
    shape = (i1 - i0, j1 - j0, g.nz + 2)
    return State3D(F, *(torch.zeros(shape, device=device, dtype=dtype) for _ in range(4)))
