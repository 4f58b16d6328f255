"""Pure-advection scheme-verification cases and the loop that runs them
(counterpart of tpuvof/models/advection.py).

The FCT sweeps run alone, with no Navier-Stokes, under a fixed analytic
velocity field: the Kothe-Rider single vortex (the reference's active
fixture), translation, Zalesak's slotted disk and a checkerboard. The
fields are built in numpy float32 exactly as tpuvof builds them, so they
are bit-equal to tpuvof's, and then moved to ``device``.

Scheme: the FCT test variant (flux-only dV compensation, no clamping
inside a sweep, eps=1e-4 in the limiter's denominator), F's ghosts
mirrored around each sweep, and 0-based parity: step 0 sweeps y then x,
unlike the forward solver, whose first step sweeps x then y.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import FCT_SCHEME_TEST, FCTVariant, Numerics
from ..grid import Grid2D
from ..ops.bc import mirror_scalar
from ..ops.fct import rudman_advect
from ..state import find_area

__all__ = [
    "AdvectionCase",
    "single_vortex",
    "zalesak_disk",
    "translation",
    "checkerboard",
    "simulate_advection",
    "ADVECTION_CASES",
]


@dataclass(frozen=True)
class AdvectionCase:
    """A fixed-velocity VOF advection problem."""

    grid: Grid2D
    dt: float
    n_steps: int  # the canonical duration (tmax in the reference)
    fct: FCTVariant = FCT_SCHEME_TEST

    def numerics(self) -> Numerics:
        return Numerics(dt=self.dt, fct=self.fct, bc_between_sweeps=True, backend="torch")


def _centers(g: Grid2D):
    """Cell centres xm[i] = (x[i] + x[i+1]) / 2 over the padded index
    range (the reference's grid_staggered)."""
    xs = np.hstack((0.0, np.linspace(0.0, g.Lx, g.nx + 1), g.Lx)).astype(np.float32)
    ys = np.hstack((0.0, np.linspace(0.0, g.Ly, g.ny + 1), g.Ly)).astype(np.float32)
    xm = 0.5 * (xs[: g.nx + 2] + xs[1 : g.nx + 3])
    ym = 0.5 * (ys[: g.ny + 2] + ys[1 : g.ny + 3])
    return xm.astype(np.float32), ym.astype(np.float32)


def _face_coords(g: Grid2D):
    """Where the staggered velocity components sit: u at (xm - dx/2, ym),
    v at (xm, ym - dy/2)."""
    xm, ym = _centers(g)
    ux = (xm - np.float32(g.dx) / 2)[:, None]
    uy = ym[None, :]
    vx = xm[:, None]
    vy = (ym - np.float32(g.dy) / 2)[None, :]
    return ux, uy, vx, vy


def _mirror_velocity_bc(u, v):
    """The reference test program's velocity ghost mirrors, in place."""
    u[:, 0] = u[:, 1]
    v[:, 1] = v[:, 2]
    u[:, -1] = u[:, -2]
    v[:, -1] = v[:, -2]
    u[1, :] = u[2, :]
    v[0, :] = v[1, :]
    u[-1, :] = u[-2, :]
    v[-1, :] = v[-2, :]
    return u, v


def _vortex_velocity(g: Grid2D, scale):
    """The Kothe-Rider vortex field on the interior faces, ghosts
    mirrored."""
    ux, uy, vx, vy = _face_coords(g)
    u = np.zeros(g.shape, np.float32)
    v = np.zeros(g.shape, np.float32)
    u[1:-1, 1:-1] = (-np.sin(ux) ** 2 * np.sin(2 * uy) * scale)[1:-1, 1:-1]
    v[1:-1, 1:-1] = (np.sin(vy) ** 2 * np.sin(2 * vx) * scale)[1:-1, 1:-1]
    return _mirror_velocity_bc(u, v)


def _on(device, *arrays):
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


def single_vortex(n: int = 500, tmax: int = 1000, dt: float = 1e-4, device="cuda"):
    """The Kothe-Rider single vortex deforming a circle (the reference's
    active fixture). Returns (case, F0, u, v, F_target), f32 on
    ``device``."""
    g = Grid2D(n, n, Lx=float(np.pi), Ly=float(np.pi))
    case = AdvectionCase(grid=g, dt=dt, n_steps=tmax)
    # circle at (Lx/2, 3Ly/4), r = Lx/10; find_area gives 1 outside
    F0 = find_area(g, g.Lx / 2, g.Ly * 3 / 4, g.Lx / 10)
    u, v = _vortex_velocity(g, np.float32(g.Lx * 1.0 / dt / tmax * 2))
    return (case, *_on(device, F0, u, v, F0.copy()))


def zalesak_disk(n: int = 200, tmax: int = 1000, dt: float = 1e-4, omega: float = 3.0,
                 device="cuda"):
    """Zalesak's slotted disk in solid-body rotation about the domain
    centre. With the fixture's parameters the canonical duration turns it
    by omega*tmax*dt = 0.3 rad, not a revolution, so the target (the
    initial disk) is a yardstick of shape, not the exact end state."""
    g = Grid2D(n, n, Lx=float(np.pi), Ly=float(np.pi))
    case = AdvectionCase(grid=g, dt=dt, n_steps=tmax)
    xm, ym = _centers(g)
    cx, cy, r = g.Lx * 3.0 / 4, g.Ly * 3.0 / 4, g.Lx / 10
    F0 = find_area(g, cx, cy, r)
    sw, sh = r / 6.0, r * 0.8
    slot = (np.abs(xm[:, None] - cx) < sw) & (np.abs(ym[None, :] - cy + r / 4) < sh)
    F0 = np.where(slot, np.float32(1.0), F0)

    ux, uy, vx, vy = _face_coords(g)
    u = np.zeros(g.shape, np.float32)
    v = np.zeros(g.shape, np.float32)
    u[1:-1, 1:-1] = (-omega * (uy - g.Ly / 2) * np.ones_like(ux))[1:-1, 1:-1]
    v[1:-1, 1:-1] = (omega * (vx - g.Lx / 2) * np.ones_like(vy))[1:-1, 1:-1]
    u, v = _mirror_velocity_bc(u, v)
    return (case, *_on(device, F0, u, v, F0.copy()))


def translation(n: int = 200, tmax: int = 200, dt: float = 1e-4, device="cuda"):
    """Uniform translation along x at one cell per step."""
    g = Grid2D(n, n, Lx=float(np.pi), Ly=float(np.pi))
    case = AdvectionCase(grid=g, dt=dt, n_steps=tmax)
    F0 = find_area(g, g.Lx / 2, g.Ly / 2, g.Lx / 10)
    u = np.full(g.shape, np.float32(g.Lx / g.nx / dt), np.float32)
    v = np.zeros(g.shape, np.float32)
    return (case, *_on(device, F0, u, v, F0.copy()))


def checkerboard(n: int = 121, tmax: int = 100, dt: float = 1e-4, device="cuda"):
    """11 x 11 tiles of alternating 0 and 1 in the vortex field."""
    g = Grid2D(n, n, Lx=float(np.pi), Ly=float(np.pi))
    case = AdvectionCase(grid=g, dt=dt, n_steps=tmax)
    i = np.arange(g.nx + 2)[:, None] // 11
    j = np.arange(g.ny + 2)[None, :] // 11
    F0 = ((i + j) % 2 != 0).astype(np.float32)
    u, v = _vortex_velocity(g, np.float32(g.Lx / dt / tmax * 2))
    return (case, *_on(device, F0, u, v, F0.copy()))


ADVECTION_CASES = {
    "single_vortex": single_vortex,
    "zalesak_disk": zalesak_disk,
    "translation": translation,
    "checkerboard": checkerboard,
}


def simulate_advection(case: AdvectionCase, F, u, v, n_steps: int, istep0: int = 0):
    """Advect F for ``n_steps`` under the fixed staggered velocity (u, v):
    F's ghosts mirrored once at entry and around each sweep, 0-based
    parity (step k sweeps y then x when istep0 + k is even). Chunked
    callers pass ``istep0``, the steps already taken, so that the parity
    continues across calls. Returns a new F."""
    g = case.grid
    nm = case.numerics()
    F = mirror_scalar(F)  # the reference test program's initial set_BC(0, F)
    for k in range(n_steps):
        F = rudman_advect(g, nm, F, u, v, even_step=(istep0 + k) % 2 == 0)
    return F
