"""Momentum predictor and velocity correction (counterpart of
tpuvof/ops/momentum.py:30-116).

Explicit Euler with first-order upwind convection, central viscosity,
gravity and Brackbill CSF surface tension. The core routines compute over
the full interior; the serial wrappers write only the reference's face
ranges (u* on i in [2, nx], v* on j in [2, ny]) so the wall faces keep
their values.
"""
from __future__ import annotations

import torch

from ..config import Fluid, Numerics
from ..grid import Grid2D
from .common import embed2, merge_region, win

__all__ = [
    "predict_velocity",
    "predict_velocity_interior",
    "correct_velocity_interior",
    "update_velocity",
]


def predict_velocity_interior(g: Grid2D, fl: Fluid, nm: Numerics, u, v, F, rho, nu, kappa):
    """(u*, v*) over all interior faces [1..nx] x [1..ny]; the entries at
    the wall faces (i=1 column of u*, j=1 row of v*) are dropped by the
    caller."""
    dt = nm.dt
    dxi, dyi = g.dxi, g.dyi
    ri = (1, g.nx + 1)
    rj = (1, g.ny + 1)

    def U(di=0, dj=0):
        return win(u, ri, rj, di, dj)

    def Vv(di=0, dj=0):
        return win(v, ri, rj, di, dj)

    u_c = U()
    v_here = 0.25 * (Vv(-1, 0) + Vv(-1, 1) + Vv(0, 0) + Vv(0, 1))
    dudx = torch.where(u_c > 0, (u_c - U(-1, 0)) * dxi, (U(1, 0) - u_c) * dxi)
    dudy = torch.where(v_here > 0, (u_c - U(0, -1)) * dyi, (U(0, 1) - u_c) * dyi)
    kappa_ave = (win(kappa, ri, rj) + win(kappa, ri, rj, -1, 0)) * 0.5
    fx_kappa = -fl.sigma * (win(F, ri, rj) - win(F, ri, rj, -1, 0)) * kappa_ave / g.dx
    nu_c = win(nu, ri, rj)
    us = u_c + dt * (
        nu_c * (U(-1, 0) - 2.0 * u_c + U(1, 0)) * dxi**2
        + nu_c * (U(0, -1) - 2.0 * u_c + U(0, 1)) * dyi**2
        - u_c * dudx
        - v_here * dudy
        + fl.gx
        + fx_kappa * 2.0 / (win(rho, ri, rj) + win(rho, ri, rj, -1, 0))
    )

    v_c = Vv()
    u_here = 0.25 * (U(0, -1) + U(0, 0) + U(1, -1) + U(1, 0))
    dvdx = torch.where(u_here > 0, (v_c - Vv(-1, 0)) * dxi, (Vv(1, 0) - v_c) * dxi)
    dvdy = torch.where(v_c > 0, (v_c - Vv(0, -1)) * dyi, (Vv(0, 1) - v_c) * dyi)
    kappa_ave = (win(kappa, ri, rj) + win(kappa, ri, rj, 0, -1)) * 0.5
    fy_kappa = -fl.sigma * (win(F, ri, rj) - win(F, ri, rj, 0, -1)) * kappa_ave / g.dy
    vs = v_c + dt * (
        nu_c * (Vv(-1, 0) - 2.0 * v_c + Vv(1, 0)) * dxi**2
        + nu_c * (Vv(0, -1) - 2.0 * v_c + Vv(0, 1)) * dyi**2
        - u_here * dvdx
        - v_c * dvdy
        + fl.gy
        + fy_kappa * 2.0 / (win(rho, ri, rj) + win(rho, ri, rj, 0, -1))
    )
    return us, vs


def predict_velocity(g: Grid2D, fl: Fluid, nm: Numerics, u, v, F, rho, nu, kappa):
    """Serial (u*, v*): zero everywhere except the reference's ranges."""
    us, vs = predict_velocity_interior(g, fl, nm, u, v, F, rho, nu, kappa)
    u_star = embed2(us[1:, :], 2, 1, 1, 1)
    v_star = embed2(vs[:, 1:], 1, 1, 2, 1)
    return u_star, v_star


def correct_velocity_interior(g: Grid2D, nm: Numerics, u_star, v_star, p, rho):
    """Pressure-gradient correction over all interior faces; the wall-face
    entries are dropped by the caller."""
    dt = nm.dt
    ri = (1, g.nx + 1)
    rj = (1, g.ny + 1)
    r_u = (win(rho, ri, rj) + win(rho, ri, rj, -1, 0)) * 0.5
    u_int = win(u_star, ri, rj) - dt / r_u * (
        win(p, ri, rj) - win(p, ri, rj, -1, 0)
    ) * g.dxi
    r_v = (win(rho, ri, rj) + win(rho, ri, rj, 0, -1)) * 0.5
    v_int = win(v_star, ri, rj) - dt / r_v * (
        win(p, ri, rj) - win(p, ri, rj, 0, -1)
    ) * g.dyi
    return u_int, v_int


def update_velocity(g: Grid2D, nm: Numerics, u_prev, v_prev, u_star, v_star, p, rho):
    """Corrected velocities written over the reference's face ranges of the
    previous fields; every other entry keeps its previous value."""
    u_int, v_int = correct_velocity_interior(g, nm, u_star, v_star, p, rho)
    u = merge_region(u_prev, u_int[1:, :], 2, g.nx + 1, 1, g.ny + 1)
    v = merge_region(v_prev, v_int[:, 1:], 1, g.nx + 1, 2, g.ny + 1)
    return u, v
