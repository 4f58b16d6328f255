"""3-D momentum predictor and corrector (counterpart of
tpuvof/ops/momentum3d.py:19-150; reference 3dvof.py:207-302).

The 2-D op with the third component and the z-terms. The surface-tension
terms take a curvature field: zero reproduces the reference, whose 3-D
normals are disabled; ops/normals3d.py gives the opt-in csf one.
"""
from __future__ import annotations

import torch

from ..config import Fluid
from ..grid import Grid3D
from .common import win3

__all__ = ["predict_velocity_3d", "update_velocity_3d"]


def predict_velocity_3d(g: Grid3D, fl: Fluid, dt, u, v, w, F, rho, nu, kappa,
                        u_lo: int = 2, v_lo: int = 2):
    """(u*, v*, w*), zero outside their update ranges. ``u_lo``/``v_lo``:
    the first updated u-/v-face index (2 on the serial grid, where face 1
    is the wall)."""
    dxi, dyi, dzi = g.dxi, g.dyi, g.dzi
    n1, n2, n3 = g.nx, g.ny, g.nz

    # ---------- u* on i in [u_lo, nx], j, k interior ----------
    ri, rj, rk = (u_lo, n1 + 1), (1, n2 + 1), (1, n3 + 1)

    def U(di=0, dj=0, dk=0):
        return win3(u, ri, rj, rk, di, dj, dk)

    def V(di=0, dj=0, dk=0):
        return win3(v, ri, rj, rk, di, dj, dk)

    def W(di=0, dj=0, dk=0):
        return win3(w, ri, rj, rk, di, dj, dk)

    u_c = U()
    v_here = 0.25 * (V(-1, 0, 0) + V(-1, 1, 0) + V(0, 0, 0) + V(0, 1, 0))
    w_here = 0.25 * (W(-1, 0, 0) + W(-1, 0, 1) + W(0, 0, 0) + W(0, 0, 1))
    dudx = torch.where(u_c > 0, (u_c - U(-1, 0, 0)) * dxi, (U(1, 0, 0) - u_c) * dxi)
    dudy = torch.where(v_here > 0, (u_c - U(0, -1, 0)) * dyi, (U(0, 1, 0) - u_c) * dyi)
    dudz = torch.where(w_here > 0, (u_c - U(0, 0, -1)) * dzi, (U(0, 0, 1) - u_c) * dzi)
    kap = (win3(kappa, ri, rj, rk) + win3(kappa, ri, rj, rk, -1, 0, 0)) * 0.5
    fx = -fl.sigma * (win3(F, ri, rj, rk) - win3(F, ri, rj, rk, -1, 0, 0)) * kap / g.dx
    nu_c = win3(nu, ri, rj, rk)
    us = u_c + dt * (
        nu_c * (U(-1, 0, 0) - 2 * u_c + U(1, 0, 0)) * dxi**2
        + nu_c * (U(0, -1, 0) - 2 * u_c + U(0, 1, 0)) * dyi**2
        + nu_c * (U(0, 0, -1) - 2 * u_c + U(0, 0, 1)) * dzi**2
        - u_c * dudx - v_here * dudy - w_here * dudz
        + fl.gx
        + fx * 2 / (win3(rho, ri, rj, rk) + win3(rho, ri, rj, rk, -1, 0, 0))
    )
    u_star = torch.zeros_like(u)
    u_star[u_lo : n1 + 1, 1 : n2 + 1, 1 : n3 + 1] = us

    # ---------- v* on j in [v_lo, ny] ----------
    ri, rj, rk = (1, n1 + 1), (v_lo, n2 + 1), (1, n3 + 1)

    def U2(di=0, dj=0, dk=0):
        return win3(u, ri, rj, rk, di, dj, dk)

    def V2(di=0, dj=0, dk=0):
        return win3(v, ri, rj, rk, di, dj, dk)

    def W2(di=0, dj=0, dk=0):
        return win3(w, ri, rj, rk, di, dj, dk)

    v_c = V2()
    u_here = 0.25 * (U2(0, -1, 0) + U2(0, 0, 0) + U2(1, -1, 0) + U2(1, 0, 0))
    w_here = 0.25 * (W2(0, -1, 1) + W2(0, -1, 0) + W2(0, 0, 0) + W2(0, 0, 1))
    dvdx = torch.where(u_here > 0, (v_c - V2(-1, 0, 0)) * dxi, (V2(1, 0, 0) - v_c) * dxi)
    dvdy = torch.where(v_c > 0, (v_c - V2(0, -1, 0)) * dyi, (V2(0, 1, 0) - v_c) * dyi)
    dvdz = torch.where(w_here > 0, (v_c - V2(0, 0, -1)) * dzi, (V2(0, 0, 1) - v_c) * dzi)
    kap = (win3(kappa, ri, rj, rk) + win3(kappa, ri, rj, rk, 0, -1, 0)) * 0.5
    fy = -fl.sigma * (win3(F, ri, rj, rk) - win3(F, ri, rj, rk, 0, -1, 0)) * kap / g.dy
    nu_c = win3(nu, ri, rj, rk)
    vs = v_c + dt * (
        nu_c * (V2(-1, 0, 0) - 2 * v_c + V2(1, 0, 0)) * dxi**2
        + nu_c * (V2(0, -1, 0) - 2 * v_c + V2(0, 1, 0)) * dyi**2
        + nu_c * (V2(0, 0, -1) - 2 * v_c + V2(0, 0, 1)) * dzi**2
        - u_here * dvdx - v_c * dvdy - w_here * dvdz
        + fl.gy
        + fy * 2 / (win3(rho, ri, rj, rk) + win3(rho, ri, rj, rk, 0, -1, 0))
    )
    v_star = torch.zeros_like(v)
    v_star[1 : n1 + 1, v_lo : n2 + 1, 1 : n3 + 1] = vs

    # ---------- w* on k in [2, nz] ----------
    ri, rj, rk = (1, n1 + 1), (1, n2 + 1), (2, n3 + 1)

    def U3(di=0, dj=0, dk=0):
        return win3(u, ri, rj, rk, di, dj, dk)

    def V3(di=0, dj=0, dk=0):
        return win3(v, ri, rj, rk, di, dj, dk)

    def W3(di=0, dj=0, dk=0):
        return win3(w, ri, rj, rk, di, dj, dk)

    w_c = W3()
    u_here = 0.25 * (U3(1, 0, -1) + U3(0, 0, -1) + U3(1, 0, 0) + U3(0, 0, 0))
    v_here = 0.25 * (V3(0, 1, -1) + V3(0, 0, -1) + V3(0, 0, 0) + V3(0, 1, 0))
    dwdx = torch.where(u_here > 0, (w_c - W3(-1, 0, 0)) * dxi, (W3(1, 0, 0) - w_c) * dxi)
    dwdy = torch.where(v_here > 0, (w_c - W3(0, -1, 0)) * dyi, (W3(0, 1, 0) - w_c) * dyi)
    dwdz = torch.where(w_c > 0, (w_c - W3(0, 0, -1)) * dzi, (W3(0, 0, 1) - w_c) * dzi)
    kap = (win3(kappa, ri, rj, rk) + win3(kappa, ri, rj, rk, 0, 0, -1)) * 0.5
    fz = -fl.sigma * (win3(F, ri, rj, rk) - win3(F, ri, rj, rk, 0, 0, -1)) * kap / g.dz
    nu_c = win3(nu, ri, rj, rk)
    ws = w_c + dt * (
        nu_c * (W3(-1, 0, 0) - 2 * w_c + W3(1, 0, 0)) * dxi**2
        + nu_c * (W3(0, -1, 0) - 2 * w_c + W3(0, 1, 0)) * dyi**2
        + nu_c * (W3(0, 0, -1) - 2 * w_c + W3(0, 0, 1)) * dzi**2
        - u_here * dwdx - v_here * dwdy - w_c * dwdz
        + fl.gz
        + fz * 2 / (win3(rho, ri, rj, rk) + win3(rho, ri, rj, rk, 0, 0, -1))
    )
    w_star = torch.zeros_like(w)
    w_star[1 : n1 + 1, 1 : n2 + 1, 2 : n3 + 1] = ws
    return u_star, v_star, w_star


def update_velocity_3d(g: Grid3D, dt, u_prev, v_prev, w_prev,
                       u_star, v_star, w_star, p, rho, u_lo: int = 2,
                       v_lo: int = 2):
    """The pressure-gradient correction over the reference's face ranges
    (3dvof.py:286-302); elsewhere the previous u, v, w. Returns new
    tensors."""
    n1, n2, n3 = g.nx, g.ny, g.nz

    ri, rj, rk = (u_lo, n1 + 1), (1, n2 + 1), (1, n3 + 1)
    r_u = (win3(rho, ri, rj, rk) + win3(rho, ri, rj, rk, -1, 0, 0)) * 0.5
    u_int = win3(u_star, ri, rj, rk) - dt / r_u * (
        win3(p, ri, rj, rk) - win3(p, ri, rj, rk, -1, 0, 0)
    ) * g.dxi
    u = u_prev.clone()
    u[u_lo : n1 + 1, 1 : n2 + 1, 1 : n3 + 1] = u_int

    ri, rj, rk = (1, n1 + 1), (v_lo, n2 + 1), (1, n3 + 1)
    r_v = (win3(rho, ri, rj, rk) + win3(rho, ri, rj, rk, 0, -1, 0)) * 0.5
    v_int = win3(v_star, ri, rj, rk) - dt / r_v * (
        win3(p, ri, rj, rk) - win3(p, ri, rj, rk, 0, -1, 0)
    ) * g.dyi
    v = v_prev.clone()
    v[1 : n1 + 1, v_lo : n2 + 1, 1 : n3 + 1] = v_int

    ri, rj, rk = (1, n1 + 1), (1, n2 + 1), (2, n3 + 1)
    r_w = (win3(rho, ri, rj, rk) + win3(rho, ri, rj, rk, 0, 0, -1)) * 0.5
    w_int = win3(w_star, ri, rj, rk) - dt / r_w * (
        win3(p, ri, rj, rk) - win3(p, ri, rj, rk, 0, 0, -1)
    ) * g.dzi
    w = w_prev.clone()
    w[1 : n1 + 1, 1 : n2 + 1, 2 : n3 + 1] = w_int
    return u, v, w
