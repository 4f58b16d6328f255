"""The step's phases on a block with a global origin (counterpart of the
windowed bodies of tpuvof/pallas_kernels/step_kernels.py: _predict_body,
_sweep_body, _sanitized_win, _win_step_values, _bc_values).

A block is a 2-D tensor whose (0, 0) entry sits at global index (oi, oj)
of a grid with nx x ny interior cells. Every mask is taken at global
indices, and every value outside the global ghost-included domain
[0, nx+2) x [0, ny+2) is zeroed at load, so junk there (NaN included)
cannot leak in. Reads past the block's own edges see zeros; the values
they feed erode inward by one cell per stencil pass and are junk by
contract (callers keep the block's centre). The expressions are the
whole-grid ops' (ops/normals.py, momentum.py, poisson.py, fct.py, bc.py)
in full-shape masked form, so at oi = oj = 0 on the whole grid each
phase equals its op bit for bit.

These are the plain versions of the windowed and whole-step kernels
(kernels/step_kernels.py); the plain-torch route does not use them.
"""
from __future__ import annotations

import torch

from ..config import SimConfig
from .common import clamp01
from .materials import mix_properties
from .poisson import poisson_diagonal_constants

__all__ = ["shift", "sanitize", "predict_values", "sweep_values", "step_values"]


def shift(x, di: int = 0, dj: int = 0):
    """x[i+di, j+dj], with zeros past the block's edges."""
    n0, n1 = x.shape
    out = torch.zeros_like(x)
    out[max(-di, 0):n0 - max(di, 0), max(-dj, 0):n1 - max(dj, 0)] = \
        x[max(di, 0):n0 + min(di, 0), max(dj, 0):n1 + min(dj, 0)]
    return out


class _Idx:
    """Global row/column indices of a block, and its global masks."""

    def __init__(self, shape, oi: int, oj: int, device):
        self.row = torch.arange(shape[0], device=device)[:, None] + oi
        self.col = torch.arange(shape[1], device=device)[None, :] + oj

    def region(self, r0, r1, c0, c1):
        """Global box [r0, r1) x [c0, c1)."""
        return (self.row >= r0) & (self.row < r1) & (self.col >= c0) & (self.col < c1)


def sanitize(cfg: SimConfig, oi: int, oj: int, *fields):
    """The fields with every entry outside [0, n+2)^2 set to 0."""
    g = cfg.grid
    ix = _Idx(fields[0].shape, oi, oj, fields[0].device)
    valid = ix.region(0, g.nx + 2, 0, g.ny + 2)
    return [torch.where(valid, a, 0.0) for a in fields]


def predict_values(cfg: SimConfig, u, v, F, oi: int, oj: int):
    """(u*, v*, rho) on a block of sanitized fields: materials, Youngs
    normals, curvature and the momentum predictor, u* on global rows
    [2, nx+1) x cols [1, ny+1) and v* on [1, nx+1) x [2, ny+1), 0
    elsewhere."""
    g, fl, nm = cfg.grid, cfg.fluid, cfg.num
    sh = shift
    ix = _Idx(F.shape, oi, oj, F.device)
    interior = ix.region(1, g.nx + 1, 1, g.ny + 1)
    dt = nm.dt
    dxi, dyi = g.dxi, g.dyi
    rho, nu = mix_properties(fl, F)

    inv2dx = 1.0 / (2.0 * g.dx)
    inv2dy = 1.0 / (2.0 * g.dy)

    def f(di, dj):
        return sh(F, di, dj)

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
    degenerate = (torch.abs(mxsum) < 1e-10) & (torch.abs(mysum) < 1e-10)
    mag_sq = mxsum * mxsum + mysum * mysum
    safe_mag = torch.sqrt(torch.where(degenerate, 1.0, mag_sq))
    mx = torch.where(interior, torch.where(degenerate, mxsum, mxsum / safe_mag), 0.0)
    my = torch.where(interior, torch.where(degenerate, mysum, mysum / safe_mag), 0.0)
    kappa = torch.where(
        interior,
        -(inv2dx * (sh(mx, 1, 0) - sh(mx, -1, 0)) + inv2dy * (sh(my, 0, 1) - sh(my, 0, -1))),
        0.0,
    )

    v_here = 0.25 * (sh(v, -1, 0) + sh(v, -1, 1) + v + sh(v, 0, 1))
    dudx = torch.where(u > 0, (u - sh(u, -1, 0)) * dxi, (sh(u, 1, 0) - u) * dxi)
    dudy = torch.where(v_here > 0, (u - sh(u, 0, -1)) * dyi, (sh(u, 0, 1) - u) * dyi)
    kap_u = (kappa + sh(kappa, -1, 0)) * 0.5
    fx_kappa = -fl.sigma * (F - sh(F, -1, 0)) * kap_u / g.dx
    us = u + dt * (
        nu * (sh(u, -1, 0) - 2.0 * u + sh(u, 1, 0)) * dxi**2
        + nu * (sh(u, 0, -1) - 2.0 * u + sh(u, 0, 1)) * dyi**2
        - u * dudx
        - v_here * dudy
        + fl.gx
        + fx_kappa * 2.0 / (rho + sh(rho, -1, 0))
    )

    u_here = 0.25 * (sh(u, 0, -1) + u + sh(u, 1, -1) + sh(u, 1, 0))
    dvdx = torch.where(u_here > 0, (v - sh(v, -1, 0)) * dxi, (sh(v, 1, 0) - v) * dxi)
    dvdy = torch.where(v > 0, (v - sh(v, 0, -1)) * dyi, (sh(v, 0, 1) - v) * dyi)
    kap_v = (kappa + sh(kappa, 0, -1)) * 0.5
    fy_kappa = -fl.sigma * (F - sh(F, 0, -1)) * kap_v / g.dy
    vs = v + dt * (
        nu * (sh(v, -1, 0) - 2.0 * v + sh(v, 1, 0)) * dxi**2
        + nu * (sh(v, 0, -1) - 2.0 * v + sh(v, 0, 1)) * dyi**2
        - u_here * dvdx
        - v * dvdy
        + fl.gy
        + fy_kappa * 2.0 / (rho + sh(rho, 0, -1))
    )
    us = torch.where(ix.region(2, g.nx + 1, 1, g.ny + 1), us, 0.0)
    vs = torch.where(ix.region(1, g.nx + 1, 2, g.ny + 1), vs, 0.0)
    return us, vs, rho


def _sweep_axis0(dx, dy, dt, var, F, u, n_ax: int, n_ot: int, off_ax: int, off_ot: int):
    """One FCT sweep along axis 0 of a block of sanitized fields; the
    output keeps F off the global interior."""
    sh = shift
    idx = torch.arange(F.shape[0], device=F.device)[:, None] + off_ax
    odx = torch.arange(F.shape[1], device=F.device)[None, :] + off_ot
    o_int = (odx >= 1) & (odx <= n_ot)
    interior = (idx >= 1) & (idx <= n_ax) & o_int
    face = (idx >= 1) & o_int

    F_up = sh(F, -1)
    fL = u * dt * torch.where(u >= 0, F_up, F)
    fH = u * dt * torch.where(u <= 0, F_up, F)
    a = torch.where(face, fH - fL, 0.0)

    dv = dx * dy - dt * dy * (sh(u, 1) - u)
    netflux = (fL - sh(fL, 1)) * dy / (dx * dy)
    if var.full_dv:
        ftd = (F + netflux) * dx * dy / dv
    else:
        ftd = F + netflux * dx * dy / dv
    if var.clamp:
        ftd = clamp01(ftd)
    Ftd = torch.where(interior, ftd, 0.0)

    fmax = torch.maximum(Ftd, torch.maximum(sh(Ftd, -1), sh(Ftd, 1)))
    fmin = torch.minimum(Ftd, torch.minimum(sh(Ftd, -1), sh(Ftd, 1)))
    a_hi = sh(a, 1)
    zero = torch.zeros((), dtype=F.dtype, device=F.device)
    one = torch.ones((), dtype=F.dtype, device=F.device)
    pp = torch.maximum(zero, a) - torch.minimum(zero, a_hi)
    qp = (fmax - Ftd) * dx
    den_p = torch.where(pp > var.guard_eps, pp + var.denom_eps, 1.0)
    rp = torch.where(interior & (pp > var.guard_eps), torch.minimum(one, qp / den_p), 0.0)
    pm = torch.maximum(zero, a_hi) - torch.minimum(zero, a)
    qm = (Ftd - fmin) * dx
    den_m = torch.where(pm > var.guard_eps, pm + var.denom_eps, 1.0)
    rm = torch.where(interior & (pm > var.guard_eps), torch.minimum(one, qm / den_m), 0.0)

    c = torch.where(
        face,
        torch.where(a >= 0, torch.minimum(rp, sh(rm, -1)), torch.minimum(sh(rp, -1), rm)),
        0.0,
    )
    corr = (sh(a, 1) * sh(c, 1) - a * c) / dy
    f_new = Ftd - corr * dx * dy / dv
    if var.clamp:
        f_new = clamp01(f_new)
    return torch.where(interior, f_new, F)


def sweep_values(cfg: SimConfig, F, vel, axis: int, oi: int, oj: int):
    """One FCT sweep along x (axis 0, vel = u) or y (axis 1, vel = v) on a
    block of sanitized fields. The y-sweep is the transposed x-sweep with
    (dy, dx), as in tpuvof."""
    g, nm = cfg.grid, cfg.num
    if axis == 0:
        return _sweep_axis0(g.dx, g.dy, nm.dt, nm.fct, F, vel, g.nx, g.ny, oi, oj)
    return _sweep_axis0(g.dy, g.dx, nm.dt, nm.fct, F.T, vel.T,
                        g.ny, g.nx, oj, oi).T.contiguous()


def _bc_values(cfg: SimConfig, ix: _Idx, u, v, F, p):
    """The wall BCs at global indices, j-boundaries first, then i."""
    g = cfg.grid
    i_hi, j_hi = g.nx + 1, g.ny + 1

    def mirror_j(a):
        a = torch.where(ix.col == 0, shift(a, 0, 1), a)
        return torch.where(ix.col == j_hi, shift(a, 0, -1), a)

    def mirror_i(a):
        a = torch.where(ix.row == 0, shift(a, 1, 0), a)
        return torch.where(ix.row == i_hi, shift(a, -1, 0), a)

    u = torch.where((ix.row == 1) | (ix.row == i_hi), 0.0, mirror_j(u))
    v = mirror_i(torch.where((ix.col == 1) | (ix.col == j_hi), 0.0, v))
    return u, v, mirror_i(mirror_j(F)), mirror_i(mirror_j(p))


def step_values(cfg: SimConfig, F, u, v, p, oi: int, oj: int, even_step: bool):
    """One lean step on a block: (F, u, v, p) after the sanitizer, the
    predictor, rhs, n_jacobi Jacobi sweeps, the correction, both FCT
    sweeps in parity order, the clamp and the wall BCs. The Jacobi
    updates cells of the global interior that are not on the block's
    edge; every other p keeps its entry value."""
    g, nm = cfg.grid, cfg.num
    dt = nm.dt
    F, u, v, p = sanitize(cfg, oi, oj, F, u, v, p)
    ix = _Idx(F.shape, oi, oj, F.device)
    interior = ix.region(1, g.nx + 1, 1, g.ny + 1)
    us, vs, rho = predict_values(cfg, u, v, F, oi, oj)

    rhs = rho / dt * ((shift(us, 1, 0) - us) * g.dxi + (shift(vs, 0, 1) - vs) * g.dyi)
    dxi2 = float(g.dxi) ** 2
    dyi2 = float(g.dyi) ** 2
    c = poisson_diagonal_constants(g)

    def const(x):
        return torch.full((), x, dtype=p.dtype, device=p.device)

    zero = const(0.0)
    ae = torch.where(ix.row == g.nx, zero, const(dxi2))
    aw = torch.where(ix.row == 1, zero, const(dxi2))
    an = torch.where(ix.col == g.ny, zero, const(dyi2))
    a_s = torch.where(ix.col == 1, zero, const(dyi2))
    ex = (ix.row == 1) | (ix.row == g.nx)
    ey = (ix.col == 1) | (ix.col == g.ny)
    ap_inv = torch.where(ex, torch.where(ey, const(c[1, 1]), const(c[1, 0])),
                         torch.where(ey, const(c[0, 1]), const(c[0, 0])))
    local = torch.zeros_like(interior)
    local[1:-1, 1:-1] = True
    update = interior & local
    for _ in range(nm.n_jacobi):
        p_new = (rhs - ae * shift(p, 1, 0) - aw * shift(p, -1, 0)
                 - an * shift(p, 0, 1) - a_s * shift(p, 0, -1)) * ap_inv
        p = torch.where(update, p_new, p)

    r_u = (rho + shift(rho, -1, 0)) * 0.5
    u_corr = us - dt / r_u * (p - shift(p, -1, 0)) * g.dxi
    u = torch.where(ix.region(2, g.nx + 1, 1, g.ny + 1), u_corr, u)
    r_v = (rho + shift(rho, 0, -1)) * 0.5
    v_corr = vs - dt / r_v * (p - shift(p, 0, -1)) * g.dyi
    v = torch.where(ix.region(1, g.nx + 1, 2, g.ny + 1), v_corr, v)

    for axis in (1, 0) if even_step else (0, 1):
        F = sweep_values(cfg, F, v if axis else u, axis, oi, oj)
    F = clamp01(F)
    u, v, F, p = _bc_values(cfg, ix, u, v, F, p)
    return F, u, v, p
