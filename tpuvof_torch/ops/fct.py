"""Rudman/Zalesak flux-corrected transport of F (counterpart of
tpuvof/ops/fct.py:48-170).

One sweep has four passes: the donor-cell value Ftd with the divergence
compensation dV/dv, the anti-diffusive face flux a = f_H - f_L with the
Zalesak limiter ratios rp/rm, the corrected flux factor c per face, and
the limited anti-diffusion.

Ghost conventions are load-bearing: Ftd/rp/rm/a/c are zero off their
ranges, and F keeps its ghosts from the last boundary application (the
main solver does not refresh them between the two sweeps). With square
cells the y-sweep is the exact transpose of the x-sweep, including the
dx-scaled limiter numerators, so one axis-0 routine serves both.
"""
from __future__ import annotations

import torch

from ..config import FCTVariant, Numerics
from ..grid import Grid2D
from .bc import mirror_scalar
from .common import clamp01, embed2, merge_interior

__all__ = ["fct_sweep_x", "fct_sweep_y", "rudman_advect"]


def _max3(a, b, c):
    return torch.maximum(a, torch.maximum(b, c))


def _min3(a, b, c):
    return torch.minimum(a, torch.minimum(b, c))


def _sweep_axis0(dx: float, dy: float, dt: float, var: FCTVariant, F, u):
    """One FCT sweep along axis 0 of (n0+2, n1+2) tensors. ``u[i, j]`` is
    the face-normal velocity on the lower axis-0 face of cell (i, j).
    Returns the updated F with its ghosts preserved."""
    # face fluxes on faces f in [1, n0+1], j in [1, n1]
    uf = u[1:, 1:-1]
    F_up = F[:-1, 1:-1]  # donor cell below the face
    F_dn = F[1:, 1:-1]  # donor cell above the face
    fL = uf * dt * torch.where(uf >= 0, F_up, F_dn)  # upwind (low order)
    fH = uf * dt * torch.where(uf <= 0, F_up, F_dn)  # downwind (high order)
    a = embed2(fH - fL, 1, 0, 1, 1)

    # pass 1: low-order transported and diffused value
    F_c = F[1:-1, 1:-1]
    du = uf[1:] - uf[:-1]
    dv = dx * dy - dt * dy * du
    netflux = (fL[:-1] - fL[1:]) * dy / (dx * dy)
    if var.full_dv:
        ftd_int = (F_c + netflux) * dx * dy / dv
    else:
        ftd_int = F_c + netflux * dx * dy / dv
    if var.clamp:
        ftd_int = clamp01(ftd_int)
    Ftd = embed2(ftd_int, 1, 1, 1, 1)

    # pass 2: Zalesak limiter ratios (reads Ftd's zero ghosts at the edge)
    fmax = _max3(Ftd[1:-1, 1:-1], Ftd[:-2, 1:-1], Ftd[2:, 1:-1])
    fmin = _min3(Ftd[1:-1, 1:-1], Ftd[:-2, 1:-1], Ftd[2:, 1:-1])
    a_lo = a[1:-1, 1:-1]  # flux through the cell's lower face
    a_hi = a[2:, 1:-1]  # flux through the cell's upper face

    zero = torch.zeros((), dtype=F.dtype, device=F.device)
    one = torch.ones((), dtype=F.dtype, device=F.device)
    pp = torch.maximum(zero, a_lo) - torch.minimum(zero, a_hi)
    qp = (fmax - ftd_int) * dx
    den_p = torch.where(pp > var.guard_eps, pp + var.denom_eps, 1.0)
    rp_int = torch.where(pp > var.guard_eps, torch.minimum(one, qp / den_p), 0.0)

    pm = torch.maximum(zero, a_hi) - torch.minimum(zero, a_lo)
    qm = (ftd_int - fmin) * dx
    den_m = torch.where(pm > var.guard_eps, pm + var.denom_eps, 1.0)
    rm_int = torch.where(pm > var.guard_eps, torch.minimum(one, qm / den_m), 0.0)

    rp = embed2(rp_int, 1, 1, 1, 1)
    rm = embed2(rm_int, 1, 1, 1, 1)

    # pass 3: corrected flux factor per face f in [1, n0+1]
    a_f = a[1:, 1:-1]
    c_int = torch.where(
        a_f >= 0,
        torch.minimum(rp[1:, 1:-1], rm[:-1, 1:-1]),
        torch.minimum(rp[:-1, 1:-1], rm[1:, 1:-1]),
    )
    c = embed2(c_int, 1, 0, 1, 1)

    # pass 4: apply the limited anti-diffusion
    corr = (a[2:, 1:-1] * c[2:, 1:-1] - a[1:-1, 1:-1] * c[1:-1, 1:-1]) / dy
    f_new = ftd_int - corr * dx * dy / dv
    if var.clamp:
        f_new = clamp01(f_new)
    return merge_interior(F, f_new)


def fct_sweep_x(g: Grid2D, nm: Numerics, F, u, var: FCTVariant | None = None):
    var = nm.fct if var is None else var
    return _sweep_axis0(g.dx, g.dy, nm.dt, var, F, u)


def fct_sweep_y(g: Grid2D, nm: Numerics, F, v, var: FCTVariant | None = None):
    var = nm.fct if var is None else var
    # square cells: the y-sweep is the transposed x-sweep, including the
    # reference's dx-scaled limiter numerators
    return _sweep_axis0(g.dy, g.dx, nm.dt, var, F.T, v.T).T.contiguous()


def rudman_advect(g: Grid2D, nm: Numerics, F, u, v, even_step: bool,
                  var: FCTVariant | None = None):
    """Strang-alternated double sweep: even steps sweep y then x, odd steps
    x then y."""
    var = nm.fct if var is None else var
    if even_step:
        F = fct_sweep_y(g, nm, F, v, var)
        if nm.bc_between_sweeps:
            F = mirror_scalar(F)
        F = fct_sweep_x(g, nm, F, u, var)
    else:
        F = fct_sweep_x(g, nm, F, u, var)
        if nm.bc_between_sweeps:
            F = mirror_scalar(F)
        F = fct_sweep_y(g, nm, F, v, var)
    if nm.bc_between_sweeps:
        F = mirror_scalar(F)
    return F
