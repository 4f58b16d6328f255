"""3-D Rudman FCT sweeps (counterpart of tpuvof/ops/fct3d.py; reference
3dvof.py:366-541).

One sweep, stated once in shift-and-mask form at global indices (as the
CUDA kernel computes it) and parameterized by the reference's literal
scale factors, which are not uniform: the y-sweep keeps a 2-D flux scale
dy/(dx*dy) (3dvof.py:438) and the limiter numerators use dx for the x/y
sweeps but dz for z. On the cubic cells the solver admits they coincide
numerically; they stay explicit so the rounding is the reference's. The
formula is not the 2-D one: Ftd = clamp01((F + (fL - fL+)*flux_scale) *
vol/dv), the limiter is min(1, q/p) where p > 0 with no epsilon, and the
correction is divided by final_div.

``fct3d_sweep_x/_y/_z`` keep tpuvof's names for the whole-grid sweep;
``sweep3d`` on an i-block or an (x, y) pencil is the kernel's plain version
(kernels/step3d_kernels.py).
"""
from __future__ import annotations

import torch

from ..grid import Grid3D
from .common import clamp01

__all__ = ["fct3d_sweep_x", "fct3d_sweep_y", "fct3d_sweep_z", "sweep3d", "rudman_advect_3d",
           "upwind_advect_3d", "sweep_x_masked", "sweep_inplane_masked",
           "sweep_masked_2axis", "axis_scales", "shift3"]


def axis_scales(g: Grid3D, axis: int):
    """(vol, dv_area, flux_scale, q_scale, final_div) of the sweep along
    ``axis``: the reference's literal factors."""
    vol = g.dx * g.dy * g.dz
    if axis == 0:
        return (vol, g.dy * g.dz, g.dy * g.dz / vol, g.dx, g.dy)
    if axis == 1:
        return (vol, g.dx * g.dz, g.dy / (g.dx * g.dy), g.dx, g.dy)
    return (vol, g.dx * g.dy, g.dy * g.dx / vol, g.dz, g.dz)


def sweep3d(g: Grid3D, dt, F, vel, axis: int, gi0: int = 0, gj0: int | None = None):
    """F after one sweep along ``axis`` (0, 1, 2 with vel = u, v, w) on a
    block whose plane l holds global i-index gi0 + l; its first and last
    planes carry F. On the whole grid (gi0 = 0) this is the sweep of
    tpuvof/ops/fct3d.py: every non-interior position carries F. With
    ``gj0`` the block is an (x, y) pencil whose row m holds global j-index
    gj0 + m, swept by the two-axis-masked body (tpuvof's pencil mode)."""
    if gj0 is not None:
        out = sweep_masked_2axis(g, dt, F, vel, axis, gi0, gj0)
    elif axis == 0:
        out = sweep_x_masked(g, dt, F, vel, gi0)
    else:
        out = sweep_inplane_masked(g, dt, F, vel, axis)
    out[0] = F[0]
    out[-1] = F[-1]
    return out


def fct3d_sweep_x(g: Grid3D, dt, F, u):
    return sweep3d(g, dt, F, u, 0)


def fct3d_sweep_y(g: Grid3D, dt, F, v):
    return sweep3d(g, dt, F, v, 1)


def fct3d_sweep_z(g: Grid3D, dt, F, w):
    return sweep3d(g, dt, F, w, 2)


def rudman_advect_3d(g: Grid3D, dt, F, u, v, w, phase: int):
    """The three sweeps in the istep % 3 rotation (3dvof.py:351-363):
    phase 0 x, y, z; 1 y, z, x; 2 z, x, y."""
    sweeps = {0: (fct3d_sweep_x, u), 1: (fct3d_sweep_y, v), 2: (fct3d_sweep_z, w)}
    for axis in SWEEP_ORDER[phase]:
        sweep, vel = sweeps[axis]
        F = sweep(g, dt, F, vel)
    return F


#: The sweep axes of each phase (tpuvof's solver3d._SWEEP_ORDER).
SWEEP_ORDER = {0: (0, 1, 2), 1: (1, 2, 0), 2: (2, 0, 1)}


def upwind_advect_3d(g: Grid3D, dt, F, u, v, w):
    """Plain donor-cell VOF update (reference solve_VOF_upwind,
    3dvof.py:335-347, disabled in its main loop), with the reference's 2-D
    volume factor dx*dy/(dx*dy*dz). No step calls it: it is kept as
    tpuvof's counterpart, for its test only."""
    Ftd = F

    def face_flux(vel, lo, hi):
        return vel * dt * torch.where(vel > 0, lo, hi)

    c = Ftd[1:-1, 1:-1, 1:-1]
    fl = face_flux(u[1:-1, 1:-1, 1:-1], Ftd[:-2, 1:-1, 1:-1], c)
    fr = face_flux(u[2:, 1:-1, 1:-1], c, Ftd[2:, 1:-1, 1:-1])
    fs = face_flux(v[1:-1, 1:-1, 1:-1], Ftd[1:-1, :-2, 1:-1], c)
    fn = face_flux(v[1:-1, 2:, 1:-1], c, Ftd[1:-1, 2:, 1:-1])
    fb = face_flux(w[1:-1, 1:-1, 1:-1], Ftd[1:-1, 1:-1, :-2], c)
    ff = face_flux(w[1:-1, 1:-1, 2:], c, Ftd[1:-1, 1:-1, 2:])
    upd = c + (fl - fr + fs - fn + fb - ff) * (g.dx * g.dy) / (g.dx * g.dy * g.dz)
    out = F.clone()
    out[1:-1, 1:-1, 1:-1] = upd
    return out


# ----------------------------------------------------------------------
# shift-and-mask form (the plain version of the sweep kernel)
# ----------------------------------------------------------------------
def shift3(x, di=0, dj=0, dk=0):
    """x[i+di, j+dj, k+dk], 0 where that lies off the array. tpuvof's
    masked forms roll (wrap) instead; the two differ only on positions
    whose values are junk by contract (near a block's edge)."""
    out = torch.zeros_like(x)
    src, dst = [], []
    for d, n in zip((di, dj, dk), x.shape):
        if abs(d) >= n:
            return out
        src.append(slice(max(d, 0), n + min(d, 0)))
        dst.append(slice(max(-d, 0), n + min(-d, 0)))
    out[tuple(dst)] = x[tuple(src)]
    return out


def _sweep_masked(g: Grid3D, dt, F, vel, axis, idx, n_sweep, o_int, sh):
    """The limiter chain of one sweep at global indices: ``idx`` is the
    global index along the sweep, ``o_int`` the interior mask across it,
    ``sh(x, d)`` the shift along it. Non-interior positions carry F."""
    vol, dv_area, flux_scale, q_scale, final_div = axis_scales(g, axis)
    zero = torch.zeros((), dtype=F.dtype, device=F.device)
    F_up = sh(F, -1)
    fL = vel * dt * torch.where(vel >= 0, F_up, F)
    fH = vel * dt * torch.where(vel <= 0, F_up, F)
    face = (idx >= 1) & o_int
    a = torch.where(face, fH - fL, zero)
    dv = vol - dt * dv_area * (sh(vel, 1) - vel)
    ftd = clamp01((F + (fL - sh(fL, 1)) * flux_scale) * vol / dv)
    int_m = (idx >= 1) & (idx <= n_sweep) & o_int
    Ftd = torch.where(int_m, ftd, zero)
    fmax = torch.maximum(Ftd, torch.maximum(sh(Ftd, -1), sh(Ftd, 1)))
    fmin = torch.minimum(Ftd, torch.minimum(sh(Ftd, -1), sh(Ftd, 1)))
    a_hi = sh(a, 1)
    pp = torch.maximum(zero, a) - torch.minimum(zero, a_hi)
    qp = (fmax - Ftd) * q_scale
    rp = torch.where(int_m & (pp > 0),
                     torch.clamp_max(qp / torch.where(pp > 0, pp, 1.0), 1.0), zero)
    pm = torch.maximum(zero, a_hi) - torch.minimum(zero, a)
    qm = (Ftd - fmin) * q_scale
    rm = torch.where(int_m & (pm > 0),
                     torch.clamp_max(qm / torch.where(pm > 0, pm, 1.0), 1.0), zero)
    cfct = torch.where(face,
                       torch.where(a >= 0, torch.minimum(rp, sh(rm, -1)),
                                   torch.minimum(sh(rp, -1), rm)),
                       zero)
    corr = (sh(a, 1) * sh(cfct, 1) - a * cfct) / final_div
    return torch.where(int_m, clamp01(Ftd - corr * vol / dv), F)


def _iota(shape, axis, device):
    view = [1, 1, 1]
    view[axis] = shape[axis]
    return torch.arange(shape[axis], device=device).reshape(view)


def sweep_x_masked(g: Grid3D, dt, F, vel, gi0: int):
    """One x-sweep on a block whose plane l holds global i-index gi0 + l;
    positions within 3 planes of a block edge that is not the array's
    true edge are junk."""
    dev = F.device
    gi = _iota(F.shape, 0, dev) + gi0
    j = _iota(F.shape, 1, dev)
    k = _iota(F.shape, 2, dev)
    o_int = (j >= 1) & (j <= g.ny) & (k >= 1) & (k <= g.nz)
    return _sweep_masked(g, dt, F, vel, 0, gi, g.nx, o_int,
                         lambda x, d: shift3(x, d, 0, 0))


def sweep_inplane_masked(g: Grid3D, dt, F, vel, axis: int):
    """One y- (axis=1) or z- (axis=2) sweep, plane by plane: valid for any
    set of i-planes."""
    dev = F.device
    idx = _iota(F.shape, axis, dev)
    io = _iota(F.shape, 2 if axis == 1 else 1, dev)
    o_hi = g.nz if axis == 1 else g.ny
    o_int = (io >= 1) & (io <= o_hi)
    n_sweep = g.ny if axis == 1 else g.nz
    return _sweep_masked(g, dt, F, vel, axis, idx, n_sweep, o_int,
                         lambda x, d: shift3(x, 0, d if axis == 1 else 0,
                                             d if axis == 2 else 0))


def sweep_masked_2axis(g: Grid3D, dt, F, vel, axis: int, gi0: int, gj0: int):
    """One sweep along ``axis`` on an (x, y) pencil whose position (l, m, n)
    holds global indices (gi0 + l, gj0 + m, n), every mask global in i and
    j (tpuvof's sweep_masked_2axis, the pencil engine's sweep body). Unlike
    the slab's in-plane sweeps, the y- and z-sweeps also require an
    interior global i. Positions within 3 cells of a block edge along the
    sweep axis are junk unless that edge is the true wall. tpuvof's
    ``nj_valid`` bound keeps its sublane-pad rows at zero; the port's
    blocks have no pad rows, so every row is in bounds."""
    dev = F.device
    gi = _iota(F.shape, 0, dev) + gi0
    gj = _iota(F.shape, 1, dev) + gj0
    k = _iota(F.shape, 2, dev)
    m_i = (gi >= 1) & (gi <= g.nx)
    m_j = (gj >= 1) & (gj <= g.ny)
    m_k = (k >= 1) & (k <= g.nz)
    o_int = {0: m_j & m_k, 1: m_i & m_k, 2: m_i & m_j}[axis]
    return _sweep_masked(g, dt, F, vel, axis, (gi, gj, k)[axis], (g.nx, g.ny, g.nz)[axis],
                         o_int, lambda x, d: shift3(x, *(d if a == axis else 0
                                                         for a in range(3))))
