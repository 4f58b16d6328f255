"""Geometric multigrid for the edge-zeroed pure-Neumann Poisson operator
(counterpart of tpuvof/ops/mg.py:60-298), the 'mg' rung of the ladder.

Dimension-generic, as tpuvof's, so the 3-D driver can reuse it: every
level works on interior-shaped tensors, and each level's operator zeroes
its wall coefficients, which makes ``torch.roll`` a safe shift (the
wrapped neighbour meets an exactly-zero coefficient).

Scheme: red-black Gauss-Seidel smoothing, V(1,1) when a relative
tolerance is set and V(2,2) otherwise; pairwise-mean restriction;
edge-clamped linear prolongation; 50 red-black sweeps on the coarsest
level; coarsening while every extent is even and stays >= 4. The outer
loop runs V-cycles until the nullspace-projected residual meets the
tolerance, the cycle cap, or the stall exit. tpuvof runs it as a
``lax.while_loop``; here the exit test reads the residual on the host once
per V-cycle (ops.poisson.keep_iterating).

``mg_solve_implicit`` is ``mg_solve`` with the implicit-function adjoint,
one more mg solve on the mean-free cotangent (ops.poisson.RbsorImplicit
explains it); the differentiable path's 'selfadjoint' route reaches mg
that way.
"""
from __future__ import annotations

import numpy as np
import torch

from .poisson import cell_mean, effective_tol, keep_iterating, mean_free_interior

__all__ = ["mg_solve", "mg_solve_implicit", "mg_levels", "STALL_CYCLES"]

#: V-cycles without a new best residual before the stall exit may fire.
STALL_CYCLES = 4

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def mg_levels(shape) -> list[tuple[int, ...]]:
    """The coarsening ladder of an interior shape: halve every axis while
    all extents are even and stay >= 4. [(fine), ..., (coarsest)]."""
    shapes = [tuple(int(n) for n in shape)]
    while all(n % 2 == 0 and n // 2 >= 4 for n in shapes[-1]):
        shapes.append(tuple(n // 2 for n in shapes[-1]))
    return shapes


def _index(shape, ax, device, offset: int = 0):
    """The index along ``ax``, plus ``offset``, broadcastable to ``shape``."""
    view = [1] * len(shape)
    view[ax] = shape[ax]
    return (torch.arange(shape[ax], device=device) + offset).reshape(view)


def _coeffs(shape, inv2, dtype, device, offsets=None, whole=None):
    """Edge-zeroed coefficients of one level: ([(a_plus, a_minus) per
    axis], ap, ap_inv). a_plus multiplies the +1 neighbour and is zero on
    the last slice (the wall); ap and ap_inv accumulate in ``dtype``.
    ``offsets`` and ``whole`` place a block of a sharded level: its cell 0
    sits at global index ``offsets`` of a level of shape ``whole``, and
    only the global walls zero a coefficient."""
    offsets = offsets or (0,) * len(shape)
    whole = whole or shape
    total = None
    axes = []
    zero = torch.zeros((), dtype=dtype, device=device)
    for ax, c in enumerate(inv2):
        idx = _index(shape, ax, device, offsets[ax])
        cval = torch.full((), float(np.float64(c).astype(_NP_DTYPE[dtype])),
                          dtype=dtype, device=device)
        apl = torch.where(idx == whole[ax] - 1, zero, cval).expand(shape)
        ami = torch.where(idx == 0, zero, cval).expand(shape)
        pair = apl + ami
        total = pair if total is None else total + pair
        axes.append((apl, ami))
    return axes, -total, -1.0 / total


def _neigh(axes, p, rhs):
    """rhs - the neighbour contributions."""
    out = rhs
    for ax, (apl, ami) in enumerate(axes):
        out = out - apl * torch.roll(p, -1, ax) - ami * torch.roll(p, 1, ax)
    return out


def _red_mask(shape, device, offsets=None):
    """(i + j [+ k]) % 2 == 0, at global indices on a block whose cell 0
    sits at ``offsets``."""
    offsets = offsets or (0,) * len(shape)
    s = None
    for ax in range(len(shape)):
        idx = _index(shape, ax, device, offsets[ax])
        s = idx if s is None else s + idx
    return (s % 2) == 0


def _rb_sweep(axes, ap_inv, red, p, rhs):
    """One red-black Gauss-Seidel sweep (two half sweeps)."""
    for mask in (red, ~red):
        gs = _neigh(axes, p, rhs) * ap_inv
        p = torch.where(mask, gs, p)
    return p


def _restrict(r):
    """Per-axis pairwise mean (cell-centred full weighting)."""
    for ax in range(r.ndim):
        n = r.shape[ax]
        r = r.reshape(r.shape[:ax] + (n // 2, 2) + r.shape[ax + 1:]).mean(dim=ax + 1)
    return r


def _prolong_axis(e, ax):
    n = e.shape[ax]
    lo = torch.cat([e.narrow(ax, 0, 1), e.narrow(ax, 0, n - 1)], dim=ax)
    hi = torch.cat([e.narrow(ax, 1, n - 1), e.narrow(ax, n - 1, 1)], dim=ax)
    a = 0.25 * lo + 0.75 * e  # fine cell 2i, nearer coarse cell i-1
    b = 0.75 * e + 0.25 * hi  # fine cell 2i+1, nearer coarse cell i+1
    out = torch.stack([a, b], dim=ax + 1)
    return out.reshape(e.shape[:ax] + (2 * n,) + e.shape[ax + 1:])


def _prolong(e):
    """Bi/tri-linear cell-centred interpolation, clamped at the edges."""
    for ax in range(e.ndim):
        e = _prolong_axis(e, ax)
    return e


def _nu_policy(nu, tol_rel) -> int:
    """nu=None: V(1,1) in the relative-tolerance mode, V(2,2) otherwise
    (tpuvof's measured policy)."""
    if nu is None:
        return 1 if (tol_rel and tol_rel > 0.0) else 2
    return nu


def _build_levels(shapes, inv2, dtype, device):
    """Per level (axes, ap, ap_inv, red mask); ``inv2`` is 1/h^2 on the
    finest level, divided by 4 per level."""
    levels = []
    for lvl, shape in enumerate(shapes):
        axes, ap, ap_inv = _coeffs(shape, tuple(c / 4.0**lvl for c in inv2),
                                   dtype, device)
        levels.append((axes, ap, ap_inv, _red_mask(shape, device)))
    return levels


def _vcycle(levels, nu: int, coarse_iters: int, lvl: int, p_l, rhs_l):
    axes, ap, ap_inv, red = levels[lvl]
    if lvl == len(levels) - 1:
        for _ in range(coarse_iters):
            p_l = _rb_sweep(axes, ap_inv, red, p_l, rhs_l)
        return p_l
    for _ in range(nu):
        p_l = _rb_sweep(axes, ap_inv, red, p_l, rhs_l)
    rn = _restrict(_neigh(axes, p_l, rhs_l) - ap * p_l)  # restricted rhs - A p
    e = _vcycle(levels, nu, coarse_iters, lvl + 1, torch.zeros_like(rn), rn)
    p_l = p_l + _prolong(e)
    for _ in range(nu):
        p_l = _rb_sweep(axes, ap_inv, red, p_l, rhs_l)
    return p_l


def mg_solve(p, rhs, inv2, tol, max_cycles, nu: int | None = None,
             coarse_iters: int = 50, tol_rel: float = 0.0):
    """Solve the interior pressure system by residual-driven V-cycles.

    p: the full ghosted tensor (its ghosts are kept); rhs: interior-shaped;
    inv2: per-axis 1/h^2 on the fine level; tol: stop when max|Ap - rhs'|
    <= tol; max_cycles: the V-cycle cap; tol_rel > 0 raises tol to
    tol_rel * max|rhs'| (ops.poisson.effective_tol); nu: smoothing sweeps,
    None for the policy above. Raises ValueError where the grid does not
    coarsen at all; 'rbsor' serves there."""
    nu = _nu_policy(nu, tol_rel)
    shapes = mg_levels(rhs.shape)
    if len(shapes) < 2:
        raise ValueError(
            f"pressure_solver='mg' needs a coarsenable interior grid "
            f"(all extents even and >= 8); got {tuple(rhs.shape)} - use 'rbsor'")
    levels = _build_levels(shapes, inv2, p.dtype, p.device)
    rhs = rhs - cell_mean(rhs)
    tol = effective_tol(tol, tol_rel, rhs).item()
    axes0, ap0, _, _ = levels[0]

    def resid(p_l):
        r = _neigh(axes0, p_l, rhs) - ap0 * p_l
        r = r - cell_mean(r)
        return torch.max(torch.abs(r)).item()

    interior = (slice(1, -1),) * rhs.ndim
    p_l = p[interior]
    r = best = resid(p_l)
    it = stall = 0
    while keep_iterating(it, max_cycles, r, tol, best, stall, STALL_CYCLES):
        p_l = _vcycle(levels, nu, coarse_iters, 0, p_l, rhs)
        r = resid(p_l)
        stall = 0 if r < best else stall + 1
        best = min(best, r)
        it += 1
    out = p.clone()
    out[interior] = p_l
    return out


class _MgImplicit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, rhs, kw):
        ctx.kw = kw
        return mg_solve(p, rhs, **kw)

    @staticmethod
    def backward(ctx, g_out):
        y = mg_solve(torch.zeros_like(g_out), mean_free_interior(g_out), **ctx.kw)
        return torch.zeros_like(g_out), mean_free_interior(y), None


def mg_solve_implicit(p, rhs, inv2, tol, max_cycles, nu: int | None = None,
                      coarse_iters: int = 50, tol_rel: float = 0.0):
    """``mg_solve``, differentiable by the implicit-function adjoint
    (tpuvof's mg_solve_implicit): the cotangent of rhs is one more mg
    solve, from zero, on the mean-free interior cotangent of p, made
    mean-free again; the warm start p gets a zero cotangent. The primal
    is mg_solve's, bit for bit; nothing is saved."""
    return _MgImplicit.apply(p, rhs, dict(inv2=inv2, tol=tol, max_cycles=max_cycles, nu=nu,
                                          coarse_iters=coarse_iters, tol_rel=tol_rel))
