"""Chorin pressure projection and the pressure-solver ladder
(counterpart of tpuvof/ops/poisson.py:38-109, 148-298).

A 5-point stencil whose edge coefficients are zeroed on the pure-Neumann
walls. 'jacobi' iterates it a fixed number of times with no residual
check (the reference); 'rbsor' and 'mg' (ops/mg.py) iterate to a residual
tolerance. tpuvof runs those two as ``lax.while_loop``s on the device;
here the exit test reads the residual on the host once per iteration, in
the dtype tpuvof compares it in, so both take the same number of
iterations. The adjoints of the ladder belong to the differentiable path
(ROADMAP Queue 1 item 6).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import Numerics
from ..grid import Grid2D
from .common import win

__all__ = [
    "poisson_coefficients",
    "poisson_diagonal_constants",
    "poisson_constants_3d",
    "ap_inv_3d",
    "divergence_rhs",
    "jacobi_sweeps",
    "solve_pressure",
    "residual",
    "effective_tol",
    "STALL_ITERS",
    "PLATEAU_FACTOR",
]


def poisson_diagonal_constants(g: Grid2D) -> dict:
    """The four edge-class values of ap_inv = -1/(ae + aw + an + as), keyed
    by (on an x-edge, on a y-edge), computed in float64 in the order
    ((ae + aw) + an) + as (adding a zeroed edge coefficient is exact). The
    caller casts them to its dtype; tpuvof builds its coefficients the
    same way, so the cast values are bit-equal to tpuvof's."""
    dxi2 = np.float64(g.dxi) ** 2
    dyi2 = np.float64(g.dyi) ** 2

    def const(x_edge, y_edge):
        t = dxi2 if x_edge else dxi2 + dxi2
        for _ in range(2 - y_edge):
            t = t + dyi2
        return float(-1.0 / t)

    return {(ex, ey): const(ex, ey) for ex in (0, 1) for ey in (0, 1)}


def poisson_constants_3d(g) -> tuple[tuple[float, float, float], dict]:
    """The 3-D stencil's (1/dx^2, 1/dy^2, 1/dz^2) and its 8 edge-class
    values of 1/ap, keyed by (on an x-edge, on a y-edge, on a z-edge), in
    float64 in tpuvof's ((((ae + aw) + an) + as) + ab) + af order; the
    caller casts them to its dtype."""
    dxi2 = np.float64(g.dxi) ** 2
    dyi2 = np.float64(g.dyi) ** 2
    dzi2 = np.float64(g.dzi) ** 2

    def const(ex, ey, ez):
        t = dxi2 if ex else dxi2 + dxi2
        for _ in range(2 - ey):
            t = t + dyi2
        for _ in range(2 - ez):
            t = t + dzi2
        return float(-1.0 / t)

    classes = {(ex, ey, ez): const(ex, ey, ez)
               for ex in (0, 1) for ey in (0, 1) for ez in (0, 1)}
    return (float(dxi2), float(dyi2), float(dzi2)), classes


def ap_inv_3d(classes: dict, ex, ey, ez, dtype, device):
    """1/ap of the 3-D stencil from ``poisson_constants_3d``'s edge classes:
    ``ex``, ``ey``, ``ez`` are broadcastable masks of the cells on an x-, y-
    and z-edge."""
    c = {key: torch.full((), val, dtype=dtype, device=device) for key, val in classes.items()}
    return torch.where(
        ex,
        torch.where(ey, torch.where(ez, c[1, 1, 1], c[1, 1, 0]),
                    torch.where(ez, c[1, 0, 1], c[1, 0, 0])),
        torch.where(ey, torch.where(ez, c[0, 1, 1], c[0, 1, 0]),
                    torch.where(ez, c[0, 0, 1], c[0, 0, 0])),
    )


def poisson_coefficients(g: Grid2D, dtype, device):
    """Neumann-edge-zeroed coefficients (ae, aw, an, as, ap_inv), each
    broadcastable to the interior shape (nx, ny)."""
    dxi2 = float(np.float64(g.dxi) ** 2)
    dyi2 = float(np.float64(g.dyi) ** 2)
    i = torch.arange(g.nx, device=device)[:, None]
    j = torch.arange(g.ny, device=device)[None, :]

    def const(x):
        # a fill, not a host-to-device copy, so a CUDA graph can capture it
        return torch.full((), x, dtype=dtype, device=device)

    zero = const(0.0)
    ae = torch.where(i == g.nx - 1, zero, const(dxi2))
    aw = torch.where(i == 0, zero, const(dxi2))
    an = torch.where(j == g.ny - 1, zero, const(dyi2))
    a_s = torch.where(j == 0, zero, const(dyi2))
    c = poisson_diagonal_constants(g)
    ex = (i == 0) | (i == g.nx - 1)
    ey = (j == 0) | (j == g.ny - 1)
    ap_inv = torch.where(
        ex,
        torch.where(ey, const(c[1, 1]), const(c[1, 0])),
        torch.where(ey, const(c[0, 1]), const(c[0, 0])),
    )
    return ae, aw, an, a_s, ap_inv


def divergence_rhs(g: Grid2D, nm: Numerics, u_star, v_star, rho):
    """rhs = rho/dt * div(u*) on the interior, shape (nx, ny)."""
    ri = (1, g.nx + 1)
    rj = (1, g.ny + 1)
    return (
        win(rho, ri, rj)
        / nm.dt
        * (
            (win(u_star, ri, rj, 1, 0) - win(u_star, ri, rj)) * g.dxi
            + (win(v_star, ri, rj, 0, 1) - win(v_star, ri, rj)) * g.dyi
        )
    )


def jacobi_sweeps(g: Grid2D, n_iter: int, p, rhs):
    """n_iter out-of-place Jacobi updates of the interior of a copy of p;
    the ghosts keep p's values (they are read only through zero
    coefficients)."""
    ae, aw, an, a_s, ap_inv = poisson_coefficients(g, p.dtype, p.device)
    ri = (1, g.nx + 1)
    rj = (1, g.ny + 1)
    p = p.clone()
    for _ in range(n_iter):
        p_int = (
            rhs
            - ae * win(p, ri, rj, 1, 0)
            - aw * win(p, ri, rj, -1, 0)
            - an * win(p, ri, rj, 0, 1)
            - a_s * win(p, ri, rj, 0, -1)
        ) * ap_inv
        p[1:-1, 1:-1] = p_int
    return p


def solve_pressure(g: Grid2D, nm: Numerics, p, u_star, v_star, rho):
    """rhs assembly and the configured solver; returns a new p."""
    rhs = divergence_rhs(g, nm, u_star, v_star, rho)
    if nm.pressure_solver == "rbsor":
        return _rbsor(g, nm, p, rhs)
    if nm.pressure_solver == "mg":
        from .mg import mg_solve

        return mg_solve(p, rhs, (g.dxi**2, g.dyi**2), nm.sor_tol,
                        nm.sor_max_iter, tol_rel=nm.sor_tol_rel)
    if nm.pressure_solver != "jacobi":
        raise ValueError(
            f"unknown pressure_solver {nm.pressure_solver!r} "
            "(expected 'jacobi', 'rbsor' or 'mg'; resolve 'auto' first)")
    return jacobi_sweeps(g, nm.n_jacobi, p, rhs)


def residual(g: Grid2D, p, rhs, project_nullspace: bool = True):
    """max |A p - rhs| over the interior, as a 0-dim tensor. With
    ``project_nullspace`` the mean is removed first, so the measure sees
    only the part of the residual the pure-Neumann system can remove."""
    ae, aw, an, a_s, ap_inv = poisson_coefficients(g, p.dtype, p.device)
    ri = (1, g.nx + 1)
    rj = (1, g.ny + 1)
    ap = 1.0 / ap_inv
    r = (
        rhs
        - ae * win(p, ri, rj, 1, 0)
        - aw * win(p, ri, rj, -1, 0)
        - an * win(p, ri, rj, 0, 1)
        - a_s * win(p, ri, rj, 0, -1)
        - ap * win(p, ri, rj)
    )
    if project_nullspace:
        r = r - torch.mean(r)
    return torch.max(torch.abs(r))


#: A residual-driven solve also stops when STALL_ITERS iterations in a row
#: bring no new best residual while the residual sits within
#: PLATEAU_FACTOR of that best: the dtype's floor can lie above the
#: tolerance, and SOR near omega = 2 oscillates before it converges.
STALL_ITERS = 25
PLATEAU_FACTOR = 2.0


def effective_tol(tol: float, tol_rel: float, rhs_projected):
    """The stopping tolerance: ``tol``, raised to ``tol_rel * max|rhs'|``
    when ``tol_rel > 0``; ``rhs_projected`` is mean-free. A 0-dim tensor
    in the rhs's dtype, the type the solver compares the residual in."""
    if tol_rel and tol_rel > 0.0:
        return torch.maximum(_scalar(tol, rhs_projected),
                             tol_rel * torch.max(torch.abs(rhs_projected)))
    return _scalar(tol, rhs_projected)


def _scalar(x: float, like):
    return torch.full((), x, dtype=like.dtype, device=like.device)


def keep_iterating(it: int, max_iter: int, r: float, tol: float, best: float,
                   stall: int, stall_limit: int) -> bool:
    """The while-loop condition of both residual-driven solvers, on host
    floats that hold the dtype's values exactly (each comparison then
    agrees with the dtype's; 2 * best is exact)."""
    floored = stall >= stall_limit and r <= PLATEAU_FACTOR * best
    return it < max_iter and r > tol and not floored


def _rbsor(g: Grid2D, nm: Numerics, p, rhs):
    """Red-black SOR against the mean-free rhs, until max|Ap - rhs'| <=
    the tolerance, the iteration cap, or the stall exit."""
    rhs = rhs - torch.mean(rhs)
    tol = effective_tol(nm.sor_tol, nm.sor_tol_rel, rhs).item()
    ae, aw, an, a_s, ap_inv = poisson_coefficients(g, p.dtype, p.device)
    ri = (1, g.nx + 1)
    rj = (1, g.ny + 1)
    i = torch.arange(g.nx, device=p.device)[:, None]
    j = torch.arange(g.ny, device=p.device)[None, :]
    red = (i + j) % 2 == 0
    omega = nm.sor_omega

    def half_sweep(p, mask):
        gs = (
            rhs
            - ae * win(p, ri, rj, 1, 0)
            - aw * win(p, ri, rj, -1, 0)
            - an * win(p, ri, rj, 0, 1)
            - a_s * win(p, ri, rj, 0, -1)
        ) * ap_inv
        p_int = win(p, ri, rj)
        upd = p_int + omega * (gs - p_int)
        p = p.clone()
        p[1:-1, 1:-1] = torch.where(mask, upd, p_int)
        return p

    r = best = residual(g, p, rhs).item()
    it = stall = 0
    while keep_iterating(it, nm.sor_max_iter, r, tol, best, stall, STALL_ITERS):
        p = half_sweep(p, red)
        p = half_sweep(p, ~red)
        r = residual(g, p, rhs).item()
        stall = 0 if r < best else stall + 1
        best = min(best, r)
        it += 1
    return p
