"""Chorin pressure projection with the fixed-iteration Jacobi solve
(counterpart of tpuvof/ops/poisson.py:38-109, 148-174).

A 5-point stencil whose edge coefficients are zeroed on the pure-Neumann
walls, iterated a fixed number of times with no residual check. The
residual-driven solvers (rbsor, mg) and the self-adjoint backward arrive
with ROADMAP Queue 1 items 5 and 6.
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
    "divergence_rhs",
    "jacobi_sweeps",
    "solve_pressure",
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
    """rhs assembly and the fixed Jacobi iteration; returns a new p."""
    if nm.pressure_solver != "jacobi":
        raise NotImplementedError(
            f"pressure_solver={nm.pressure_solver!r} is not ported yet "
            "(ROADMAP Queue 1 item 5); only 'jacobi' runs")
    rhs = divergence_rhs(g, nm, u_star, v_star, rho)
    return jacobi_sweeps(g, nm.n_jacobi, p, rhs)
