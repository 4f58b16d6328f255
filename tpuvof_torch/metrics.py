"""Per-frame metrics and guards (counterpart of tpuvof/metrics.py:24-55).

Liquid mass, max velocities, CFL numbers, the divergence the fixed Jacobi
solve leaves behind, and a finiteness guard, as 0-dim tensors on the
state's device (reading them synchronises with the device).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .config import SimConfig
from .state import State

__all__ = ["Metrics", "compute_metrics"]


class Metrics(NamedTuple):
    mass: torch.Tensor  # sum of F over the interior (liquid volume / dx*dy)
    max_u: torch.Tensor
    max_v: torch.Tensor
    cfl_u: torch.Tensor  # max |u|*dt/dx; the reference warns when > 0.25
    cfl_v: torch.Tensor
    max_div: torch.Tensor  # max |div(u)| after the projection
    finite: torch.Tensor  # all fields finite?


def compute_metrics(cfg: SimConfig, state: State) -> Metrics:
    g, nm = cfg.grid, cfg.num
    F, u, v, p = state
    max_u = u.abs().max()
    max_v = v.abs().max()
    div = (u[2:, 1:-1] - u[1:-1, 1:-1]) * g.dxi + (v[1:-1, 2:] - v[1:-1, 1:-1]) * g.dyi
    finite = (
        torch.isfinite(F).all()
        & torch.isfinite(u).all()
        & torch.isfinite(v).all()
        & torch.isfinite(p).all()
    )
    return Metrics(
        mass=F[1:-1, 1:-1].sum(),
        max_u=max_u,
        max_v=max_v,
        cfl_u=max_u * nm.dt * g.dxi,
        cfl_v=max_v * nm.dt * g.dyi,
        max_div=div.abs().max(),
        finite=finite,
    )
