"""Per-frame metrics, guards and log lines (counterpart of
tpuvof/metrics.py).

Liquid mass, max velocities, CFL numbers, the divergence the fixed Jacobi
solve leaves behind, and a finiteness guard, as 0-dim tensors on the
state's device (reading them synchronises with the device); the startup
banner and the per-frame line the CLI prints.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .config import SimConfig
from .state import State
from .utils.profiling import span

__all__ = ["Metrics", "compute_metrics", "banner", "format_frame"]


class Metrics(NamedTuple):
    mass: torch.Tensor  # sum of F over the interior (liquid volume / dx*dy)
    max_u: torch.Tensor
    max_v: torch.Tensor
    cfl_u: torch.Tensor  # max |u|*dt/dx; the reference warns when > 0.25
    cfl_v: torch.Tensor
    max_div: torch.Tensor  # max |div(u)| after the projection
    finite: torch.Tensor  # all fields finite?


def compute_metrics(cfg: SimConfig, state: State) -> Metrics:
    with span("tv.metrics"):
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


def banner(cfg: SimConfig) -> str:
    """Startup banner with the reference's derived ratios (2dvof.py:95-98);
    lines 2-4 are tpuvof's character for character."""
    g, fl, nm = cfg.grid, cfg.fluid, cfg.num
    return (
        f">>> The PyTorch + CUDA port of tpuvof (tpuvof_torch).\n"
        f">>> Grid resolution: {g.nx} x {g.ny}, dt = {nm.dt:4.2e}\n"
        f">>> Density ratio: {fl.rho_l / fl.rho_g: 4.2f}, gravity: {fl.gy: 4.2f}, "
        f"sigma: {fl.sigma: 4.2f}\n"
        f">>> Viscosity ratio: {fl.nu_l / fl.nu_g: 4.2f}"
    )


def format_frame(istep: int, dt: float, m: Metrics, mode_name: str) -> str:
    """Per-frame log line (superset of the reference's 2dvof.py:533), as
    tpuvof's; the metrics reach the host in one copy."""
    with span("tv.host_read"):
        mass, max_u, max_v, cfl_u, cfl_v, max_div, finite = torch.stack(
            [torch.as_tensor(x, dtype=torch.float64) for x in m]).tolist()
    warn = " [CFL>0.25!]" if cfl_u > 0.25 or cfl_v > 0.25 else ""
    nan = "" if finite else " [NON-FINITE!]"
    return (
        f">>> Number of steps:{istep:<5d}, Time:{istep * dt:5.2e} sec. "
        f"Displaying {mode_name}. mass={mass:.4f} "
        f"max|u|={max_u:.3e} max|v|={max_v:.3e} "
        f"CFL=({cfl_u:.3f},{cfl_v:.3f}) "
        f"div={max_div:.3e}{warn}{nan}"
    )
