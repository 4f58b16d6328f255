"""Simulation configuration (counterpart of tpuvof/config.py:28-145).

Frozen dataclasses, as in tpuvof. ``Numerics`` carries the fields the
2-D step reads: the pressure-solver ladder's settings, the FCT test
variant's mirror between sweeps, and the pressure adjoint of the
differentiable path (``diff``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from .grid import Grid2D

__all__ = [
    "Fluid",
    "FCTVariant",
    "Numerics",
    "SimConfig",
    "FCT_FORWARD",
    "FCT_DIFF",
    "FCT_SCHEME_TEST",
    "dam_break_2d",
]


@dataclass(frozen=True)
class Fluid:
    """Two-phase fluid properties."""

    rho_l: float = 1000.0
    rho_g: float = 50.0
    nu_l: float = 1.0e-6  # kinematic viscosity of the liquid
    nu_g: float = 1.5e-5
    sigma: float = 0.007  # surface tension coefficient
    gx: float = 0.0
    gy: float = -5.0
    gz: float = 0.0


@dataclass(frozen=True)
class FCTVariant:
    """Flux-corrected-transport behavioural variant.

    - ``full_dv``: apply the divergence compensation dV/dv to (F + flux)
      (main solver) or to the flux term only (diff/test variants).
    - ``clamp``: clamp Ftd and the corrected F to [0, 1] inside the sweep.
    - ``guard_eps``: the limiter fires only where pp > guard_eps.
    - ``denom_eps``: added to the limiter denominator, qp / (pp + denom_eps).
    """

    full_dv: bool = True
    clamp: bool = True
    guard_eps: float = 0.0
    denom_eps: float = 0.0


FCT_FORWARD = FCTVariant(full_dv=True, clamp=True, guard_eps=0.0, denom_eps=0.0)
FCT_DIFF = FCTVariant(full_dv=False, clamp=False, guard_eps=1e-6, denom_eps=0.0)
FCT_SCHEME_TEST = FCTVariant(full_dv=False, clamp=False, guard_eps=0.0, denom_eps=1e-4)


@dataclass(frozen=True)
class Numerics:
    """Time stepping and solver controls."""

    dt: float = 4e-6
    n_jacobi: int = 10  # fixed iteration count, no residual check
    fct: FCTVariant = field(default_factory=FCTVariant)
    # mirror F ghosts between the two half sweeps (the FCT test variant);
    # the main solver does not
    bc_between_sweeps: bool = False
    # how autograd crosses the pressure solve: 'unrolled' differentiates
    # through the Jacobi sweeps; 'selfadjoint' runs the hand-written
    # adjoints of ops/poisson.py and ops/mg.py (the same truncated Jacobi
    # on the cotangent; one more converged rbsor/mg solve)
    pressure_adjoint: str = "unrolled"
    # 'torch' = plain torch ops (tpuvof's 'xla'); 'cuda' = the hand-written
    # phase kernels of tpuvof_torch/csrc (tpuvof's 'pallas'); 'cuda_mono' =
    # the whole-step kernel on the whole grid ('pallas_mono'); 'cuda_tiled'
    # = the whole-step kernel tile by tile ('pallas_tiled'); 'cuda_strips' =
    # the whole-step kernel on a padded resident layout ('pallas_strips').
    # Every 'cuda*' backend with a residual-driven solver runs the hybrid
    # step: phase kernels around the plain solve.
    backend: str = "cuda"
    # 'jacobi' = the reference's fixed n_jacobi sweeps; 'rbsor' = red-black
    # SOR to a residual tolerance; 'mg' = residual-driven multigrid
    # V-cycles (ops/mg.py); 'auto' = mg wherever the grid coarsens, else
    # rbsor (solver.resolve_auto). sor_tol/sor_max_iter govern both
    # residual-driven solvers (max_iter counts V-cycles under 'mg');
    # sor_omega is rbsor's; sor_tol_rel > 0 raises each solve's tolerance
    # to sor_tol_rel * max|rhs'| (ops.poisson.effective_tol).
    pressure_solver: str = "jacobi"
    sor_omega: float = 1.7
    sor_tol: float = 1e-3
    sor_max_iter: int = 200
    sor_tol_rel: float = 0.0


@dataclass(frozen=True)
class SimConfig:
    """Full static simulation configuration."""

    grid: Grid2D = field(default_factory=lambda: Grid2D(200, 200))
    fluid: Fluid = field(default_factory=Fluid)
    num: Numerics = field(default_factory=Numerics)

    def __post_init__(self):
        self.grid.validate()

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


def dam_break_2d(n: int = 200, **kw) -> SimConfig:
    """The reference's default 2-D workload."""
    return SimConfig(grid=Grid2D(n, n), **kw)
