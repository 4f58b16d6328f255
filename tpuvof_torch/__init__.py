"""tpuvof_torch: the PyTorch + CUDA port of tpuvof for NVIDIA Hopper.

The 2-D and 3-D forward steps of the two-phase Navier-Stokes/VOF solver:
staggered MAC grid, Youngs normals with Brackbill CSF surface tension
(opt-in in 3-D), Chorin projection with the reference's fixed-iteration
Jacobi, Rudman/Zalesak flux-corrected VOF transport, and the
pressure-solver ladder (fixed Jacobi, red-black SOR, multigrid), the
3-D domain decomposition over a device mesh (``parallel``), and the
differentiable F0 optimisation (``diff``) with the advection cases
(``models.advection``).
``backend='torch'`` runs plain torch ops; the ``'cuda*'`` backends run the
hand-written kernels of ``csrc/`` (see ``solver`` and ``solver3d``).

tpuvof (JAX) stays the reference: module names mirror it, so each
counterpart is found by path. This package never imports jax.
"""
from .config import (
    FCT_DIFF,
    FCT_FORWARD,
    FCT_SCHEME_TEST,
    FCTVariant,
    Fluid,
    Numerics,
    SimConfig,
    dam_break_2d,
)
from . import diff
from .grid import Grid2D, Grid3D
from .metrics import Metrics, compute_metrics
from .parallel import Decomp3D, admission_3d, make_mesh
from .solver import make_step_fn, simulate, simulate_cfl, step, step_pair
from .solver3d import simulate_3d, step_3d
from .state import State, State3D, find_area, init_state, init_state_3d, initial_volume_fraction

__all__ = [
    "FCT_DIFF",
    "FCT_FORWARD",
    "FCT_SCHEME_TEST",
    "FCTVariant",
    "Fluid",
    "Numerics",
    "SimConfig",
    "dam_break_2d",
    "diff",
    "Grid2D",
    "Grid3D",
    "Metrics",
    "compute_metrics",
    "Decomp3D",
    "admission_3d",
    "make_mesh",
    "simulate",
    "simulate_cfl",
    "make_step_fn",
    "step",
    "step_pair",
    "step_3d",
    "simulate_3d",
    "State",
    "State3D",
    "find_area",
    "init_state",
    "init_state_3d",
    "initial_volume_fraction",
]
