"""tpuvof_torch: the PyTorch + CUDA port of tpuvof for NVIDIA Hopper.

The 2-D and 3-D forward steps of the two-phase Navier-Stokes/VOF solver:
staggered MAC grid, Youngs normals with Brackbill CSF surface tension
(opt-in in 3-D), Chorin projection with the reference's fixed-iteration
Jacobi, Rudman/Zalesak flux-corrected VOF transport, and the
pressure-solver ladder (fixed Jacobi, red-black SOR, multigrid), the
2-D and 3-D domain decompositions over a device mesh with the mesh planner
(``parallel``), and the
differentiable F0 optimisation (``diff``) with the advection cases
(``models.advection``), and the app layer: the command line
(``python -m tpuvof_torch``, ``cli``), frames (``viz``), PNG/GIF/VTK output
and checkpoints (``io_utils``), the live and paint windows (``live``,
``paint``) and tracing (``utils``).
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
from . import cli, diff, io_utils, live, paint, utils, viz
from .grid import Grid2D, Grid3D
from .metrics import Metrics, banner, compute_metrics, format_frame
from .parallel import (Decomp, Decomp3D, HaloSpec, MeshPlan, admission_2d, admission_3d,
                       exchange, format_plans, make_mesh, plan_mesh_2d, plan_mesh_3d)
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
    "cli",
    "diff",
    "io_utils",
    "live",
    "paint",
    "utils",
    "viz",
    "Grid2D",
    "Grid3D",
    "Metrics",
    "banner",
    "compute_metrics",
    "format_frame",
    "Decomp",
    "Decomp3D",
    "HaloSpec",
    "MeshPlan",
    "admission_2d",
    "admission_3d",
    "exchange",
    "format_plans",
    "make_mesh",
    "plan_mesh_2d",
    "plan_mesh_3d",
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
