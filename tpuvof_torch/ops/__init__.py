"""Plain-torch stencil ops of the 2-D and 3-D steps (counterpart of tpuvof.ops)."""
from .bc import apply_bc, apply_bc_, apply_bc_3d, apply_bc_3d_, mirror_scalar
from .common import clamp01, win
from .fct import fct_sweep_x, fct_sweep_y, rudman_advect
from .materials import mix_properties
from .momentum import predict_velocity, update_velocity
from .normals import young_normals_curvature
from .poisson import divergence_rhs, poisson_coefficients, solve_pressure

__all__ = [
    "apply_bc",
    "apply_bc_",
    "apply_bc_3d",
    "apply_bc_3d_",
    "mirror_scalar",
    "clamp01",
    "win",
    "fct_sweep_x",
    "fct_sweep_y",
    "rudman_advect",
    "mix_properties",
    "predict_velocity",
    "update_velocity",
    "young_normals_curvature",
    "divergence_rhs",
    "poisson_coefficients",
    "solve_pressure",
]
