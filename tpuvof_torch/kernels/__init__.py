"""Hand-written CUDA kernels of the step, their wrappers and plain versions."""
from .step_kernels import (
    LAUNCHES,
    fct_sweep,
    fct_sweep_plain,
    predict,
    predict_plain,
    project,
    project_plain,
    reset_launch_counts,
)

__all__ = [
    "LAUNCHES",
    "fct_sweep",
    "fct_sweep_plain",
    "predict",
    "predict_plain",
    "project",
    "project_plain",
    "reset_launch_counts",
]
