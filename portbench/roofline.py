"""The yardstick of ``kernels_roofline``: the card's published peaks and
the least work of one time step, counted from the equations and the
grid's shape and dtype, whatever kernels carry the step.

Bytes: each state field (2-D F, u, v, p; 3-D F, u, v, w, p) read once at
the step's entry and written once at its exit, over the whole ghosted
array. Operations: the arithmetic of one step per interior cell, as the
equations state it, counting each add, subtract, multiply, divide, square
root, minimum, maximum, absolute value and comparison once; constants
folded; a quantity shared by neighbouring cells (a corner gradient of F)
counted once. The least time is the larger of bytes over the memory rate
and operations over the arithmetic rate of the dtype.
"""
from __future__ import annotations

__all__ = ["PEAKS", "STEP_OPS_2D", "STEP_OPS_3D", "step_ops", "step_bytes", "least_time"]

#: Published peaks (NVIDIA H100 SXM data sheet; dense, no tensor cores for
#: f32/f64 elementwise work; at the card's 700 W limit), keyed by the name
#: torch.cuda.get_device_name() gives.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "float32": 67e12, "float64": 34e12},
}

#: Operations per interior cell of the 2-D step; "jacobi" is per sweep.
STEP_OPS_2D = {
    "mix": 10,          # clamp 2; rho and nu 4 each
    "normals": 26,      # corner gradient 8 (once per node), two sums 8, guard 4, norm 6
    "curvature": 6,     # two differences, two scalings, sum, negation
    "predict": 82,      # per component 41: neighbour mean 4, two upwind derivatives 6,
                        # surface force 9, two Laplacian terms 10, advection 4, gravity 1,
                        # sum and update 7
    "rhs": 6,           # two differences, two scalings, sum, rho/dt
    "jacobi": 9,        # four products, four subtractions, the diagonal
    "correct": 14,      # per component 7: mean density 2, gradient 1, dt/rho 1, two
                        # products, subtraction
    "sweeps": 100,      # two FCT sweeps of 50: fluxes 7, donor value 9, limiter 26,
                        # correction 8
    "clamp": 2,
}

#: Operations per interior cell of the 3-D step (surface tension off).
STEP_OPS_3D = {
    "mix": 10,
    "predict": 123,     # per component 41: two neighbour means 8, three upwind
                        # derivatives 9, three Laplacian terms 15, advection 6, gravity 1,
                        # update 2
    "rhs": 9,
    "jacobi": 13,       # six products, six subtractions, the diagonal
    "correct": 21,      # three components of 7
    "sweeps": 144,      # three FCT sweeps of 48 (each clamps)
}

_ITEMSIZE = {"float32": 4, "float64": 8}


def step_ops(dims: int, n_jacobi: int) -> int:
    """Operations per interior cell of one step."""
    table = STEP_OPS_2D if dims == 2 else STEP_OPS_3D
    return sum(v for k, v in table.items() if k != "jacobi") + n_jacobi * table["jacobi"]


def step_bytes(shape: tuple, dtype: str) -> int:
    """Compulsory bytes of one step: every state field of the ghosted
    ``shape`` read once and written once."""
    n_fields = len(shape) + 2  # F, the velocity components, p
    cells = 1
    for n in shape:
        cells *= n
    return 2 * n_fields * cells * _ITEMSIZE[dtype]


def least_time(device_kind: str | None, shape: tuple, interior_cells: int, dtype: str,
               n_jacobi: int, steps: int) -> tuple[float, str] | None:
    """(seconds, 'bytes' or 'operations') of ``steps`` steps at the card's
    peaks; None for a card without published peaks here."""
    peak = PEAKS.get(device_kind or "")
    if peak is None:
        return None
    t_bytes = steps * step_bytes(shape, dtype) / peak["bytes_per_s"]
    t_ops = steps * interior_cells * step_ops(len(shape), n_jacobi) / peak[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
