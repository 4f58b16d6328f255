"""L1 kernels: the least time of the traced sub-window's steps (the step's
work from the grid's shape and dtype, portbench/roofline.py) over the
device time of the kernels launched inside the solver's calls."""
from __future__ import annotations

from portbench.roofline import least_time


def read(run):
    tr = run.trace
    if tr is None or tr.steps <= 0:
        return None
    busy = sum(dur for _, _, dur in tr.solver_kernels()) * 1e-6
    route = run.route
    bound = least_time(run.device_kind, tuple(route.shape), route.cells, route.dtype,
                       route.n_jacobi, tr.steps)
    if bound is None or busy <= 0:
        return None
    run.extra["roofline_bound_by"] = bound[1]
    return 100.0 * bound[0] / busy
