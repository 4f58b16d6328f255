"""L1 kernels (csrc/*.cu): the least time of the traced sub-window's steps
of the whole grid (portbench/roofline.py: the ghosted grid's fields read
and written once, the step's operations on its interior cells) at the
peaks of the mesh's cards together, over the device time of the kernels
launched inside the solver's calls, summed over the cards and shared
among them: least_time / cards over kernel time / cards. None for a route
without a mesh."""
from __future__ import annotations

from portbench.roofline import least_time


def read(run):
    tr = run.trace
    route = run.route
    if tr is None or tr.steps <= 0 or not getattr(route, "cards", None):
        return None
    busy = sum(dur for _, _, dur in tr.solver_kernels()) * 1e-6
    bound = least_time(run.device_kind, tuple(route.shape), route.cells, route.dtype,
                       route.n_jacobi, tr.steps)
    if bound is None or busy <= 0:
        return None
    run.extra["shard_roofline_bound_by"] = bound[1]
    return 100.0 * (bound[0] / route.cards) / (busy / route.cards)
