"""L2 wrappers and glue: device kernels launched inside the solver's calls in
the traced sub-window, per step (the kernels' own launches and the plain
ops between them)."""
from __future__ import annotations


def read(run):
    tr = run.trace
    if tr is None or tr.steps <= 0:
        return None
    kernels = tr.solver_kernels()
    if not kernels:
        return None
    return len(kernels) / tr.steps
