"""L3 driver: the host-clock span from the solver call to the fence after it,
over the frame's steps, for the measured window's frames (outside the
profiler's sub-window)."""
from __future__ import annotations


def read(run):
    steps = sum(s.steps for s in run.spans)
    if steps <= 0:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in run.spans) / steps
