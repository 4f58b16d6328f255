"""L3 driver: the host time of the program's halo refreshes (its
``tv.halo`` spans, Decomp3D's in-place refresh of every block's halo
planes), whole, over the traced sub-window's steps, in microseconds a
step. None where the program records no such span."""
from __future__ import annotations

from portbench.program_spans import program_spans, per_step_us


def read(run):
    spans = program_spans(run)
    if spans is None or not any(s.name == "tv.halo" for s in spans):
        return None
    return per_step_us(run, lambda name: name == "tv.halo", self_time=False)
