"""L3 driver: the self time of the program's ``tv.simulate`` spans (its
Python step loop, the route's choice, ``step``'s dispatch; not the BC
passes, wrappers or launches inside it) over the traced sub-window's
steps, in microseconds a step."""
from __future__ import annotations

from portbench.program_spans import per_step_us


def read(run):
    return per_step_us(run, lambda name: name == "tv.simulate")
