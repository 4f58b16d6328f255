"""L1 kernels, host side: the whole time of the program's ``tv.launch.*``
spans (the foreign call into the kernel library: its C entry's host code
and its launches) over the traced sub-window's steps, in microseconds a
step."""
from __future__ import annotations

from portbench.program_spans import per_step_us


def read(run):
    return per_step_us(run, lambda name: name.startswith("tv.launch."), self_time=False)
