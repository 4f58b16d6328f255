"""L2 wrappers and glue: the self time of the program's ``tv.wrap.*``
spans (the CUDA wrappers' checks, ``load_library``, allocations,
constants and ctypes arrays, without their foreign calls), ``tv.bc`` (the
plain-torch BC passes) and ``tv.cfl`` (the Courant tracker's ops) over the
traced sub-window's steps, in microseconds a step."""
from __future__ import annotations

from portbench.program_spans import per_step_us


def read(run):
    return per_step_us(run, lambda name: name.startswith("tv.wrap.")
                       or name in ("tv.bc", "tv.cfl"))
