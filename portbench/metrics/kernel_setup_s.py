"""L1 kernels, set-up: the program's counters of its kernel library, read
after the run: the seconds of the first ``load_library()`` call (the
sources' digest, a build where this process made the library, its
loading and binding) plus the host seconds of each kernel entry's first
launch (``FIRST_LAUNCH_S``: a module's load under CUDA's lazy loading).
Puts ``kernel_library_built`` in the run's notes. Nothing without the
program's spans in the trace or without the counters."""
from __future__ import annotations

from portbench.program_spans import program_spans


def read(run):
    if program_spans(run) is None:
        return None
    from tpuvof_torch.kernels import build, step_kernels

    built = getattr(build, "library_built", None)
    first = getattr(step_kernels, "FIRST_LAUNCH_S", None)
    load_s = build.build_seconds()
    if built is None or first is None or load_s is None:
        return None
    run.extra["kernel_library_built"] = built()
    return load_s + sum(first.values())
