"""The program's own spans in the traced sub-window.

tpuvof_torch records its spans (``tv.simulate``, ``tv.bc``, ``tv.cfl``,
``tv.wrap.<kernel>``, ``tv.launch.<kernel>``, ``tv.metrics``,
``tv.host_read``, ``tv.render``; tpuvof_torch/utils/profiling.py) as
``cpu_op`` events of the running profiler, so they come with the trace's
other host operators (``TraceData.cpu_ops``), on the clock of its device
events. A span's self time is its duration less the durations of its
direct ``tv.`` children: the spans it holds with no other ``tv.`` span
between. A program without these spans has no ``tv.simulate`` span.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["ProgramSpan", "program_spans", "per_step_us"]

PREFIX = "tv."
#: Microseconds by which a child's rounded end may pass its parent's.
_SLACK_US = 0.01


@dataclass
class ProgramSpan:
    name: str
    ts: float
    dur: float
    self_us: float


def _holds(outer: ProgramSpan, inner: ProgramSpan) -> bool:
    return (inner.ts >= outer.ts - _SLACK_US
            and inner.ts + inner.dur <= outer.ts + outer.dur + _SLACK_US)


def program_spans(run) -> list[ProgramSpan] | None:
    """The ``tv.`` spans of the run's trace with their self times, in
    order of start (a holder before what it holds); None without a trace
    or without a ``tv.simulate`` span."""
    tr = run.trace
    if tr is None:
        return None
    spans = sorted((ProgramSpan(n, ts, dur, dur) for n, ts, dur in tr.cpu_ops
                    if n.startswith(PREFIX)), key=lambda s: (s.ts, -s.dur))
    if not any(s.name == "tv.simulate" for s in spans):
        return None
    open_: list[ProgramSpan] = []
    for s in spans:
        while open_ and not _holds(open_[-1], s):
            open_.pop()
        if open_:
            open_[-1].self_us -= s.dur
        open_.append(s)
    return spans


def per_step_us(run, pick, self_time: bool = True) -> float | None:
    """Microseconds a traced step of the spans whose name ``pick``
    accepts: their self times, or with ``self_time=False`` their whole
    durations."""
    spans = program_spans(run)
    if spans is None or run.trace.steps <= 0:
        return None
    total = sum(s.self_us if self_time else s.dur for s in spans if pick(s.name))
    return total / run.trace.steps
