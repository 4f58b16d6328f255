"""The traced sub-window: a few whole frames under torch.profiler, after the
measured window, read back from its Chrome trace.

The harness marks its own spans with ``record_function``:
``portbench.window`` around the sub-window, and in each frame
``portbench.job_init`` (a new job's initial state), ``portbench.solver``
(the solver call and the fence after it) and ``portbench.frame_host`` (the
frame's host work). A device event belongs to the solver's calls where it
starts inside a solver span: the fence closes the span only once every
kernel the call queued has run, and the frame's host work queues nothing
before it.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import torch

__all__ = ["TraceData", "traced_frames", "parse"]

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class TraceData:
    """Events of the sub-window, in microseconds on the trace's clock."""

    window: tuple[float, float]
    device: list = field(default_factory=list)   # (cat, name, ts, dur)
    spans: list = field(default_factory=list)    # (name, ts, dur)
    cpu_ops: list = field(default_factory=list)  # (name, ts, dur)
    steps: int = 0

    @property
    def window_s(self) -> float:
        return self.window[1] * 1e-6

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device's busy intervals inside the window."""
        w0, w1 = self.window[0], self.window[0] + self.window[1]
        ivs = sorted((max(ts, w0), min(ts + dur, w1)) for _, _, ts, dur in self.device
                     if ts + dur > w0 and ts < w1)
        merged: list[list[float]] = []
        for a, b in ivs:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def solver_kernels(self) -> list:
        """Device kernels that start inside a solver span."""
        solver = [(ts, ts + dur) for name, ts, dur in self.spans if name == "portbench.solver"]
        out = []
        for cat, name, ts, dur in self.device:
            if cat == "kernel" and any(a <= ts <= b for a, b in solver):
                out.append((name, ts, dur))
        return out

    def _host_at(self, t: float) -> str:
        """The harness span and the innermost operator the host was in."""
        span = next((n for n, ts, dur in self.spans
                     if n != "portbench.window" and ts <= t <= ts + dur), "portbench.loop")
        inner = None
        for name, ts, dur in self.cpu_ops:
            if ts <= t <= ts + dur and (inner is None or dur < inner[1]):
                inner = (name, dur)
        label = span.removeprefix("portbench.")
        return f"{label}/{inner[0]}" if inner else label

    def breakdown(self) -> dict:
        """The ten device operations with the most time, and the ten longest
        idle gaps named by what the host was doing, in seconds."""
        by_name: dict[str, float] = {}
        for _, name, _, dur in self.device:
            key = name if len(name) <= 120 else name[:117] + "..."
            by_name[key] = by_name.get(key, 0.0) + dur * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        w0, w1 = self.window[0], self.window[0] + self.window[1]
        gaps, t = [], w0
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if w1 > t:
            gaps.append((t, w1))
        gaps.sort(key=lambda g: g[0] - g[1])
        idle = [[self._host_at(0.5 * (a + b)), (b - a) * 1e-6] for a, b in gaps[:10]]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": idle}


def parse(events: list, steps: int) -> TraceData | None:
    """The sub-window's events from a Chrome trace's ``traceEvents``; None
    when the trace has no window span."""
    win = None
    device, spans, cpu_ops = [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        if cat in _DEVICE_CATS:
            device.append((cat, name, ts, dur))
        elif cat == "user_annotation" and name.startswith("portbench."):
            if name == "portbench.window":
                win = (ts, dur)
            else:
                spans.append((name, ts, dur))
        elif cat == "cpu_op":
            cpu_ops.append((name, ts, dur))
    if win is None:
        return None
    return TraceData(window=win, device=device, spans=spans, cpu_ops=cpu_ops, steps=steps)


def traced_frames(loop, n_frames: int, outdir) -> TraceData | None:
    """Run ``n_frames`` more frames of the loop under the profiler (CPU and
    CUDA activity) and read its trace. The frames are not the window's."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if loop.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    steps = 0
    with profile(activities=activities) as prof:
        with record_function("portbench.window"):
            for _ in range(n_frames):
                steps += loop.one_frame(span=record_function, keep=False).steps
    path = os.path.join(str(outdir), "trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    if loop.device.type == "cuda":
        torch.cuda.synchronize(loop.device)
    return parse(events, steps)
