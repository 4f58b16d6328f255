"""The job loop of the port's benchmark, its spans and its check.

A cell is one entry of ``workloads`` in BENCHMARK.json: a configuration
(``configs/<name>.json``) under a traffic mix (``traffic/<name>.json``).
Everything about a cell is found by name:

  configs/<config>.json      the sizes, the fluid, the dam and its seeded shifts
  cases/<case>.py            makes a job's initial state on the device
  traffic/<traffic>.json     route, backend, job length, frame cadence, frame work
  routes/<route>.py          the solver call of the window, and its reference
  frames/<kind>.py           the frame's host work, and how its output is judged
  limits/<workload>.json     the limit of each number the check compares
  metrics/<metric>.py        a per-layer metric's reader

The loop is closed: jobs run back to back for the whole window. A job is
``steps`` steps from a fresh initial state, cut into frames of
``frame_every`` steps; each frame is the solver call, a fence, and the
frame's host work, which ends in a host read. Frames carry the global
step index, so the sweep parity follows the source's counter.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import random
import re
import shutil
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

__all__ = ["Cell", "load_cell", "Loop", "Sample", "check", "compare_states", "on_device", "run_cell"]

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` under the benchmark's folder."""
    if not _NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = BENCH / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    mod_name = f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload of the manifest with its files read."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    chips: int


def _for_cell(metrics: list, cell: str, known: set) -> list:
    """The metrics that a cell reports: those whose ``workloads`` name it,
    and those without the key whose end-to-end metric the cell reports."""
    out = []
    for m in metrics:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif "moves" not in m or m["moves"] in known:
            out.append(m)
    return out


def load_cell(workload: str, manifest: dict | None = None) -> Cell:
    manifest = manifest or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    traffic = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
    limits = load_json(BENCH / "limits" / f"{workload}.json")
    e2e = _for_cell(manifest["end_to_end"], workload, set())
    known = {m["name"] for m in e2e}
    return Cell(name=workload, config=config, traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=_for_cell(manifest["per_layer"], workload, known), chips=w["chips"])


# ----------------------------------------------------------------------
# the loop
# ----------------------------------------------------------------------
@dataclass
class Sample:
    """A frame kept for the check: its input and output state, the solver's
    report and what the frame's host work produced."""

    job: int
    frame: int
    istep0: int
    steps: int
    inp: tuple
    out: tuple
    report: dict | None
    outputs: dict


@dataclass
class FrameSpan:
    """Host-clock seconds of one frame: t0 solver call, t1 after the fence
    that follows it, t2 after the frame's host work."""

    job: int
    frame: int
    steps: int
    t0: float
    t1: float
    t2: float


def _fence(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _no_span(_name):
    return contextlib.nullcontext()


def sample_plan(rng: random.Random, n_check: int, frames_per_job: int,
                start_frames: int = 1) -> dict:
    """The frames kept for the check, {job: {frame}}, one per job of the
    first ``n_check`` jobs: job 0's first frame (from the harness's own
    initial state), job 1's last (the most developed flow), the others'
    drawn from the seed among the frames after the job's first
    ``start_frames``."""
    plan = {}
    for job in range(n_check):
        if job == 0:
            plan[job] = {0}
        elif job == 1:
            plan[job] = {frames_per_job - 1}
        else:
            plan[job] = {rng.randrange(min(start_frames, frames_per_job - 1), frames_per_job)}
    return plan


def make_route(cell: Cell, device):
    """The cell's route: its solver call on ``device``."""
    return load_module("routes", cell.traffic["route"]).Route(cell.config, cell.traffic, device)


class Loop:
    """The closed job loop of one cell on one device."""

    def __init__(self, cell: Cell, seed: int, device, outdir: Path, route=None):
        self.cell = cell
        self.device = torch.device(device)
        tr = cell.traffic
        self.steps = int(tr["steps"])
        self.frame_every = int(tr["frame_every"])
        self.frames_per_job = -(-self.steps // self.frame_every)
        rng = random.Random(seed)
        self.case = load_module("cases", cell.config["case"])
        self.jobs = self.case.job_order(cell.config, rng)
        self.start_frames = int(tr["start_frames"])
        self.plan = sample_plan(rng, int(tr["check_frames"]), self.frames_per_job,
                                self.start_frames)
        self.route = route or make_route(cell, self.device)
        self.frames = [load_module("frames", k).Frame(self.route, tr, outdir)
                       for k in tr["frame_work"]]
        self.job = 0
        self.frame = 0
        self.state = None
        self.spans: list[FrameSpan] = []
        self.samples: list[Sample] = []
        self.steps_done = 0
        self.error: str | None = None

    def _start_job(self):
        self.state = self.case.initial_state(self.cell.config, self.jobs[self.job % len(self.jobs)],
                                             self.device)
        _fence(self.device)

    def one_frame(self, span=_no_span, keep: bool = True) -> FrameSpan:
        """Run the next frame; starts the next job first where one ended."""
        if self.frame == 0:
            with span("portbench.job_init"):
                self._start_job()
        istep0 = self.frame * self.frame_every
        n = min(self.frame_every, self.steps - istep0)
        kept = keep and self.frame in self.plan.get(self.job, ())
        # a kept frame's states wait on the host: the device holds only the run's own
        inp = tuple(a.cpu() for a in self.state) if kept else None
        t0 = time.perf_counter()
        with span("portbench.solver"):
            state, report = self.route.advance(self.state, n, istep0)
            _fence(self.device)
        t1 = time.perf_counter()
        with span("portbench.frame_host"):
            outputs = {f.name: f.run(state, istep0 + n, self.job * self.frames_per_job + self.frame)
                       for f in self.frames}
        t2 = time.perf_counter()
        self.state = tuple(state)
        rec = FrameSpan(self.job, self.frame, n, t0, t1, t2)
        if kept:
            self.samples.append(Sample(self.job, self.frame, istep0, n, inp,
                                       tuple(a.cpu() for a in state), report, outputs))
        self.frame += 1
        if self.frame == self.frames_per_job:
            self.job += 1
            self.frame = 0
        return rec

    def close(self):
        for f in self.frames:
            if hasattr(f, "close"):
                f.close()

    def warm_up(self):
        """One whole frame of every kind of work the window does, then a
        fresh start; nothing of it is kept."""
        self.one_frame(keep=False)
        _fence(self.device)
        self.job, self.frame = 0, 0

    def window(self, seconds: float, until_samples: bool = False) -> float:
        """Frames back to back until ``seconds`` have passed (the frame in
        flight finishes), or, with ``until_samples``, until every frame of
        the check's plan has been taken. Returns the window's seconds."""
        t_start = time.perf_counter()
        while True:
            try:
                rec = self.one_frame()
            except Exception:  # a frame that fails ends the window; the run is not correct
                self.error = traceback.format_exc()
                return time.perf_counter() - t_start
            self.spans.append(rec)
            self.steps_done += rec.steps
            if until_samples:
                if len(self.samples) == sum(len(v) for v in self.plan.values()):
                    break
            elif rec.t2 - t_start >= seconds:
                break
        return self.spans[-1].t2 - t_start


# ----------------------------------------------------------------------
# the check
# ----------------------------------------------------------------------
def _finite_or_inf(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def compare_states(port: tuple, ref: tuple, names: tuple) -> dict:
    """Each field's relative gap between a state of the program and the
    reference's, in float64: by the L2 norm (``<field>_rel_l2``) and by the
    largest entry (``<field>_max_rel``); ``flow_rel_l2`` is the worst
    velocity component's or the pressure's L2 gap."""
    out = {}
    for name, a, b in zip(names, port, ref):
        a = a.double()
        b = b.double().to(a.device)
        d = a - b
        nb = float(torch.linalg.vector_norm(b))
        mb = float(b.abs().max())
        nd = float(torch.linalg.vector_norm(d))
        md = float(d.abs().max())
        out[f"{name}_rel_l2"] = _finite_or_inf(nd / nb if nb > 0 else nd)
        out[f"{name}_max_rel"] = _finite_or_inf(md / mb if mb > 0 else md)
    out["flow_rel_l2"] = max(v for k, v in out.items()
                             if k.endswith("_rel_l2") and not k.startswith("F_"))
    return out


def on_device(sample: Sample, device) -> Sample:
    """The kept frame with its states on ``device``."""
    return dataclasses.replace(sample, inp=tuple(a.to(device) for a in sample.inp),
                               out=tuple(a.to(device) for a in sample.out))


def check(loop: Loop, ref_dtype=torch.float64) -> list[dict]:
    """Judge every kept frame by the reference: the reference advances the
    frame's input state in ``ref_dtype``. Returns, for each kept frame,
    {number: value} for every number computed. A number of a frame among
    its job's first ``start_frames`` is named ``<number>.start`` where the
    cell's limits name one: the start's flow is held apart from the
    developed flow's."""
    route = loop.route
    ref = route.reference(loop.cell.config)
    per_frame = []
    for s in loop.samples:
        s = on_device(s, loop.device)
        ref_state, nums = route.judge(ref, s, ref_dtype)
        for f in loop.frames:
            out = s.outputs.get(f.name)
            nums.update(dict.fromkeys(f.numbers, math.inf) if out is None
                        else f.judge(ref, ref_state, s, out))
        if s.frame < loop.start_frames:
            nums = {(f"{k}.start" if f"{k}.start" in loop.cell.limits else k): v
                    for k, v in nums.items()}
        per_frame.append({k: _finite_or_inf(float(v)) for k, v in nums.items()})
        del ref_state, s
    return per_frame


def worst(per_frame: list[dict]) -> dict:
    """Each number's worst reading over the kept frames."""
    out: dict[str, float] = {}
    for nums in per_frame:
        for k, v in nums.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def verdict(numbers: dict, limits: dict, n_samples: int) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}) for the numbers the cell compares;
    a number that was not computed reads infinite."""
    compared = {k: {"value": numbers.get(k, math.inf), "limit": lim}
                for k, lim in limits.items()}
    ok = n_samples > 0 and all(c["value"] <= c["limit"] for c in compared.values())
    return ok, compared


# ----------------------------------------------------------------------
# one run
# ----------------------------------------------------------------------
@dataclass
class RunRecord:
    """What a per-layer reader sees: the window's frame spans, the traced
    sub-window's events (or None), the route and the device."""

    spans: list
    trace: object
    route: object
    config: dict
    traffic: dict
    device_kind: str | None
    extra: dict = field(default_factory=dict)


def outdir_for(workload: str) -> Path:
    """A new scratch directory of the run for frames, logs and the trace,
    under the temporary directory the environment names; the caller
    removes it."""
    return Path(tempfile.mkdtemp(prefix=f"portbench-{workload}-"))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, device_kind: str | None = None,
             until_samples: bool = False) -> dict:
    """One run of a cell: set-up with one warm-up frame, the window, with
    ``trace`` a profiled sub-window after it, then the check. Returns the
    result's fields (without the device block's card facts). With
    ``until_samples`` the window lasts until every planned frame is kept."""
    device = torch.device(device)
    outdir = outdir_for(cell.name)
    loop = None
    try:
        loop = Loop(cell, seed, device, outdir)
        loop.warm_up()
        setup_s = time.time() - t_start
        window_s = loop.window(seconds, until_samples)
        rec = RunRecord(loop.spans, None, loop.route, cell.config, cell.traffic, device_kind)
        breakdown = None
        dev_extra = {}
        if trace and loop.error is None:
            from . import trace as tracing

            data = tracing.traced_frames(loop, int(cell.traffic["trace_frames"]), outdir)
            rec.trace = data
            if data is not None:
                dev_extra = {"busy_s": data.busy_s, "window_s": data.window_s}
                breakdown = data.breakdown()
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        attempted = len(loop.spans) + (loop.error is not None)
        metrics = {}
        if trace:
            for m in cell.per_layer:
                value = load_module("metrics", m["name"]).read(rec)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        elif loop.spans:
            steps = loop.steps_done
            cells = loop.route.cells
            frame_ms = sorted(1e3 * (s.t2 - s.t0) for s in loop.spans)
            values = {"cell_updates_per_s": cells * steps / window_s,
                      "frame_ms_p95": _percentile(frame_ms, 95.0),
                      "setup_s": setup_s}
            for m in cell.end_to_end:
                if m["name"] in values:
                    metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        loop.state = None
        if device.type == "cuda":
            torch.cuda.empty_cache()
        per_frame = check(loop)
        numbers = worst(per_frame)
        ok, compared = verdict(numbers, cell.limits, len(per_frame))
        failed = sum(1 for nums in per_frame
                     if not verdict(nums, {k: v for k, v in cell.limits.items() if k in nums}, 1)[0])
        if loop.error is not None or not per_frame:
            ok, failed = False, failed + 1
        return {"correct": ok, "attempted": attempted, "failed": failed, "error": loop.error,
                "metrics": metrics, "memory_peak_bytes": peak, "device_extra": dev_extra,
                "notes": rec.extra,
                "breakdown": breakdown, "numbers": numbers, "check": compared,
                "samples": [(s.job, s.frame) for s in loop.samples]}
    finally:
        if loop is not None:
            loop.close()
        shutil.rmtree(outdir, ignore_errors=True)


def _percentile(sorted_values: list, q: float) -> float:
    """The q-th percentile by linear interpolation between ranks."""
    n = len(sorted_values)
    if n == 1:
        return sorted_values[0]
    pos = (n - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, n - 1)
    return sorted_values[lo] + (sorted_values[hi] - sorted_values[lo]) * (pos - lo)
