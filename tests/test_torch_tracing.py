"""The port's own spans and counters (tpuvof_torch/utils/profiling.py).

On the CPU: under a torch.profiler, each driver emits one ``tv.simulate``
a call with its ``tv.bc`` (and the CFL tracker's ``tv.cfl`` a step) inside,
the frame's metrics emit ``tv.metrics`` and ``tv.host_read``, all as
``cpu_op`` events of the profiler's Chrome trace, and the states are the
same bit for bit with and without the profiler. With no profiler nothing
is recorded, and no launch or library counter is set.

The ``cuda``-marked tests (run on a card: ``python3 -m pytest
tests/test_torch_tracing.py --noconftest -m cuda``) hold the wrappers'
spans: one ``tv.wrap.<kernel>`` holding one ``tv.launch.<kernel>`` a
wrapper call, each kernel's launch call (a graph's replay on 'cuda_mono')
inside its ``tv.launch`` span on the profiler's one clock, and the
first-launch seconds counted.
"""
from __future__ import annotations

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tpuvof_torch as tt
from tpuvof_torch.kernels import build
from tpuvof_torch.kernels import step_kernels as K
from tpuvof_torch.metrics import compute_metrics, format_frame
from tpuvof_torch.utils import span


def _events(prof, path) -> list[dict]:
    """The complete events of the profile's Chrome trace."""
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _tv(events, prefix: str = "tv.") -> list[dict]:
    return sorted((e for e in events if e["name"].startswith(prefix)),
                  key=lambda e: float(e["ts"]))


def _inside(inner: dict, outer: dict, slack: float = 0.01) -> bool:
    a, b = float(outer["ts"]), float(outer["ts"]) + float(outer["dur"])
    t0 = float(inner["ts"])
    return a - slack <= t0 and t0 + float(inner.get("dur", 0.0)) <= b + slack


def _run_2d(backend: str, device: str, dtype, n: int, steps: int, cfl: bool = False):
    cfg = tt.dam_break_2d(n, num=tt.Numerics(backend=backend))
    state = tt.init_state(cfg, 1, device, dtype)
    if cfl:
        return lambda: tt.simulate_cfl(cfg, state, steps)[0]
    return lambda: tt.simulate(cfg, state, steps)


def _run_3d(device: str, dtype, n: int, steps: int):
    g = tt.Grid3D(n, n, n)
    state = tt.init_state_3d(g, ic=1, device=device, dtype=dtype)
    return lambda: tt.simulate_3d(g, state, steps, backend="cuda")


# 'cuda' on CPU tensors runs the kernels' plain versions: the 3-D route's
# entry and exit BCs are there
DRIVERS = {
    "simulate": (lambda: _run_2d("torch", "cpu", torch.float64, 16, 3), 1, 0),
    "simulate_cfl": (lambda: _run_2d("torch", "cpu", torch.float64, 16, 3, cfl=True), 1, 3),
    "simulate_3d": (lambda: _run_3d("cpu", torch.float64, 8, 2), 2, 0),
}


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_driver_spans_on_the_cpu(driver, tmp_path):
    make, n_bc, n_cfl = DRIVERS[driver]
    run = make()
    plain = run()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = run()
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
    tv = _tv(_events(prof, tmp_path / "t.json"))
    assert {e["cat"] for e in tv} == {"cpu_op"}
    (sim,) = [e for e in tv if e["name"] == "tv.simulate"]
    assert all(_inside(e, sim) for e in tv)
    assert sum(e["name"] == "tv.bc" for e in tv) == n_bc
    assert sum(e["name"] == "tv.cfl" for e in tv) == n_cfl
    assert sum(e["name"] == "tv.host_read" for e in tv) == (driver == "simulate_cfl")


def test_metrics_line_spans_on_the_cpu(tmp_path):
    cfg = tt.dam_break_2d(16, num=tt.Numerics(backend="torch"))
    state = tt.init_state(cfg, 1, "cpu", torch.float64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        line = format_frame(0, cfg.num.dt, compute_metrics(cfg, state), "vof")
    assert line == format_frame(0, cfg.num.dt, compute_metrics(cfg, state), "vof")
    tv = _tv(_events(prof, tmp_path / "t.json"))
    assert [(e["name"], e["cat"]) for e in tv] == [("tv.metrics", "cpu_op"),
                                                   ("tv.host_read", "cpu_op")]


def test_no_profiler_records_and_counts_nothing():
    """A span with no profiler is one shared no-op; the kernel wrappers on
    CPU tensors count no launch and load no library."""
    assert span("tv.simulate") is span("tv.bc")
    cfg = tt.dam_break_2d(16, num=tt.Numerics(backend="cuda_mono"))
    tt.simulate(cfg, tt.init_state(cfg, 1, "cpu", torch.float64), 2)
    assert K.FIRST_LAUNCH_S == {}
    assert build.build_seconds() is None and build.library_built() is None


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _launch_calls(events) -> dict[int, dict]:
    """The host's launch calls (cudaLaunchKernel, cudaLaunchCooperativeKernel,
    cudaGraphLaunch) by correlation id."""
    return {e["args"]["correlation"]: e for e in events
            if e.get("cat") == "cuda_runtime"
            and e["name"].startswith(("cudaLaunch", "cudaGraphLaunch"))}


def _wraps_hold_one_launch(tv) -> list[str]:
    """The kernel of each tv.wrap span, checking it holds exactly one
    tv.launch span of the same kernel."""
    kernels = []
    for w in (e for e in tv if e["name"].startswith("tv.wrap.")):
        name = w["name"].removeprefix("tv.wrap.")
        inner = [e for e in tv if e["name"].startswith("tv.launch.") and _inside(e, w)]
        assert [e["name"] for e in inner] == [f"tv.launch.{name}"]
        kernels.append(name)
    return kernels


@pytest.mark.cuda
def test_mono_spans_share_the_profilers_clock_on_card(tmp_path):
    _card()
    run = _run_2d("cuda_mono", "cuda", torch.float32, 64, 3)
    # builds or loads the library, the first launch loads fullstep, and
    # simulate captures its graph of a step pair
    run()
    torch.cuda.synchronize()
    assert K.FIRST_LAUNCH_S["fullstep"] > 0
    assert build.build_seconds() > 0 and build.library_built() is not None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = _events(prof, tmp_path / "t.json")
    tv = _tv(events)
    # the pair replayed from the graph, the odd third step through the wrapper
    assert _wraps_hold_one_launch(tv) == ["fullstep"]
    launches = [e for e in tv if e["name"].startswith("tv.launch.")]
    assert [e["name"] for e in launches] == ["tv.launch.fullstep_graph", "tv.launch.fullstep"]
    calls = _launch_calls(events)
    kernels = [e for e in events if e.get("cat") == "kernel" and "fullstep" in e["name"]]
    assert len(kernels) == 3
    for k in kernels:
        call = calls[k["args"]["correlation"]]
        assert sum(_inside(call, s) for s in launches) == 1


@pytest.mark.cuda
def test_3d_spans_one_launch_a_wrapper_call_on_card(tmp_path):
    _card()
    run = _run_3d("cuda", torch.float32, 16, 2)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    tv = _tv(_events(prof, tmp_path / "t.json"))
    step = ["predict3d_rhs", "jacobi3d", "correct3d"] + ["fct3d_sweep"] * 3
    assert _wraps_hold_one_launch(tv) == step * 2
    assert sum(e["name"].startswith("tv.launch.") for e in tv) == 12
    assert sum(e["name"] == "tv.bc" for e in tv) == 2
    assert all(K.FIRST_LAUNCH_S[k] > 0 for k in set(step))
