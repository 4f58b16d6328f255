"""``simulate``'s 'cuda_mono' loop replayed from a CUDA graph
(tpuvof_torch.solver: mono_graph_plan, MONO_GRAPH; the fullstep wrapper's
caller-given outputs and scratch).

On the CPU: the decision and the schedule (``mono_graph_plan``) over
route, device, step count, a caller's capture and the first step's
parity; ``simulate`` on 'cuda_mono' with CPU tensors counts nothing and
equals the loop of ``step(..., lean=True)``; ``fullstep``'s ``out`` and
``scratch``, and the checks on them.

The ``cuda``-marked tests (run on a card: ``python3 -m pytest
tests/test_torch_mono_graph.py --noconftest -m cuda``) hold the graph's
path to the step loop bit for bit, at 64^2 and 512^2, f32 and f64, odd and
even step counts and both parities, with one fullstep launch counted a
step; its results new and its entry state untouched across calls, one
capture per key; the step loop under a caller's own capture; every card
of the machine; the replayed kernels in a profiler's trace.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import tpuvof_torch as tt
from tpuvof_torch import solver
from tpuvof_torch.kernels import step_kernels as K
from tpuvof_torch.ops import apply_bc
from tpuvof_torch.solver import MONO_GRAPH, MonoPlan, mono_graph_plan

ROUTES = ("torch", "cuda", "cuda_mono", "cuda_tiled", "cuda_strips")


def _state(n: int, device, dtype, seed: int = 0) -> tt.State:
    """A perturbed, BC-consistent dam-break state (numpy noise, so that
    every device and dtype sees the same numbers)."""
    cfg = tt.dam_break_2d(n)
    s = tt.init_state(cfg, 1, "cpu", torch.float64)
    rng = np.random.default_rng(seed)
    F, u, v, p = (a + torch.as_tensor(rng.uniform(-1e-3, 1e-3, a.shape)) for a in s)
    u, v, F, p = apply_bc(u, v, F.clamp(0, 1), p)
    return tt.State(*(a.to(device=device, dtype=dtype).contiguous() for a in (F, u, v, p)))


def _step_loop(cfg, state, n: int, istep0: int) -> tt.State:
    """``simulate``'s step loop: the entry BCs, then lean steps."""
    u, v, F, p = apply_bc(state.u, state.v, state.F, state.p)
    s = tt.State(F, u, v, p)
    even1 = (istep0 + 1) % 2 == 0
    for k in range(n):
        s = tt.step(cfg, s, even_step=even1 if k % 2 == 0 else not even1, lean=True)
    return s


# ----------------------------------------------------------------------
# on the CPU
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n_steps", [0, 1, 2, 7, 100])
@pytest.mark.parametrize("device", ["cpu", "cuda:0"])
@pytest.mark.parametrize("route", ROUTES)
def test_mono_graph_plan(route, device, n_steps):
    """A graph on 'cuda_mono' with a state on a card, two steps or more
    and no capture in progress: n // 2 pairs whose first step takes the
    call's first parity, and for an odd count a tail of that parity."""
    for capturing in (False, True):
        for even1 in (False, True):
            plan = mono_graph_plan(route, torch.device(device), n_steps, capturing, even1)
            if route != "cuda_mono" or device == "cpu" or n_steps < 2 or capturing:
                assert plan is None
                continue
            assert plan == MonoPlan(n_steps // 2, even1, even1 if n_steps % 2 else None)
            assert 2 * plan.pairs + (plan.tail is not None) == n_steps


@pytest.mark.parametrize("istep0", [0, 1])
@pytest.mark.parametrize("n_steps", [1, 2, 3, 7])
def test_simulate_mono_on_cpu_counts_nothing(n_steps, istep0):
    cfg = tt.dam_break_2d(16, num=tt.Numerics(backend="cuda_mono"))
    state = _state(16, "cpu", torch.float64)
    before = dict(MONO_GRAPH)
    K.reset_launch_counts()
    got = tt.simulate(cfg, state, n_steps, istep0=istep0)
    assert MONO_GRAPH == before
    assert not any(K.LAUNCHES.values())
    for g_, w_ in zip(got, _step_loop(cfg, state, n_steps, istep0)):
        assert torch.equal(g_, w_)


@pytest.mark.parametrize("even", [False, True])
def test_fullstep_writes_into_out_on_cpu(even):
    cfg = tt.dam_break_2d(16)
    state = _state(16, "cpu", torch.float64)
    out = [torch.full_like(state.F, float("nan")) for _ in range(4)]
    scratch = torch.empty(K.scratch_cells("fullstep", state.F.shape, state.F.dtype),
                          dtype=torch.float64)
    got = K.fullstep(cfg, *state, even, out=out, scratch=scratch)
    assert all(g_ is o for g_, o in zip(got, out))
    for g_, w_ in zip(got, K.fullstep_plain(cfg, *state, even)):
        assert torch.equal(g_, w_)


def _bad_buffers(case: str, state):
    """(out, scratch) that the fullstep wrapper refuses."""
    like = state.F
    out = [torch.empty_like(like) for _ in range(4)]
    scratch = torch.empty(K.scratch_cells("fullstep", like.shape, like.dtype), dtype=like.dtype)
    if case == "three outputs":
        out = out[:3]
    elif case == "shape":
        out[1] = torch.empty(like.shape[0], like.shape[1] + 1, dtype=like.dtype)
    elif case == "dtype":
        out[2] = out[2].float()
    elif case == "strided":
        out[3] = torch.empty(like.shape[1], like.shape[0], dtype=like.dtype).t()
    elif case == "small scratch":
        scratch = scratch[:-1]
    elif case == "out is an input":
        out[0] = state.p
    elif case == "scratch holds an input":
        scratch = torch.cat([state.u.reshape(-1), scratch])
        state = tt.State(state.F, scratch[:like.numel()].view(like.shape), state.v, state.p)
    elif case == "two outputs share":
        out[1] = out[0]
    elif case == "out without scratch":
        scratch = None
    return state, out, scratch


@pytest.mark.parametrize("case", ["three outputs", "shape", "dtype", "strided",
                                  "small scratch", "out is an input", "scratch holds an input",
                                  "two outputs share", "out without scratch"])
def test_fullstep_refuses_bad_out_and_scratch(case):
    cfg = tt.dam_break_2d(16)
    state, out, scratch = _bad_buffers(case, _state(16, "cpu", torch.float64))
    with pytest.raises(ValueError):
        K.fullstep(cfg, *state, False, out=out, scratch=scratch)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _mono(n: int) -> tt.SimConfig:
    return tt.dam_break_2d(n, num=tt.Numerics(backend="cuda_mono"))


def _extent(t):
    return t.data_ptr(), t.data_ptr() + t.numel() * t.element_size()


def _shares_memory(a, b) -> bool:
    (p, q), (r, s) = _extent(a), _extent(b)
    return p < s and r < q


def _cached_buffers() -> list:
    return [t for e in solver._MONO_GRAPHS.values() for t in (*e.a, *e.b, e.scratch)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [64, 512])
@pytest.mark.parametrize("istep0", [0, 1])
@pytest.mark.parametrize("n_steps", [1, 2, 3, 100])
def test_graph_equals_the_step_loop_on_card(n_steps, istep0, n, dtype):
    """Bit for bit with the eager loop, n fullstep launches counted and no
    other, the entry state untouched, every step counted in MONO_GRAPH."""
    _card()
    cfg = _mono(n)
    state = _state(n, "cuda", dtype)
    entry = [t.clone() for t in state]
    want = _step_loop(cfg, state, n_steps, istep0)
    before = dict(MONO_GRAPH)
    K.reset_launch_counts()
    got = tt.simulate(cfg, state, n_steps, istep0=istep0)
    torch.cuda.synchronize()
    assert {k: c for k, c in K.LAUNCHES.items() if c} == {"fullstep": n_steps}
    for name, g_, w_ in zip("Fuvp", got, want):
        assert torch.equal(g_, w_), name
    for a, b in zip(state, entry):
        assert torch.equal(a, b)
    moved = {k: MONO_GRAPH[k] - before[k] for k in MONO_GRAPH}
    assert moved["graph_steps"] + moved["eager_steps"] == n_steps
    if n_steps == 1:
        assert moved == {"captures": 0, "graph_steps": 0, "eager_steps": 1}
    else:
        assert moved["captures"] in (0, 1)
        assert moved["eager_steps"] == 2 * moved["captures"] + n_steps % 2


@pytest.mark.cuda
def test_graph_results_are_new_and_one_capture_a_key_on_card():
    """Two calls from different states on one key: one capture, each
    result equal to its step loop, the first result unchanged by the
    second call, no result sharing memory with the other or with the
    cache's buffers, the entry states untouched."""
    _card()
    solver._MONO_GRAPHS.clear()
    cfg = _mono(64)
    s1, s2 = _state(64, "cuda", torch.float32, 1), _state(64, "cuda", torch.float32, 2)
    entries = [[t.clone() for t in s] for s in (s1, s2)]
    before = MONO_GRAPH["captures"]
    r1 = tt.simulate(cfg, s1, 10)
    kept = [t.clone() for t in r1]
    r2 = tt.simulate(cfg, s2, 10)
    torch.cuda.synchronize()
    assert MONO_GRAPH["captures"] - before == 1 and len(solver._MONO_GRAPHS) == 1
    for got, want in ((r1, _step_loop(cfg, s1, 10, 0)), (r2, _step_loop(cfg, s2, 10, 0))):
        for g_, w_ in zip(got, want):
            assert torch.equal(g_, w_)
    for a, b in zip(r1, kept):
        assert torch.equal(a, b)
    for s, e in zip((s1, s2), entries):
        for a, b in zip(s, e):
            assert torch.equal(a, b)
    results = [*r1, *r2]
    for k, t in enumerate(results):
        assert not any(_shares_memory(t, o) for o in results[k + 1:] + _cached_buffers())


@pytest.mark.cuda
def test_caller_capture_runs_the_step_loop_on_card():
    """simulate inside a caller's torch.cuda.graph capture launches step by
    step (no graph of its own), and the caller's replay gives the loop's
    result."""
    _card()
    cfg = _mono(64)
    state = _state(64, "cuda", torch.float32)
    want = _step_loop(cfg, state, 4, 0)
    tt.simulate(cfg, state, 1)  # the kernel's module is loaded before the capture
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    torch.cuda.synchronize()
    before = dict(MONO_GRAPH)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = tt.simulate(cfg, state, 4)
    assert {k: MONO_GRAPH[k] - before[k] for k in MONO_GRAPH} == {
        "captures": 0, "graph_steps": 0, "eager_steps": 4}
    graph.replay()
    torch.cuda.synchronize()
    for g_, w_ in zip(out, want):
        assert torch.equal(g_, w_)


@pytest.mark.cuda
def test_graph_on_every_card():
    """On each card of the machine, made current, the graph's path equals
    the step loop on that card; a state off the current card is refused,
    as the wrappers refuse it."""
    _card()
    cfg = _mono(64)
    for index in range(torch.cuda.device_count()):
        with torch.cuda.device(index):
            state = _state(64, f"cuda:{index}", torch.float32)
            got = tt.simulate(cfg, state, 5)
            for g_, w_ in zip(got, _step_loop(cfg, state, 5, 0)):
                assert g_.device.index == index and torch.equal(g_, w_)
    if torch.cuda.device_count() > 1:
        with torch.cuda.device(0), pytest.raises(ValueError):
            tt.simulate(cfg, _state(64, "cuda:1", torch.float32), 4)


@pytest.mark.cuda
def test_replayed_kernels_in_the_profiler_trace_on_card(tmp_path):
    """Under torch.profiler a captured key's call shows one
    tv.launch.fullstep_graph span holding the replays, and each step's
    fullstep kernel in the trace, launched from inside that span."""
    from torch.profiler import ProfilerActivity, profile

    _card()
    cfg = _mono(64)
    state = _state(64, "cuda", torch.float32)
    tt.simulate(cfg, state, 6)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tt.simulate(cfg, state, 6)
        torch.cuda.synchronize()
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    (span,) = [e for e in events if e["name"] == "tv.launch.fullstep_graph"]
    assert not [e for e in events if e["name"].startswith("tv.wrap.")]
    kernels = [e for e in events if e.get("cat") == "kernel" and "fullstep" in e["name"]]
    assert len(kernels) == 6
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") == "cuda_runtime" and e["name"].startswith("cudaGraphLaunch")}
    assert len(launches) == 3
    t0, t1 = float(span["ts"]), float(span["ts"]) + float(span["dur"])
    for k in kernels:
        call = launches[k["args"]["correlation"]]
        assert t0 - 0.01 <= float(call["ts"]) <= t1 + 0.01
