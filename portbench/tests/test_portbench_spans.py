"""The program's spans in a synthetic trace: self times, the four readers
that read them, and the idle gaps they name."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))

from portbench.harness import FrameSpan, RunRecord, load_module  # noqa: E402
from portbench.program_spans import program_spans  # noqa: E402
from portbench.trace import parse  # noqa: E402


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _trace(with_program_spans: bool = True):
    """A window of 200 us over two steps: a solver span 0-150 whose
    tv.simulate holds an entry BC and two wrapped launches, device work
    50-90 and 110-145; frame work 150-200 (metrics, the host read)."""
    ev = [
        _ev("user_annotation", "portbench.window", 0, 200),
        _ev("user_annotation", "portbench.solver", 0, 150),
        _ev("user_annotation", "portbench.frame_host", 150, 50),
        _ev("cpu_op", "aten::copy_", 5, 8),
        _ev("kernel", "fullstep", 50, 40),
        _ev("kernel", "fullstep", 110, 35),
        _ev("kernel", "reduce", 160, 5),
        _ev("gpu_memcpy", "Memcpy DtoH", 175, 5),
    ]
    if with_program_spans:
        ev += [
            _ev("cpu_op", "tv.simulate", 2, 146),
            _ev("cpu_op", "tv.bc", 4, 10),
            _ev("cpu_op", "tv.wrap.fullstep", 20, 40),
            _ev("cpu_op", "tv.launch.fullstep", 40, 10),
            _ev("cpu_op", "tv.wrap.fullstep", 80, 40),
            _ev("cpu_op", "tv.launch.fullstep", 100, 10),
            _ev("cpu_op", "tv.metrics", 152, 18),
            _ev("cpu_op", "tv.host_read", 172, 18),
        ]
    return parse(ev, steps=2)


def _record(trace):
    spans = [FrameSpan(0, 0, 2, 0.0, 150e-6, 200e-6)]
    return RunRecord(spans, trace, None, {}, {}, "NVIDIA H100 80GB HBM3")


def test_self_time_is_less_the_direct_tv_children():
    got = {(s.name, s.ts): s.self_us for s in program_spans(_record(_trace()))}
    assert got[("tv.simulate", 2)] == pytest.approx(146 - 10 - 40 - 40)
    assert got[("tv.bc", 4)] == pytest.approx(10)  # aten::copy_ is not a tv. span
    assert got[("tv.wrap.fullstep", 20)] == pytest.approx(30)
    assert got[("tv.launch.fullstep", 40)] == pytest.approx(10)
    assert got[("tv.metrics", 152)] == pytest.approx(18)
    assert len(got) == 8


@pytest.mark.parametrize("name,value", [
    ("driver_us_per_step", (146 - 90) / 2),
    ("glue_us_per_step", (10 + 30 + 30) / 2),
    ("launch_us_per_step", (10 + 10) / 2),
])
def test_span_readers(name, value):
    assert load_module("metrics", name).read(_record(_trace())) == pytest.approx(value)


def test_driver_glue_launch_account_for_the_simulate_span():
    rec = _record(_trace())
    total = sum(load_module("metrics", n).read(rec)
                for n in ("driver_us_per_step", "glue_us_per_step", "launch_us_per_step"))
    assert total * 2 == pytest.approx(146)


@pytest.mark.parametrize("name", ["driver_us_per_step", "glue_us_per_step",
                                  "launch_us_per_step", "kernel_setup_s"])
@pytest.mark.parametrize("trace", ["none", "no_program_spans"])
def test_span_readers_read_nothing_without_the_program_spans(name, trace):
    tr = None if trace == "none" else _trace(with_program_spans=False)
    rec = _record(tr)
    assert load_module("metrics", name).read(rec) is None
    assert rec.extra == {}


def test_kernel_setup_s_reads_the_program_counters(monkeypatch):
    from tpuvof_torch.kernels import build, step_kernels

    rec = _record(_trace())
    reader = load_module("metrics", "kernel_setup_s")
    assert build.build_seconds() is None and reader.read(rec) is None  # nothing loaded
    monkeypatch.setattr(build, "_build_seconds", 1.5)
    monkeypatch.setattr(build, "_built", False)
    monkeypatch.setitem(step_kernels.FIRST_LAUNCH_S, "fullstep", 0.25)
    monkeypatch.setitem(step_kernels.FIRST_LAUNCH_S, "jacobi3d", 0.125)
    assert reader.read(rec) == pytest.approx(1.875)
    assert rec.extra == {"kernel_library_built": False}
    # a program without the first-launch counter reads nothing
    monkeypatch.delattr(step_kernels, "FIRST_LAUNCH_S")
    assert reader.read(_record(_trace())) is None


def test_breakdown_names_gaps_by_the_program_spans():
    gaps = _trace().breakdown()["idle_gaps"]
    assert gaps[0] == ["solver/tv.wrap.fullstep", pytest.approx(50e-6)]
    labels = [g[0] for g in gaps]
    assert "solver/tv.launch.fullstep" in labels
    assert "frame_host/tv.metrics" in labels
    assert not [lab for lab in labels if lab == "solver"]
