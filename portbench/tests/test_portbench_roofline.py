"""The step's bytes and operations, and the trace readers, at small sizes."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))

from portbench.harness import FrameSpan, RunRecord, load_module  # noqa: E402
from portbench.roofline import least_time, step_bytes, step_ops  # noqa: E402
from portbench.trace import parse  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"


def test_step_bytes_count_each_field_in_and_out():
    assert step_bytes((6, 6), "float32") == 2 * 4 * 36 * 4
    assert step_bytes((4, 5, 6), "float64") == 2 * 5 * 120 * 8
    assert step_bytes((514, 514), "float32") == (2 * 4 * 514 * 514 * 4)


@pytest.mark.parametrize("dims,n_jacobi,ops", [(2, 10, 336), (2, 0, 246), (3, 10, 437),
                                               (3, 1, 320)])
def test_step_ops_grow_with_the_sweeps(dims, n_jacobi, ops):
    assert step_ops(dims, n_jacobi) == ops


def test_least_time_is_the_larger_bound():
    t, by = least_time(H100, (514, 514), 512 * 512, "float32", 10, 1)
    assert by == "bytes" and t == pytest.approx((2 * 4 * 514 * 514 * 4) / 3.35e12)
    t3, by3 = least_time(H100, (202, 202, 202), 200 ** 3, "float32", 10, 1)
    assert by3 == "bytes" and t3 == pytest.approx(2 * 5 * 202 ** 3 * 4 / 3.35e12)
    # a grid of few ghost cells and many sweeps is bound by operations
    t4, by4 = least_time(H100, (3, 3), 1, "float32", 10 ** 6, 1)
    assert by4 == "operations" and t4 == pytest.approx(step_ops(2, 10 ** 6) / 67e12)
    assert least_time("some other card", (6, 6), 16, "float32", 10, 1) is None


class _Route:
    shape, cells, dtype, n_jacobi = (514, 514), 512 * 512, "float32", 10


def _trace():
    """A window of 100 us: a solver span 0-60 with two kernels, frame work
    60-100 with one kernel and a copy."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "portbench.window", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "portbench.solver", "ts": 0, "dur": 60},
        {"ph": "X", "cat": "user_annotation", "name": "portbench.frame_host", "ts": 60, "dur": 40},
        {"ph": "X", "cat": "cpu_op", "name": "aten::sum", "ts": 62, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "fullstep", "ts": 5, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "fullstep", "ts": 30, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "reduce", "ts": 65, "dur": 5},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 68, "dur": 4},
    ]
    return parse(ev, steps=2)


def test_trace_busy_idle_and_breakdown():
    tr = _trace()
    assert tr.busy_s == pytest.approx((20 + 20 + 7) * 1e-6)
    assert tr.window_s == pytest.approx(100e-6)
    assert [k[0] for k in tr.solver_kernels()] == ["fullstep", "fullstep"]
    b = tr.breakdown()
    assert b["device_ops"][0] == ["fullstep", pytest.approx(40e-6)]
    assert b["idle_gaps"][0] == ["frame_host/aten::sum", pytest.approx(28e-6)]
    assert len(b["idle_gaps"]) == 4


def _record(trace):
    spans = [FrameSpan(0, 0, 100, 0.0, 0.010, 0.012), FrameSpan(0, 1, 100, 0.012, 0.022, 0.025)]
    return RunRecord(spans, trace, _Route(), {}, {}, H100)


@pytest.mark.parametrize("name,value", [
    ("device_idle_pct", 53.0),
    ("launches_per_step", 1.0),
    ("kernels_roofline", 100 * 2 * (2 * 4 * 514 * 514 * 4) / 3.35e12 / 40e-6),
    ("solver_ms_per_step", 0.1),
    ("frame_host_ms", 2.5),
])
def test_readers(name, value):
    assert load_module("metrics", name).read(_record(_trace())) == pytest.approx(value)


@pytest.mark.parametrize("name", ["device_idle_pct", "launches_per_step", "kernels_roofline"])
def test_trace_readers_read_nothing_without_a_trace(name):
    assert load_module("metrics", name).read(_record(None)) is None
