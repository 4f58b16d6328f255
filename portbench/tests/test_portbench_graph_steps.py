"""The reader of the program's graph-steps counter, ``graph_steps_pct``."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))

from portbench.harness import FrameSpan, RunRecord, load_module  # noqa: E402


def _record():
    spans = [FrameSpan(0, 0, 2, 0.0, 150e-6, 200e-6)]
    return RunRecord(spans, None, None, {}, {}, "NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("counts,value", [
    (None, None),  # a program without the counter
    ({"captures": 0, "graph_steps": 0, "eager_steps": 0}, None),
    ({"captures": 1, "graph_steps": 0, "eager_steps": 7}, 0.0),
    ({"captures": 1, "graph_steps": 198, "eager_steps": 2}, 99.0),
])
def test_graph_steps_pct_reads_the_program_counter(monkeypatch, counts, value):
    from tpuvof_torch import solver

    if counts is None:
        monkeypatch.delattr(solver, "MONO_GRAPH")
    else:
        monkeypatch.setattr(solver, "MONO_GRAPH", counts)
    got = load_module("metrics", "graph_steps_pct").read(_record())
    assert got == (None if value is None else pytest.approx(value))
