"""The check fails what it must: a whole run on the CPU at a small size, the
look for a card skipped, with the timed path broken underneath (a step
that returns its state unchanged, half of the grid left out, an answer
altered where it is produced) and with the control (the reference in
bfloat16 in the program's place); and it passes the program itself.

Each cell's own limits are used. The small size keeps what decides them
at the cell's: frames of the cell's 100 steps, a kept frame from a fresh
dam and one from a developed flow (``small_cell``)."""
from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))

from held_cells import load_any_cell  # noqa: E402
from portbench.control import StandIn  # noqa: E402
from portbench.harness import load_module, make_route, run_cell  # noqa: E402

#: (cells along an axis, the time step's factor) of each cell's small copy
SMALL = {"dambreak2d-512.mono": (64, 8.0), "dambreak2d-512.cli": (64, 8.0),
         "dambreak3d-200.frames": (24, 4.0)}
SEED = 2 ** 33 + 12345


def small_cell(name: str):
    """The cell on a coarser grid, its time step grown (no more than its
    cells are, so the Courant numbers stay the cell's or below), so that a
    job of 600 steps reaches a developed flow as the cell's do."""
    cell = load_any_cell(name)
    n, scale = SMALL[name]
    cell.config = dict(cell.config, nx=n, ny=n, dt=cell.config["dt"] * scale,
                       **({"nz": n} if cell.config["dims"] == 3 else {}))
    cell.traffic = dict(cell.traffic, steps=600, check_frames=2, trace_frames=1)
    return cell


def run(cell, route=None):
    """A run of ``cell`` on the CPU; ``route`` replaces the cell's."""
    from portbench import harness

    if route is None:
        return run_cell(cell, SEED, 0.0, False, "cpu", time.time(), until_samples=True)
    orig = harness.make_route
    harness.make_route = lambda c, d: route
    try:
        return run_cell(cell, SEED, 0.0, False, "cpu", time.time(), until_samples=True)
    finally:
        harness.make_route = orig


class Broken:
    """The cell's route with its solver call broken by ``fault``."""

    def __init__(self, route, fault):
        self.route, self.fault = route, fault

    def __getattr__(self, name):
        return getattr(self.route, name)

    def advance(self, state, n, istep0):
        out, rep = self.route.advance(state, n, istep0)
        return self.fault(tuple(state), tuple(a.clone() for a in out)), rep


def unchanged(inp, out):
    return tuple(a.clone() for a in inp)


def half_left_out(inp, out):
    """The half of the grid that holds the dam keeps its input values."""
    h = inp[0].shape[0] // 2
    for a, b in zip(out, inp):
        a[:h] = b[:h]
    return out


def altered_cell(inp, out):
    F = out[0]
    idx = tuple(s // 3 for s in F.shape)
    F[idx] = 0.5 if float(F[idx]) != 0.5 else 0.25
    return out


def pressure_stale(inp, out):
    """The pressure is never written back: p keeps its input values."""
    out[-1].copy_(inp[-1])
    return out


FAULTS = {"unchanged": unchanged, "half_left_out": half_left_out, "altered_cell": altered_cell,
          "pressure_stale": pressure_stale}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_program_passes(name):
    res = run(small_cell(name))
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["samples"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", sorted(SMALL))
def test_broken_step_fails(name, fault):
    cell = small_cell(name)
    res = run(cell, Broken(make_route(cell, torch.device("cpu")), FAULTS[fault]))
    assert not res["correct"], res["check"]
    assert res["failed"] >= 1


@pytest.mark.parametrize("name", sorted(SMALL))
def test_half_the_pressure_sweeps_fails(name):
    """The program's step with 6 Jacobi sweeps where the configuration
    states 10: the developed flow's pressure, not the start's, shows it."""
    cell = small_cell(name)
    short = dataclasses.replace(cell, config=dict(cell.config, n_jacobi=6))
    res = run(cell, make_route(short, torch.device("cpu")))
    assert not res["correct"], res["check"]
    assert res["check"]["flow_rel_l2"]["value"] > res["check"]["flow_rel_l2"]["limit"]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_fails(name):
    cell = small_cell(name)
    res = run(cell, StandIn(make_route(cell, torch.device("cpu")), cell.config, torch.bfloat16))
    assert not res["correct"], res["check"]


def test_altered_metrics_line_fails(monkeypatch):
    metrics_line = load_module("frames", "metrics_line")
    cell = small_cell("dambreak2d-512.mono")
    real = metrics_line.Frame.run

    def altered(self, state, istep, index):
        line = real(self, state, istep, index)
        head, tail = line.split("max|u|=")
        value, rest = tail.split(" ", 1)
        return f"{head}max|u|={float(value) * 1.01:.3e} {rest}"

    monkeypatch.setattr(metrics_line.Frame, "run", altered)
    res = run(cell)
    assert not res["correct"] and res["check"]["line_units"]["value"] > res["check"][
        "line_units"]["limit"]


def test_altered_picture_fails(monkeypatch):
    from PIL import Image

    vof_png = load_module("frames", "vof_png")
    cell = small_cell("dambreak2d-512.cli")
    real = vof_png.Frame.run

    def altered(self, state, istep, index):
        path = real(self, state, istep, index)
        with Image.open(path) as im:
            img = im.convert("RGB")
        img.putpixel((3, 3), (255, 0, 0))
        img.save(path)
        return path

    monkeypatch.setattr(vof_png.Frame, "run", altered)
    res = run(cell)
    assert not res["correct"] and res["check"]["png_index_gap"]["value"] == 256


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


@pytest.mark.cuda
def test_one_short_cell_on_the_card(card):
    """The command as the benchmark runs it, on the card, for two seconds."""
    import json
    import subprocess

    out = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                          "dambreak2d-512.mono", "--seed", str(SEED), "--seconds", "2",
                          "--trace", "0"], capture_output=True, text=True, timeout=900,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["kind"] == card
    assert set(res["metrics"]) == {"cell_updates_per_s", "frame_ms_p95", "setup_s"}
