"""The mesh cell ``dambreak3d-big.decomp4`` on the CPU: its judged-box
reference, its five per-layer readers, and its check.

The box-cone reference (reference/cone3d.py) equals flow3d.py's whole-grid
run on a box's cells, f64, at 48³: over 10 steps (the cell's frame, where
the cone reaches the walls), and over 1 and 2 steps with cones inside the
grid, where one plane less a step would not do. The readers read
synthetic traces, and nothing where there is nothing to read. The cell
runs at 48³ on a 2x2 virtual mesh of the CPU with its own limits: it
passes the program, and fails with the y seam's refresh skipped, with one
halo plane left stale, with an altered line, and on the control (the
reference in bfloat16 on the kept inputs). A program without the resident
driver fails when the route is made.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))

from portbench.harness import RunRecord, load_cell, load_module, make_route, run_cell  # noqa: E402
from portbench.reference.cone3d import ConeFlow3D, cone, crop, reach  # noqa: E402
from portbench.reference.flow3d import Flow3D  # noqa: E402
from portbench.trace import TraceData  # noqa: E402

CELL = "dambreak3d-big.decomp4"
SEED = 2 ** 33 + 12345
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def small_cell():
    """The cell at 48³ (24³ pencils, the 14-plane halos fit), its time step
    grown 4x as the 3-D cell's small copy has it, boxes that keep the
    cell's: one on both seams and the dam's top, one on the floor, the x
    seam and the dam's bottom edge; one job of two frames, job 0's first
    kept."""
    cell = load_cell(CELL)
    cell.config = dict(cell.config, nx=48, ny=48, nz=48, dt=cell.config["dt"] * 4,
                       boxes=[{"lo": [12, 16, 8], "hi": [36, 32, 24]},
                              {"lo": [12, 0, 12], "hi": [30, 6, 20]}])
    cell.traffic = dict(cell.traffic, steps=20, check_frames=1, trace_frames=1)
    return cell


def run(cell, trace: bool = False):
    return run_cell(cell, SEED, 0.0, trace, "cpu", time.time(), until_samples=True)


# ----------------------------------------------------------------------
# the box-cone reference
# ----------------------------------------------------------------------
CONFIG = dict(json.loads((ROOT / "portbench/configs/dambreak3d-big.json").read_text()),
              nx=48, ny=48, nz=48, dt=2e-4)


def _random_state(seed):
    rng = np.random.default_rng(seed)
    shape = (50, 50, 50)
    F = np.clip(rng.normal(0.5, 0.4, shape), 0, 1)
    u, v, w = (rng.normal(0, 1.0, shape) for _ in range(3))
    p = rng.normal(0, 10.0, shape)
    return tuple(torch.as_tensor(a) for a in (F, u, v, w, p))


def _on_cone(state, box, steps, margin=None):
    m = steps * reach(10) if margin is None else margin
    ranges = tuple((max(lo + 1 - m, 0), min(hi + 1 + m, 50)) for lo, hi in box)
    sub = tuple(a[tuple(slice(a0, b0) for a0, b0 in ranges)] for a in state)
    return ConeFlow3D(CONFIG).advance(sub, steps, 0), ranges


BOXES = {
    "frame, cone on the walls": (10, ((18, 30), (20, 28), (16, 32))),
    "one step, cone inside": (1, ((18, 30), (20, 28), (16, 32))),
    "two steps at the x wall": (2, ((0, 6), (20, 26), (18, 24))),
    "one step at a corner": (1, ((40, 48), (0, 8), (20, 28))),
}


@pytest.mark.parametrize("case", list(BOXES))
def test_cone_reference_equals_whole_grid(case):
    steps, box = BOXES[case]
    state = _random_state(1)
    whole = Flow3D(CONFIG).advance(state, steps, 0)
    out, ranges = _on_cone(state, box, steps)
    assert ranges == cone(box, steps, 10, (48, 48, 48))
    full = ((0, 50),) * 3
    for name, a, b in zip("Fuvwp", out, whole):
        assert torch.equal(crop(a, box, ranges), crop(b, box, full)), name
    if case == "one step, cone inside":
        # the cone is tight: a plane less a side and F differs on the box
        short, r = _on_cone(state, box, steps, margin=reach(10) - 1)
        assert not torch.equal(crop(short[0], box, r), crop(whole[0], box, full))


# ----------------------------------------------------------------------
# the readers
# ----------------------------------------------------------------------
def _record(trace, cards=4):
    route = SimpleNamespace(cards=cards, shape=(1154,) * 3, cells=1152 ** 3, dtype="float32",
                            n_jacobi=10)
    return RunRecord(spans=[], trace=trace, route=route, config={}, traffic={},
                     device_kind=H100)


def _trace():
    """A 1000 µs sub-window of 10 steps: one solver span; on the cards two
    kernels of 300 µs, one peer copy of 50 µs and a host-to-device copy of
    10 µs, one of the kernels half outside the window; the program's
    tv.simulate holding two tv.halo spans of 20 µs."""
    device = [("kernel", "jacobi3d_kernel", 100.0, 300.0), ("kernel", "predict3d", 850.0, 300.0),
              ("gpu_memcpy", "Memcpy PtoP (Device -> Device)", 500.0, 50.0),
              ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 600.0, 10.0)]
    spans = [("portbench.solver", 50.0, 900.0)]
    cpu = [("tv.simulate", 60.0, 800.0), ("tv.halo", 70.0, 20.0), ("tv.halo", 200.0, 20.0)]
    return TraceData(window=(0.0, 1000.0), device=device, spans=spans, cpu_ops=cpu, steps=10)


def _read(name, rec):
    return load_module("metrics", name).read(rec)


def test_readers_on_a_synthetic_trace(monkeypatch):
    from tpuvof_torch.parallel import dist3d

    rec = _record(_trace())
    # 300 + 150 (clipped) + 50 + 10 µs busy of 4 x 1000
    assert _read("mesh_idle_pct", rec) == pytest.approx(100.0 * (1 - 510.0 / 4000.0))
    assert _read("halo_us_per_step", rec) == pytest.approx(4.0)
    assert _read("peer_copy_ms_per_step", rec) == pytest.approx(0.005)
    from portbench.roofline import least_time

    bound = least_time(H100, (1154,) * 3, 1152 ** 3, "float32", 10, 10)[0]
    # both kernels start inside the solver span: 600 µs of kernel time
    assert _read("shard_kernels_roofline", rec) == pytest.approx(100.0 * bound / 600e-6)
    monkeypatch.setattr(dist3d, "HALO", {"refreshes": 7, "steps": 4, "copies": 8,
                                         "peer_copies": 8, "bytes": 1000})
    assert _read("halo_bytes_per_step", rec) == 250.0


def test_readers_read_nothing_where_nothing_is(monkeypatch):
    from tpuvof_torch.parallel import dist3d

    names = ("mesh_idle_pct", "halo_us_per_step", "peer_copy_ms_per_step",
             "shard_kernels_roofline")
    for name in names:
        assert _read(name, _record(None)) is None, name
    empty = TraceData(window=(0.0, 1000.0), steps=10)
    for name in names:
        assert _read(name, _record(empty)) is None, name
    # a one-card route, and a trace without the program's halo spans
    assert _read("mesh_idle_pct", _record(_trace(), cards=None)) is None
    assert _read("shard_kernels_roofline", _record(_trace(), cards=None)) is None
    bare = _trace()
    bare.cpu_ops = [op for op in bare.cpu_ops if op[0] != "tv.halo"]
    assert _read("halo_us_per_step", _record(bare)) is None
    monkeypatch.setattr(dist3d, "HALO", {"refreshes": 0, "steps": 0, "copies": 0,
                                         "peer_copies": 0, "bytes": 0})
    assert _read("halo_bytes_per_step", _record(_trace())) is None
    monkeypatch.delattr(dist3d, "HALO")
    assert _read("halo_bytes_per_step", _record(_trace())) is None


# ----------------------------------------------------------------------
# the cell's check
# ----------------------------------------------------------------------
def test_case_makes_dambreaks_state_shard_by_shard():
    """The case's shards, gathered, are dambreak.py's whole initial state
    after the BCs; nothing of it was made whole."""
    cell = small_cell()
    route = make_route(cell, torch.device("cpu"))
    dambreak = load_module("cases", "dambreak")
    shards_case = load_module("cases", "dambreak_shards")
    shift = (-6, 2, 6)
    whole = dambreak.initial_state(cell.config, shift, "cpu")
    got = route.dec.gather_state(shards_case.shards(cell.config, shift, route.dec))
    want = route.dec.gather_state(route.dec.scatter_state(whole))
    for name, a, b in zip("Fuvwp", got, want):
        assert torch.equal(a, b), name


def test_program_passes_and_reads_its_metrics():
    res = run(small_cell(), trace=True)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["samples"] == [(0, 0)]
    assert set(res["check"]) == {"F_rel_l2.start", "flow_rel_l2.start", "line_units"}
    assert res["metrics"]["halo_bytes_per_step"]["value"] > 0
    assert res["metrics"]["halo_us_per_step"]["value"] > 0


def _x_stage_only(arrs, px, py, widths=(0, 0), off=0, counts=None):
    """halo.refresh_ with its y stage left out."""
    w = widths[0]
    n = arrs[0].shape[0] - 2 - 2 * (off + w)
    for k, dst in enumerate(arrs):
        if k // py > 0:
            dst.narrow(0, off, w + 1).copy_(arrs[k - py].narrow(0, off + n, w + 1))
        if k // py < px - 1:
            dst.narrow(0, off + w + n + 1, w + 1).copy_(arrs[k + py].narrow(0, off + w + 1, w + 1))
    return arrs


def _y_seam_skipped(monkeypatch):
    """Every step's refresh of the y seam left out (the x seam's kept)."""
    from tpuvof_torch.parallel import dist3d, halo

    def refresh(arrs, px, py, widths=(0, 0), off=0, counts=None):
        if widths == (0, 0):
            return halo.refresh_(arrs, px, py, widths, off, counts)
        return _x_stage_only(arrs, px, py, widths, off, counts)

    monkeypatch.setattr(dist3d, "refresh_", refresh)


def _ghost_row_stale(monkeypatch):
    """The innermost halo plane on each block's low y side (the ghost row
    next to its owned cells) keeps, through a frame, what it held after the
    frame's first refresh."""
    from tpuvof_torch.parallel import dist3d

    real_refresh, real_advance = dist3d.Decomp3D._refresh, dist3d.Decomp3D.advance
    held = {}

    def refresh(self, shards, W, Wy):
        real_refresh(self, shards, W, Wy)
        if W == 0:
            return
        rows = [[a.narrow(1, Wy, 1) for a in s] for s in shards]
        if not held:
            held["rows"] = [[r.clone() for r in s] for s in rows]
        for s, h in zip(rows, held["rows"]):
            for r, old in zip(s, h):
                r.copy_(old)

    def advance(self, blocks, n_steps, istep0=0):
        held.clear()
        return real_advance(self, blocks, n_steps, istep0)

    monkeypatch.setattr(dist3d.Decomp3D, "_refresh", refresh)
    monkeypatch.setattr(dist3d.Decomp3D, "advance", advance)


BROKEN = {"y_seam_skipped": _y_seam_skipped, "ghost_row_stale": _ghost_row_stale}


@pytest.mark.parametrize("fault", sorted(BROKEN))
def test_broken_program_fails(fault, monkeypatch):
    BROKEN[fault](monkeypatch)
    res = run(small_cell())
    assert not res["correct"], res["check"]
    assert res["check"]["flow_rel_l2.start"]["value"] > res["check"]["flow_rel_l2.start"]["limit"]


def test_altered_line_fails(monkeypatch):
    frames = load_module("frames", "shard_lines")
    real = frames.Frame.run

    def altered(self, state, istep, index):
        line = real(self, state, istep, index)
        head, tail = line.split("mass=")
        value, rest = tail.split(" ", 1)
        return f"{head}mass={float(value) + 0.3:.1f} {rest}"

    monkeypatch.setattr(frames.Frame, "run", altered)
    res = run(small_cell())
    assert not res["correct"]
    assert res["check"]["line_units"]["value"] > res["check"]["line_units"]["limit"]


def test_control_fails():
    """readings.py's control: the reference in bfloat16 advancing the kept
    frame's input cones in the program's place; judged as the program is,
    it fails the state's limits, and has no line."""
    from portbench.readings import one

    cell = small_cell()
    res = one(cell, SEED, make_route(cell, torch.device("cpu")), torch.device("cpu"), True)
    assert res["error"] is None and res["kept"] == [(0, 0)]
    mine, ctrl = res["worst"], res["control_worst"]
    for k in ("F_rel_l2.start", "flow_rel_l2.start"):
        assert mine[k] <= cell.limits[k] < ctrl[k], (k, mine[k], ctrl[k])
    assert ctrl["line_units"] == float("inf")


def test_program_without_the_resident_driver_fails_at_once(monkeypatch):
    from tpuvof_torch.parallel import dist3d

    monkeypatch.delattr(dist3d.Decomp3D, "start")
    with pytest.raises(RuntimeError, match="no resident driver"):
        make_route(small_cell(), torch.device("cpu"))
