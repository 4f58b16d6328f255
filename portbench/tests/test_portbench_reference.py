"""The plain reference against tpuvof_torch's plain path on the CPU, in
float64, at 64^2 and 16^3: the same state, Courant report, metrics and
picture."""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))

import tpuvof_torch as tt  # noqa: E402
from portbench.cases import dambreak  # noqa: E402
from portbench.harness import load_cell  # noqa: E402
from portbench.reference.flow2d import Flow2D  # noqa: E402
from portbench.reference.flow3d import Flow3D  # noqa: E402
from portbench.routes.simulate import port_config  # noqa: E402


def _config(name: str, n: int) -> dict:
    cfg = dict(load_cell(name).config, nx=n, ny=n, dtype="float64")
    if cfg["dims"] == 3:
        cfg["nz"] = n
    return cfg


def _state2d(n=64, shift=(2, -2)):
    cfg = _config("dambreak2d-512.mono", n)
    return cfg, dambreak.initial_state(cfg, shift, "cpu")


@pytest.mark.parametrize("backend", ["cuda_mono", "cuda", "torch"])
@pytest.mark.parametrize("istep0", [0, 7])
def test_2d_state_equals_the_port(backend, istep0):
    cfg, s = _state2d()
    pc = port_config(cfg, {"backend": backend})
    got = tt.simulate(pc, tt.State(*s), 30, istep0=istep0)
    want = Flow2D(cfg).advance(s, 30, istep0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12 * float(b.abs().max()))


def test_2d_cfl_report_equals_the_port():
    cfg, s = _state2d()
    pc = port_config(cfg, {"backend": "cuda"})
    got, rep = tt.simulate_cfl(pc, tt.State(*s), 25, istep0=100)
    want, r = Flow2D(cfg).advance(s, 25, 100, track_cfl=True,
                                  probe=(rep["step"], rep["axis"], rep["i"], rep["j"]))
    for k in ("cfl", "step", "axis", "i", "j", "violations", "first_step"):
        assert rep[k] == pytest.approx(r[k], rel=1e-12), k
    assert r["at_probe"] == pytest.approx(r["cfl"], rel=1e-12)


def test_2d_metrics_and_picture_equal_the_port(tmp_path):
    from PIL import Image

    from tpuvof_torch.io_utils import save_frame_png
    from tpuvof_torch.viz import render_frame

    cfg, s = _state2d()
    pc = port_config(cfg, {"backend": "cuda_mono"})
    ref = Flow2D(cfg)
    state = ref.advance(s, 40, 0)
    m = tt.compute_metrics(pc, tt.State(*state))
    want = ref.metrics(state)
    for k in want:
        assert float(getattr(m, k)) == pytest.approx(want[k], rel=1e-12), k
    path = tmp_path / "f.png"
    save_frame_png(str(path), render_frame(pc, tt.State(*state), "vof"))
    with Image.open(path) as im:
        got = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(got, ref.vof_image(state[0]))


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("istep0", [0, 4])
def test_3d_state_equals_the_port(backend, istep0):
    cfg = _config("dambreak3d-200.frames", 16)
    s = dambreak.initial_state(cfg, (-2, 2, 2), "cpu")
    g = tt.Grid3D(16, 16, 16)
    got = tt.simulate_3d(g, tt.State3D(*s), 20, cfg["dt"], cfg["n_jacobi"],
                         fl=tt.Fluid(**cfg["fluid"]), backend=backend, istep0=istep0)
    want = Flow3D(cfg).advance(s, 20, istep0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12 * max(float(b.abs().max()), 1e-30))


def test_3d_readback_line_numbers():
    cfg = _config("dambreak3d-200.frames", 16)
    s = dambreak.initial_state(cfg, (0, 0, 0), "cpu")
    r = Flow3D.readback(s[0])
    assert r == {"mass": float(s[0][1:-1, 1:-1, 1:-1].sum()), "min": 0.0, "max": 1.0}


def test_initial_state_is_the_sources_block_moved():
    cfg = _config("dambreak2d-512.mono", 64)
    F = dambreak.initial_state(cfg, (0, 0), "cpu")[0]
    # the source's test at node coordinates: x <= Lx/3, y <= Ly/2
    xn = np.clip(np.arange(66) - 1, 0, 64) * (0.1 / 64)
    inside = (xn[:, None] <= 0.1 / 3 + 1e-12) & (xn[None, :] <= 0.05 + 1e-12)
    np.testing.assert_array_equal(F.numpy() == 1.0, inside)
    moved = dambreak.initial_state(cfg, (2, -2), "cpu")[0]
    assert int(moved[:, 0].sum()) == int(F[:, 0].sum()) + 2
    assert int(moved[0].sum()) == int(F[0].sum()) - 2


def test_every_seed_runs_the_same_set_of_jobs():
    import random

    cfg = _config("dambreak3d-200.frames", 16)
    a = dambreak.job_order(cfg, random.Random(1))
    b = dambreak.job_order(cfg, random.Random(2 ** 40 + 3))
    assert sorted(a) == sorted(b) and a != b and len(a) == 64


def test_index_gap_counts_table_entries():
    from portbench.frames.vof_png import index_gap

    table = np.array([[0, 0, 0], [1, 1, 1], [1, 1, 1], [5, 5, 5]], np.uint8)
    image = np.array([[[1, 1, 1], [5, 5, 5], [9, 9, 9], [0, 0, 0]]], np.uint8)
    # entries 1 and 2 share a colour; (9, 9, 9) is no entry's
    got = index_gap(image, np.array([[0, 1, 2, 0]]), table)
    np.testing.assert_array_equal(got, [[1, 2, 256, 0]])
