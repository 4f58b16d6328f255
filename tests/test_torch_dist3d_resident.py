"""Decomp3D's resident driver (init_shards, start, advance, line, finish),
the CLI's ``--three-d --mesh`` path on it, and its spans and counter.

On the CPU, f64, a 48³ grid on a 2x2 virtual mesh with the fixed 10-sweep
Jacobi (W = Wy = 14, blocks of 54 x 54 x 50), where the kernel wrappers
run their plain versions: the resident path equals the serial
simulate_3d bit for bit frame by frame, its per-shard line equals the
gathered state's, and its initial blocks equal init_state_3d's sliced.
The CLI's mesh path makes no whole-grid state and gathers only for a
checkpoint or a VTK frame. Under a profiler the resident driver records its spans;
without one they are the shared no-op, and ``HALO`` counts the halo's
bytes as the engine's geometry predicts.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tpuvof_torch as tt
from tpuvof_torch import cli
from tpuvof_torch.ops import apply_bc_3d
from tpuvof_torch.parallel import Mesh, dist3d
from tpuvof_torch.utils import span
from tpuvof_torch.utils.profiling import recording

G48 = tt.Grid3D(48, 48, 48)
DT = 2e-4  # the flow moves within the 21 steps
CPU = ["--device", "cpu", "--backend", "torch"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (as the other 3-D
    test files): the gate's worker processes share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _decomp(g=G48, **kw):
    devices = np.empty(4, dtype=object)
    devices[:] = [torch.device("cpu")] * 4
    return tt.Decomp3D(g, Mesh(devices.reshape(2, 2), ("mx", "my")), dt=DT, **kw)


def _line_of(state):
    """The serial CLI's line numbers of a whole state, the mass in f64."""
    F = state.F.double()
    return float(F[1:-1, 1:-1, 1:-1].sum()), float(F.min()), float(F.max())


def _random_state(g, seed):
    rng = np.random.default_rng(seed)
    F = np.clip(rng.normal(0.5, 0.4, g.shape), 0, 1)
    u, v, w = (rng.normal(0, 1.0, g.shape) for _ in range(3))
    p = rng.normal(0, 10.0, g.shape)
    u, v, w, F, p = apply_bc_3d(*map(torch.as_tensor, (u, v, w, F, p)))
    return tt.State3D(F=F, u=u, v=v, w=w, p=p)


@pytest.mark.parametrize("istep0", [0, 1])
def test_resident_path_equals_serial(istep0):
    """Three frames of 7 steps on the resident blocks against simulate_3d
    on 'cuda' (the kernels' plain versions), bit for bit after every
    frame, from either phase of the sweep rotation; each frame's line
    equals the serial state's."""
    dec = _decomp()
    assert dec.pencil and dec.W == dec.Wy == 14
    blocks = dec.start(dec.init_shards(1, torch.float64))
    serial = tt.init_state_3d(G48, 1, "cpu", torch.float64)
    done = istep0
    for _ in range(3):
        blocks = dec.advance(blocks, 7, istep0=done)
        serial = tt.simulate_3d(G48, serial, 7, DT, 10, backend="cuda", istep0=done)
        done += 7
        got = dec.finish(blocks)
        for name, a, b in zip("Fuvwp", got, serial):
            assert torch.equal(a, b), name
        mass, lo, hi = dec.line(blocks)
        want = _line_of(serial)
        assert mass == pytest.approx(want[0], rel=1e-14, abs=0) and (lo, hi) == want[1:]
    assert float(serial.v.abs().max()) > 1e-3  # the flow moved


def test_shard_line_equals_gathered_line():
    """On a random state, as the engine's blocks and as the torch engine's
    ring shards: the per-shard numbers equal the gathered state's, and the
    printed lines are the same string."""
    state = _random_state(G48, 7)
    for backend in ("cuda", "torch"):
        dec = _decomp(backend=backend)
        blocks = dec.start(dec.scatter_state(state))
        got = dec.line(blocks)
        want = _line_of(dec.finish(blocks))
        assert got[0] == pytest.approx(want[0], rel=1e-14, abs=0)
        assert got[1:] == want[1:]
        assert cli._export_line(9, *got) == cli._export_line(9, *want)


@pytest.mark.parametrize("ic", [1, 2, 3])
def test_init_shards_equal_init_state_sliced(ic):
    dec = _decomp()
    whole = tt.init_state_3d(G48, ic, "cpu", torch.float64)
    for got, want in zip(dec.init_shards(ic, torch.float64), dec.scatter_state(whole)):
        for a, b in zip(got, want):
            assert a.dtype == torch.float64 and torch.equal(a, b)


def _ckpt(path):
    z = np.load(path)
    return [z[k] for k in "Fuvwp"]


def test_cli_mesh_never_gathers_without_frames(tmp_path, monkeypatch):
    """--three-d --mesh --no-frames makes no whole-grid state (neither the
    initial one nor a gathered one) and prints one line a frame; with
    --checkpoint-every it gathers once a checkpoint, and the checkpoint
    equals the serial run's bit for bit."""
    gathers = []
    real_gather = dist3d.Decomp3D.gather_state

    def counted(self, shards, device=None):
        gathers.append(device)
        return real_gather(self, shards, device)

    def no_whole_state(*a, **k):
        raise AssertionError("the mesh path made a whole-grid initial state")

    monkeypatch.setattr(dist3d.Decomp3D, "gather_state", counted)
    monkeypatch.setattr(tt.state, "init_state_3d", no_whole_state)
    flags = CPU + ["--three-d", "--nx", "24", "--steps", "21", "--frame-every", "7"]
    rc = cli.main(flags + ["--mesh", "2,2", "--no-frames", "--outdir", str(tmp_path / "a")])
    assert rc == 0 and gathers == []
    rc = cli.main(flags + ["--mesh", "2,2", "--no-frames", "--checkpoint-every", "21",
                           "--outdir", str(tmp_path / "b")])
    assert rc == 0 and gathers == ["cpu"]
    monkeypatch.undo()
    rc = cli.main(flags + ["--no-frames", "--checkpoint-every", "21",
                           "--outdir", str(tmp_path / "c")])
    assert rc == 0
    for k, a, b in zip("Fuvwp", _ckpt(tmp_path / "b" / "ckpt_000021.npz"),
                       _ckpt(tmp_path / "c" / "ckpt_000021.npz")):
        assert np.array_equal(a, b), k


def test_cli_mesh_lines(tmp_path, capsys):
    """One export line a frame, in the serial CLI's format."""
    rc = cli.main(CPU + ["--three-d", "--mesh", "2,2", "--nx", "16", "--steps", "6",
                         "--frame-every", "2", "--no-frames", "--outdir", str(tmp_path)])
    assert rc == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "Exporting" in ln]
    assert [ln.split()[2] for ln in lines] == ["step-00002", "step-00004", "step-00006"]
    assert all(" mass=" in ln and " range=[" in ln for ln in lines)


def _halo_bytes_a_step(dec, itemsize: int) -> int:
    """The refresh's bytes by the engine's geometry: on each of the four
    shards one x copy of (W+1) planes and one y copy of (Wy+1) rows, each
    over the block's other extents, for five fields."""
    nz2 = dec.g.nz + 2
    x = (dec.W + 1) * (dec.nyE + 2) * nz2
    y = (dec.Wy + 1) * (dec.nloc + 2) * nz2
    return 4 * 5 * (x + y) * itemsize


def test_spans_and_halo_counter_under_a_profiler(tmp_path):
    """Under torch.profiler: one tv.simulate an advance call, one tv.halo a
    step (plus the entry's ghost exchange), one tv.shard_line a line, the
    blocks the same bit for bit as without it; HALO gains a step's bytes
    each step, with no peer copy on one device."""
    g = tt.Grid3D(32, 32, 8, Lz=0.025)
    dec = _decomp(g, n_jacobi=2)
    plain = dec.advance(dec.start(dec.init_shards(1, torch.float64)), 3)
    before = dict(dist3d.HALO)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        blocks = dec.start(dec.init_shards(1, torch.float64))
        blocks = dec.advance(blocks, 3)
        dec.line(blocks)
    after = dict(dist3d.HALO)
    for a, b in zip(plain, blocks):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X" and e["name"].startswith("tv.")]
    assert names.count("tv.simulate") == 1
    assert names.count("tv.halo") == 3 + 1
    assert names.count("tv.shard_line") == 1
    assert after["steps"] - before["steps"] == 3
    assert after["refreshes"] - before["refreshes"] == 4
    assert after["peer_copies"] == before["peer_copies"]
    entry = after["bytes"] - before["bytes"] - 3 * _halo_bytes_a_step(dec, 8)
    assert 0 < entry < _halo_bytes_a_step(dec, 8)  # the entry's one-layer exchange


def test_spans_cost_nothing_without_a_profiler():
    """With no profiler every span of the resident driver is the shared no-op,
    and stepping records nothing."""
    assert span("tv.halo") is span("tv.simulate") is span("tv.shard_line")
    dec = _decomp(tt.Grid3D(32, 32, 8, Lz=0.025), n_jacobi=2)
    before = dist3d.HALO["steps"]
    dec.line(dec.advance(dec.start(dec.init_shards(1, torch.float64)), 2))
    assert dist3d.HALO["steps"] == before + 2
    assert not recording()
