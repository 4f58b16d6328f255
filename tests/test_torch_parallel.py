"""The port's 2-D domain decomposition, tpuvof_torch.parallel.Decomp
(tests/test_parallel.py's analogs), against the port's serial simulate and
tpuvof's serial simulate.

CPU meshes, one controller, f64; on CPU tensors the kernel wrappers run
their plain versions. Every case must equal the port's serial route bit
for bit ('torch' for the torch engine, 'cuda_mono' for the whole-step
engines, the 'cuda' hybrid), and tpuvof's serial XLA path, run eagerly
(jax.disable_jit(): jitted tpuvof contracts FMAs), at tpuvof's own bars
(1e-12, p 1e-7; the whole-step engines 1e-13, p 1e-9). The residual-driven
solves also take the serial trip count, counted by the calls of the loop
test (ops.poisson.keep_iterating).

The ``cuda``-marked tests run each engine on a card (a virtual 2x2 mesh on
cuda:0) against the serial route there, bit for bit, with its launch
counts; they need no jax: ``pytest tests/test_torch_parallel.py
--noconftest -m cuda``.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import tpuvof_torch as tt
import tpuvof_torch.ops.mg as omg
import tpuvof_torch.ops.poisson as tpoisson
import tpuvof_torch.parallel.mg as pmg
from tpuvof_torch.kernels import step_kernels as K
from tpuvof_torch.parallel import Decomp, Mesh

CPU = torch.device("cpu")
JACOBI_BARS = dict(F=1e-12, u=1e-12, v=1e-12, p=1e-7)
KERNEL_BARS = dict(F=1e-13, u=1e-13, v=1e-13, p=1e-9)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def loop_tests(monkeypatch):
    """Calls of the residual-driven loops' test, serial and distributed."""
    calls = [0]
    real = tpoisson.keep_iterating

    def counted(*a):
        calls[0] += 1
        return real(*a)

    for mod in (tpoisson, omg, pmg):
        monkeypatch.setattr(mod, "keep_iterating", counted)
    return calls


def _mesh(px, py, dev=CPU):
    devices = np.empty(px * py, dtype=object)
    devices[:] = [torch.device(dev)] * (px * py)
    return Mesh(devices.reshape(px, py), ("mx", "my"))


def _cfg(n, backend="torch", **num):
    return tt.dam_break_2d(n, num=tt.Numerics(backend=backend, **num))


def _state(cfg, ic=1):
    return tt.init_state(cfg, ic, "cpu", torch.float64)


def _assert_equal(got, want, region=(slice(None), slice(None))):
    for name, a, b in zip("Fuvp", got, want):
        assert torch.equal(a[region], b[region]), (name, (a - b)[region].abs().max().item())


@functools.lru_cache(maxsize=None)
def _tpuvof_states(n, ic, steps, solver="jacobi", perturbed=False):
    """tpuvof's serial XLA states after 1..steps steps from the port's
    initial state, eagerly: the entry BC, then lean steps in parity order,
    as its simulate takes them; numpy f64."""
    import jax
    import jax.numpy as jnp

    import tpuvof as tv
    from tpuvof.ops import apply_bc as jbc
    from tpuvof.solver import step

    num = dict(pressure_solver=solver, sor_tol=1e-6, sor_max_iter=500) if solver != "jacobi" \
        else {}
    cfg = tv.SimConfig(grid=tv.Grid2D(n, n), num=tv.Numerics(**num))
    F, u, v, p = (jnp.asarray(a.numpy()) for a in (_perturbed(n) if perturbed
                                                    else _state(_cfg(n), ic)))
    u, v, F, p = jbc(u, v, F, p)
    s = tv.State(F=F, u=u, v=v, p=p)
    out = []
    with jax.disable_jit():
        for k in range(steps):
            s = step(cfg, s, even_step=(k + 1) % 2 == 0, lean=True)
            out.append(tuple(np.asarray(a) for a in s))
    return out


def _assert_tpuvof(got, n, ic, steps, bars=JACOBI_BARS, **kw):
    want = _tpuvof_states(n, ic, steps, **kw)[steps - 1]
    I = (slice(1, -1),) * 2
    for name, a, b in zip("Fuvp", got, want):
        np.testing.assert_allclose(a.numpy()[I], b[I], rtol=0, atol=bars[name], err_msg=name)


def _perturbed(n):
    """A start whose ghost ring is not BC-consistent (tpuvof's
    test_distributed_matches_serial_from_non_bc_consistent_state)."""
    F, u, v, p = _state(_cfg(n))
    F = F.clone()
    F[0, :] += 0.01
    F[:, -1] -= 0.02
    u = u.clone()
    u[0, :] += 1e-3
    return tt.State(F=F, u=u, v=v, p=p)


@pytest.mark.parametrize("px,py,n_steps", [(2, 4, 9), (4, 2, 8), (1, 8, 5), (8, 1, 4),
                                           (2, 2, 6)])
def test_dist_matches_serial(px, py, n_steps):
    """The torch engine on every layout, (1, 8) and (8, 1) with blocks two
    cells thick: equal to the serial 'torch' run, and to tpuvof's."""
    cfg = _cfg(16)
    s0 = _state(cfg)
    dec = Decomp(cfg, _mesh(px, py))
    assert dec.engine == "torch"
    got = dec.simulate(s0, n_steps)
    _assert_equal(got, tt.simulate(cfg, s0, n_steps))
    _assert_tpuvof(got, 16, 1, n_steps)


@pytest.mark.parametrize("ic", [2, 3])
def test_dist_other_ics(ic):
    cfg = _cfg(16)
    s0 = _state(cfg, ic)
    got = Decomp(cfg, _mesh(2, 4)).simulate(s0, 6)
    _assert_equal(got, tt.simulate(cfg, s0, 6))
    _assert_tpuvof(got, 16, ic, 6)


def test_indivisible_grid_rejected():
    with pytest.raises(ValueError, match="not divisible"):
        Decomp(_cfg(18), _mesh(2, 4))
    with pytest.raises(ValueError, match="2-D mesh"):
        Decomp(_cfg(16), tt.make_mesh(4, ("mx",), [CPU] * 4))


def _kernel_engine_case(dec, steps):
    """The engine's run from the 64^2 dam break: equal to the serial
    'cuda_mono' run bit for bit and to tpuvof's at its kernel bars."""
    s0 = _state(dec.cfg)
    got = dec.simulate(s0, steps)
    _assert_equal(got, tt.simulate(_cfg(64, "cuda_mono"), s0, steps))
    _assert_tpuvof(got, 64, 1, steps, bars=KERNEL_BARS)


def test_distributed_full_block_matches_serial():
    """One fullstep_win per shard on resident blocks extended by W = 22:
    64^2 over 2x2 gives 32^2 blocks, each halo from one neighbour."""
    for backend in ("cuda_mono", "cuda"):
        dec = Decomp(_cfg(64, backend), _mesh(2, 2))
        assert (dec.engine, dec.W) == ("full", 22)
    _kernel_engine_case(dec, 4)


def test_distributed_tiled_matches_serial():
    """The tiled engine with tiles narrower than W = 22 and an odd step
    count (both parities)."""
    for px, py, tile in ((2, 2, 16), (1, 2, 8)):
        dec = Decomp(_cfg(64, "cuda_mono"), _mesh(px, py), tile=tile)
        assert (dec.engine, dec.tile) == ("tiled", (tile, tile))
        _kernel_engine_case(dec, 5)


def test_distributed_strips_matches_serial():
    """The strips engine on both mesh orientations and corners (2x2) over
    an odd step count, with NaN in every cell of the resident layout that
    no refresh or launch writes: the kernel's load sanitizer and the
    (W+1)-band refresh at offset W2 - W keep it out of every kept cell."""
    s0 = _state(_cfg(64))
    want = tt.simulate(_cfg(64, "cuda_mono"), s0, 5)
    for px, py in ((2, 2), (1, 2), (2, 1)):
        dec = Decomp(_cfg(64, "cuda_strips"), _mesh(px, py))
        assert (dec.engine, dec.W, dec.W2) == ("strips", 22, 24)
        blocks = dec.widen(dec.scatter_state(s0))
        off = dec.W2 - dec.W
        for b in blocks:
            for a in b:
                a[:off] = float("nan")
                a[-off:] = float("nan")
                a[:, :off] = float("nan")
                a[:, -off:] = float("nan")
        got = dec.gather_state(dec.narrow(dec.advance(blocks, 5)))
        _assert_equal(got, want)
    _assert_tpuvof(got, 64, 1, 5, bars=KERNEL_BARS)


def test_shard_tile_validation():
    """tile must divide the local blocks; by default the tiled engine
    takes solver.TILE_ROWS rows where they divide, else the whole block;
    'cuda' and 'cuda_mono' take the full-block engine at any size."""
    cfg = _cfg(64, "cuda_mono")
    with pytest.raises(ValueError, match="does not divide"):
        Decomp(cfg, _mesh(2, 2), tile=24)
    assert Decomp(cfg, _mesh(2, 2)).tile is None
    assert Decomp(_cfg(64, "cuda_tiled"), _mesh(2, 2)).tile == (32, 32)
    assert Decomp(_cfg(512, "cuda_tiled"), _mesh(2, 2)).tile == (128, 256)
    assert Decomp(_cfg(512, "cuda_tiled"), _mesh(2, 2), tile=(64, 128)).tile == (64, 128)
    assert Decomp(_cfg(4096, "cuda_mono"), _mesh(1, 1)).engine == "full"


def test_shard_engine_routing_and_validation():
    """Each backend reaches its engine, tile= takes the tiled one from any
    whole-step backend, and an engine that cannot run raises instead of
    degrading; the trajectory through the strips engine equals the serial
    one."""
    mesh = _mesh(2, 2)
    routes = {"torch": "torch", "cuda": "full", "cuda_mono": "full", "cuda_tiled": "tiled",
              "cuda_strips": "strips"}
    for backend, engine in routes.items():
        assert Decomp(_cfg(64, backend), mesh).engine == engine
        if backend != "torch":
            assert Decomp(_cfg(64, backend), mesh, tile=16).engine == "tiled"
    with pytest.raises(ValueError, match="backend='torch' runs the plain engine"):
        Decomp(_cfg(64), mesh, tile=16)
    # thinner than the W = 22 halo: raise, naming the engine that runs it
    with pytest.raises(ValueError, match=r"strips engine needs nx/px > W=22.*backend='torch'"):
        Decomp(_cfg(64, "cuda_strips"), _mesh(4, 1))
    with pytest.raises(ValueError, match=r"tiled engine needs nx/px > W=22.*backend='torch'"):
        Decomp(_cfg(64, "cuda_mono"), _mesh(4, 1), tile=16)
    with pytest.raises(ValueError, match="ny/py > W=22"):
        Decomp(_cfg(16, "cuda"), _mesh(1, 2))
    with pytest.raises(NotImplementedError, match="bc_between_sweeps"):
        Decomp(_cfg(16, bc_between_sweeps=True), mesh)
    s0 = _state(_cfg(64))
    got = Decomp(_cfg(64, "cuda_strips"), mesh).simulate(s0, 3)
    _assert_equal(got, tt.simulate(_cfg(64, "cuda_mono"), s0, 3))


def test_strips_run_any_block_height():
    """backend='cuda_strips' on 100-row shards (no multiple of 8, where
    tpuvof's strip layout finds no height and it takes its full-block
    engine): the port's strips engine has no height rule and runs them."""
    cfg = _cfg(200, "cuda_strips")
    dec = Decomp(cfg, _mesh(2, 2))
    assert (dec.engine, dec.nxl) == ("strips", 100)
    s0 = _state(cfg)
    _assert_equal(dec.simulate(s0, 3), tt.simulate(_cfg(200, "cuda_mono"), s0, 3))


def test_forced_engine_with_rbsor_raises():
    for backend in ("cuda_mono", "cuda_strips"):
        cfg = _cfg(64, backend, pressure_solver="rbsor")
        with pytest.raises(ValueError, match="HYBRID"):
            Decomp(cfg, _mesh(2, 2), tile=16)


def test_distributed_matches_serial_from_non_bc_consistent_state():
    """Serial simulate applies the BCs once at entry; so must the
    distributed one, or a start whose ghosts are not BC-consistent parts
    from it. Compared on the interior: u's x-ghost row beyond the wall
    face, which no BC writes and no step reads, keeps the start's value in
    the serial run, and the gathered state rebuilds it."""
    s0 = _perturbed(16)
    cfg = _cfg(16)
    got = Decomp(cfg, _mesh(2, 4)).simulate(s0, 4)
    _assert_equal(got, tt.simulate(cfg, s0, 4), (slice(1, -1), slice(1, -1)))
    _assert_tpuvof(got, 16, 1, 4, perturbed=True)


def test_distributed_rbsor_matches_serial(loop_tests):
    """The distributed rbsor: one exchange a half sweep, the nullspace
    mean summed in the serial order, the global max; the serial trip count
    and values bit for bit; tpuvof's serial rbsor at its bars."""
    cfg = _cfg(16, pressure_solver="rbsor", sor_tol=1e-6, sor_max_iter=500)
    s0 = _state(cfg)
    want = tt.simulate(cfg, s0, 5)
    n_serial, loop_tests[0] = loop_tests[0], 0
    got = Decomp(cfg, _mesh(2, 4)).simulate(s0, 5)
    assert loop_tests[0] == n_serial > 20, (loop_tests[0], n_serial)
    _assert_equal(got, want)
    _assert_tpuvof(got, 16, 1, 5, solver="rbsor")


def test_distributed_rbsor_f32_matches_serial(loop_tests):
    """In f32 too: the shards' coefficients are the serial solver's (ap_inv
    from the f64 edge classes, where tpuvof forms it in the dtype and an
    f32 trip count can part from the serial one), so the relative-tolerance
    solve stops where the serial one stops, bit for bit."""
    cfg = _cfg(32, pressure_solver="rbsor", sor_tol_rel=1e-2)
    s0 = tt.init_state(cfg, 1, "cpu")
    want = tt.simulate(cfg, s0, 4)
    n_serial, loop_tests[0] = loop_tests[0], 0
    _assert_equal(Decomp(cfg, _mesh(2, 2)).simulate(s0, 4), want)
    assert loop_tests[0] == n_serial > 8, (loop_tests[0], n_serial)


def test_distributed_rbsor_with_cuda_backend_runs_hybrid(loop_tests):
    """backend='cuda_mono' with rbsor runs the hybrid: predict_win and
    fct_sweep_win around the distributed solve, equal to the serial 'cuda'
    hybrid, trip counts included."""
    num = dict(pressure_solver="rbsor", sor_tol=1e-6, sor_max_iter=500)
    s0 = _state(_cfg(64))
    want = tt.simulate(_cfg(64, "cuda", **num), s0, 3)
    n_serial, loop_tests[0] = loop_tests[0], 0
    dec = Decomp(_cfg(64, "cuda_mono", **num), _mesh(2, 2))
    assert (dec.engine, dec.W) == ("hybrid", K.PHASE_HALO)
    got = dec.simulate(s0, 3)
    assert loop_tests[0] == n_serial
    _assert_equal(got, want)


def test_chunked_with_istep0_and_public_stages():
    """Chunks with istep0 continue the sweep parity; widen, advance, narrow
    and gather_state compose to simulate, and so do start, advance and
    finish; widen leaves its shards as they were."""
    cfg = _cfg(64, "cuda_mono")
    s0 = _state(cfg)
    dec = Decomp(cfg, _mesh(2, 2))
    whole = dec.simulate(s0, 5)
    _assert_equal(dec.simulate(dec.simulate(s0, 2), 3, istep0=2), whole)
    shards = dec.scatter_state(s0)
    kept = [tt.State(*(a.clone() for a in s)) for s in shards]
    blocks = dec.advance(dec.advance(dec.widen(shards), 3), 2, 3)
    _assert_equal(dec.gather_state(dec.narrow(blocks)), whole)
    for a, b in zip(shards, kept):
        _assert_equal(a, b)
    _assert_equal(dec.finish(dec.advance(dec.start(shards), 5)), whole)


#: The engines on a 2x2 mesh: (backend, n, Decomp's keywords, Numerics'
#: keywords); 64^2 gives the whole-step engines their W = 22 halos.
ENGINES = {
    "torch": ("torch", 16, {}, {}),
    "full": ("cuda_mono", 64, {}, {}),
    "tiled": ("cuda_mono", 64, {"tile": 16}, {}),
    "strips": ("cuda_strips", 64, {}, {}),
    "hybrid": ("cuda", 16, {}, dict(pressure_solver="mg", sor_tol=1e-8, sor_max_iter=2000)),
}


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_resident_frames_equal_simulate(engine):
    """The CLI's mesh loop: ``start`` once, ``advance`` a frame at a time
    with istep0 (both parities at a frame's start), ``finish`` after each
    frame; the last frame's state equals ``simulate`` over the same steps
    bit for bit: the entry BC a frame no longer takes changes nothing."""
    backend, n, kw, num = ENGINES[engine]
    cfg = _cfg(n, backend, **num)
    s0 = _state(cfg)
    dec = Decomp(cfg, _mesh(2, 2), **kw)
    assert dec.engine == engine
    blocks, done = dec.start(dec.scatter_state(s0)), 0
    for k in (1, 2, 2):
        blocks = dec.advance(blocks, k, done)
        done += k
        got = dec.finish(blocks, device=s0.F.device)
    _assert_equal(got, dec.simulate(s0, done))


def test_spans_and_halo_counter_under_a_profiler(tmp_path):
    """Under torch.profiler the 2-D Decomp records one tv.simulate an
    advance call and one tv.halo a step of a kernel engine, its blocks the
    same bit for bit as without it; HALO gains each step and the bytes
    the refresh's geometry predicts, with no peer copy on one device."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from tpuvof_torch.parallel import dist3d

    cfg = _cfg(64, "cuda_mono")
    dec = Decomp(cfg, _mesh(2, 2))
    s0 = _state(cfg)
    plain = dec.advance(dec.start(dec.scatter_state(s0)), 2)
    blocks = dec.start(dec.scatter_state(s0))
    before = dict(dist3d.HALO)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        blocks = dec.advance(blocks, 2)
    after = dict(dist3d.HALO)
    for a, b in zip(plain, blocks):
        _assert_equal(a, b)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X" and e["name"].startswith("tv.")]
    assert names.count("tv.simulate") == 1 and names.count("tv.halo") == 2
    assert after["steps"] - before["steps"] == 2
    assert after["refreshes"] - before["refreshes"] == 2
    assert after["peer_copies"] == before["peer_copies"]
    # each shard: one x copy of W+1 rows and one y copy of W+1 columns of
    # the (nxl+2W+2)^2 block, for four fields
    band = (dec.W + 1) * (dec.nxl + 2 * dec.W + 2)
    assert after["bytes"] - before["bytes"] == 2 * 4 * 4 * 2 * band * 8


# ---- on a card: each engine on a virtual 2x2 mesh on cuda:0 ----
def _card_case(backend, n, steps, launches, **kw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    cfg = _cfg(n, backend, **kw)
    s0 = tt.init_state(cfg, 1, "cuda", torch.float64)
    serial = {"torch": "torch", "cuda_strips": "cuda_mono"}.get(backend, backend)
    want = tt.simulate(cfg.replace(num=dataclasses.replace(cfg.num, backend=serial)), s0, steps)
    dec = Decomp(cfg, _mesh(2, 2, "cuda:0"))
    torch.cuda.synchronize()
    K.reset_launch_counts()
    got = dec.simulate(s0, steps)
    torch.cuda.synchronize()
    assert {k: c for k, c in K.LAUNCHES.items() if c} == launches
    _assert_equal(got, want)


@pytest.mark.cuda
def test_torch_engine_on_card():
    _card_case("torch", 16, 4, {})


@pytest.mark.cuda
def test_full_block_engine_on_card():
    _card_case("cuda_mono", 64, 4, {"fullstep_win": 16})


@pytest.mark.cuda
def test_tiled_engine_on_card():
    _card_case("cuda_tiled", 64, 3, {"fullstep_win": 12})


@pytest.mark.cuda
def test_strips_engine_on_card():
    _card_case("cuda_strips", 64, 3, {"fullstep_strips": 12})


@pytest.mark.cuda
def test_hybrid_engine_on_card():
    _card_case("cuda", 64, 2, {"predict_win": 8, "fct_sweep_win": 16}, pressure_solver="mg",
               sor_tol=1e-8, sor_max_iter=2000)
