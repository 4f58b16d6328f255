"""The port's distributed hybrid, Decomp3D(backend='cuda') with rbsor, mg
or auto (tpuvof's _local_step_hybrid): the 3-D kernels' wrappers on the
resident extended blocks, whose cone leaves out the Jacobi erosion, and
the distributed solve between predict3d_rhs and correct3d.

CPU meshes, where the kernel wrappers run their plain versions. tpuvof's
hybrid test setup (tests/test_hybrid_dist3d.py): the 16^3 dam break in
f64, 4 steps (phases 1, 2, 0, 1: every sweep order and a wrap, which a p
re-embedded into anything but a zeroed block would not survive), sor_tol
1e-8, sor_max_iter 2000, its bars (F, u, v, w atol 1e-12, p 1e-7) against
the port's serial simulate_3d on 'cuda' (the serial hybrid), and the
serial trip count, counted by the calls of the loop test
(ops.poisson.keep_iterating). mg runs with the crossover at 64 cells, so
its fine levels run sharded. One case against tpuvof's serial step_3d,
eager.
"""
import numpy as np
import pytest
import torch

import tpuvof_torch as tt
import tpuvof_torch.ops.mg as omg
import tpuvof_torch.ops.poisson as tpoisson
import tpuvof_torch.parallel.mg as pmg
from tpuvof_torch.kernels import step3d_kernels as K3
from tpuvof_torch.parallel import Mesh

G = tt.Grid3D(16, 16, 16)
SOLVE = dict(sor_tol=1e-8, sor_max_iter=2000)
STEPS = 4
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread_sharded_mg(monkeypatch):
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(pmg, "GATHER_VOLUME", 64)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def loop_tests(monkeypatch):
    calls = [0]
    real = tpoisson.keep_iterating

    def counted(*a):
        calls[0] += 1
        return real(*a)

    for mod in (tpoisson, omg, pmg):
        monkeypatch.setattr(mod, "keep_iterating", counted)
    return calls


def _mesh(shape):
    n = int(np.prod(shape))
    names = ("mx",) if len(shape) == 1 else ("mx", "my")
    devices = np.empty(n, dtype=object)
    devices[:] = [CPU] * n
    return Mesh(devices.reshape(shape), names)


def _state():
    return tt.init_state_3d(G, 1, "cpu", torch.float64)


def _check(got, want, atol_p=1e-7):
    I = (slice(1, -1),) * 3
    for name in "Fuvw":
        np.testing.assert_allclose(np.asarray(getattr(got, name))[I],
                                   np.asarray(getattr(want, name))[I], rtol=0, atol=1e-12,
                                   err_msg=name)
    np.testing.assert_allclose(np.asarray(got.p)[I], np.asarray(want.p)[I], rtol=0,
                               atol=atol_p, err_msg="p")


@pytest.mark.parametrize("shape", [(1,), (2,), (2, 2)], ids=["1-slab", "2-slab", "2x2-pencil"])
@pytest.mark.parametrize("solver", ["rbsor", "mg"])
def test_hybrid_matches_serial_hybrid(solver, shape, loop_tests):
    s0 = _state()
    want = tt.simulate_3d(G, s0, STEPS, pressure_solver=solver, **SOLVE)
    n_serial, loop_tests[0] = loop_tests[0], 0
    dec = tt.Decomp3D(G, _mesh(shape), pressure_solver=solver, **SOLVE)
    assert dec.hybrid and dec.W == 4 and dec.Wy == (4 if len(shape) == 2 else 0)
    _check(dec.simulate(s0, STEPS), want)
    assert loop_tests[0] == n_serial > 2 * STEPS, (loop_tests[0], n_serial)


def test_hybrid_rbsor_f32_matches_serial_hybrid(loop_tests):
    """In f32, at the production tolerance (sor_tol_rel 1e-2): the shards'
    coefficients are the serial solver's on their blocks (ap_inv from the
    f64 edge classes; tpuvof forms it in the dtype), so the distributed
    rbsor stops where the serial one stops and gives its values bit for
    bit."""
    s0 = tt.init_state_3d(G, 1, "cpu")
    kw = dict(pressure_solver="rbsor", sor_tol_rel=1e-2)
    want = tt.simulate_3d(G, s0, 3, **kw)
    n_serial, loop_tests[0] = loop_tests[0], 0
    got = tt.Decomp3D(G, _mesh((2, 2)), **kw).simulate(s0, 3)
    assert loop_tests[0] == n_serial > 6, (loop_tests[0], n_serial)
    for name, a, b in zip("Fuvwp", got, want):
        assert torch.equal(a, b), name


def test_hybrid_matches_tpuvof_serial():
    """(2, 2) pencils with rbsor against tpuvof's serial step_3d on 'xla',
    eager, as tpuvof holds its own distributed hybrid. Eager tpuvof takes
    ~3 s a converged 16^3 step, so each solve here runs a fixed 10
    iterations (sor_tol 0: the cap ends it), over the three sweep orders."""
    import jax
    import jax.numpy as jnp

    import tpuvof as tv
    from tpuvof.config import Fluid
    from tpuvof.grid import Grid3D

    kw = dict(pressure_solver="rbsor", sor_tol=0.0, sor_max_iter=10)
    s0 = _state()
    got = tt.Decomp3D(G, _mesh((2, 2)), **kw).simulate(s0, 3)
    want = tv.State3D(*(jnp.asarray(a.numpy()) for a in s0))
    with jax.disable_jit():
        for phase in (1, 2, 0):
            want = tv.solver3d.step_3d(Grid3D(16, 16, 16), Fluid(), 4e-6, 10, want, phase,
                                       **kw)
    _check(got, want)


def test_hybrid_runs_no_jacobi_launch(monkeypatch):
    """'auto' routes to the hybrid: predict3d_rhs, correct3d and the three
    sweeps on every shard a step, and never jacobi3d."""
    calls = {}
    for name in ("predict3d_rhs", "correct3d", "fct3d_sweep", "jacobi3d"):
        real = getattr(K3, name)

        def counted(*a, _name=name, _real=real, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **k)

        monkeypatch.setattr(K3, name, counted)
    dec = tt.Decomp3D(G, _mesh((2, 2)), pressure_solver="auto", sor_tol_rel=1e-2)
    assert dec.pressure_solver == "mg" and dec.hybrid
    out = dec.simulate(_state(), 2)
    assert calls == {"predict3d_rhs": 8, "correct3d": 8, "fct3d_sweep": 24}
    assert all(bool(torch.isfinite(a).all()) for a in out)


def test_hybrid_cone_leaves_out_the_jacobi_erosion():
    g = tt.Grid3D(32, 32, 32)
    for kw, want in (({}, (4, 4)), ({"csf": True}, (6, 6))):
        dec = tt.Decomp3D(g, _mesh((2, 2)), n_jacobi=10, pressure_solver="rbsor", **kw)
        assert dec.hybrid and (dec.W, dec.Wy) == want
    dec = tt.Decomp3D(g, _mesh((2, 2)), n_jacobi=10)
    assert not dec.hybrid and (dec.W, dec.Wy) == (14, 14)


@pytest.mark.parametrize("shape,kw", [((8,), {}), ((2, 4), {}), ((4,), {"csf": True})],
                         ids=["8-slab", "2x4-pencil", "4-slab-csf"])
def test_hybrid_thin_blocks_raise_naming_the_torch_engine(shape, kw):
    """Where tpuvof falls back to its XLA engine, the port raises and names
    the engine that runs the shape."""
    with pytest.raises(ValueError, match="backend='torch'"):
        tt.Decomp3D(G, _mesh(shape), pressure_solver="rbsor", **kw)
    tt.Decomp3D(G, _mesh(shape), pressure_solver="rbsor", backend="torch", **kw)


def test_hybrid_csf_matches_serial_hybrid(loop_tests):
    s0 = _state()
    want = tt.simulate_3d(G, s0, STEPS, pressure_solver="mg", csf=True, **SOLVE)
    n_serial, loop_tests[0] = loop_tests[0], 0
    dec = tt.Decomp3D(G, _mesh((2, 2)), pressure_solver="mg", csf=True, **SOLVE)
    assert dec.W == 6
    _check(dec.simulate(s0, STEPS), want)
    assert loop_tests[0] == n_serial


def test_hybrid_chunked_with_istep0():
    s0 = _state()
    dec = tt.Decomp3D(G, _mesh((2, 2)), pressure_solver="mg", sor_tol_rel=1e-2)
    whole = dec.simulate(s0, STEPS)
    half = dec.simulate(dec.simulate(s0, 2), STEPS - 2, istep0=2)
    for a, b in zip(half, whole):
        assert torch.equal(a, b)
    blocks = dec.advance(dec.widen(dec.scatter_state(s0)), 2)
    blocks = dec.advance(blocks, STEPS - 2, istep0=2)
    for a, b in zip(dec.gather_state(dec.narrow(blocks)), whole):
        assert torch.equal(a, b)
