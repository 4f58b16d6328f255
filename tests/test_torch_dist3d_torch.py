"""The port's plain-torch distributed engine, Decomp3D(backend='torch')
(tpuvof's XLA engine), against the port's serial simulate_3d on 'torch'
and tpuvof's serial simulate_3d.

CPU meshes, one controller, f64. The fixed-Jacobi cases run 6 steps
(every sweep phase twice) with n_jacobi = 2 from random BC-consistent
states (tests/test_torch_dist3d.py's recipe: unit velocities, dt 2e-4 so
F moves by tenths), at 1e-12 of each field's scale. Meshes: (2,) slabs,
(8,) slabs two planes thick and (16,) slabs one plane thick (thinner than
any cone of the wide-halo engine), (2, 2) and (2, 4) pencils, csf on
(2, 2). The residual-driven cases run tpuvof's hybrid test setup (the
16^3 dam break, 4 steps, sor_tol 1e-8, sor_max_iter 2000) with tpuvof's
bars (tests/test_hybrid_dist3d.py::_check: F, u, v, w atol 1e-12, p
1e-7) and the serial solver's trip count, counted by the calls of the
loop test (ops.poisson.keep_iterating). tpuvof runs eagerly
(jax.disable_jit(): jitted tpuvof contracts FMAs).
"""
import dataclasses

import numpy as np
import pytest
import torch

import tpuvof_torch as tt
import tpuvof_torch.ops.mg as omg
import tpuvof_torch.ops.poisson as tpoisson
import tpuvof_torch.parallel.mg as pmg
from tpuvof_torch.ops import apply_bc_3d
from tpuvof_torch.parallel import Mesh

TOL = 1e-12
DT = 2e-4
NJ = 2
STEPS = 6
G16 = tt.Grid3D(16, 16, 8, Lz=0.05)
CUBE = tt.Grid3D(16, 16, 16)
SOLVE = dict(sor_tol=1e-8, sor_max_iter=2000)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


def _assert_close(got, want, tol=TOL):
    for name, a, b in zip("Fuvwp", got, want):
        assert _rel(a, b) <= tol, (name, _rel(a, b))


def _check(got, want, atol_p=1e-7):
    """tpuvof's hybrid bars on the interior."""
    I = (slice(1, -1),) * 3
    for name in "Fuvw":
        np.testing.assert_allclose(np.asarray(getattr(got, name))[I],
                                   np.asarray(getattr(want, name))[I], rtol=0, atol=1e-12,
                                   err_msg=name)
    np.testing.assert_allclose(np.asarray(got.p)[I], np.asarray(want.p)[I], rtol=0,
                               atol=atol_p, err_msg="p")


def _random_state(g, seed):
    rng = np.random.default_rng(seed)
    F = np.clip(rng.normal(0.5, 0.4, g.shape), 0, 1)
    u, v, w = (rng.normal(0, 1.0, g.shape) for _ in range(3))
    p = rng.normal(0, 10.0, g.shape)
    u[0] = 0.0
    v[:, 0] = 0.0
    w[:, :, 0] = 0.0
    u, v, w, F, p = apply_bc_3d(*map(torch.as_tensor, (u, v, w, F, p)))
    return tt.State3D(F=F, u=u, v=v, w=w, p=p)


def _dam_break():
    return tt.init_state_3d(CUBE, 1, "cpu", torch.float64)


def _mesh(shape):
    n = int(np.prod(shape))
    names = ("mx",) if len(shape) == 1 else ("mx", "my")
    devices = np.empty(n, dtype=object)
    devices[:] = [CPU] * n
    return Mesh(devices.reshape(shape), names)


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


CASES = {
    "slab (2,)": ((2,), {}),
    "slab (8,) two planes": ((8,), {}),
    "slab (16,) one plane": ((16,), {}),
    "pencil (2, 2)": ((2, 2), {}),
    "pencil (2, 4)": ((2, 4), {}),
    "pencil (2, 2) csf": ((2, 2), {"csf": True}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_torch_engine_matches_serial(case):
    shape, kw = CASES[case]
    s0 = _random_state(G16, 3)
    dec = tt.Decomp3D(G16, _mesh(shape), dt=DT, n_jacobi=NJ, backend="torch", **kw)
    assert (dec.W, dec.Wy, dec.pencil, dec.hybrid) == (0, 0, False, False)
    got = dec.simulate(s0, STEPS)
    want = tt.simulate_3d(G16, s0, STEPS, dt=DT, n_jacobi=NJ, backend="torch", **kw)
    assert _rel(want.F, s0.F) > 0.1  # the flow moved
    _assert_close(got, want)


@pytest.mark.parametrize("solver", ["rbsor", "mg"])
def test_torch_engine_residual_solvers_match_serial(solver, loop_tests, monkeypatch):
    """(2, 2) pencils; mg with the crossover at 64 cells, so the fine
    levels run sharded."""
    monkeypatch.setattr(pmg, "GATHER_VOLUME", 64)
    s0 = _dam_break()
    want = tt.simulate_3d(CUBE, s0, 4, backend="torch", pressure_solver=solver, **SOLVE)
    n_serial, loop_tests[0] = loop_tests[0], 0
    dec = tt.Decomp3D(CUBE, _mesh((2, 2)), backend="torch", pressure_solver=solver, **SOLVE)
    got = dec.simulate(s0, 4)
    _check(got, want)
    assert loop_tests[0] == n_serial > 8, (loop_tests[0], n_serial)


def test_torch_engine_auto_on_one_plane_slabs(loop_tests):
    """'auto' is mg on a grid that coarsens, on slabs one plane thick; and
    rbsor where the grid does not coarsen."""
    s0 = _dam_break()
    want = tt.simulate_3d(CUBE, s0, 2, backend="torch", pressure_solver="mg", **SOLVE)
    n_serial, loop_tests[0] = loop_tests[0], 0
    dec = tt.Decomp3D(CUBE, _mesh((16,)), backend="torch", pressure_solver="auto", **SOLVE)
    assert dec.pressure_solver == "mg"
    _check(dec.simulate(s0, 2), want)
    assert loop_tests[0] == n_serial
    g = tt.Grid3D(12, 12, 6, Lz=0.05)
    assert tt.Decomp3D(g, _mesh((2,)), backend="torch",
                       pressure_solver="auto").pressure_solver == "rbsor"


def test_torch_engine_chunked_with_istep0():
    s0 = _random_state(G16, 5)
    dec = tt.Decomp3D(G16, _mesh((2, 4)), dt=DT, n_jacobi=NJ, backend="torch")
    whole = dec.simulate(s0, STEPS)
    half = dec.simulate(dec.simulate(s0, STEPS // 2), STEPS - STEPS // 2, istep0=STEPS // 2)
    for a, b in zip(half, whole):
        assert torch.equal(a, b)
    shards = dec.advance(dec.widen(dec.scatter_state(s0)), STEPS // 2)
    shards = dec.advance(shards, STEPS - STEPS // 2, istep0=STEPS // 2)
    for a, b in zip(dec.gather_state(dec.narrow(shards)), whole):
        assert torch.equal(a, b)


def test_torch_engine_matches_tpuvof_serial():
    """(2, 4) pencils against tpuvof's serial simulate_3d on 'xla', eager."""
    import jax
    import jax.numpy as jnp

    import tpuvof as tv
    from tpuvof.grid import Grid3D

    s0 = _random_state(G16, 4)
    got = tt.Decomp3D(G16, _mesh((2, 4)), dt=DT, n_jacobi=NJ,
                      backend="torch").simulate(s0, STEPS)
    with jax.disable_jit():
        want = tv.simulate_3d(Grid3D(**dataclasses.asdict(G16)),
                              tv.State3D(*(jnp.asarray(a.numpy()) for a in s0)), STEPS,
                              dt=DT, n_jacobi=NJ)
    _assert_close(got, [torch.as_tensor(np.array(a)) for a in want])


def test_torch_engine_launches_no_kernel(monkeypatch):
    """The plain engine never reaches a kernel wrapper."""
    from tpuvof_torch.kernels import step3d_kernels as K3

    def boom(*a, **k):
        raise AssertionError("a kernel wrapper ran on backend='torch'")

    for name in ("predict3d_rhs", "jacobi3d", "correct3d", "fct3d_sweep"):
        monkeypatch.setattr(K3, name, boom)
    tt.Decomp3D(G16, _mesh((2, 2)), dt=DT, n_jacobi=NJ, backend="torch",
                csf=True).simulate(_random_state(G16, 6), 3)
