"""The port's distributed 2-D hybrid, Decomp with a 'cuda*' backend and
rbsor or mg (tpuvof's _local_step_hybrid; tests/test_hybrid_dist.py's
analogs): predict_win and fct_sweep_win on PHASE_HALO-widened blocks
around the distributed solve.

CPU meshes, where the kernel wrappers run their plain versions. tpuvof's
setup: the 16^2 dam break in f64 (32^2 for the (1, 8) mesh, whose 16^2
blocks would be two rows thick), 7 steps, sor_tol 1e-8, sor_max_iter 2000,
against the port's serial 'cuda' hybrid at tpuvof's bars (F, u, v 1e-12,
p 1e-7) and bit for bit, with the serial trip count, counted by the calls
of the loop test (ops.poisson.keep_iterating). mg runs with the crossover
at 64 cells, so its fine levels run sharded. One case against tpuvof's
serial hybrid, eager (jitted tpuvof contracts FMAs).
"""
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
SOLVE = dict(sor_tol=1e-8, sor_max_iter=2000)
I = (slice(1, -1),) * 2


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


def _mesh(px, py):
    devices = np.empty(px * py, dtype=object)
    devices[:] = [CPU] * (px * py)
    return Mesh(devices.reshape(px, py), ("mx", "my"))


def _cfg(solver, n=16, backend="cuda"):
    return tt.dam_break_2d(n, num=tt.Numerics(backend=backend, pressure_solver=solver, **SOLVE))


def _check(got, want):
    """tpuvof's hybrid bars on the interior, then bit for bit."""
    for name in "Fuv":
        np.testing.assert_allclose(getattr(got, name)[I].numpy(), getattr(want, name)[I].numpy(),
                                   rtol=0, atol=1e-12, err_msg=name)
    np.testing.assert_allclose(got.p[I].numpy(), want.p[I].numpy(), rtol=0, atol=1e-7)
    for name, a, b in zip("Fuvp", got, want):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("solver", ["rbsor", "mg"])
@pytest.mark.parametrize("px,py,n", [(1, 1, 16), (2, 4, 16), (1, 8, 32), (2, 2, 16)])
def test_dist_hybrid_matches_serial(solver, px, py, n, loop_tests):
    """Every layout, 1x1 included (the windowed phase kernels at origin
    -PHASE_HALO, no exchange); the serial hybrid's trip count."""
    cfg = _cfg(solver, n)
    s0 = tt.init_state(cfg, 1, "cpu", torch.float64)
    want = tt.simulate(cfg, s0, 7)
    n_serial, loop_tests[0] = loop_tests[0], 0
    dec = Decomp(cfg, _mesh(px, py))
    assert dec.engine == "hybrid"
    _check(dec.simulate(s0, 7), want)
    assert loop_tests[0] == n_serial > 7, (loop_tests[0], n_serial)


def test_dist_hybrid_matches_tpuvof():
    """The (2, 2) mg hybrid against tpuvof's serial mg steps (both
    parities), eagerly."""
    import jax
    import jax.numpy as jnp

    import tpuvof as tv
    from tpuvof.ops import apply_bc as jbc
    from tpuvof.solver import step

    cfg = _cfg("mg")
    s0 = tt.init_state(cfg, 1, "cpu", torch.float64)
    got = Decomp(cfg, _mesh(2, 2)).simulate(s0, 2)
    jcfg = tv.SimConfig(grid=tv.Grid2D(16, 16), num=tv.Numerics(pressure_solver="mg", **SOLVE))
    F, u, v, p = (jnp.asarray(a.numpy()) for a in s0)
    u, v, F, p = jbc(u, v, F, p)
    s = tv.State(F=F, u=u, v=v, p=p)
    with jax.disable_jit():
        for k in range(2):
            s = step(jcfg, s, even_step=(k + 1) % 2 == 0, lean=True)
    for name in "Fuvp":
        np.testing.assert_allclose(getattr(got, name)[I].numpy(), np.asarray(getattr(s, name))[I],
                                   rtol=0, atol=1e-7 if name == "p" else 1e-12, err_msg=name)


def test_hybrid_is_actually_selected(monkeypatch):
    """A 'cuda*' backend with an upgraded solver on admissible blocks runs
    the hybrid: the phase kernels' wrappers, never the torch engine's step
    or the whole-step kernels."""
    cfg = _cfg("mg", backend="cuda_strips")
    dec = Decomp(cfg, _mesh(2, 2))

    def boom(*a, **k):
        raise AssertionError("a step other than the hybrid's ran")

    monkeypatch.setattr(dec, "_step_torch", boom)
    for name in ("fullstep_win", "fullstep_strips", "predict", "fct_sweep", "project"):
        monkeypatch.setattr(K, name, boom)
    calls = {"predict_win": 0, "fct_sweep_win": 0}
    for name in calls:
        real = getattr(K, name)

        def counted(*a, name=name, real=real, **k):
            calls[name] += 1
            return real(*a, **k)

        monkeypatch.setattr(K, name, counted)
    out = dec.simulate(tt.init_state(cfg, 1, "cpu", torch.float64), 2)
    assert calls == {"predict_win": 8, "fct_sweep_win": 16}
    assert all(bool(torch.isfinite(a).all()) for a in out)


def test_hybrid_thin_blocks_raise():
    """Blocks thinner than PHASE_HALO + 1 on a split axis cannot take the
    phase widening from one neighbour: tpuvof warns and runs its XLA
    engine; the port raises, naming backend='torch', which runs them."""
    cfg = _cfg("rbsor")
    with pytest.raises(ValueError, match=r"nx/px > W=3 \(nx/px=2\).*backend='torch'"):
        Decomp(cfg, _mesh(8, 1))
    s0 = tt.init_state(cfg, 1, "cpu", torch.float64)
    plain = _cfg("rbsor", backend="torch")
    got = Decomp(plain, _mesh(8, 1)).simulate(s0, 4)
    _check(got, tt.simulate(plain, s0, 4))


def test_engine_force_with_upgraded_solver_raises():
    with pytest.raises(ValueError, match="HYBRID"):
        Decomp(_cfg("mg"), _mesh(2, 2), tile=16)


def test_dist_hybrid_other_ics_and_odd_steps():
    """ic 2 and 3 exercise the curvature; odd step counts end on an odd
    parity."""
    for ic, n_steps in ((2, 5), (3, 3)):
        cfg = _cfg("mg")
        s0 = tt.init_state(cfg, ic, "cpu", torch.float64)
        _check(Decomp(cfg, _mesh(2, 4)).simulate(s0, n_steps), tt.simulate(cfg, s0, n_steps))
