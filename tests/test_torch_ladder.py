"""The pressure-solver ladder (tpuvof_torch.ops.poisson rbsor, ops.mg) and
the routes that run it: the hybrid step, its tiled form, 'auto', and
simulate_cfl.

Each residual-driven solve is held against tpuvof's in f64 within 1e-12 of
the field's scale. That bar needs the same iteration count on both sides:
the port reads the residual on the host once per iteration and compares it
in tpuvof's order and dtype, with the same stall and plateau exits. The
grid is tpuvof's own hybrid test grid (tests/test_mg.py), 32 x 64 cells
with Lx=0.1, Ly=0.2, from a developed dam break.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import tpuvof as tv
from tpuvof import ops as jops
from tpuvof.ops import mg as jmg
from tpuvof.ops import poisson as jpoisson

import tpuvof_torch as tt
from tpuvof_torch import ops as tops
from tpuvof_torch.convert import config_from_tpuvof, state_from_numpy, state_to_numpy
from tpuvof_torch.ops import mg as tmg
from tpuvof_torch.ops import poisson as tpoisson
from tpuvof_torch.solver import _step_cuda, _step_cuda_hybrid_tiled, resolve_auto

TOL = 1e-12


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def _t(a):
    return torch.as_tensor(np.array(a, np.float64))


def _num(cfg, **kw):
    return cfg.replace(num=dataclasses.replace(cfg.num, **kw))


@pytest.fixture(scope="module")
def dev():
    """tpuvof's config, a developed 32 x 64 state and its (u*, v*, rho),
    all numpy f64."""
    cfg = tv.SimConfig(grid=tv.Grid2D(32, 64, Lx=0.1, Ly=0.2))
    s0 = tv.State(*(jnp.asarray(a, jnp.float64) for a in tv.init_state(cfg, ic=1)))
    s = tv.simulate(cfg, s0, 30)
    F, u, v, p = (np.asarray(a) for a in s)
    J = jnp.asarray
    rho, nu = jops.mix_properties(cfg.fluid, J(F))
    _, _, kap = jops.young_normals_curvature(cfg.grid, J(F))
    us, vs = jops.predict_velocity(cfg.grid, cfg.fluid, cfg.num, J(u), J(v), J(F),
                                   rho, nu, kap)
    return cfg, (F, u, v, p), tuple(np.asarray(a) for a in (us, vs, rho))


@pytest.mark.parametrize("solver", ["rbsor", "mg"])
@pytest.mark.parametrize("mode", ["abs", "rel"])
def test_solve_pressure_matches_tpuvof(dev, solver, mode):
    cfg, (F, u, v, p), (us, vs, rho) = dev
    kw = dict(sor_tol=1e-6, sor_max_iter=5000) if mode == "abs" else dict(sor_tol_rel=1e-2)
    jc = _num(cfg, pressure_solver=solver, **kw)
    pc = config_from_tpuvof(jc)
    want = jops.solve_pressure(jc.grid, jc.num, jnp.asarray(p), jnp.asarray(us),
                               jnp.asarray(vs), jnp.asarray(rho))
    got = tops.solve_pressure(pc.grid, pc.num, _t(p), _t(us), _t(vs), _t(rho))
    assert _rel(got, want) <= TOL
    np.testing.assert_array_equal(got.numpy()[0], p[0])  # ghosts kept
    assert _rel(got, p) > 1e-6  # the solve did work
    rhs = jpoisson.divergence_rhs(jc.grid, jc.num, jnp.asarray(us), jnp.asarray(vs),
                                  jnp.asarray(rho))
    assert abs(tpoisson.residual(pc.grid, got, _t(rhs)).item()
               - float(jpoisson.residual(jc.grid, want, rhs))) <= 1e-9 * float(
                   jnp.max(jnp.abs(rhs)))


def test_residual_effective_tol_and_levels(dev):
    cfg, (F, u, v, p), _ = dev
    rng = np.random.default_rng(4)
    rhs = rng.standard_normal((32, 64))
    for proj in (True, False):
        want = float(jpoisson.residual(cfg.grid, jnp.asarray(p), jnp.asarray(rhs), proj))
        got = tpoisson.residual(config_from_tpuvof(cfg).grid, _t(p), _t(rhs), proj).item()
        assert abs(got - want) <= 1e-12 * abs(want)
    rp = rhs - rhs.mean()
    for tol, tol_rel in ((1e-3, 0.0), (1e-3, 1e-2), (1e2, 1e-2)):
        want = float(jpoisson.effective_tol(tol, tol_rel, jnp.asarray(rp)))
        assert tpoisson.effective_tol(tol, tol_rel, _t(rp)).item() == want
    for shape in ((64, 64), (200, 200), (7, 7), (32, 64), (48, 80, 16)):
        assert tmg.mg_levels(shape) == jmg.mg_levels(shape)
    assert (tpoisson.STALL_ITERS, tpoisson.PLATEAU_FACTOR, tmg.STALL_CYCLES) == (25, 2.0, 4)


@pytest.mark.parametrize("n,pick", [(64, "mg"), (81, "rbsor")])
def test_resolve_auto(n, pick):
    from tpuvof.solver import resolve_auto as j_resolve

    jc = tv.dam_break_2d(n, num=tv.Numerics(pressure_solver="auto"))
    pc = config_from_tpuvof(jc)
    assert resolve_auto(pc).num.pressure_solver == pick
    assert j_resolve(jc).num.pressure_solver == pick
    assert resolve_auto(resolve_auto(pc)) == resolve_auto(pc)


def test_mg_raises_where_the_grid_does_not_coarsen():
    g = tt.Grid2D(7, 7)
    with pytest.raises(ValueError, match="rbsor"):
        tmg.mg_solve(torch.zeros(9, 9, dtype=torch.float64),
                     torch.zeros(7, 7, dtype=torch.float64),
                     (g.dxi**2, g.dyi**2), 1e-3, 10)


def test_vcycle_contraction():
    """One V(2,2) cycle contracts the residual at least 10x (as tpuvof's
    tests/test_mg.py pins): a broken transfer operator would not."""
    n = 64
    g = tt.Grid2D(n, n)
    rhs = torch.as_tensor(np.random.default_rng(3).standard_normal((n, n)))
    rhs = rhs - rhs.mean()
    p0 = torch.zeros(n + 2, n + 2, dtype=torch.float64)
    r0 = tpoisson.residual(g, p0, rhs).item()
    p1 = tmg.mg_solve(p0, rhs, (g.dxi**2, g.dyi**2), tol=0.0, max_cycles=1)
    assert tpoisson.residual(g, p1, rhs).item() < r0 / 10.0


@pytest.mark.parametrize("solver", ["rbsor", "mg"])
def test_hybrid_step_matches_tpuvof_step(dev, solver):
    """The 'cuda' hybrid (its wrappers' plain versions on the CPU) against
    tpuvof's xla step, 3 steps of both parities. tpuvof runs jitted here
    (eager rbsor takes minutes); its FMA contraction stays far inside the
    bar over 3 steps."""
    cfg, arrays, _ = dev
    jc = _num(cfg, pressure_solver=solver, sor_tol=1e-6, sor_max_iter=5000)
    pc = config_from_tpuvof(_num(jc, backend="pallas_mono"))
    assert pc.num.backend == "cuda_mono"
    want = tv.State(*map(jnp.asarray, arrays))
    got = state_from_numpy(*arrays, "cpu", torch.float64)
    for k in range(1, 4):
        want = tv.step(jc, want, even_step=k % 2 == 0)
        got = tt.step(pc, got, even_step=k % 2 == 0)
    for name, g_, w_ in zip("Fuvp", state_to_numpy(got), want):
        assert _rel(g_, w_) <= TOL, name


@pytest.mark.parametrize("tile", [8, 16, (16, 32)])
def test_hybrid_tiled_equals_hybrid_whole(dev, tile):
    """Each phase kernel run tile by tile on PHASE_HALO blocks is the
    whole-field hybrid bit for bit (tpuvof's tests/test_mg.py contract)."""
    cfg, arrays, _ = dev
    pc = config_from_tpuvof(_num(cfg, backend="pallas", pressure_solver="mg",
                                 sor_tol=1e-6, sor_max_iter=5000))
    whole = got = state_from_numpy(*arrays, "cpu", torch.float64)
    for k in range(1, 4):
        whole = _step_cuda(pc, whole, k % 2 == 0, lean=False)
        got = _step_cuda_hybrid_tiled(pc, got, k % 2 == 0, tile=tile)
    for name, g_, w_ in zip("Fuvp", got, whole):
        assert torch.equal(g_, w_), name


def test_simulate_cfl_report_matches_tpuvof():
    """For a dt that breaks the limit the report equals tpuvof's (cfl to
    1e-12, the rest exactly), and the state equals simulate's."""
    from tpuvof.solver import simulate_cfl as j_cfl

    jc = tv.SimConfig(grid=tv.Grid2D(24, 24), num=tv.Numerics(dt=4e-5))
    pc = config_from_tpuvof(jc)
    s0 = tv.State(*(jnp.asarray(a, jnp.float64) for a in tv.init_state(jc, ic=1)))
    s0 = s0._replace(u=s0.u.at[10, 7].set(40.0), v=s0.v.at[15, 12].set(-30.0))
    arrays = [np.asarray(a) for a in s0]
    for istep0 in (0, 3):
        with jax.disable_jit():
            _, want = j_cfl(jc, s0, 5, istep0=istep0)
        s, got = tt.simulate_cfl(pc, state_from_numpy(*arrays, "cpu", torch.float64), 5,
                                 istep0=istep0)
        assert got["violations"] > 0 and got["cfl"] > tt.solver.CFL_LIMIT
        assert abs(got["cfl"] - want["cfl"]) <= 1e-12 * abs(want["cfl"])
        assert {k: got[k] for k in got if k != "cfl"} == {k: want[k] for k in want if k != "cfl"}
        plain = tt.simulate(pc, state_from_numpy(*arrays, "cpu", torch.float64), 5,
                            istep0=istep0)
        for a, b in zip(s, plain):
            assert torch.equal(a, b)


def test_make_step_fn_follows_istep_parity():
    cfg = tt.dam_break_2d(16)
    s = tt.simulate(cfg, tt.init_state(cfg, 1, "cpu", torch.float64), 3)
    fn = tt.make_step_fn(cfg)
    for istep, even in ((4, True), (7, False)):
        for a, b in zip(fn(s, istep), tt.step(cfg, s, even_step=even)):
            assert torch.equal(a, b)
