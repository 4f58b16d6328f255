"""The port's 3-D slice against tpuvof and the 3-D golden.

- ICs 1/2/3 equal tpuvof's bit for bit; Grid3D.validate rejects
  non-cubic cells.
- Each op of tpuvof_torch.ops (bc, momentum3d, normals3d, fct3d) and the
  3-D pressure solvers against tpuvof's, in f64 on random BC-consistent
  states (tests/test_3d.py's recipe), within 1e-12 of the field's scale:
  the same operations in the same order. tpuvof's ops run eagerly, op by
  op, as its own tests run them.
- step_3d('torch') against tpuvof's step_3d('xla') under
  ``jax.disable_jit()`` at 16^3, every phase, csf off and on, every
  pressure solver: 1e-12 of each field's scale.
- simulate_3d('cuda') on CPU tensors (the kernels' plain versions) against
  tpuvof's simulate_3d('xla') over 5 steps: F/u/v/w within 1e-11 and p
  within 1e-7 absolute, tpuvof's own bars between its 'pallas' and 'xla'
  routes (tests/test_3d.py).
- The 32^3 x 300 f64 golden through 'torch' and 'cuda' within 1e-9 (the
  bar of tests/test_golden.py), resumed at the step-100 checkpoint with
  istep0; chunked == continuous with istep0.
"""
import dataclasses
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import tpuvof as tv
from tpuvof.config import Fluid
from tpuvof.grid import Grid3D

import tpuvof_torch as tt
from tpuvof_torch import solver3d as S3
from tpuvof_torch.convert import (fluid_from_tpuvof, grid3d_from_tpuvof, state3d_from_numpy,
                                  state3d_to_numpy)
from tpuvof_torch.ops import fct3d, momentum3d, normals3d

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN3D = os.path.join(REPO, "tests", "golden_dambreak3d_32_300.npz")
TOL = 1e-12
DT = 4e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: a 34^3 field is past
    torch's parallel grain, and under the gate's worker processes its
    threads would oversubscribe the cores (a 300-step golden then took
    35x its time alone)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def _t(a):
    return torch.as_tensor(np.array(a, np.float64))


def _random_state(n, seed, vel_scale=1e-3):
    """tests/test_3d.py's random BC-consistent state, as numpy f64."""
    from tpuvof.ops import apply_bc_3d

    rng = np.random.default_rng(seed)
    shape = (n + 2,) * 3
    F = np.clip(rng.normal(0.5, 0.4, shape), 0, 1)
    u, v, w = (rng.normal(0, vel_scale, shape) for _ in range(3))
    p = rng.normal(0, 10.0, shape)
    u[0] = 0.0
    v[:, 0] = 0.0
    w[:, :, 0] = 0.0
    u, v, w, F, p = apply_bc_3d(*map(jnp.asarray, (u, v, w, F, p)))
    return tuple(np.asarray(a) for a in (F, u, v, w, p))


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("ic", [1, 2, 3])
def test_initial_conditions_match_tpuvof(n, ic):
    g = Grid3D(n, n, n)
    want = tv.init_state_3d(g, ic=ic)
    got = tt.init_state_3d(grid3d_from_tpuvof(g), ic=ic, device="cpu")
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError):
        tt.init_state_3d(tt.Grid3D(8, 8, 8), ic=7, device="cpu")


def test_grid3d_validate_and_geometry():
    g, pg = Grid3D(12, 12, 12), tt.Grid3D(12, 12, 12)
    assert pg.validate() is pg
    for name in ("dx", "dy", "dz", "dxi", "dyi", "dzi", "shape"):
        assert getattr(pg, name) == getattr(g, name), name
    np.testing.assert_array_equal(pg.node_z(), g.node_z())
    with pytest.raises(ValueError):
        tt.Grid3D(12, 12, 8).validate()  # non-cubic cells
    with pytest.raises(ValueError):
        tt.Grid3D(12, 12, 12, Lz=0.2).validate()
    with pytest.raises(ValueError):
        tt.simulate_3d(tt.Grid3D(8, 8, 16), tt.init_state_3d(tt.Grid3D(8, 8, 16), device="cpu"), 1)


@pytest.fixture(scope="module")
def ops_ref():
    n = 10
    g = Grid3D(n, n, n)
    return g, grid3d_from_tpuvof(g), Fluid(), tt.Fluid(), _random_state(n, 1, 0.5)


def test_apply_bc_3d_matches_tpuvof(ops_ref):
    from tpuvof.ops import apply_bc_3d

    _, _, _, _, (F, u, v, w, p) = ops_ref
    rng = np.random.default_rng(2)
    rho = rng.uniform(50, 1000, F.shape)
    F, u, v, w, p = (a + rng.normal(0, 1, a.shape) for a in (F, u, v, w, p))
    want = apply_bc_3d(*map(jnp.asarray, (u, v, w, F, p, rho)))
    got = tt.ops.apply_bc_3d(*map(_t, (u, v, w, F, p, rho)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    fields = list(map(_t, (u, v, w, F, p)))
    out = tt.ops.apply_bc_3d_(*fields)
    assert all(a is b for a, b in zip(out, fields))  # in place
    for a, b in zip(out, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("csf", [False, True])
def test_momentum3d_matches_tpuvof(ops_ref, csf):
    from tpuvof.ops import mix_properties
    from tpuvof.ops import momentum3d as jm
    from tpuvof.ops.normals3d import young_normals_curvature_3d

    g, pg, fl, pfl, (F, u, v, w, p) = ops_ref
    rho, nu = mix_properties(fl, jnp.asarray(F))
    kappa = young_normals_curvature_3d(g, jnp.asarray(F))[3] if csf else jnp.zeros_like(F)
    want = jm.predict_velocity_3d(g, fl, DT, *map(jnp.asarray, (u, v, w, F)), rho, nu, kappa)
    got = momentum3d.predict_velocity_3d(pg, pfl, DT, *map(_t, (u, v, w, F, rho, nu, kappa)))
    for a, b in zip(got, want):
        assert _rel(a, b) <= TOL
    us, vs, ws = map(np.asarray, want)
    want = jm.update_velocity_3d(g, DT, *map(jnp.asarray, (u, v, w, us, vs, ws, p)), rho)
    got = momentum3d.update_velocity_3d(pg, DT, *map(_t, (u, v, w, us, vs, ws, p, rho)))
    for a, b in zip(got, want):
        assert _rel(a, b) <= TOL


def test_normals3d_match_tpuvof(ops_ref):
    from tpuvof.ops import normals3d as jn

    g, pg, _, _, (F, *_) = ops_ref
    want = jn.young_normals_curvature_3d(g, jnp.asarray(F))
    got = normals3d.young_normals_curvature_3d(pg, _t(F))
    for a, b in zip(got, want):
        assert _rel(a, b) <= TOL
    # the degeneracy guard keeps the raw sums where all three are tiny
    flat = np.full(F.shape, 0.5)
    for a in normals3d.young_normals_curvature_3d(pg, _t(flat)):
        assert float(a.abs().max()) == 0.0


@pytest.mark.parametrize("phase", [0, 1, 2])
def test_fct3d_matches_tpuvof(ops_ref, phase):
    from tpuvof.ops import fct3d as jf

    g, pg, _, _, (F, u, v, w, _) = ops_ref
    dt = 2e-3  # unit-scale velocities: the limiter fires
    F, u, v, w = F, 2 * u, 2 * v, 2 * w
    want = jf.rudman_advect_3d(g, dt, *map(jnp.asarray, (F, u, v, w)), phase)
    got = fct3d.rudman_advect_3d(pg, dt, *map(_t, (F, u, v, w)), phase)
    assert _rel(got, want) <= TOL
    assert _rel(got, F) > 1e-3
    axis = phase
    vel = (u, v, w)[axis]
    sweep = (jf.fct3d_sweep_x, jf.fct3d_sweep_y, jf.fct3d_sweep_z)[axis]
    want = sweep(g, dt, jnp.asarray(F), jnp.asarray(vel))
    got = (fct3d.fct3d_sweep_x, fct3d.fct3d_sweep_y, fct3d.fct3d_sweep_z)[axis](
        pg, dt, _t(F), _t(vel))
    assert _rel(got, want) <= TOL
    # the shift-and-mask forms (the kernel's plain version) agree with the
    # serial sweep on the whole grid
    if axis == 0:
        masked = fct3d.sweep_x_masked(pg, dt, _t(F), _t(vel), 0)
        assert _rel(masked, jf.sweep_x_masked(g, dt, jnp.asarray(F), jnp.asarray(vel), 0)) <= TOL
    else:
        masked = fct3d.sweep_inplane_masked(pg, dt, _t(F), _t(vel), axis)
        assert _rel(masked, jf.sweep_inplane_masked(g, dt, jnp.asarray(F), jnp.asarray(vel),
                                                    axis)) <= TOL
    inner = (slice(1, -1),) * 3
    assert _rel(masked[inner], np.asarray(want)[inner]) <= TOL
    want = jf.upwind_advect_3d(g, dt, *map(jnp.asarray, (F, u, v, w)))
    assert _rel(fct3d.upwind_advect_3d(pg, dt, *map(_t, (F, u, v, w))), want) <= TOL


def test_pressure_solvers_match_tpuvof():
    from tpuvof import solver3d as js
    from tpuvof.ops.mg import mg_solve as jmg
    from tpuvof_torch.ops.mg import mg_solve

    n = 16
    g, pg = Grid3D(n, n, n), tt.Grid3D(n, n, n)
    rng = np.random.default_rng(4)
    p = rng.normal(0, 10, g.shape)
    rhs = rng.standard_normal((n, n, n)) * 1e5
    want = js._rbsor_3d(g, jnp.asarray(p), jnp.asarray(rhs), 1.7, 0.0, 40, tol_rel=1e-3)
    got = S3._rbsor_3d(pg, _t(p), _t(rhs), 1.7, 0.0, 40, tol_rel=1e-3)
    assert _rel(got, want) <= TOL
    inv2 = (g.dxi**2, g.dyi**2, g.dzi**2)
    want = jmg(jnp.asarray(p), jnp.asarray(rhs), inv2, 0.0, 3, tol_rel=1e-6)
    got = mg_solve(_t(p), _t(rhs), inv2, 0.0, 3, tol_rel=1e-6)
    assert _rel(got, want) <= TOL
    us, vs, ws = (rng.normal(0, 1e-3, g.shape) for _ in range(3))
    rho = rng.uniform(50, 1000, g.shape)
    want = js._solve_pressure_3d(g, DT, 10, *map(jnp.asarray, (p, us, vs, ws, rho)))
    got = S3._solve_pressure_3d(pg, DT, 10, *map(_t, (p, us, vs, ws, rho)))
    assert _rel(got, want) <= TOL
    assert S3._resolve_auto_3d(pg) == js._resolve_auto_3d(g) == "mg"
    assert S3._resolve_auto_3d(tt.Grid3D(6, 6, 6)) == "rbsor"


@pytest.fixture(scope="module")
def state16():
    return _random_state(16, 19)


@pytest.mark.parametrize("phase", [0, 1, 2])
@pytest.mark.parametrize("csf", [False, True])
def test_step_torch_matches_tpuvof_xla(state16, phase, csf):
    n = 16
    g = Grid3D(n, n, n)
    with jax.disable_jit():
        want = tv.solver3d.step_3d(g, Fluid(), DT, 10, tv.State3D(*map(jnp.asarray, state16)),
                                   phase, csf=csf)
    for backend in ("torch", "cuda"):
        got = tt.step_3d(grid3d_from_tpuvof(g), tt.Fluid(), DT, 10,
                         tt.State3D(*map(_t, state16)), phase, backend=backend, csf=csf)
        for name, a, b in zip("Fuvwp", got, want):
            # the kernels' route zeroes p's ghost ring inside the step and the
            # exit BC mirrors it back: equal values, not equal operations
            assert _rel(a, b) <= TOL, (backend, name)


@pytest.mark.parametrize("solver", ["rbsor", "mg", "auto"])
def test_step_residual_solvers_match_tpuvof_xla(state16, solver):
    n = 16
    g = Grid3D(n, n, n)
    kw = dict(pressure_solver=solver, sor_tol=0.0, sor_max_iter=6, sor_tol_rel=1e-3)
    with jax.disable_jit():
        want = tv.solver3d.step_3d(g, Fluid(), DT, 10, tv.State3D(*map(jnp.asarray, state16)),
                                   1, **kw)
    for backend in ("torch", "cuda"):
        got = tt.step_3d(grid3d_from_tpuvof(g), tt.Fluid(), DT, 10,
                         tt.State3D(*map(_t, state16)), 1, backend=backend, **kw)
        for name, a, b in zip("Fuvwp", got, want):
            assert _rel(a, b) <= TOL, (backend, solver, name)


@pytest.mark.parametrize("n", [16, 9])  # 9: odd nx, which tpuvof's slab kernels refuse
def test_simulate_cuda_on_cpu_matches_tpuvof_xla(n):
    g = Grid3D(n, n, n)
    s0 = tv.State3D(*(jnp.asarray(a, jnp.float64) for a in tv.init_state_3d(g, ic=1)))
    want = tv.simulate_3d(g, s0, 5)
    got = tt.simulate_3d(grid3d_from_tpuvof(g),
                         state3d_from_numpy(*map(np.asarray, s0), "cpu", torch.float64), 5,
                         backend="cuda")
    for name, a, b in zip("Fuvwp", state3d_to_numpy(got), want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-7 if name == "p" else 1e-11,
                                   err_msg=name)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_chunked_with_istep0_matches_continuous(backend):
    g = tt.Grid3D(10, 10, 10)
    s0 = tt.init_state_3d(g, 1, "cpu", torch.float64)
    whole = tt.simulate_3d(g, s0, 7, backend=backend)
    part = tt.simulate_3d(g, tt.simulate_3d(g, s0, 4, backend=backend), 3, istep0=4,
                          backend=backend)
    for a, b in zip(whole, part):
        assert torch.equal(a, b)
    # restarting the rotation each chunk is a different trajectory
    wrong = tt.simulate_3d(g, tt.simulate_3d(g, s0, 4, backend=backend), 3, backend=backend)
    assert not torch.equal(whole.F, wrong.F)
    # simulate_3d does not modify its entry state
    assert torch.equal(s0.F, tt.init_state_3d(g, 1, "cpu", torch.float64).F)


def test_backend_and_solver_names_are_checked():
    """simulate_3d, step_3d and Decomp3D reject the same bad backend and
    solver names with the same errors (solver3d.numerics_3d)."""
    g = tt.Grid3D(8, 8, 8)
    s = tt.init_state_3d(g, device="cpu")
    mesh = tt.make_mesh(2, ("mx",), [torch.device("cpu")] * 2)
    for name, bad, err in (("backend", "cuda_mono", NotImplementedError),
                           ("pressure_solver", "cg", ValueError)):
        for run in (lambda kw: tt.simulate_3d(g, s, 1, **kw),
                    lambda kw: tt.step_3d(g, tt.Fluid(), DT, 10, s, 1, **kw),
                    lambda kw: tt.Decomp3D(g, mesh, n_jacobi=2, **kw)):
            with pytest.raises(err, match=repr(bad)):
                run({name: bad})


def test_convert_carries_grid_fluid_and_state():
    g = Grid3D(6, 8, 10, Lx=0.2)
    assert grid3d_from_tpuvof(g) == tt.Grid3D(6, 8, 10, Lx=0.2)
    fl = Fluid(sigma=0.0, gz=-1.0)
    assert fluid_from_tpuvof(fl) == tt.Fluid(**dataclasses.asdict(fl))
    with pytest.raises(TypeError):
        grid3d_from_tpuvof((6, 8, 10))
    arrays = _random_state(6, 3)
    s = state3d_from_numpy(*arrays, "cpu", torch.float32)
    assert all(a.dtype == torch.float32 for a in s)
    for a, b in zip(state3d_to_numpy(s), arrays):
        np.testing.assert_array_equal(a, b.astype(np.float32))


@pytest.fixture(scope="module")
def golden3d():
    return np.load(GOLDEN3D)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_golden_3d_300_steps_f64(golden3d, backend):
    n = int(golden3d["n"])
    g = tt.Grid3D(n, n, n)
    s0 = tt.init_state_3d(g, 1, "cpu", torch.float64)
    mid = tt.simulate_3d(g, s0, int(golden3d["checkpoint"]), backend=backend)
    assert np.max(np.abs(mid.F.numpy() - golden3d["F100"])) <= 1e-9
    assert np.max(np.abs(mid.u.numpy() - golden3d["u100"])) <= 1e-9
    end = tt.simulate_3d(g, mid, int(golden3d["n_steps"]) - int(golden3d["checkpoint"]),
                         istep0=int(golden3d["checkpoint"]), backend=backend)
    assert np.max(np.abs(end.F.numpy() - golden3d["F"])) <= 1e-9
    assert np.max(np.abs(end.u.numpy() - golden3d["u"])) <= 1e-9
