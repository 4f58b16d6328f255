"""tpuvof_torch's plain-torch ops against tpuvof's ops (the xla path), f64.

The same inputs, made with numpy from a seed, go through both packages.
Each op runs eagerly on both sides, so both do the same IEEE operations in
the same order and the bar is rounding: 1e-12 relative to the field's
scale. The input is a BC-consistent, developed 32^2 dam-break state with a
seeded perturbation, so every branch of the stencils (upwind selects, the
limiter, the normals' guard) is taken somewhere.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import tpuvof as tv
from tpuvof import ops as jops
from tpuvof.ops import poisson as jpoisson

import tpuvof_torch as tt
from tpuvof_torch import ops as tops
from tpuvof_torch.convert import config_from_tpuvof
from tpuvof_torch.ops import poisson as tpoisson

N = 32
TOL = 1e-12


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def _t(a):
    return torch.as_tensor(np.array(a, np.float64))


@pytest.fixture(scope="module")
def dev():
    """(tpuvof cfg, port cfg, F, u, v, p) with the arrays as numpy f64."""
    cfg = tv.dam_break_2d(N)
    s0 = tv.State(*(jnp.asarray(a, jnp.float64) for a in tv.init_state(cfg, ic=1)))
    s = tv.simulate(cfg, s0, 40)
    rng = np.random.default_rng(0)
    F, u, v, p = (np.asarray(a) + rng.uniform(-1e-3, 1e-3, a.shape) for a in s)
    u, v, F, p = (np.asarray(a) for a in jops.apply_bc(*map(jnp.asarray, (u, v, F, p))))
    return cfg, config_from_tpuvof(cfg), F, u, v, p


def test_mix_properties(dev):
    cfg, pc, F, u, v, p = dev
    want = jops.mix_properties(cfg.fluid, jnp.asarray(F))
    got = tops.mix_properties(pc.fluid, _t(F))
    for g_, w_ in zip(got, want):
        assert _rel(g_, w_) <= TOL


def test_young_normals_curvature(dev):
    cfg, pc, F, u, v, p = dev
    want = jops.young_normals_curvature(cfg.grid, jnp.asarray(F))
    got = tops.young_normals_curvature(pc.grid, _t(F))
    for g_, w_ in zip(got, want):
        assert _rel(g_, w_) <= TOL


def test_predict_velocity(dev):
    cfg, pc, F, u, v, p = dev
    J = jnp.asarray
    rho, nu = jops.mix_properties(cfg.fluid, J(F))
    _, _, kap = jops.young_normals_curvature(cfg.grid, J(F))
    want = jops.predict_velocity(cfg.grid, cfg.fluid, cfg.num, J(u), J(v), J(F), rho, nu, kap)
    got = tops.predict_velocity(pc.grid, pc.fluid, pc.num, _t(u), _t(v), _t(F),
                                _t(rho), _t(nu), _t(kap))
    for g_, w_ in zip(got, want):
        assert _rel(g_, w_) <= TOL


def test_poisson_coefficients_bit_equal(dev):
    cfg, pc, *_ = dev
    for dtype, tdtype in ((np.float32, torch.float32), (np.float64, torch.float64)):
        want = jpoisson.poisson_coefficients(cfg.grid, dtype)
        got = tpoisson.poisson_coefficients(pc.grid, tdtype, "cpu")
        for g_, w_ in zip(got, want):
            g_ = g_.expand(cfg.grid.nx, cfg.grid.ny).numpy()
            np.testing.assert_array_equal(g_, np.asarray(w_))


def test_divergence_rhs_and_jacobi(dev):
    cfg, pc, F, u, v, p = dev
    J = jnp.asarray
    rho, nu = jops.mix_properties(cfg.fluid, J(F))
    _, _, kap = jops.young_normals_curvature(cfg.grid, J(F))
    us, vs = jops.predict_velocity(cfg.grid, cfg.fluid, cfg.num, J(u), J(v), J(F), rho, nu, kap)
    rhs_w = jpoisson.divergence_rhs(cfg.grid, cfg.num, us, vs, rho)
    rhs_g = tpoisson.divergence_rhs(pc.grid, pc.num, _t(us), _t(vs), _t(rho))
    assert _rel(rhs_g, rhs_w) <= TOL
    p_w = jops.solve_pressure(cfg.grid, cfg.num, J(p), us, vs, rho)
    p_g = tops.solve_pressure(pc.grid, pc.num, _t(p), _t(us), _t(vs), _t(rho))
    assert _rel(p_g, p_w) <= TOL
    # the ghosts keep the entry p
    np.testing.assert_array_equal(p_g.numpy()[0], p[0])
    np.testing.assert_array_equal(p_g.numpy()[:, -1], p[:, -1])


def test_update_velocity(dev):
    cfg, pc, F, u, v, p = dev
    J = jnp.asarray
    rho, _ = jops.mix_properties(cfg.fluid, J(F))
    rng = np.random.default_rng(1)
    us, vs = (rng.uniform(-1e-3, 1e-3, F.shape) for _ in range(2))
    want = jops.update_velocity(cfg.grid, cfg.num, J(u), J(v), J(us), J(vs), J(p), rho)
    got = tops.update_velocity(pc.grid, pc.num, _t(u), _t(v), _t(us), _t(vs), _t(p), _t(rho))
    for g_, w_ in zip(got, want):
        assert _rel(g_, w_) <= TOL


@pytest.mark.parametrize("variant", ["forward", "diff", "scheme_test"])
@pytest.mark.parametrize("axis", [0, 1])
def test_fct_sweep(dev, variant, axis):
    cfg, pc, F, u, v, p = dev
    jvar = {"forward": tv.FCT_FORWARD, "diff": tv.FCT_DIFF,
            "scheme_test": tv.FCT_SCHEME_TEST}[variant]
    tvar = {"forward": tt.FCT_FORWARD, "diff": tt.FCT_DIFF,
            "scheme_test": tt.FCT_SCHEME_TEST}[variant]
    vel = u if axis == 0 else v
    jf = jops.fct_sweep_x if axis == 0 else jops.fct_sweep_y
    tf = tops.fct_sweep_x if axis == 0 else tops.fct_sweep_y
    want = jf(cfg.grid, cfg.num, jnp.asarray(F), jnp.asarray(vel), jvar)
    got = tf(pc.grid, pc.num, _t(F), _t(vel), tvar)
    assert got.is_contiguous()
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("even", [False, True])
@pytest.mark.parametrize("between", [False, True])
def test_rudman_advect_parity_order(dev, even, between):
    cfg, pc, F, u, v, p = dev
    import dataclasses
    cfg = cfg.replace(num=dataclasses.replace(cfg.num, bc_between_sweeps=between))
    pc = pc.replace(num=dataclasses.replace(pc.num, bc_between_sweeps=between))
    want = jops.rudman_advect(cfg.grid, cfg.num, *map(jnp.asarray, (F, u, v)), even)
    got = tops.rudman_advect(pc.grid, pc.num, _t(F), _t(u), _t(v), even)
    assert _rel(got, want) <= TOL


def test_apply_bc_bit_equal_and_corner_order():
    rng = np.random.default_rng(2)
    arrs = [rng.standard_normal((10, 12)) for _ in range(5)]
    want = jops.apply_bc(*map(jnp.asarray, arrs))
    got = tops.apply_bc(*map(_t, arrs))
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
    u, v, F, p, rho = (a.numpy() for a in got)
    # j-boundaries first, then i: a corner ghost is the diagonal interior value
    for a in (F, p, rho):
        assert a[0, 0] == a[1, 1] and a[-1, -1] == a[-2, -2]
    assert u[1, 0] == 0.0 and u[-1, -1] == 0.0  # the i-walls overwrite u's j-ghosts
    assert v[0, 1] == 0.0  # v's i-ghost mirrors the j-wall's zero
    # the inputs are not modified
    for a, t in zip(arrs, map(_t, arrs)):
        np.testing.assert_array_equal(a, t.numpy())


def test_mirror_scalar_bit_equal():
    a = np.random.default_rng(3).standard_normal((9, 7))
    np.testing.assert_array_equal(tops.mirror_scalar(_t(a)).numpy(),
                                  np.asarray(jops.mirror_scalar(jnp.asarray(a))))


def test_clamp01_strict_select():
    x = np.array([-0.5, 0.0, 0.3, 1.0, 1.5, -0.0])
    got = tops.clamp01(_t(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.clamp01(jnp.asarray(x))))
    # derivative 1 at the ties 0 and 1, as the strict selects give (the
    # differentiable path depends on it; torch.clamp would give 0.5 here)
    xt = _t(x).requires_grad_(True)
    tops.clamp01(xt).sum().backward()
    want = jax.grad(lambda a: jops.clamp01(a).sum())(jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
    assert xt.grad.numpy()[1] == 1.0 and xt.grad.numpy()[3] == 1.0


@pytest.mark.parametrize("n", [64, 200])
@pytest.mark.parametrize("ic", [1, 2, 3])
def test_initial_conditions_bit_equal(n, ic):
    cfg = tv.dam_break_2d(n)
    want = tv.initial_volume_fraction(cfg.grid, ic)
    got = tt.initial_volume_fraction(tt.Grid2D(n, n), ic)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    s = tt.init_state(tt.dam_break_2d(n), ic, "cpu", torch.float32)
    np.testing.assert_array_equal(s.F.numpy(), np.asarray(tv.init_state(cfg, ic=ic).F))
    for a in s[1:]:
        assert a.dtype == torch.float32 and not a.any()


def test_grid_and_ic_validation():
    with pytest.raises(ValueError):
        tt.initial_volume_fraction(tt.Grid2D(16, 16), 7)
    with pytest.raises(ValueError):
        tt.SimConfig(grid=tt.Grid2D(32, 16))
    with pytest.raises(ValueError):
        tt.Grid2D(1, 1).validate()
    g, jg = tt.Grid2D(48, 48), tv.Grid2D(48, 48)
    assert (g.dx, g.dy, g.dxi, g.dyi, g.shape) == (jg.dx, jg.dy, jg.dxi, jg.dyi, jg.shape)
