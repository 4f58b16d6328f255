"""tpuvof_torch.diff, the differentiable path, against tpuvof.diff.

The analogs of tests/test_diff.py hold the port's gradients to central
finite differences and its optimiser to progress, at that file's sizes and
bars; the ones tpuvof's conftest marks slow are marked slow here. Port
against tpuvof: loss and dL/dF0 through the unrolled and the self-adjoint
pressure adjoints, f64, the same numpy F0, tpuvof run eagerly (its jitted
program contracts FMAs); the loss within 1e-12 relative, the gradient at
the bar tpuvof holds between its own two gradient paths (rtol 1e-8, atol
1e-12).
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import tpuvof as tv
from tpuvof import diff as jdiff

import tpuvof_torch as tt
from tpuvof_torch import diff
import tpuvof_torch.models as M
from tpuvof_torch.convert import config_from_tpuvof

from test_diff import smooth_f0 as _smooth_f0_jax


def small_cfg(adjoint="unrolled", n=10, n_jacobi=4):
    return diff.diff_config(n=n, n_jacobi=n_jacobi, adjoint=adjoint)


def smooth_f0(cfg, seed=0):
    """tpuvof's test F0 (smooth, inside (0.2, 0.8), away from the upwind and
    limiter selects, so finite differences hold), f64."""
    return torch.tensor(np.asarray(_smooth_f0_jax(cfg, seed)))


def target(cfg, ic=2):
    return diff.diff_target(cfg, ic, device="cpu").to(torch.float64)


def test_grad_matches_finite_differences():
    """Autograd through the unrolled step equals the true derivative."""
    cfg = small_cfg()
    Ftarget = target(cfg)
    F0 = smooth_f0(cfg)
    n_steps = 3
    _, grad = diff.loss_and_grad(cfg, F0, Ftarget, n_steps, True)
    rng = np.random.default_rng(1)
    eps = 1e-6
    for _ in range(6):
        i, j = rng.integers(2, cfg.grid.nx, size=2)
        e = torch.zeros_like(F0)
        e[i, j] = 1.0
        lp, _ = diff.loss_and_grad(cfg, F0 + eps * e, Ftarget, n_steps, True)
        lm, _ = diff.loss_and_grad(cfg, F0 - eps * e, Ftarget, n_steps, True)
        fd = (lp - lm).item() / (2 * eps)
        assert np.isclose(grad[i, j].item(), fd, rtol=5e-4, atol=1e-7), (
            (i, j), grad[i, j].item(), fd)


@pytest.mark.slow
def test_remat_matches_no_remat():
    cfg = small_cfg()
    Ftarget = target(cfg)
    F0 = smooth_f0(cfg)
    l1, g1 = diff.loss_and_grad(cfg, F0, Ftarget, 4, True)
    l2, g2 = diff.loss_and_grad(cfg, F0, Ftarget, 4, False)
    assert np.isclose(l1.item(), l2.item(), rtol=1e-12)
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), rtol=1e-8, atol=1e-12)


@pytest.mark.slow
def test_selfadjoint_adjoint_close_to_unrolled():
    """The self-adjoint pressure adjoint treats the truncated solve as
    converged; its gradient points the way of the exact unrolled one."""
    cfg_u = small_cfg("unrolled", n_jacobi=10)
    cfg_s = small_cfg("selfadjoint", n_jacobi=10)
    Ftarget = target(cfg_u)
    F0 = smooth_f0(cfg_u)
    _, gu = diff.loss_and_grad(cfg_u, F0, Ftarget, 4, True)
    _, gs = diff.loss_and_grad(cfg_s, F0, Ftarget, 4, True)
    gu = gu.numpy().ravel()
    gs = gs.numpy().ravel()
    cos = gu @ gs / (np.linalg.norm(gu) * np.linalg.norm(gs) + 1e-30)
    assert cos > 0.99, cos


def test_apply_grad_gate_and_clamp():
    F0 = torch.tensor([[0.5, 0.9], [0.1, 0.0]], dtype=torch.float64)
    grad = torch.tensor([[10.0, 0.5], [-0.5, -1.0]], dtype=torch.float64)
    out = diff.apply_grad(F0, grad, lr=1.0, grad_gate=5.0, interior_only=False).numpy()
    assert out[0, 0] == 0.5  # gated: |grad| >= 5 leaves F untouched
    assert out[0, 1] == pytest.approx(0.4)
    assert out[1, 0] == pytest.approx(0.6)
    assert out[1, 1] == pytest.approx(1.0)  # clamped to [0, 1]


@pytest.mark.parametrize("gate", [5.0, None, 0.0])
@pytest.mark.parametrize("interior_only", [True, False])
def test_apply_grad_matches_tpuvof(gate, interior_only):
    """Bit for bit with tpuvof's eager apply_grad; gate None updates every cell,
    0.0 none (the literal |g| < 0)."""
    rng = np.random.default_rng(7)
    F0 = rng.uniform(0.0, 1.0, (8, 8))
    grad = rng.normal(scale=6.0, size=(8, 8))
    with jax.disable_jit():  # jitted, F0 - lr * grad contracts to an FMA
        want = np.asarray(jdiff.apply_grad(jnp.asarray(F0), jnp.asarray(grad), 0.05, gate,
                                           interior_only))
    got = diff.apply_grad(torch.as_tensor(F0), torch.as_tensor(grad), 0.05, gate,
                          interior_only).numpy()
    np.testing.assert_array_equal(got, want)
    if gate == 0.0:
        np.testing.assert_array_equal(got, F0)
    if gate is None and not interior_only:
        np.testing.assert_array_equal(got, np.clip(F0 - 0.05 * grad, 0.0, 1.0))


@pytest.mark.slow
def test_optimize_f0_decreases_loss():
    """A small diff_vof cycle: the loss falls and F0 stays in [0, 1]."""
    cfg = diff.diff_config(n=16, n_jacobi=4)
    Ftarget = diff.diff_target(cfg, 1, device="cpu")
    opts = diff.DiffOptions(n_steps=10, lr=0.05)
    F0, losses = diff.optimize_f0(cfg, Ftarget, opts=opts, n_epochs=25)
    assert losses[-1] < 0.5 * losses[0], losses[:3] + losses[-3:]
    assert F0.min().item() >= 0.0 and F0.max().item() <= 1.0


def test_optimize_advection_f0_decreases_loss():
    """test/diff_fct.py's analog: recover a circle target through 20
    advected steps of the vortex from a uniform F0."""
    case, _, u, v, Ftarget = M.single_vortex(n=24, tmax=2000, device="cpu")
    F0, losses = diff.optimize_advection_f0(case, u, v, Ftarget, n_steps=20, n_epochs=40,
                                            lr=0.1)
    # the L1 gradient is sign-valued: fixed-lr SGD descends, then
    # oscillates about the optimum, as the reference's does at lr=0.1
    assert min(losses) < 0.5 * losses[0], (losses[0], min(losses))
    assert losses[-1] < 0.75 * losses[0], (losses[0], losses[-1])
    gas_rec = 1.0 - F0.numpy()[1:-1, 1:-1]
    gas_tgt = 1.0 - Ftarget.numpy()[1:-1, 1:-1]
    assert gas_rec.sum() > 0.3 * gas_tgt.sum()


def test_paint_blocks():
    g = tt.Grid2D(20, 20)
    t = diff.paint_blocks(g, [(0.5, 0.5), (0.0, 0.0)], device="cpu")
    assert t.dtype == torch.float32
    t = t.numpy()
    assert t[10, 10] == 1.0 and t[9, 9] == 1.0
    assert t.sum() == pytest.approx(16 + 4)  # a whole block and a corner-clipped one
    base = np.zeros(g.shape, np.float32)
    base[3, 4] = 0.5
    want = np.asarray(jdiff.paint_blocks(tv.Grid2D(20, 20), [(0.3, 0.9), (0.99, 0.5)], base))
    got = diff.paint_blocks(g, [(0.3, 0.9), (0.99, 0.5)], torch.as_tensor(base), device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert base.sum() == 0.5  # the given target is not painted in place


def test_rollout_frames_matches_rollout():
    """The chunked forward for frames follows rollout's trajectory bit for
    bit: the 0-based parity is carried across chunks of odd length."""
    cfg = small_cfg()
    F0 = smooth_f0(cfg)
    want = diff.rollout(cfg, F0, 7, remat=False).F
    frames = list(diff.rollout_frames(cfg, F0, 7, every=3))
    assert [s for s, _ in frames] == [3, 6, 7]
    assert torch.equal(frames[-1][1], want)
    assert not frames[-1][1].requires_grad
    assert torch.is_grad_enabled()  # the generator leaves autograd on


@pytest.mark.parametrize("adjoint", ["unrolled", "selfadjoint"])
def test_loss_and_grad_matches_tpuvof(adjoint):
    """10^2 x 4 steps, f64, the same F0 and target; tpuvof eager."""
    jcfg = jdiff.diff_config(n=10, n_jacobi=4, adjoint=adjoint)
    pc = config_from_tpuvof(jcfg)
    F0 = np.random.default_rng(3).uniform(0.2, 0.8, jcfg.grid.shape)
    T = np.asarray(jdiff.diff_target(jcfg, 2), np.float64)
    with jax.disable_jit():
        lj, gj = jdiff.loss_and_grad(jcfg, jnp.asarray(F0), jnp.asarray(T), 4, True)
    lt, gt = diff.loss_and_grad(pc, torch.as_tensor(F0), torch.as_tensor(T), 4)
    assert lt.ndim == 0 and gt.shape == F0.shape
    assert np.isclose(lt.item(), float(lj), rtol=1e-12, atol=0.0)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-8, atol=1e-12)
    assert np.abs(np.asarray(gj)).max() > 1.0  # a gradient worth comparing


@pytest.mark.parametrize("adjoint,solver", [("unrolled", "jacobi"), ("selfadjoint", "jacobi"),
                                            ("selfadjoint", "mg"), ("selfadjoint", "rbsor")])
def test_diff_config_matches_tpuvof(adjoint, solver):
    """Every adjoint and solver pair tpuvof accepts converts, and equals the
    port's own diff_config (the converted backend is 'torch')."""
    kw = dict(n=12, n_jacobi=6, adjoint=adjoint, pressure_solver=solver, sor_tol=1e-7,
              sor_max_iter=123, sor_tol_rel=1e-3)
    pc = config_from_tpuvof(jdiff.diff_config(**kw))
    assert pc == diff.diff_config(**kw)
    assert pc.num.pressure_adjoint == adjoint and pc.num.backend == "torch"


@pytest.mark.parametrize("ic", [1, 2, 3])
def test_diff_target_matches_tpuvof(ic):
    jcfg = jdiff.diff_config(n=24)
    got = diff.diff_target(config_from_tpuvof(jcfg), ic, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jdiff.diff_target(jcfg, ic)))


def test_step_diff_runs_plain_ops_on_any_backend():
    """The differentiable step calls the plain ops whatever backend the
    config names, as tpuvof's does."""
    cfg = small_cfg()
    F0 = smooth_f0(cfg)
    want = diff.rollout(cfg, F0, 3, remat=False)
    for backend in ("cuda", "cuda_mono"):
        c = cfg.replace(num=dataclasses.replace(cfg.num, backend=backend))
        got = diff.rollout(c, F0, 3, remat=False)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
