"""The converged projection under autograd: tpuvof_torch's implicit-function
adjoints of mg and rbsor (ops.mg.mg_solve_implicit, ops.poisson.
RbsorImplicit), and the self-adjoint Jacobi (ops.poisson.JacobiSelfAdjoint),
against finite differences and against tpuvof.

The analogs of tests/test_diff_implicit.py keep that file's sizes and bars
(the 80^2 FD check and the 999-step bound are slow there and here). Port
against tpuvof, f64, the same numpy inputs: the solve's gradient against
tpuvof run eagerly, and the 3-step rollout's against tpuvof's jitted
program (eager, its mg rollout takes minutes; a linear solve's FMA
contraction moves the gradient by ~1e-26 here), at rtol 1e-8.

FD validity: a perturbation can shift a residual-driven loop's trip count;
with a tight tolerance the kink sits at the tolerance's scale, far below
the FD step.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import tpuvof as tv
from tpuvof import diff as jdiff
from tpuvof.config import Numerics as JNumerics
from tpuvof.ops.mg import mg_solve_implicit as j_mg_solve_implicit
from tpuvof.ops.poisson import _rbsor_implicit as j_rbsor_implicit

import tpuvof_torch as tt
from tpuvof_torch import diff
from tpuvof_torch.convert import config_from_tpuvof
from tpuvof_torch.ops.mg import mg_solve, mg_solve_implicit
from tpuvof_torch.ops.poisson import JacobiSelfAdjoint, RbsorImplicit

from test_torch_diff import smooth_f0

TIGHT = dict(sor_tol=1e-11, sor_max_iter=3000)
G = tt.Grid2D(16, 16)
INV2 = (G.dxi**2, G.dyi**2)
NM_RBSOR = tt.Numerics(pressure_solver="rbsor", backend="torch", **TIGHT)


def _rand(shape, seed, scale=1.0):
    return torch.as_tensor(np.random.default_rng(seed).normal(size=shape) * scale)


def _weight():
    """A weight with a mean-free interior: the solve's output is defined up
    to a constant that no downstream difference sees, so the adjoint
    answers only such losses."""
    w = _rand((18, 18), 1)
    w[1:-1, 1:-1] -= w[1:-1, 1:-1].mean()
    return w


def _solve(solver, p0, rhs):
    if solver == "mg":
        return mg_solve_implicit(p0, rhs, INV2, 1e-9, 3000)
    if solver == "rbsor":
        return RbsorImplicit.apply(G, NM_RBSOR, p0, rhs)
    return JacobiSelfAdjoint.apply(G, 10, p0, rhs)


def test_mg_implicit_primal_matches_mg_solve():
    """The primal is mg_solve's, bit for bit."""
    rhs = _rand((16, 16), 0)
    rhs = rhs - rhs.mean()
    p0 = torch.zeros((18, 18), dtype=torch.float64)
    a = mg_solve(p0, rhs, INV2, 1e-10, 500)
    b = mg_solve_implicit(p0, rhs, INV2, 1e-10, 500)
    assert torch.equal(a, b)


@pytest.mark.parametrize("solver", ["mg", "rbsor"])
def test_implicit_solve_grad_matches_fd(solver):
    """d(loss)/d(rhs) through the converged solve against central
    differences, f64, solve tolerance 1e-9 against a rhs of scale 1e3."""
    w = _weight()
    rhs0 = _rand((16, 16), 2, scale=1e3)

    def loss(rhs):
        return torch.sum(w * _solve(solver, torch.zeros((18, 18), dtype=torch.float64), rhs))

    r = rhs0.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(loss(r), r)
    assert torch.isfinite(grad).all()
    rng = np.random.default_rng(3)
    eps = 1e-2  # FD noise ~ tol / eps ~ 1e-7
    for _ in range(4):
        i, j = rng.integers(0, 16, size=2)
        e = torch.zeros_like(rhs0)
        e[i, j] = 1.0
        fd = (loss(rhs0 + eps * e) - loss(rhs0 - eps * e)).item() / (2 * eps)
        assert np.isclose(grad[i, j].item(), fd, rtol=1e-4, atol=1e-8), (
            (i, j), grad[i, j].item(), fd)


@pytest.mark.parametrize("solver", ["mg", "rbsor", "jacobi"])
def test_implicit_warm_start_carries_no_grad(solver):
    """The adjoints give the warm start a zero cotangent, exactly: a
    converged solve depends on it only through the projected-out constant,
    and the self-adjoint Jacobi treats its truncated solve as converged."""
    rhs = _rand((16, 16), 4, scale=1e3)
    p0 = _rand((18, 18), 5).requires_grad_(True)
    p = _solve(solver, p0, rhs)
    (gp,) = torch.autograd.grad(torch.sum(p * p), p0)
    assert torch.equal(gp, torch.zeros_like(gp))


@pytest.mark.parametrize("solver", ["mg", "rbsor"])
def test_implicit_solve_grad_matches_tpuvof(solver):
    """The solve's dL/d(rhs) against tpuvof's custom_vjp, eager, f64."""
    w = _weight()
    rhs0 = _rand((16, 16), 2, scale=1e3)
    jw = jnp.asarray(w.numpy())
    jg = tv.Grid2D(16, 16)
    jnm = JNumerics(pressure_solver="rbsor", **TIGHT)
    if solver == "mg":
        def jloss(rhs):
            return jnp.sum(jw * j_mg_solve_implicit(jnp.zeros((18, 18)), rhs, INV2, 1e-9, 3000))
    else:
        def jloss(rhs):
            return jnp.sum(jw * j_rbsor_implicit(jg, jnm, jnp.zeros((18, 18)), rhs))
    with jax.disable_jit():
        want = np.asarray(jax.grad(jloss)(jnp.asarray(rhs0.numpy())))
    r = rhs0.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(
        torch.sum(w * _solve(solver, torch.zeros((18, 18), dtype=torch.float64), r)), r)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("solver", ["mg", "rbsor"])
def test_diff_rollout_grad_matches_fd(solver):
    """Autograd through step_diff with the converged projection against
    central differences: the mg and rbsor twin of test_torch_diff's
    unrolled FD check."""
    cfg = diff.diff_config(n=10, pressure_solver=solver, **TIGHT)
    Ftarget = diff.diff_target(cfg, 2, device="cpu").to(torch.float64)
    F0 = smooth_f0(cfg)
    n_steps = 3
    _, grad = diff.loss_and_grad(cfg, F0, Ftarget, n_steps, True)
    assert torch.isfinite(grad).all()
    rng = np.random.default_rng(1)
    eps = 1e-6
    for _ in range(4):
        i, j = rng.integers(2, cfg.grid.nx, size=2)
        e = torch.zeros_like(F0)
        e[i, j] = 1.0
        lp, _ = diff.loss_and_grad(cfg, F0 + eps * e, Ftarget, n_steps, True)
        lm, _ = diff.loss_and_grad(cfg, F0 - eps * e, Ftarget, n_steps, True)
        fd = (lp - lm).item() / (2 * eps)
        assert np.isclose(grad[i, j].item(), fd, rtol=1e-3, atol=1e-6), (
            (i, j), grad[i, j].item(), fd)


@pytest.mark.parametrize("solver", ["mg", "rbsor"])
def test_diff_rollout_grad_matches_tpuvof(solver):
    """loss_and_grad with the converged projection, 10^2 x 3 steps, f64,
    the same F0, against tpuvof's (jitted: see the module's docstring)."""
    jcfg = jdiff.diff_config(n=10, pressure_solver=solver, **TIGHT)
    F0 = np.random.default_rng(0).uniform(0.2, 0.8, jcfg.grid.shape)
    T = np.asarray(jdiff.diff_target(jcfg, 2), np.float64)
    lj, gj = jdiff.loss_and_grad(jcfg, jnp.asarray(F0), jnp.asarray(T), 3, True)
    lt, gt = diff.loss_and_grad(config_from_tpuvof(jcfg), torch.as_tensor(F0),
                                torch.as_tensor(T), 3)
    assert np.isclose(lt.item(), float(lj), rtol=1e-12, atol=0.0)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("solver", ["mg", "rbsor"])
def test_remat_recomputes_the_same_converged_solves(solver):
    """Under remat the backward pass reruns each pair of steps, the
    host-driven solver loops included; they take the forward pass's exits,
    so the gradient equals the one without remat bit for bit."""
    cfg = diff.diff_config(n=10, pressure_solver=solver, sor_tol=1e-9, sor_max_iter=500)
    Ftarget = diff.diff_target(cfg, 2, device="cpu").to(torch.float64)
    F0 = smooth_f0(cfg)
    l1, g1 = diff.loss_and_grad(cfg, F0, Ftarget, 5, True)
    l2, g2 = diff.loss_and_grad(cfg, F0, Ftarget, 5, False)
    assert torch.equal(l1, l2) and torch.equal(g1, g2)


@pytest.mark.slow
def test_diff_mg_grad_at_80():
    """FD check of the mg projection at the reference's 80^2 diff grid."""
    cfg = diff.diff_config(n=80, pressure_solver="mg", **TIGHT)
    Ftarget = diff.diff_target(cfg, 2, device="cpu").to(torch.float64)
    F0 = smooth_f0(cfg)
    n_steps = 2
    _, grad = diff.loss_and_grad(cfg, F0, Ftarget, n_steps, True)
    assert torch.isfinite(grad).all()
    rng = np.random.default_rng(2)
    eps = 1e-6
    for _ in range(3):
        i, j = rng.integers(2, cfg.grid.nx, size=2)
        e = torch.zeros_like(F0)
        e[i, j] = 1.0
        lp, _ = diff.loss_and_grad(cfg, F0 + eps * e, Ftarget, n_steps, True)
        lm, _ = diff.loss_and_grad(cfg, F0 - eps * e, Ftarget, n_steps, True)
        fd = (lp - lm).item() / (2 * eps)
        assert np.isclose(grad[i, j].item(), fd, rtol=1e-3, atol=1e-6), (
            (i, j), grad[i, j].item(), fd)


@pytest.mark.slow
def test_diff_mg_grads_bounded_999_steps():
    """The production mg setting over the reference's 999-step horizon, f32:
    finite, and |g| inside the reference's gate scale (it gates at 5; an
    exploding adjoint would run far past 50)."""
    cfg = diff.diff_config(n=80, pressure_solver="mg", sor_tol=0.0, sor_tol_rel=1e-3,
                           sor_max_iter=50)
    Ftarget = diff.diff_target(cfg, 2, device="cpu")
    F0 = torch.zeros_like(Ftarget)
    loss, grad = diff.loss_and_grad(cfg, F0, Ftarget, 999, True)
    assert torch.isfinite(loss) and torch.isfinite(grad).all()
    assert grad.abs().max().item() < 50.0, grad.abs().max().item()


@pytest.mark.parametrize("solver", ["mg", "rbsor"])
def test_unrolled_with_converged_solver_raises(solver):
    with pytest.raises(ValueError, match="implicit-function"):
        diff.diff_config(n=10, pressure_solver=solver, adjoint="unrolled")
