"""Differentiable simulation (counterpart of tpuvof/diff.py): optimise the
initial volume fraction F0 so the end state of the solver matches a
target shape.

The reference (diff_vof.py) keeps every field with a time axis and replays
its kernels in reverse. Here autograd runs through the step loop; with
``remat`` each pair of steps is a ``torch.utils.checkpoint`` segment, so
memory holds the carried states of the pairs plus one pair's
recomputed intermediates. ``Numerics.pressure_adjoint='selfadjoint'`` runs
the pressure solve's hand-written adjoints (ops/poisson.py, ops/mg.py),
which save nothing.

The differentiable step differs from the forward solver's as the
reference's does: 0-based parity (step 0 sweeps y then x), the diff FCT
variant (flux-only dV, no clamping inside a sweep, limiter guard 1e-6), an
interior-only final clamp, and no mid-step BC applications. It runs the
plain ops whatever ``cfg.num.backend`` says, as tpuvof's runs XLA ops:
there is no kernel on this path. Every function takes its device and
dtype from its inputs.

The optimisation loop is the reference's: an L1 loss over the whole
padded array, SGD on the interior of F0 where |dL/dF0| < 5, and a clamp to
[0, 1].
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .config import FCT_DIFF, Fluid, Numerics, SimConfig
from .grid import Grid2D
from .ops import (
    apply_bc,
    clamp01,
    mix_properties,
    predict_velocity,
    rudman_advect,
    solve_pressure,
    update_velocity,
    young_normals_curvature,
)
from .ops.common import merge_interior
from .state import State, find_area

__all__ = [
    "DiffOptions",
    "diff_config",
    "diff_target",
    "paint_blocks",
    "step_diff",
    "rollout",
    "rollout_frames",
    "l1_loss",
    "loss_and_grad",
    "apply_grad",
    "optimize_f0",
    "advection_loss_and_grad",
    "optimize_advection_f0",
]


@dataclass(frozen=True)
class DiffOptions:
    """Optimisation hyperparameters (the reference's diff_vof.py)."""

    n_steps: int = 999  # forward steps per epoch
    lr: float = 0.02
    grad_gate: float = 5.0  # update only where |dL/dF0| < gate
    remat: bool = True  # checkpoint each pair of steps


def diff_config(n: int = 80, n_jacobi: int = 10, adjoint: str = "selfadjoint",
                pressure_solver: str = "jacobi", sor_tol: float = 1e-3,
                sor_max_iter: int = 200, sor_tol_rel: float = 0.0) -> SimConfig:
    """The differentiable workload (diff_vof.py): n x n, gy = -1000, the
    diff FCT variant, plain ops. ``adjoint='selfadjoint'`` (the default,
    as in tpuvof) runs the hand-written pressure adjoints; 'unrolled'
    tapes the Jacobi sweeps. The converged solvers 'rbsor' and 'mg' are
    differentiable only through their implicit-function adjoint: paired
    with 'unrolled' this raises, as tpuvof's does (autograd would tape the
    host-driven loop instead)."""
    if pressure_solver != "jacobi" and adjoint != "selfadjoint":
        raise ValueError(
            f"pressure_solver={pressure_solver!r} is differentiable only "
            "under pressure_adjoint='selfadjoint' (the implicit-function "
            "adjoint); 'unrolled' would tape the residual-driven loop")
    return SimConfig(
        grid=Grid2D(n, n),
        fluid=Fluid(gy=-1000.0),
        num=Numerics(
            dt=4e-6, n_jacobi=n_jacobi, fct=FCT_DIFF, backend="torch",
            pressure_adjoint=adjoint, pressure_solver=pressure_solver,
            sor_tol=sor_tol, sor_max_iter=sor_max_iter, sor_tol_rel=sor_tol_rel,
        ),
    )


def diff_target(cfg: SimConfig, ic: int, device="cuda") -> torch.Tensor:
    """The reference's programmatic targets, f32 on ``device``: 1 = a
    centred block, 2 = a circle at the domain centre, 3 = its inverse."""
    g = cfg.grid
    if ic == 1:
        xn = g.node_x()[:, None]
        yn = g.node_y()[None, :]
        cond = (xn >= g.Lx / 3) & (xn <= 2 * g.Lx / 3) & (yn >= 0.0) & (yn <= g.Ly / 2)
        t = np.where(cond, np.float32(1.0), np.float32(0.0))
    elif ic == 2:
        t = find_area(g, g.Lx / 2, g.Ly / 2, g.Lx / 12)
    elif ic == 3:
        t = 1.0 - find_area(g, g.Lx / 2, g.Ly / 2, g.Lx / 12)
    else:
        raise ValueError(f"unknown target ic {ic}")
    return torch.as_tensor(t, device=device)


def paint_blocks(g: Grid2D, points, target=None, device="cuda") -> torch.Tensor:
    """The reference's paint-a-target, from a list of points: each (x, y)
    in [0, 1]^2 stamps a 4 x 4 block of ones (its set_pixel kernel). f32
    on ``device``; ``target``, if given, is painted over (not in place)."""
    if target is None:
        t = np.zeros(g.shape, np.float32)
    else:
        t = torch.as_tensor(target).detach().cpu().numpy().copy()
    for x, y in points:
        xc = int(x * g.nx)
        yc = int(y * g.ny)
        for i in range(max(0, xc - 2), xc + 2):
            for j in range(max(0, yc - 2), yc + 2):
                if i < t.shape[0] and j < t.shape[1]:
                    t[i, j] = 1.0
    return torch.as_tensor(t, device=device)


def step_diff(cfg: SimConfig, state: State, even_step: bool) -> State:
    """One differentiable step (diff_vof.py forward()): the lean step with
    an interior-only final clamp. ``clamp01``'s strict selects pass
    derivative 1 at the bounds, as tpuvof's do; the BCs return new
    tensors, so nothing on the tape is written in place."""
    g, fl, nm = cfg.grid, cfg.fluid, cfg.num
    F, u, v, p = state
    rho, nu = mix_properties(fl, F)
    _, _, kappa = young_normals_curvature(g, F)
    u_star, v_star = predict_velocity(g, fl, nm, u, v, F, rho, nu, kappa)
    p = solve_pressure(g, nm, p, u_star, v_star, rho)
    u, v = update_velocity(g, nm, u, v, u_star, v_star, p, rho)
    F = rudman_advect(g, nm, F, u, v, even_step)
    F = merge_interior(F, clamp01(F[1:-1, 1:-1]))
    u, v, F, p = apply_bc(u, v, F, p)
    return State(F=F, u=u, v=v, p=p)


def _step_pair(cfg: SimConfig, *fields):
    s = step_diff(cfg, State(*fields), even_step=True)
    return tuple(step_diff(cfg, s, even_step=False))


def rollout(cfg: SimConfig, F0, n_steps: int, remat: bool = True) -> State:
    """``n_steps`` of ``step_diff`` from a state at rest, 0-based parity
    (step 0 sweeps y then x). With ``remat`` each pair of steps is a
    checkpoint segment: its intermediates are recomputed in the backward
    pass. The recomputation must take the residual-driven solvers' exits
    of the forward pass, which it does: the plain ops are deterministic."""
    z = torch.zeros_like(F0)
    state = (F0, z, z, z)
    for _ in range(n_steps // 2):
        if remat:
            # the step draws no random numbers: no RNG state to keep
            state = checkpoint(_step_pair, cfg, *state, use_reentrant=False,
                               preserve_rng_state=False)
        else:
            state = _step_pair(cfg, *state)
    state = State(*state)
    if n_steps % 2:
        state = step_diff(cfg, state, even_step=True)
    return state


@torch.no_grad()
def _rollout_chunk(cfg: SimConfig, state: State, k: int, istep0: int) -> State:
    """k steps of ``step_diff`` continuing the 0-based parity from global
    step ``istep0``."""
    for i in range(k):
        state = step_diff(cfg, state, even_step=(istep0 + i) % 2 == 0)
    return state


def rollout_frames(cfg: SimConfig, F0, n_steps: int, every: int):
    """Yield (steps done, F) every ``every`` steps of ``rollout``'s
    trajectory, and at its end, for drawing the reference's frames: no
    autograd, the parity carried across chunks of any length. The final
    F equals ``rollout(remat=False)``'s bit for bit."""
    z = torch.zeros_like(F0)
    state = State(F=F0, u=z, v=z, p=z)
    done = 0
    while done < n_steps:
        k = min(every, n_steps - done)
        state = _rollout_chunk(cfg, state, k, done)
        done += k
        yield done, state.F


def _abs(x):
    # |x| whose derivative at 0 is +1, as jnp.abs's: torch.abs passes 0 there
    return torch.where(x >= 0, x, -x)


def l1_loss(F_final, Ftarget):
    """L1 over the whole padded array, ghosts included (diff_vof.py)."""
    return torch.sum(_abs(Ftarget - F_final))


def loss_and_grad(cfg: SimConfig, F0, Ftarget, n_steps: int, remat: bool = True):
    """(loss, dL/dF0) of ``rollout`` from F0 against Ftarget: a 0-dim
    tensor and a tensor shaped like F0."""
    F0 = F0.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = l1_loss(rollout(cfg, F0, n_steps, remat=remat).F, Ftarget)
        (grad,) = torch.autograd.grad(loss, F0)
    return loss.detach(), grad


@torch.no_grad()
def apply_grad(F0, grad, lr=0.02, grad_gate: float | None = 5.0,
               interior_only: bool = True):
    """Gated SGD and clamp (diff_vof.py): update only where |grad| <
    grad_gate and clamp the updated entries to [0, 1]. ``grad_gate=None``
    disables the gate; 0.0 is the literal |g| < 0, which updates
    nothing."""
    new = torch.clamp(F0 - lr * grad, 0.0, 1.0)
    upd = new if grad_gate is None else torch.where(torch.abs(grad) < grad_gate, new, F0)
    return merge_interior(F0, upd[1:-1, 1:-1]) if interior_only else upd


def optimize_f0(cfg: SimConfig, Ftarget, F0=None, opts: DiffOptions = DiffOptions(),
                n_epochs: int = 100, callback=None):
    """The optimisation cycle (diff_vof.py): ``n_epochs`` of
    ``loss_and_grad`` and ``apply_grad``, from F0 (zeros like Ftarget by
    default). Returns (F0, losses); ``callback(epoch, loss, F0, grad)``
    after each epoch."""
    if F0 is None:
        F0 = torch.zeros_like(Ftarget)
    losses = []
    for epoch in range(n_epochs):
        loss, grad = loss_and_grad(cfg, F0, Ftarget, opts.n_steps, opts.remat)
        F0 = apply_grad(F0, grad, opts.lr, opts.grad_gate)
        losses.append(float(loss))
        if callback is not None:
            callback(epoch, float(loss), F0, grad)
    return F0, losses


def advection_loss_and_grad(case, F0, u, v, Ftarget, n_steps: int):
    """(loss, dL/dF0) after ``n_steps`` of ``simulate_advection`` under the
    fixed (u, v): L1 over cells [1:, 1:] (the reference's
    test/diff_fct.py)."""
    from .models.advection import simulate_advection

    F0 = F0.detach().requires_grad_(True)
    with torch.enable_grad():
        F = simulate_advection(case, F0, u, v, n_steps)
        loss = torch.sum(_abs(Ftarget[1:, 1:] - F[1:, 1:]))
        (grad,) = torch.autograd.grad(loss, F0)
    return loss.detach(), grad


def optimize_advection_f0(case, u, v, Ftarget, n_steps: int, n_epochs: int,
                          lr: float = 0.1, F0=None):
    """test/diff_fct.py's cycle: from F0 all ones, plain SGD with a clamp
    to [0, 1] and no gate. Returns (F0, losses)."""
    if F0 is None:
        F0 = torch.ones_like(Ftarget)
    losses = []
    for _ in range(n_epochs):
        loss, grad = advection_loss_and_grad(case, F0, u, v, Ftarget, n_steps)
        F0 = torch.clamp(F0 - lr * grad, 0.0, 1.0)
        losses.append(float(loss))
    return F0, losses
