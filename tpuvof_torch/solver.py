"""Time-step driver (counterpart of tpuvof/solver.py:64-153, 257-304, 515-561).

Step order (identical to the reference):
  mix rho/nu -> Youngs normals + curvature -> momentum predictor -> BC ->
  n_jacobi Jacobi sweeps -> velocity correction -> BC -> Rudman FCT double
  sweep (parity-alternated order) -> clamp F -> BC.

The reference increments istep before the step body, so the first step
runs the odd branch (x then y). ``simulate`` applies the BCs once at entry
and then runs lean steps (see ``step``), in a Python loop that makes no
host synchronisation.

Backends: 'torch' runs the plain ops (tpuvof's 'xla'); 'cuda' runs the
three hand-written phase kernels (tpuvof's 'pallas'), whose wrappers run
the plain versions for CPU tensors.
"""
from __future__ import annotations

from .config import SimConfig
from .kernels import step_kernels as K
from .ops import (
    apply_bc,
    apply_bc_,
    clamp01,
    mix_properties,
    predict_velocity,
    rudman_advect,
    solve_pressure,
    update_velocity,
    young_normals_curvature,
)
from .state import State

__all__ = ["step", "step_pair", "simulate"]


def _check_supported(cfg: SimConfig) -> None:
    nm = cfg.num
    if nm.backend not in ("torch", "cuda"):
        raise NotImplementedError(
            f"backend={nm.backend!r} is not ported yet: 'torch' and 'cuda' run; "
            "the whole-step kernels arrive with ROADMAP Queue 2 item 1")
    if nm.pressure_solver != "jacobi":
        raise NotImplementedError(
            f"pressure_solver={nm.pressure_solver!r} is not ported yet "
            "(ROADMAP Queue 1 item 5); only 'jacobi' runs")
    if nm.bc_between_sweeps:
        raise NotImplementedError(
            "bc_between_sweeps=True (the FCT test variant's mid-sweep mirror) "
            "is not ported yet (ROADMAP Queue 1 item 6)")


def step(cfg: SimConfig, state: State, even_step: bool, lean: bool = False) -> State:
    """One full time step; ``even_step`` selects the sweep order.

    ``lean=True`` skips the two mid-step BC re-applications. From an entry
    state whose ghosts are BC-consistent this is exactly the same
    computation: the first re-application touches only fields unchanged
    since the last end-of-step BC, and the second only rewrites ghost
    entries and wall faces that the rest of the step never reads or that
    still hold their BC values. The returned tensors are new; the entry
    state is not modified."""
    _check_supported(cfg)
    if cfg.num.backend == "cuda":
        return _step_cuda(cfg, state, even_step, lean)
    g, fl, nm = cfg.grid, cfg.fluid, cfg.num
    F, u, v, p = state

    rho, nu = mix_properties(fl, F)
    _, _, kappa = young_normals_curvature(g, F)

    u_star, v_star = predict_velocity(g, fl, nm, u, v, F, rho, nu, kappa)
    if not lean:
        u, v, F, p, rho = apply_bc(u, v, F, p, rho)

    p = solve_pressure(g, nm, p, u_star, v_star, rho)

    u, v = update_velocity(g, nm, u, v, u_star, v_star, p, rho)
    if not lean:
        u, v, F, p, rho = apply_bc(u, v, F, p, rho)

    F = rudman_advect(g, nm, F, u, v, even_step)
    F = clamp01(F)
    # u, v, F, p are new tensors of this step: the last BC writes in place
    u, v, F, p = apply_bc_(u, v, F, p)
    return State(F=F, u=u, v=v, p=p)


def _step_cuda(cfg: SimConfig, state: State, even_step: bool, lean: bool) -> State:
    """The step through the three phase kernels (tpuvof's _step_pallas);
    the clamp and the BCs between kernels stay plain torch."""
    F, u, v, p = state

    u_star, v_star = K.predict(cfg, u, v, F)
    if not lean:
        u, v, F, p = apply_bc(u, v, F, p)

    p, u, v = K.project(cfg, F, u_star, v_star, p, u, v)
    if not lean:
        u, v, F, p = apply_bc(u, v, F, p)

    for axis in (1, 0) if even_step else (0, 1):
        F = K.fct_sweep(cfg, F, v if axis else u, axis)
    F = clamp01(F)
    u, v, F, p = apply_bc_(u, v, F, p)
    return State(F=F, u=u, v=v, p=p)


def step_pair(cfg: SimConfig, state: State, lean: bool = False) -> State:
    """Two consecutive steps, odd parity (x then y) then even (y then x)."""
    state = step(cfg, state, even_step=False, lean=lean)
    return step(cfg, state, even_step=True, lean=lean)


def simulate(cfg: SimConfig, state: State, n_steps: int, istep0: int = 0) -> State:
    """Advance ``n_steps`` steps: BCs once at entry, then lean steps in pairs.

    ``istep0`` is the global index of the last step already taken; chunked
    callers must pass it so the sweep-order parity continues as the
    reference's continuous istep counter does."""
    _check_supported(cfg)
    u, v, F, p = apply_bc(state.u, state.v, state.F, state.p)
    state = State(F=F, u=u, v=v, p=p)
    even1 = (istep0 + 1) % 2 == 0  # parity of the first step taken here
    n_pairs, rem = divmod(n_steps, 2)
    for _ in range(n_pairs):
        state = step(cfg, state, even_step=even1, lean=True)
        state = step(cfg, state, even_step=not even1, lean=True)
    if rem:
        state = step(cfg, state, even_step=even1, lean=True)
    return state
