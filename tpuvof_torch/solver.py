"""Time-step driver (counterpart of tpuvof/solver.py).

Step order (identical to the reference):
  mix rho/nu -> Youngs normals + curvature -> momentum predictor -> BC ->
  pressure solve -> velocity correction -> BC -> Rudman FCT double sweep
  (parity-alternated order) -> clamp F -> BC.

The reference increments istep before the step body, so the first step
runs the odd branch (x then y). ``simulate`` applies the BCs once at entry
and then runs lean steps (see ``step``), in a Python loop that makes no
host synchronisation on the fixed-Jacobi routes.

Routes (``effective_backend``), each tpuvof's namesake:
  'torch'        plain ops (tpuvof's 'xla'), every pressure solver;
  'cuda'         the three phase kernels; with a residual-driven solver,
                 the hybrid step: the predict and sweep kernels around the
                 plain solve (tpuvof's _step_pallas);
  'cuda_mono'    the whole-step kernel on the whole grid, one launch a step;
  'cuda_tiled'   the whole-step kernel on STEP_HALO-extended tiles;
  'cuda_strips'  the whole-step kernel on a padded layout kept resident
                 across ``simulate``.
The whole-step routes run the fixed Jacobi only; with a residual-driven
solver every 'cuda*' backend takes the hybrid step. tpuvof picks tiles,
strips and its upgrades from a model of the TPU's VMEM; that model is not
ported, so 'cuda_mono' stays mono at every size. Given CPU tensors, the
kernel wrappers run their plain versions.
"""
from __future__ import annotations

import dataclasses

import torch

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
from .ops.mg import mg_levels
from .state import State

__all__ = ["step", "step_pair", "simulate", "simulate_cfl", "make_step_fn",
           "effective_backend", "resolve_auto", "CFL_LIMIT"]

_BACKENDS = ("torch", "cuda", "cuda_mono", "cuda_tiled", "cuda_strips")
_SOLVERS = ("jacobi", "rbsor", "mg", "auto")

#: Default tile of the tiled routes: full-width strips of this many rows
#: where they divide nx, else the whole grid. The kernel streams its block
#: through HBM, so a tile needs no on-chip fit; taller tiles waste less of
#: the 2*STEP_HALO overlap per launch. Tests and callers pass their own.
TILE_ROWS = 128


def resolve_auto(cfg: SimConfig) -> SimConfig:
    """pressure_solver='auto' -> 'mg' where the grid coarsens at all
    (mg_levels >= 2 levels), else 'rbsor'; any other value unchanged."""
    if cfg.num.pressure_solver != "auto":
        return cfg
    pick = "mg" if len(mg_levels((cfg.grid.nx, cfg.grid.ny))) >= 2 else "rbsor"
    return cfg.replace(num=dataclasses.replace(cfg.num, pressure_solver=pick))


def _check_supported(cfg: SimConfig) -> None:
    nm = cfg.num
    if nm.backend not in _BACKENDS:
        raise NotImplementedError(
            f"backend={nm.backend!r} is not a backend of the port; it has "
            f"{_BACKENDS} (tpuvof's names map through tpuvof_torch.convert)")
    if nm.pressure_solver not in _SOLVERS:
        raise ValueError(f"unknown pressure_solver {nm.pressure_solver!r}; "
                         f"expected one of {_SOLVERS}")
    if nm.bc_between_sweeps and nm.backend != "torch":
        # tpuvof's Pallas routes sweep with no mirror in between and so
        # ignore the flag (tpuvof/solver.py:297-301); only its plain path
        # honours it, as 'torch' does here
        raise NotImplementedError(
            "bc_between_sweeps=True (the FCT test variant's mid-sweep mirror) "
            "runs on backend='torch' only: tpuvof's Pallas routes ignore it")


def effective_backend(cfg: SimConfig) -> str:
    """The route ``step`` takes for this config: the backend itself, except
    that every 'cuda*' backend with a residual-driven pressure solver runs
    the hybrid step of 'cuda'."""
    _check_supported(cfg)
    backend = cfg.num.backend
    if backend.startswith("cuda") and cfg.num.pressure_solver != "jacobi":
        return "cuda"
    return backend


def _with_bc(state: State) -> State:
    u, v, F, p = apply_bc(state.u, state.v, state.F, state.p)
    return State(F=F, u=u, v=v, p=p)


def step(cfg: SimConfig, state: State, even_step: bool, lean: bool = False) -> State:
    """One full time step; ``even_step`` selects the sweep order.

    ``lean=True`` skips the two mid-step BC re-applications. From an entry
    state whose ghosts are BC-consistent this is exactly the same
    computation: the first re-application touches only fields unchanged
    since the last end-of-step BC, and the second only rewrites ghost
    entries and wall faces that the rest of the step never reads or that
    still hold their BC values. The whole-step routes compute the lean
    step; called with ``lean=False`` they apply the BCs at entry first, as
    tpuvof's do. The returned tensors are new; the entry state is not
    modified."""
    cfg = resolve_auto(cfg)
    route = effective_backend(cfg)
    if route in ("cuda_mono", "cuda_tiled", "cuda_strips") and not lean:
        state = _with_bc(state)
    if route == "cuda":
        return _step_cuda(cfg, state, even_step, lean)
    if route == "cuda_mono":
        return _step_cuda_mono(cfg, state, even_step)
    if route == "cuda_tiled":
        return _step_cuda_tiled(cfg, state, even_step)
    if route == "cuda_strips":
        return _step_cuda_strips(cfg, state, even_step)
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
    """The step through the phase kernels (tpuvof's _step_pallas): the
    projection kernel for the fixed Jacobi, else the hybrid, the plain
    residual-driven solve between the predict and sweep kernels. The
    clamp and the BCs between kernels stay plain torch."""
    g, nm = cfg.grid, cfg.num
    F, u, v, p = state

    u_star, v_star = K.predict(cfg, u, v, F)
    if not lean:
        u, v, F, p = apply_bc(u, v, F, p)

    if nm.pressure_solver == "jacobi":
        p, u, v = K.project(cfg, F, u_star, v_star, p, u, v)
    else:
        rho, _ = mix_properties(cfg.fluid, F)
        p = solve_pressure(g, nm, p, u_star, v_star, rho)
        u, v = update_velocity(g, nm, u, v, u_star, v_star, p, rho)
    if not lean:
        u, v, F, p = apply_bc(u, v, F, p)

    for axis in (1, 0) if even_step else (0, 1):
        F = K.fct_sweep(cfg, F, v if axis else u, axis)
    F = clamp01(F)
    u, v, F, p = apply_bc_(u, v, F, p)
    return State(F=F, u=u, v=v, p=p)


def _tile(cfg: SimConfig, tile) -> tuple[int, int]:
    g = cfg.grid
    if tile is None:
        tile = (TILE_ROWS, g.ny) if g.nx % TILE_ROWS == 0 else (g.nx, g.ny)
    if isinstance(tile, int):
        tile = (tile, tile)
    tx, ty = tile
    if tx < 1 or ty < 1 or g.nx % tx or g.ny % ty:
        raise ValueError(f"tile {tile} does not divide the {g.nx}x{g.ny} grid")
    return tx, ty


def _tiled(fields, W: int, tile, call, n_out: int):
    """Run ``call(blocks, oi, oj)`` on every (tx+2W+2, ty+2W+2) block of the
    W-zero-padded fields, tile by tile, and assemble each output from the
    blocks' (tx+2, ty+2) centres (neighbouring centres overlap by two rows
    or columns of identical values)."""
    tx, ty = tile
    n0, n1 = fields[0].shape
    padded = [torch.nn.functional.pad(a, (W, W, W, W)) for a in fields]
    outs = [torch.empty_like(fields[0]) for _ in range(n_out)]
    for r0 in range(0, n0 - 2, tx):
        for c0 in range(0, n1 - 2, ty):
            blocks = [a[r0:r0 + tx + 2 * W + 2, c0:c0 + ty + 2 * W + 2].contiguous()
                      for a in padded]
            for acc, o in zip(outs, call(blocks, r0 - W, c0 - W)):
                acc[r0:r0 + tx + 2, c0:c0 + ty + 2] = o[W:W + tx + 2, W:W + ty + 2]
    return outs


def _step_cuda_hybrid_tiled(cfg: SimConfig, state: State, even_step: bool,
                            tile: int | tuple[int, int] | None = None,
                            lean: bool = False) -> State:
    """The hybrid step with each phase kernel run tile by tile on
    PHASE_HALO-extended blocks (predict_win, fct_sweep_win) and the plain
    solve between them (tpuvof's _step_pallas_hybrid_tiled, which serves
    grids beyond VMEM; here it is reached explicitly)."""
    g, nm = cfg.grid, cfg.num
    W = K.PHASE_HALO
    T = _tile(cfg, tile)
    F, u, v, p = state

    u_star, v_star = _tiled(
        (u, v, F), W, T, lambda b, oi, oj: K.predict_win(cfg, *b, oi, oj), 2)
    if not lean:
        u, v, F, p = apply_bc(u, v, F, p)

    rho, _ = mix_properties(cfg.fluid, F)
    p = solve_pressure(g, nm, p, u_star, v_star, rho)
    u, v = update_velocity(g, nm, u, v, u_star, v_star, p, rho)
    if not lean:
        u, v, F, p = apply_bc(u, v, F, p)

    for axis in (1, 0) if even_step else (0, 1):
        vel = v if axis else u
        (F,) = _tiled((F, vel), W, T, lambda b, oi, oj, axis=axis: (
            K.fct_sweep_win(cfg, b[0], b[1], axis, oi, oj),), 1)
    F = clamp01(F)
    u, v, F, p = apply_bc_(u, v, F, p)
    return State(F=F, u=u, v=v, p=p)


def _step_cuda_mono(cfg: SimConfig, state: State, even_step: bool) -> State:
    """The whole lean step as one kernel launch on the whole grid."""
    return State(*K.fullstep(cfg, *state, even_step))


def _step_cuda_tiled(cfg: SimConfig, state: State, even_step: bool,
                     tile: int | tuple[int, int] | None = None) -> State:
    """The whole lean step tile by tile (tpuvof's _step_pallas_tiled): each
    tile's STEP_HALO-extended block, sliced from the current state with
    zeros beyond the walls, goes through fullstep_win at its global
    origin, and its (T+2)-wide centre, at least STEP_HALO from the block's
    edges, is exactly the whole-grid step's."""
    out = _tiled(tuple(state), K.STEP_HALO(cfg), _tile(cfg, tile),
                 lambda b, oi, oj: K.fullstep_win(cfg, *b, oi, oj, even_step), 4)
    return State(*out)


def _pad_strips(cfg: SimConfig, a):
    w2 = K.strips_halo(cfg)
    return torch.nn.functional.pad(a, (w2, w2, w2, w2))


def _unpad_strips(cfg: SimConfig, padded) -> State:
    w2 = K.strips_halo(cfg)
    g = cfg.grid
    return State(*(a[w2:w2 + g.nx + 2, w2:w2 + g.ny + 2].contiguous() for a in padded))


def _step_cuda_strips(cfg: SimConfig, state: State, even_step: bool) -> State:
    """The whole lean step on the strips engine's padded layout, padded
    and cut back per call (tests, single steps); ``simulate`` keeps the
    layout resident (_simulate_strips)."""
    padded = [_pad_strips(cfg, a) for a in state]
    return _unpad_strips(cfg, K.fullstep_strips(cfg, *padded, even_step))


def _simulate_strips(cfg: SimConfig, state: State, n_steps: int, even1: bool) -> State:
    """Pad once to the resident layout, one fullstep_strips launch per step
    on the padded tensors (the margins are never rewritten between steps:
    the kernel sanitizes them at load), and cut the state out at the end
    (tpuvof's _simulate_strips)."""
    padded = [_pad_strips(cfg, a) for a in state]
    for k in range(n_steps):
        padded = K.fullstep_strips(cfg, *padded, even1 if k % 2 == 0 else not even1)
    return _unpad_strips(cfg, padded)


def step_pair(cfg: SimConfig, state: State, lean: bool = False) -> State:
    """Two consecutive steps, odd parity (x then y) then even (y then x)."""
    state = step(cfg, state, even_step=False, lean=lean)
    return step(cfg, state, even_step=True, lean=lean)


def simulate(cfg: SimConfig, state: State, n_steps: int, istep0: int = 0) -> State:
    """Advance ``n_steps`` steps: BCs once at entry, then lean steps.

    ``istep0`` is the global index of the last step already taken; chunked
    callers must pass it so the sweep-order parity continues as the
    reference's continuous istep counter does."""
    cfg = resolve_auto(cfg)
    route = effective_backend(cfg)
    state = _with_bc(state)
    even1 = (istep0 + 1) % 2 == 0  # parity of the first step taken here
    if route == "cuda_strips":
        return _simulate_strips(cfg, state, n_steps, even1)
    for k in range(n_steps):
        state = step(cfg, state, even_step=even1 if k % 2 == 0 else not even1, lean=True)
    return state


CFL_LIMIT = 0.25  # the reference's warning threshold


def simulate_cfl(cfg: SimConfig, state: State, n_steps: int, istep0: int = 0):
    """``simulate`` that also tracks the Courant number (tpuvof's
    simulate_cfl): returns (state, report), report = dict(cfl, step, axis,
    i, j, violations, first_step). cfl is the largest signed u*dt/dx or
    v*dt/dy after any step, step its 1-based global step, (i, j) its face;
    violations counts every (face, step) above CFL_LIMIT, the warnings the
    reference would print; first_step is the 1-based step of the first, or
    None. The record stays on the device until the end."""
    cfg = resolve_auto(cfg)
    g, nm = cfg.grid, cfg.num
    state = _with_bc(state)
    even1 = (istep0 + 1) % 2 == 0
    dev = state.u.device
    i32 = dict(dtype=torch.int32, device=dev)
    best = torch.full((), float("-inf"), dtype=state.u.dtype, device=dev)
    stp, ax, bi, bj, count, first = (torch.zeros((), **i32) for _ in range(6))
    n1 = state.u.shape[1]
    for k in range(n_steps):
        state = step(cfg, state, even_step=even1 if k % 2 == 0 else not even1, lean=True)
        cu = state.u * (nm.dt * g.dxi)
        cv = state.v * (nm.dt * g.dyi)
        ku = torch.argmax(cu)
        kv = torch.argmax(cv)
        mu = cu.reshape(-1)[ku]
        mv = cv.reshape(-1)[kv]
        use_v = mv > mu
        m = torch.where(use_v, mv, mu)
        kk = torch.where(use_v, kv, ku).to(torch.int32)
        nv = ((cu > CFL_LIMIT).sum() + (cv > CFL_LIMIT).sum()).to(torch.int32)
        here = torch.full((), k, **i32)
        first = torch.where((count == 0) & (nv > 0), here, first)
        better = m > best
        best = torch.where(better, m, best)
        stp = torch.where(better, here, stp)
        ax = torch.where(better, use_v.to(torch.int32), ax)
        bi = torch.where(better, kk // n1, bi)
        bj = torch.where(better, kk % n1, bj)
        count = count + nv
    nviol = int(count)
    return state, {
        "cfl": float(best),
        "step": istep0 + int(stp) + 1,
        "axis": "u" if int(ax) == 0 else "v",
        "i": int(bi),
        "j": int(bj),
        "violations": nviol,
        "first_step": (istep0 + int(first) + 1) if nviol else None,
    }


def make_step_fn(cfg: SimConfig):
    """A single-step function ``fn(state, istep)`` whose sweep order
    follows ``istep``'s parity (for drivers that step one at a time)."""

    def fn(state: State, istep: int) -> State:
        return step(cfg, state, even_step=int(istep) % 2 == 0)

    return fn
