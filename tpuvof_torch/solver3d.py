"""The 3-D time stepping (counterpart of tpuvof/solver3d.py; reference
3dvof.py:598-627).

The 2-D pipeline with w-momentum, a 7-point Poisson stencil and a three-way
FCT sweep rotation. Surface tension is inert by default, as in the
reference (its 3-D normals kernel is commented out); ``csf=True`` is the
opt-in Youngs/Brackbill upgrade (ops/normals3d.py).

Routes (``backend``), each tpuvof's namesake:
  'torch'  plain ops with a BC pass after predict, after the correction and
           after the sweeps (tpuvof's 'xla'), every pressure solver;
  'cuda'   the four kernels of kernels/step3d_kernels.py (tpuvof's
           'pallas'): predict3d_rhs, jacobi3d, correct3d and three
           fct3d_sweep launches, with no plain-torch op between them. The
           kernels carry the BCs the lean step needs (see
           ``_step_3d_cuda_lean``); ``step_3d`` applies one BC at entry and
           one at exit, ``simulate_3d`` one before its first step and one
           after its last. With rbsor, mg or auto the plain solve runs
           between predict3d_rhs and correct3d (the hybrid step).
tpuvof pads the j/k axes to the TPU's (8, 128) tiling, picks slab chunks
from a VMEM model and falls back to XLA where its slab kernels do not fit;
none of that is ported: the kernels take the unpadded fields at every size,
so 'cuda' never reroutes. Given CPU tensors, the kernel wrappers run their
plain versions.
"""
from __future__ import annotations

import dataclasses

import torch

from .config import Fluid, Numerics
from .grid import Grid3D
from .kernels import step3d_kernels as K3
from .ops import apply_bc_3d, apply_bc_3d_, clamp01, mix_properties
from .ops.fct3d import SWEEP_ORDER, rudman_advect_3d
from .ops.mg import _red_mask, mg_levels, mg_solve
from .ops.momentum3d import predict_velocity_3d, update_velocity_3d
from .ops.normals3d import young_normals_curvature_3d
from .ops.poisson import cell_mean, neigh, poisson_coefficients_3d, rbsor_blocks, rhs_3d
from .state import State3D
from .utils.profiling import span

__all__ = ["step_3d", "simulate_3d"]

_BACKENDS = ("torch", "cuda")
_SOLVERS = ("jacobi", "rbsor", "mg", "auto")


def _solve_pressure_3d(g: Grid3D, dt, n_iter, p, u_star, v_star, w_star, rho):
    """The reference's fixed Jacobi sweeps; returns a new p whose ghosts
    keep p's values."""
    rhs = rhs_3d(g, dt, u_star, v_star, w_star, rho)
    coeffs = poisson_coefficients_3d(g, p.dtype, p.device)
    ap_inv = coeffs[-1]
    p = p.clone()
    for _ in range(n_iter):
        p[1:-1, 1:-1, 1:-1] = neigh(coeffs, p, rhs) * ap_inv
    return p


def _rbsor_3d(g: Grid3D, p, rhs, omega: float, tol: float, max_iter: int,
              tol_rel: float = 0.0):
    """Red-black SOR on (i+j+k) % 2 against the mean-free rhs: the whole
    grid as the one block of ops.poisson.rbsor_blocks."""
    (p,) = rbsor_blocks([p], [rhs], [poisson_coefficients_3d(g, p.dtype, p.device)],
                        [_red_mask((g.nx, g.ny, g.nz), p.device)], omega, tol, tol_rel,
                        max_iter, mean_free=lambda xs: [x - cell_mean(x) for x in xs])
    return p


def _resolve_auto_3d(g: Grid3D) -> str:
    """pressure_solver='auto': 'mg' wherever the grid coarsens, else
    'rbsor' (mg_solve raises on grids that do not)."""
    return "mg" if len(mg_levels((g.nx, g.ny, g.nz))) >= 2 else "rbsor"


def numerics_3d(g: Grid3D, **settings) -> Numerics:
    """The 3-D step's settings as one value: ``config.Numerics`` of the
    given dt, n_jacobi, backend, pressure_solver and sor_* fields, with the
    backend and the solver checked and 'auto' resolved. ``step_3d``,
    ``simulate_3d`` and Decomp3D take their settings through it."""
    nm = Numerics(**settings)
    if nm.backend not in _BACKENDS:
        raise NotImplementedError(
            f"backend={nm.backend!r} is not a 3-D backend of the port; it has "
            f"{_BACKENDS} (tpuvof's 'xla' and 'pallas')")
    if nm.pressure_solver not in _SOLVERS:
        raise ValueError(f"unknown pressure_solver {nm.pressure_solver!r}; "
                         f"expected one of {_SOLVERS}")
    if nm.pressure_solver == "auto":
        nm = dataclasses.replace(nm, pressure_solver=_resolve_auto_3d(g))
    return nm


def _solve_residual(g, p, rhs, nm: Numerics):
    """The residual-driven rungs on an interior-shaped rhs."""
    if nm.pressure_solver == "rbsor":
        return _rbsor_3d(g, p, rhs, nm.sor_omega, nm.sor_tol, nm.sor_max_iter,
                         tol_rel=nm.sor_tol_rel)
    return mg_solve(p, rhs, (g.dxi**2, g.dyi**2, g.dzi**2), nm.sor_tol, nm.sor_max_iter,
                    tol_rel=nm.sor_tol_rel)


def _step_3d_torch(g, fl, nm: Numerics, csf: bool, state, phase) -> State3D:
    F, u, v, w, p = state
    dt = nm.dt
    rho, nu = mix_properties(fl, F)
    if csf:
        kappa = young_normals_curvature_3d(g, F)[3]
    else:
        kappa = torch.zeros_like(F)  # surface tension inert, as in the reference
    u_star, v_star, w_star = predict_velocity_3d(g, fl, dt, u, v, w, F, rho, nu, kappa)
    u, v, w, F, p, rho = apply_bc_3d(u, v, w, F, p, rho)
    if nm.pressure_solver == "jacobi":
        p = _solve_pressure_3d(g, dt, nm.n_jacobi, p, u_star, v_star, w_star, rho)
    else:
        p = _solve_residual(g, p, rhs_3d(g, dt, u_star, v_star, w_star, rho), nm)
    u, v, w = update_velocity_3d(g, dt, u, v, w, u_star, v_star, w_star, p, rho)
    u, v, w, F, p, rho = apply_bc_3d(u, v, w, F, p, rho)
    F = rudman_advect_3d(g, dt, F, u, v, w, phase)
    F = clamp01(F)
    # u, v, w, F, p are new tensors of this step: the last BC writes in place
    u, v, w, F, p = apply_bc_3d_(u, v, w, F, p)
    return State3D(F=F, u=u, v=v, w=w, p=p)


def lean_predict_3d(g, fl, nm: Numerics, csf: bool, state, **origin):
    """The lean step's first half on a whole grid or, given the block
    origin (the kernels' ``gi_base``, ``njl``, ``gj_base``), on a shard's
    extended block: predict3d_rhs, then with the fixed Jacobi its
    jacobi3d. Returns ((u*, v*, w*), p, rhs), p the solved one under
    'jacobi' and the entry one otherwise, for the caller's solve."""
    F, u, v, w, p = state
    *stars, rhs = K3.predict3d_rhs(g, fl, nm.dt, u, v, w, F, csf, **origin)
    if nm.pressure_solver == "jacobi":
        p = K3.jacobi3d(g, nm.n_jacobi, p, rhs, **origin)
    return stars, p, rhs


def lean_finish_3d(g, fl, nm: Numerics, F, stars, p, phase: int, **origin) -> State3D:
    """The lean step's second half: correct3d, then the three sweeps in
    the ``phase`` rotation, the last with mirror_out."""
    vels = K3.correct3d(g, fl, nm.dt, *stars, p, F, **origin)
    for idx, ax in enumerate(SWEEP_ORDER[phase]):
        F = K3.fct3d_sweep(g, nm.dt, F, vels[ax], ax, idx == 2, **origin)
    u, v, w = vels
    return State3D(F=F, u=u, v=v, w=w, p=p)


def _step_3d_cuda_lean(g, fl, nm: Numerics, csf: bool, state, phase) -> State3D:
    """One step on the kernels from a state whose ghosts are as the
    previous lean step (or a BC) left them (tpuvof's
    _step_3d_pallas_padded). Every per-step BC of the 'torch' route is
    dropped: predict3d_rhs rebuilds the velocity ghosts it reads, jacobi3d
    zeroes its ghost ring instead of the edge coefficients, correct3d
    writes zero off its update ranges, the first two sweeps read the stale
    F mirrors and the last writes fresh ones (mirror_out). A BC after the
    last lean step restores the velocity and pressure ghosts."""
    stars, p, rhs = lean_predict_3d(g, fl, nm, csf, state)
    if nm.pressure_solver != "jacobi":
        p = _solve_residual(g, p, rhs[1:-1, 1:-1, 1:-1], nm)
    return lean_finish_3d(g, fl, nm, state.F, stars, p, phase)


def _with_bc(state: State3D) -> State3D:
    with span("tv.bc"):
        u, v, w, F, p = apply_bc_3d(state.u, state.v, state.w, state.F, state.p)
        return State3D(F=F, u=u, v=v, w=w, p=p)


def _with_bc_(state: State3D) -> State3D:
    with span("tv.bc"):
        u, v, w, F, p = apply_bc_3d_(state.u, state.v, state.w, state.F, state.p)
        return State3D(F=F, u=u, v=v, w=w, p=p)


def step_3d(g: Grid3D, fl: Fluid, dt: float, n_jacobi: int, state: State3D, phase: int,
            backend: str = "cuda", pressure_solver: str = "jacobi",
            sor_omega: float = 1.7, sor_tol: float = 1e-3, sor_max_iter: int = 200,
            csf: bool = False, sor_tol_rel: float = 0.0) -> State3D:
    """One step; ``phase`` = istep % 3 selects the sweep rotation (the
    reference pre-increments istep, so the first step runs phase 1). On
    'cuda' the lean kernel step runs between a BC at entry and one at
    exit. The entry state is not modified."""
    nm = numerics_3d(g, dt=dt, n_jacobi=n_jacobi, backend=backend,
                     pressure_solver=pressure_solver, sor_omega=sor_omega, sor_tol=sor_tol,
                     sor_max_iter=sor_max_iter, sor_tol_rel=sor_tol_rel)
    if nm.backend == "torch":
        return _step_3d_torch(g, fl, nm, csf, state, phase)
    return _with_bc_(_step_3d_cuda_lean(g, fl, nm, csf, _with_bc(state), phase))


def simulate_3d(g: Grid3D, state: State3D, n_steps: int, dt: float = 4e-6,
                n_jacobi: int = 10, fl: Fluid | None = None, backend: str = "cuda",
                istep0: int = 0, pressure_solver: str = "jacobi",
                sor_omega: float = 1.7, sor_tol: float = 1e-3, sor_max_iter: int = 200,
                csf: bool = False, sor_tol_rel: float = 0.0) -> State3D:
    """Advance ``n_steps`` with the reference's phase schedule (first step
    phase 1, then 2, 0, 1, ...).

    ``istep0`` is the global index of the last step already taken: chunked
    callers must pass it so the istep % 3 rotation continues as the
    reference's continuous istep counter does. On 'cuda' one BC is applied
    before the first step and one after the last, and the lean kernel step
    runs between them."""
    with span("tv.simulate"):
        g.validate()  # cubic cells only (the 3-D FCT scale factors assume it)
        nm = numerics_3d(g, dt=dt, n_jacobi=n_jacobi, backend=backend,
                         pressure_solver=pressure_solver, sor_omega=sor_omega,
                         sor_tol=sor_tol, sor_max_iter=sor_max_iter, sor_tol_rel=sor_tol_rel)
        fl = fl or Fluid()
        lean = nm.backend != "torch"
        step = _step_3d_cuda_lean if lean else _step_3d_torch
        if lean:
            state = _with_bc(state)
        for istep in range(istep0 + 1, istep0 + n_steps + 1):
            state = step(g, fl, nm, csf, state, istep % 3)
        return _with_bc_(state) if lean else state
