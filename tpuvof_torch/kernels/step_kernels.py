"""The hand-written kernels of the 2-D step: wrappers and plain versions.

Counterpart of tpuvof/pallas_kernels/step_kernels.py's ``pallas_call``
sites (file:line of each site):

  ================  ====================  ==============================================
  wrapper           CUDA source           replaces
  ================  ====================  ==============================================
  predict           csrc/predict.cu       pallas_predict (:444)
  project           csrc/project.cu       project_pressure_and_correct (:237)
  fct_sweep         csrc/fct_sweep.cu     pallas_fct_sweep_x / _y (_pallas_sweep, :330)
  predict_win       csrc/predict.cu       pallas_predict_win (:506)
  fct_sweep_win     csrc/fct_sweep.cu     pallas_fct_sweep_win (:539)
  fullstep          csrc/fullstep.cu      pallas_fullstep (:669)
  fullstep_win      csrc/fullstep.cu      pallas_fullstep_win (:1119)
  fullstep_strips   csrc/fullstep.cu      pallas_fullstep_strips (:1089)
  fullstep_dma      csrc/fullstep_dma.cu  pallas_fullstep_dma (:793)
  ================  ====================  ==============================================

The ``_win`` wrappers and ``fullstep_strips`` take blocks with a global
origin (oi, oj): the index of the block's (0, 0) in the ghost-included
grid. Their outputs are exact on the cells at least the phase's halo
(PHASE_HALO, STEP_HALO) away from the block's edges; closer, they are
junk by contract, and callers keep the centre.

``fullstep``, ``fullstep_win`` and ``fullstep_strips`` are one kernel
that runs the step in stage groups separated by grid-wide barriers: the
predictor and rhs, the Jacobi sweeps in groups of at most four (the
library reports its split, ``tv_fullstep_levels``), and the correction,
both sweeps, the clamp and the BCs. ``project`` runs the same Jacobi
groups in one launch, the rhs in the first and the correction in the
last.

``fullstep_dma`` computes ``fullstep``'s step bit for bit, in the same
stage groups, and moves each tile's inputs and outputs by bulk
asynchronous copies. As in tpuvof, no solver route calls it: its callers
are its A/B scripts (scripts/torch_mono_dma_ab.py, scripts/torch_ab2d.py)
and the tests. Its operands must be 16-byte aligned, and its scratch is
laid out by its library (``scratch_cells``).

A wrapper given CPU tensors runs the plain PyTorch version beside it and
counts nothing. Given CUDA tensors it checks them, allocates its outputs
and scratch with ``torch.empty`` (``fullstep`` also takes them from its
caller, checked like its inputs), launches its kernel on the current
stream without synchronising, adds one to its entry of ``LAUNCHES``, and
raises if the launch is refused; it never falls back to the plain version.
Under a profiler, its CUDA branch is the span ``tv.wrap.<name>`` and its
foreign call into the library ``tv.launch.<name>`` (``<name>`` its
``LAUNCHES`` key; utils/profiling.py); the host seconds of each entry's
first launch in the process, which loads the kernel's module under CUDA's
lazy loading, go to ``FIRST_LAUNCH_S``. The 3-D wrappers share both.

The plain versions are built from tpuvof_torch.ops (the windowed ones
from ops/window.py). The CPU tests hold them against tpuvof's Pallas
kernels; on the card they serve only as the comparison for the kernels.
"""
from __future__ import annotations

import ctypes
import functools
import time

import numpy as np
import torch

from ..config import FCTVariant, SimConfig
from ..ops import fct as _fct
from ..ops import window as _win
from ..ops.materials import mix_properties
from ..ops.momentum import predict_velocity, update_velocity
from ..ops.normals import young_normals_curvature
from ..ops.poisson import divergence_rhs, jacobi_sweeps, poisson_diagonal_constants
from ..utils.profiling import recording, span
from .build import load_library

__all__ = [
    "LAUNCHES",
    "FIRST_LAUNCH_S",
    "PHASE_HALO",
    "STEP_HALO",
    "strips_halo",
    "reset_launch_counts",
    "predict",
    "project",
    "fct_sweep",
    "predict_win",
    "fct_sweep_win",
    "fullstep",
    "fullstep_win",
    "fullstep_strips",
    "fullstep_dma",
    "predict_plain",
    "project_plain",
    "fct_sweep_plain",
    "predict_win_plain",
    "fct_sweep_win_plain",
    "fullstep_plain",
    "fullstep_win_plain",
    "fullstep_strips_plain",
    "fullstep_dma_plain",
    "scratch_cells",
]

#: Kernel launches per wrapper since the last reset (CUDA tensors only).
LAUNCHES = {name: 0 for name in ("predict", "project", "fct_sweep", "predict_win",
                                 "fct_sweep_win", "fullstep", "fullstep_win",
                                 "fullstep_strips", "fullstep_dma")}

#: Host seconds of each kernel entry's first launch in the process, by its
#: LAUNCHES key (2-D and 3-D); never reset.
FIRST_LAUNCH_S: dict[str, float] = {}

#: Dependency radius of one phase kernel (predict, or one FCT sweep): a
#: block widened by it beyond its ghost ring yields exact phase outputs on
#: the ring and inside.
PHASE_HALO = 3


def STEP_HALO(cfg: SimConfig) -> int:  # noqa: N802 (tpuvof's step_halo_width)
    """Dependency radius of one lean step: predict 3, rhs 1, n_jacobi
    Jacobi sweeps, correction 1, two sweeps 3 + 3, BCs 1."""
    return cfg.num.n_jacobi + 12


def strips_halo(cfg: SimConfig) -> int:
    """The strips engine's margin: STEP_HALO rounded up to a multiple of 8,
    as tpuvof's resident layout has it (W2)."""
    return -(-STEP_HALO(cfg) // 8) * 8


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ----------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------
def predict_plain(cfg: SimConfig, u, v, F):
    """(u*, v*): materials, Youngs normals, curvature and the momentum
    predictor (tpuvof's _predict_body)."""
    g, fl, nm = cfg.grid, cfg.fluid, cfg.num
    rho, nu = mix_properties(fl, F)
    _, _, kappa = young_normals_curvature(g, F)
    return predict_velocity(g, fl, nm, u, v, F, rho, nu, kappa)


def project_plain(cfg: SimConfig, F, u_star, v_star, p, u, v):
    """(p, u, v): rho, rhs, n_jacobi Jacobi sweeps and the velocity
    correction (tpuvof's _project_kernel)."""
    g, nm = cfg.grid, cfg.num
    rho, _ = mix_properties(cfg.fluid, F)
    rhs = divergence_rhs(g, nm, u_star, v_star, rho)
    p = jacobi_sweeps(g, nm.n_jacobi, p, rhs)
    u, v = update_velocity(g, nm, u, v, u_star, v_star, p, rho)
    return p, u, v


def fct_sweep_plain(cfg: SimConfig, F, vel, axis: int):
    """One FCT sweep along x (axis 0, vel = u) or y (axis 1, vel = v)."""
    sweep = _fct.fct_sweep_x if axis == 0 else _fct.fct_sweep_y
    return sweep(cfg.grid, cfg.num, F, vel)


def predict_win_plain(cfg: SimConfig, u, v, F, oi: int, oj: int):
    """(u*, v*) on a block with origin (oi, oj) (tpuvof's
    _predict_win_kernel: the load sanitizer, then _predict_body)."""
    u, v, F = _win.sanitize(cfg, oi, oj, u, v, F)
    us, vs, _ = _win.predict_values(cfg, u, v, F, oi, oj)
    return us, vs


def fct_sweep_win_plain(cfg: SimConfig, F, vel, axis: int, oi: int, oj: int):
    """One FCT sweep on a block with origin (oi, oj) (tpuvof's
    _sweep_win_kernel)."""
    F, vel = _win.sanitize(cfg, oi, oj, F, vel)
    return _win.sweep_values(cfg, F, vel, axis, oi, oj)


def fullstep_win_plain(cfg: SimConfig, F, u, v, p, oi: int, oj: int, even_step: bool):
    """(F, u, v, p) after one lean step on a block with origin (oi, oj)
    (tpuvof's _win_step_values)."""
    return _win.step_values(cfg, F, u, v, p, oi, oj, even_step)


def fullstep_plain(cfg: SimConfig, F, u, v, p, even_step: bool):
    """(F, u, v, p) after one lean step on the whole grid (tpuvof's
    _fullstep_kernel): fullstep_win_plain at the origin."""
    return _win.step_values(cfg, F, u, v, p, 0, 0, even_step)


def fullstep_strips_plain(cfg: SimConfig, F, u, v, p, even_step: bool, oi0: int = 0,
                          oj0: int = 0):
    """One lean step on the strips engine's padded layout: a block with its
    ghost ring at offset (W2, W2) of arrays padded by W2 = strips_halo on
    every side, the ring's (0, 0) at global index (oi0, oj0) (the whole
    grid at (0, 0), or a shard of a decomposition)."""
    w2 = strips_halo(cfg)
    return _win.step_values(cfg, F, u, v, p, oi0 - w2, oj0 - w2, even_step)


def fullstep_dma_plain(cfg: SimConfig, F, u, v, p, even_step: bool):
    """(F, u, v, p) after one lean step on the whole grid (tpuvof's
    _fullstep_dma_kernel, which computes _fullstep_kernel's step and only
    moves the state otherwise): fullstep_plain's computation."""
    return _win.step_values(cfg, F, u, v, p, 0, 0, even_step)


# ----------------------------------------------------------------------
# kernel constants: computed in double exactly as the JAX package folds
# them, cast to the kernel's type in C. The order is the C side's.
# ----------------------------------------------------------------------
def _doubles(values):
    return (ctypes.c_double * len(values))(*(float(x) for x in values))


@functools.lru_cache(maxsize=32)
def _predict_constants(cfg: SimConfig):
    g, fl, nm = cfg.grid, cfg.fluid, cfg.num
    inv2dx = 1.0 / (2.0 * g.dx)
    inv2dy = 1.0 / (2.0 * g.dy)
    return _doubles([fl.rho_l, fl.rho_g, fl.nu_l, fl.nu_g,
                     -inv2dx, -inv2dy, inv2dx, inv2dy,
                     nm.dt, g.dxi, g.dyi, g.dxi**2, g.dyi**2,
                     -fl.sigma, g.dx, g.dy, fl.gx, fl.gy])


@functools.lru_cache(maxsize=32)
def _project_constants(cfg: SimConfig):
    g, fl, nm = cfg.grid, cfg.fluid, cfg.num
    ap = poisson_diagonal_constants(g)
    return _doubles([fl.rho_l, fl.rho_g, nm.dt, g.dxi, g.dyi,
                     np.float64(g.dxi) ** 2, np.float64(g.dyi) ** 2,
                     ap[0, 0], ap[0, 1], ap[1, 0], ap[1, 1]])


@functools.lru_cache(maxsize=32)
def _sweep_constants(dx: float, dy: float, dt: float, var: FCTVariant):
    return _doubles([dt, dx, dy, dx * dy, dt * dy, var.guard_eps, var.denom_eps])


# ----------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------
def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def _checked(name: str, shape, *tensors):
    """Validate CUDA operands of one shape; returns (library, entry point,
    stream)."""
    ref = tensors[0]
    if ref.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {ref.device} are neither CPU nor CUDA")
    if ref.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: the kernel takes float32 or float64, not {ref.dtype}")
    if ref.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors on {ref.device} but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    shape = tuple(shape)
    for t in tensors:
        if t.device != ref.device or t.dtype != ref.dtype:
            raise ValueError(f"{name}: operands must share one device and dtype")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: operand shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    lib = load_library()
    suffix = "_f32" if ref.dtype == torch.float32 else "_f64"
    fn = getattr(lib, f"tv_{name}{suffix}")
    stream = torch.cuda.current_stream(ref.device).cuda_stream
    return lib, fn, stream


def _block_shape(name: str, t: torch.Tensor):
    if t.dim() != 2 or min(t.shape) < 1:
        raise ValueError(f"{name}: a block is a non-empty 2-D tensor, not {tuple(t.shape)}")
    return tuple(t.shape)


def _launch(counts: dict, name: str, prepare, args: tuple):
    """A wrapper's CUDA branch, the one way every wrapper (2-D and 3-D)
    launches its kernel. ``prepare(*args)`` checks the operands and makes
    the outputs and the entry point's arguments: it returns (lib, fn,
    c_args, result, kernels). The foreign call ``fn(*c_args)`` then
    launches ``kernels`` kernels; a refused launch raises; the kernels are
    added to ``counts[name]`` and ``result`` is returned. The first call
    of ``name`` in the process is timed into FIRST_LAUNCH_S. While a
    profiler records, the branch is the span ``tv.wrap.<name>`` and the
    foreign call in it ``tv.launch.<name>``; with none, the branch pays
    one check for both."""
    first = name not in FIRST_LAUNCH_S
    if recording():
        with span("tv.wrap." + name):
            lib, fn, c_args, result, kernels = prepare(*args)
            t0 = time.perf_counter() if first else 0.0
            with span("tv.launch." + name):
                status = fn(*c_args)
    else:
        lib, fn, c_args, result, kernels = prepare(*args)
        t0 = time.perf_counter() if first else 0.0
        status = fn(*c_args)
    if status != 0:
        msg = lib.tv_error_string(status).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {status} ({msg})")
    if first:
        FIRST_LAUNCH_S[name] = time.perf_counter() - t0
    counts[name] += kernels
    return result


def _predict_call(cfg, u, v, F, shape, oi, oj):
    lib, fn, stream = _checked("predict", shape, u, v, F)
    us = torch.empty_like(F)
    vs = torch.empty_like(F)
    g = cfg.grid
    # rows 0: the library picks the tile height from the block size
    c_args = (u.data_ptr(), v.data_ptr(), F.data_ptr(), us.data_ptr(), vs.data_ptr(),
              *shape, oi, oj, g.nx, g.ny, _predict_constants(cfg), 0, stream)
    return lib, fn, c_args, (us, vs), 1


def predict(cfg: SimConfig, u, v, F):
    """(u*, v*) of the step; counterpart of tpuvof's pallas_predict."""
    if _on_cpu(F):
        return predict_plain(cfg, u, v, F)
    return _launch(LAUNCHES, "predict", _predict_call, (cfg, u, v, F, cfg.grid.shape, 0, 0))


def predict_win(cfg: SimConfig, u, v, F, oi: int, oj: int):
    """(u*, v*) on a block with origin (oi, oj), exact at PHASE_HALO from
    its edges; counterpart of tpuvof's pallas_predict_win."""
    if _on_cpu(F):
        return predict_win_plain(cfg, u, v, F, oi, oj)
    shape = _block_shape("predict_win", F)
    return _launch(LAUNCHES, "predict_win", _predict_call,
                   (cfg, u, v, F, shape, int(oi), int(oj)))


def project(cfg: SimConfig, F, u_star, v_star, p, u, v):
    """(p, u, v) after the pressure projection; counterpart of tpuvof's
    project_pressure_and_correct."""
    if _on_cpu(F):
        return project_plain(cfg, F, u_star, v_star, p, u, v)
    return _launch(LAUNCHES, "project", _project_call, (cfg, F, u_star, v_star, p, u, v))


def _project_call(cfg, F, u_star, v_star, p, u, v):
    g = cfg.grid
    lib, fn, stream = _checked("project", g.shape, F, u_star, v_star, p, u, v)
    p_out = torch.empty_like(p)
    p_tmp = torch.empty_like(p)
    rhs = torch.empty_like(p)
    u_out = torch.empty_like(u)
    v_out = torch.empty_like(v)
    c_args = (F.data_ptr(), u_star.data_ptr(), v_star.data_ptr(), p.data_ptr(),
              u.data_ptr(), v.data_ptr(), p_out.data_ptr(), p_tmp.data_ptr(),
              rhs.data_ptr(), u_out.data_ptr(), v_out.data_ptr(),
              g.nx, g.ny, cfg.num.n_jacobi, _project_constants(cfg), stream)
    return lib, fn, c_args, (p_out, u_out, v_out), 1


def _sweep_args(cfg: SimConfig, axis: int):
    g, nm = cfg.grid, cfg.num
    # the y-sweep passes (dy, dx), as pallas_fct_sweep_y does
    dx, dy = (g.dx, g.dy) if axis == 0 else (g.dy, g.dx)
    return _sweep_constants(dx, dy, nm.dt, nm.fct)


def _sweep_call(cfg, F, vel, axis, shape, oi, oj):
    lib, fn, stream = _checked("fct_sweep", shape, F, vel)
    g, fct = cfg.grid, cfg.num.fct
    out = torch.empty_like(F)
    c_args = (F.data_ptr(), vel.data_ptr(), out.data_ptr(), *shape, oi, oj, g.nx, g.ny,
              axis, _sweep_args(cfg, axis), int(fct.full_dv), int(fct.clamp), stream)
    return lib, fn, c_args, out, 1


def fct_sweep(cfg: SimConfig, F, vel, axis: int):
    """F after one FCT sweep along x (axis 0, vel = u) or y (axis 1,
    vel = v); counterpart of tpuvof's pallas_fct_sweep_x / _y."""
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, not {axis}")
    if _on_cpu(F):
        return fct_sweep_plain(cfg, F, vel, axis)
    return _launch(LAUNCHES, "fct_sweep", _sweep_call,
                   (cfg, F, vel, axis, cfg.grid.shape, 0, 0))


def fct_sweep_win(cfg: SimConfig, F, vel, axis: int, oi: int, oj: int):
    """One FCT sweep on a block with origin (oi, oj), exact at PHASE_HALO
    from its edges; counterpart of tpuvof's pallas_fct_sweep_win."""
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, not {axis}")
    if _on_cpu(F):
        return fct_sweep_win_plain(cfg, F, vel, axis, oi, oj)
    shape = _block_shape("fct_sweep_win", F)
    return _launch(LAUNCHES, "fct_sweep_win", _sweep_call,
                   (cfg, F, vel, axis, shape, int(oi), int(oj)))


#: Block-sized scratch fields the whole-step kernels take.
_SCRATCH_BLOCKS = 5


def scratch_cells(entry: str, shape, dtype) -> int:
    """Cells of the scratch a whole-step entry point allocates on an
    (E0, E1) block of ``dtype``: five blocks for ``fullstep``; for
    ``fullstep_dma``, whose bulk copies need every block aligned, as many
    as its library lays out (``tv_fullstep_dma_scratch_*``)."""
    e0, e1 = int(shape[0]), int(shape[1])
    if entry != "fullstep_dma":
        return _SCRATCH_BLOCKS * e0 * e1
    suffix = "_f32" if dtype == torch.float32 else "_f64"
    return int(getattr(load_library(), "tv_fullstep_dma_scratch" + suffix)(e0, e1))


def _extent(t: torch.Tensor) -> tuple[int, int]:
    start = t.data_ptr()
    return start, start + t.numel() * t.element_size()


def _check_buffers(name: str, ins, out, scratch, cells: int) -> None:
    """Validate a caller's outputs and scratch for a whole-step launch on
    ``ins``: four outputs of the inputs' shape, dtype and device, a
    scratch of at least ``cells`` cells of their dtype on their device,
    all contiguous, and no output or scratch sharing memory with an input
    or with another of them."""
    ref = ins[0]
    if len(out) != 4:
        raise ValueError(f"{name}: out holds {len(out)} tensors, not 4 (F, u, v, p)")
    for t in (*out, scratch):
        if t.device != ref.device or t.dtype != ref.dtype:
            raise ValueError(f"{name}: out and scratch must share the inputs' device and dtype")
        if not t.is_contiguous():
            raise ValueError(f"{name}: out and scratch must be contiguous")
    for t in out:
        if t.shape != ref.shape:
            raise ValueError(f"{name}: out shape {tuple(t.shape)} != {tuple(ref.shape)}")
    if scratch.numel() < cells:
        raise ValueError(f"{name}: scratch holds {scratch.numel()} cells, not {cells}")
    written = [_extent(t) for t in (*out, scratch)]
    others = [_extent(t) for t in ins]
    for k, (a, b) in enumerate(written):
        if any(a < d and c < b for c, d in others + written[k + 1:]):
            raise ValueError(f"{name}: out and scratch may not share memory with the "
                             "inputs or with each other")


def _fullstep_call(entry, cfg, F, u, v, p, shape, oi, oj, even_step, out=None,
                   scratch=None):
    lib, fn, stream = _checked(entry, shape, F, u, v, p)
    g, nm = cfg.grid, cfg.num
    cells = scratch_cells(entry, shape, F.dtype)
    if out is None:
        out = [torch.empty_like(F) for _ in range(4)]
        scratch = torch.empty(cells, dtype=F.dtype, device=F.device)
    else:
        _check_buffers(entry, (F, u, v, p), out, scratch, cells)
    ins = (ctypes.c_void_p * 4)(*(t.data_ptr() for t in (F, u, v, p)))
    out_ptrs = (ctypes.c_void_p * 4)(*(t.data_ptr() for t in out))
    c_args = (ins, out_ptrs, scratch.data_ptr(), *shape, oi, oj, g.nx, g.ny, nm.n_jacobi,
              int(bool(even_step)), _predict_constants(cfg), _project_constants(cfg),
              _sweep_args(cfg, 0), _sweep_args(cfg, 1), int(nm.fct.full_dv),
              int(nm.fct.clamp), stream)
    return lib, fn, c_args, tuple(out), 1


def fullstep(cfg: SimConfig, F, u, v, p, even_step: bool, out=None, scratch=None):
    """(F, u, v, p) after one lean step as one kernel launch; counterpart
    of tpuvof's pallas_fullstep. ``out`` (four tensors like F) and
    ``scratch`` (at least ``scratch_cells('fullstep', F.shape, F.dtype)``
    cells), given together, are used in place of new allocations, so that
    the launch allocates nothing (a CUDA graph's capture); the outputs are
    then ``out``. Neither may share memory with the inputs."""
    if (out is None) != (scratch is None):
        raise ValueError("fullstep: give out and scratch together, or neither")
    if _on_cpu(F):
        res = fullstep_plain(cfg, F, u, v, p, even_step)
        if out is None:
            return res
        _check_buffers("fullstep", (F, u, v, p), out, scratch,
                       scratch_cells("fullstep", F.shape, F.dtype))
        for o, r in zip(out, res):
            o.copy_(r)
        return tuple(out)
    return _launch(LAUNCHES, "fullstep", _fullstep_call,
                   ("fullstep", cfg, F, u, v, p, cfg.grid.shape, 0, 0, even_step, out, scratch))


def fullstep_win(cfg: SimConfig, F, u, v, p, oi: int, oj: int, even_step: bool):
    """One lean step on a block with origin (oi, oj), exact at STEP_HALO
    from its edges; counterpart of tpuvof's pallas_fullstep_win."""
    if _on_cpu(F):
        return fullstep_win_plain(cfg, F, u, v, p, oi, oj, even_step)
    shape = _block_shape("fullstep_win", F)
    return _launch(LAUNCHES, "fullstep_win", _fullstep_call,
                   ("fullstep", cfg, F, u, v, p, shape, int(oi), int(oj), even_step))


def fullstep_strips(cfg: SimConfig, F, u, v, p, even_step: bool, extents=None,
                    oi0: int = 0, oj0: int = 0):
    """One lean step on the strips engine's padded resident layout
    (fullstep_strips_plain), whose margins may hold anything, NaN
    included; counterpart of tpuvof's pallas_fullstep_strips. ``extents``
    (nxl, nyl) are the block's interior extents (default the grid's) and
    (oi0, oj0) the global index of its ghost ring's (0, 0) (default the
    origin): a decomposition's shard passes both."""
    if _on_cpu(F):
        return fullstep_strips_plain(cfg, F, u, v, p, even_step, oi0, oj0)
    w2 = strips_halo(cfg)
    nx, ny = (cfg.grid.nx, cfg.grid.ny) if extents is None else extents
    shape = (nx + 2 + 2 * w2, ny + 2 + 2 * w2)
    return _launch(LAUNCHES, "fullstep_strips", _fullstep_call,
                   ("fullstep", cfg, F, u, v, p, shape, int(oi0) - w2, int(oj0) - w2,
                    even_step))


def fullstep_dma(cfg: SimConfig, F, u, v, p, even_step: bool):
    """(F, u, v, p) after one lean step as one kernel launch whose tiles
    move by bulk asynchronous copies, equal to fullstep's bit for bit;
    counterpart of tpuvof's pallas_fullstep_dma. CUDA operands must start
    on a 16-byte boundary (a sliced view may not)."""
    if _on_cpu(F):
        return fullstep_dma_plain(cfg, F, u, v, p, even_step)
    for t in (F, u, v, p):
        if t.data_ptr() % 16:
            raise ValueError("fullstep_dma: operands must be 16-byte aligned "
                             f"(a tensor starts at {t.data_ptr():#x})")
    return _launch(LAUNCHES, "fullstep_dma", _fullstep_call,
                   ("fullstep_dma", cfg, F, u, v, p, cfg.grid.shape, 0, 0, even_step))
