"""The three phase kernels of the 2-D step: wrappers and plain versions.

Counterpart of tpuvof/pallas_kernels/step_kernels.py's phase kernels
(the ``backend='pallas'`` route):

  ============  ===============================  ==============================
  wrapper       CUDA source                      replaces
  ============  ===============================  ==============================
  predict       csrc/predict.cu                  pallas_predict
  project       csrc/project.cu                  project_pressure_and_correct
  fct_sweep     csrc/fct_sweep.cu                pallas_fct_sweep_x / _y
  ============  ===============================  ==============================

A wrapper given CPU tensors runs the plain PyTorch version beside it and
counts nothing. Given CUDA tensors it checks them, allocates its outputs
and scratch with ``torch.empty``, launches its kernel on the current
stream without synchronising, adds one to its entry of ``LAUNCHES``, and
raises if the launch is refused; it never falls back to the plain version.

The plain versions are built from the ops of tpuvof_torch.ops. The CPU
tests hold them against tpuvof's Pallas kernels; on the card they serve
only as the comparison for the kernels.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..config import FCTVariant, SimConfig
from ..ops import fct as _fct
from ..ops.materials import mix_properties
from ..ops.momentum import predict_velocity, update_velocity
from ..ops.normals import young_normals_curvature
from ..ops.poisson import divergence_rhs, jacobi_sweeps, poisson_diagonal_constants
from .build import load_library

__all__ = [
    "LAUNCHES",
    "reset_launch_counts",
    "predict",
    "project",
    "fct_sweep",
    "predict_plain",
    "project_plain",
    "fct_sweep_plain",
]

#: Kernel launches per wrapper since the last reset (CUDA tensors only).
LAUNCHES = {"predict": 0, "project": 0, "fct_sweep": 0}


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


def _checked(cfg: SimConfig, name: str, *tensors):
    """Validate CUDA operands; returns (library, entry point, stream)."""
    ref = tensors[0]
    if ref.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {ref.device} are neither CPU nor CUDA")
    if ref.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: the kernel takes float32 or float64, not {ref.dtype}")
    if ref.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors on {ref.device} but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    shape = cfg.grid.shape
    for t in tensors:
        if t.device != ref.device or t.dtype != ref.dtype:
            raise ValueError(f"{name}: operands must share one device and dtype")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: operand shape {tuple(t.shape)} != grid shape {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    lib = load_library()
    suffix = "_f32" if ref.dtype == torch.float32 else "_f64"
    fn = getattr(lib, f"tv_{name}{suffix}")
    stream = torch.cuda.current_stream(ref.device).cuda_stream
    return lib, fn, stream


def _raise_on_error(lib, name: str, status: int) -> None:
    if status != 0:
        msg = lib.tv_error_string(status).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {status} ({msg})")


def predict(cfg: SimConfig, u, v, F):
    """(u*, v*) of the step; counterpart of tpuvof's pallas_predict."""
    if _on_cpu(F):
        return predict_plain(cfg, u, v, F)
    lib, fn, stream = _checked(cfg, "predict", u, v, F)
    kappa = torch.empty_like(F)
    us = torch.empty_like(F)
    vs = torch.empty_like(F)
    g = cfg.grid
    status = fn(u.data_ptr(), v.data_ptr(), F.data_ptr(), kappa.data_ptr(),
                us.data_ptr(), vs.data_ptr(), g.nx, g.ny,
                _predict_constants(cfg), stream)
    _raise_on_error(lib, "predict", status)
    LAUNCHES["predict"] += 1
    return us, vs


def project(cfg: SimConfig, F, u_star, v_star, p, u, v):
    """(p, u, v) after the pressure projection; counterpart of tpuvof's
    project_pressure_and_correct."""
    if _on_cpu(F):
        return project_plain(cfg, F, u_star, v_star, p, u, v)
    lib, fn, stream = _checked(cfg, "project", F, u_star, v_star, p, u, v)
    g = cfg.grid
    p_out = torch.empty_like(p)
    p_tmp = torch.empty_like(p)
    rhs = torch.empty((g.nx, g.ny), dtype=p.dtype, device=p.device)
    u_out = torch.empty_like(u)
    v_out = torch.empty_like(v)
    status = fn(F.data_ptr(), u_star.data_ptr(), v_star.data_ptr(), p.data_ptr(),
                u.data_ptr(), v.data_ptr(), p_out.data_ptr(), p_tmp.data_ptr(),
                rhs.data_ptr(), u_out.data_ptr(), v_out.data_ptr(),
                g.nx, g.ny, cfg.num.n_jacobi, _project_constants(cfg), stream)
    _raise_on_error(lib, "project", status)
    LAUNCHES["project"] += 1
    return p_out, u_out, v_out


def fct_sweep(cfg: SimConfig, F, vel, axis: int):
    """F after one FCT sweep along x (axis 0, vel = u) or y (axis 1,
    vel = v); counterpart of tpuvof's pallas_fct_sweep_x / _y."""
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, not {axis}")
    if _on_cpu(F):
        return fct_sweep_plain(cfg, F, vel, axis)
    lib, fn, stream = _checked(cfg, "fct_sweep", F, vel)
    g, nm = cfg.grid, cfg.num
    # the y-sweep passes (dy, dx), as pallas_fct_sweep_y does
    dx, dy = (g.dx, g.dy) if axis == 0 else (g.dy, g.dx)
    out = torch.empty_like(F)
    status = fn(F.data_ptr(), vel.data_ptr(), out.data_ptr(), g.nx, g.ny, axis,
                _sweep_constants(dx, dy, nm.dt, nm.fct),
                int(nm.fct.full_dv), int(nm.fct.clamp), stream)
    _raise_on_error(lib, "fct_sweep", status)
    LAUNCHES["fct_sweep"] += 1
    return out
