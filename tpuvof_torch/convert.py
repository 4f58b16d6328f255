"""Carry states and configurations between tpuvof and the port.

States cross as numpy arrays. ``config_from_tpuvof``, ``grid3d_from_tpuvof``
and ``fluid_from_tpuvof`` read tpuvof's dataclasses through
``dataclasses.asdict``, so this module needs no import of tpuvof (and so
of jax).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import FCTVariant, Fluid, Numerics, SimConfig
from .grid import Grid2D, Grid3D
from .state import State, State3D

__all__ = ["to_numpy", "state_from_numpy", "state_to_numpy", "config_from_tpuvof",
           "state3d_from_numpy", "state3d_to_numpy", "grid3d_from_tpuvof", "fluid_from_tpuvof"]

# tpuvof backend -> port backend
_BACKENDS = {"xla": "torch", "pallas": "cuda", "pallas_mono": "cuda_mono",
             "pallas_tiled": "cuda_tiled", "pallas_strips": "cuda_strips"}


def to_numpy(a) -> np.ndarray:
    """A numpy array of ``a``: a tensor on any device (copied to the host)
    or anything numpy takes."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def state_from_numpy(F, u, v, p, device, dtype: torch.dtype) -> State:
    """A port State from four (nx+2, ny+2) arrays."""
    def t(a):
        return torch.tensor(np.asarray(a), device=device, dtype=dtype)

    return State(F=t(F), u=t(u), v=t(v), p=t(p))


def state_to_numpy(state: State | State3D) -> tuple[np.ndarray, ...]:
    """The fields of a State or State3D, in order, as numpy arrays on the
    host."""
    return tuple(to_numpy(a) for a in state)


def state3d_from_numpy(F, u, v, w, p, device, dtype: torch.dtype) -> State3D:
    """A port State3D from five (nx+2, ny+2, nz+2) arrays."""
    def t(a):
        return torch.tensor(np.asarray(a), device=device, dtype=dtype)

    return State3D(F=t(F), u=t(u), v=t(v), w=t(w), p=t(p))


state3d_to_numpy = state_to_numpy  # (F, u, v, w, p)


def _fields(obj, kind: str) -> dict:
    if not dataclasses.is_dataclass(obj):
        raise TypeError(f"expected a tpuvof {kind}, got {type(obj).__name__}")
    return dataclasses.asdict(obj)


def grid3d_from_tpuvof(g) -> Grid3D:
    """The port's Grid3D for a tpuvof Grid3D."""
    return Grid3D(**_fields(g, "Grid3D"))


def fluid_from_tpuvof(fl) -> Fluid:
    """The port's Fluid for a tpuvof Fluid."""
    return Fluid(**_fields(fl, "Fluid"))


def config_from_tpuvof(cfg) -> SimConfig:
    """The port's SimConfig for a tpuvof SimConfig.

    Every field is carried, the solver ladder's settings and the
    pressure adjoint included; tpuvof's backend names map to the port's
    routes. An unknown backend name raises."""
    if not dataclasses.is_dataclass(cfg):
        raise TypeError(f"expected a tpuvof SimConfig, got {type(cfg).__name__}")
    d = dataclasses.asdict(cfg)
    num = d["num"]
    backend = num["backend"]
    if backend not in _BACKENDS:
        raise NotImplementedError(
            f"unknown tpuvof backend {backend!r}; tpuvof's backends are "
            f"{sorted(_BACKENDS)}")
    gd = d["grid"]
    return SimConfig(
        grid=Grid2D(gd["nx"], gd["ny"], gd["Lx"], gd["Ly"]),
        fluid=Fluid(**d["fluid"]),
        num=Numerics(
            dt=num["dt"],
            n_jacobi=num["n_jacobi"],
            fct=FCTVariant(**num["fct"]),
            bc_between_sweeps=num["bc_between_sweeps"],
            pressure_adjoint=num["pressure_adjoint"],
            backend=_BACKENDS[backend],
            pressure_solver=num["pressure_solver"],
            sor_omega=num["sor_omega"],
            sor_tol=num["sor_tol"],
            sor_max_iter=num["sor_max_iter"],
            sor_tol_rel=num["sor_tol_rel"],
        ),
    )
