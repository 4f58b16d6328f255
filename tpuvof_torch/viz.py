"""Frames on the state's device: the reference's five view modes
(counterpart of tpuvof/viz.py).

Reference: render kernels 2dvof.py:458-492 write a 2x-resolution scalar
buffer that the host pushes through matplotlib colormaps (cm.Blues /
cm.coolwarm / cm.plasma, 2dvof.py:536-554) and the arrow overlay
(flow_visualization.py). As in tpuvof, the whole frame (nearest-neighbour
upsample and colormap lookup) is computed on the state's device as plain
torch ops returning an RGB image; the 256-entry tables are tpuvof's
(``colormaps``), one float32 copy per device. The arrow data
(``arrow_field``, ``vector_field_segments``) is numpy, as in tpuvof.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import colormaps
from .config import SimConfig
from .convert import to_numpy
from .state import State

__all__ = [
    "MODES",
    "scalar_view",
    "render_frame",
    "interp_velocity",
    "vector_field_segments",
    "arrow_field",
]

MODES = ("vof", "u", "v", "vnorm", "vectors")

_LUTS = {name: colormaps.lut(name) for name in colormaps.NAMES}
_MODE_CMAP = {"vof": "Blues", "u": "coolwarm", "v": "coolwarm", "vnorm": "plasma",
              "vectors": "Blues"}


@functools.lru_cache(maxsize=None)
def _lut_on(name: str, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_LUTS[name], device=device)


def _upsample2(a):
    """Nearest-neighbour 2x upsample replicating rgb_buf[I] = field[I // 2]
    (reference 2dvof.py:460-462): shows rows/cols [0, nx) of the padded
    field, i.e. the low ghost line and all but the last interior line."""
    return a.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)


def scalar_view(cfg: SimConfig, state: State, mode: str):
    """The scalar buffer for a view mode, at 2x grid resolution, in [0, 1]
    before colormapping (un-normalised values may exceed it; the colormap
    clips, as matplotlib does on the reference's host path)."""
    g = cfg.grid
    F, u, v, _ = state
    if mode == "vof" or mode == "vectors":
        field = F[: g.nx, : g.ny]
    elif mode == "u":
        field = u[: g.nx, : g.ny] / (g.Lx / 0.2)  # reference scaling 2dvof.py:468
    elif mode == "v":
        field = v[: g.nx, : g.ny] / (g.Ly / 0.2)
    elif mode == "vnorm":
        field = torch.sqrt(u[: g.nx, : g.ny] ** 2 + v[: g.nx, : g.ny] ** 2) / (g.Ly / 0.2)
    else:
        raise ValueError(f"unknown view mode {mode!r}; expected one of {MODES}")
    return _upsample2(field)


def render_frame(cfg: SimConfig, state: State, mode: str) -> torch.Tensor:
    """(2nx, 2ny, 3) float32 RGB frame for a view mode, on the state's
    device. The table index is clamp(buf * 255, 0, 255) truncated, as
    tpuvof's astype(int32); a NaN field has no index (the CLI stops on
    non-finite fields before it renders)."""
    buf = scalar_view(cfg, state, mode)
    lut = _lut_on(_MODE_CMAP[mode], buf.device)
    idx = torch.clamp(buf * 255.0, 0.0, 255.0).to(torch.int32)
    return lut[idx]


def interp_velocity(cfg: SimConfig, state: State) -> torch.Tensor:
    """Face -> center velocity vectors (reference interp_velocity,
    2dvof.py:489-492): V[i,j] = ((u[i,j]+u[i+1,j])/2, (v[i,j]+v[i,j+1])/2)
    over the interior; the reference's out-of-bounds edge column is
    dropped, as in tpuvof. Returns an (nx+2, ny+2, 2) tensor with zeros
    outside the interior."""
    g = cfg.grid
    _, u, v, _ = state
    V = torch.zeros((g.nx + 2, g.ny + 2, 2), dtype=u.dtype, device=u.device)
    V[1: g.nx + 1, 1: g.ny + 1, 0] = (u[1: g.nx + 1, 1: g.ny + 1]
                                      + u[2: g.nx + 2, 1: g.ny + 1]) * 0.5
    V[1: g.nx + 1, 1: g.ny + 1, 1] = (v[1: g.nx + 1, 1: g.ny + 1]
                                      + v[1: g.nx + 1, 2: g.ny + 2]) * 0.5
    return V


def vector_field_segments(V, arrow_spacing: int):
    """Line segments + arrowhead triangles for the manual vector overlay
    (the reference's plot_vector_field, flow_visualization.py:4-33,
    vectorised). Returns (begin (N,2), end (N,2), heads (N,3,2)) in [0,1]^2
    frame coordinates; zero-magnitude arrows are dropped."""
    V = to_numpy(V)
    nx, ny = V.shape[0], V.shape[1]
    norm = np.linalg.norm(V, axis=-1)
    scale = min(nx, ny) * 0.1 / (norm.max() + 1e-16)
    head = 0.3 * arrow_spacing / min(nx, ny)

    ii, jj = np.meshgrid(np.arange(1, nx, arrow_spacing),
                         np.arange(1, ny, arrow_spacing), indexing="ij")
    ii, jj = ii.ravel(), jj.ravel()
    begin = np.stack([ii / nx, jj / ny], axis=-1)
    d = V[ii, jj] * np.array([scale / nx, scale / ny])
    mag = np.linalg.norm(d, axis=-1)
    keep = mag > 0
    begin, d, mag = begin[keep], d[keep], mag[keep]
    end = begin + d
    direction = d / mag[:, None]
    normal = np.stack([-direction[:, 1], direction[:, 0]], axis=-1)
    a = end - head * direction + 0.5 * head * normal
    b = end - head * direction - 0.5 * head * normal
    heads = np.stack([end, a, b], axis=1)
    return begin, end, heads


def arrow_field(V, arrow_spacing: int = 4):
    """Arrow origins and increments in [0,1]^2 frame coordinates (the
    reference's gui.arrows overlay, flow_visualization.py:35-55). Returns
    (origins (N,2), increments (N,2)); the origins come from integer
    slicing so both always have the same length, as in tpuvof."""
    V = to_numpy(V)
    nx, ny = V.shape[0], V.shape[1]
    norm = np.linalg.norm(V, axis=-1)
    scale = min(nx, ny) * 0.1 / (norm.max() + 1e-16)
    xs = np.arange(0, nx, arrow_spacing) / nx
    ys = np.arange(0, ny, arrow_spacing) / ny
    X, Y = np.meshgrid(xs, ys)
    begin = np.dstack((X, Y)).reshape(-1, 2, order="F")
    incre = (
        V[::arrow_spacing, ::arrow_spacing]
        * np.array([scale / nx, scale / ny])
    ).reshape(-1, 2, order="C")
    return begin, incre
