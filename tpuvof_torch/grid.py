"""Staggered MAC-grid geometry (counterpart of tpuvof/grid.py:29-120).

The grid is a frozen dataclass of scalars; coordinate arrays are numpy
float32 constants built with the same numpy ops as tpuvof, so initial
conditions computed from them are bit-identical to tpuvof's.

Conventions (identical to tpuvof and its reference):
  - one ghost cell on each side: interior cell indices i in [1, nx], j in [1, ny]
  - field arrays have shape (nx + 2, ny + 2); axis 0 = i (x), axis 1 = j (y)
  - node coordinates have duplicated endpoints: x[i] = clip(i - 1, 0, nx) * dx
  - u[i, j] lives on the left x-face of cell (i, j), v[i, j] on the bottom
    y-face, and p/F at cell centers
  - uniform square cells (dx == dy); the FCT limiter scaling relies on it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["Grid2D", "Grid3D"]


def _nodes(L: float, n: int) -> np.ndarray:
    """Node coordinates with duplicated endpoints, float32."""
    return np.hstack((0.0, np.linspace(0.0, L, n + 1), L)).astype(np.float32)


@dataclass(frozen=True)
class Grid2D:
    """2-D staggered grid with one ghost cell per side."""

    nx: int
    ny: int
    Lx: float = 0.1
    Ly: float = 0.1

    @property
    def shape(self) -> tuple[int, int]:
        """Field shape including the ghost ring."""
        return (self.nx + 2, self.ny + 2)

    @property
    def dx(self) -> float:
        xs = _nodes(self.Lx, self.nx)
        return float(xs[3] - xs[2])

    @property
    def dy(self) -> float:
        ys = _nodes(self.Ly, self.ny)
        return float(ys[3] - ys[2])

    @property
    def dxi(self) -> float:
        return 1.0 / self.dx

    @property
    def dyi(self) -> float:
        return 1.0 / self.dy

    def node_x(self) -> np.ndarray:
        """x[i] for i in [0, nx+1] (duplicated-endpoint convention)."""
        return _nodes(self.Lx, self.nx)[: self.nx + 2]

    def node_y(self) -> np.ndarray:
        return _nodes(self.Ly, self.ny)[: self.ny + 2]

    def center_x(self) -> np.ndarray:
        """Cell-center x as (i - 1) * dx + dx / 2, float32."""
        i = np.arange(self.nx + 2, dtype=np.float32)
        return ((i - 1.0) * np.float32(self.dx) + np.float32(self.dx) / 2).astype(
            np.float32
        )

    def center_y(self) -> np.ndarray:
        j = np.arange(self.ny + 2, dtype=np.float32)
        return ((j - 1.0) * np.float32(self.dy) + np.float32(self.dy) / 2).astype(
            np.float32
        )

    def validate(self) -> "Grid2D":
        if self.nx < 2 or self.ny < 2:
            raise ValueError("grid needs at least 2 interior cells per axis")
        if abs(self.dx - self.dy) > 1e-12:
            raise ValueError(
                "non-square cells are unsupported: the Rudman FCT limiter "
                "scaling assumes dx == dy"
            )
        return self


@dataclass(frozen=True)
class Grid3D:
    """3-D staggered grid (counterpart of tpuvof/grid.py:121-184); fields
    have shape (nx+2, ny+2, nz+2), axis 2 = k (z) contiguous."""

    nx: int
    ny: int
    nz: int
    Lx: float = 0.1
    Ly: float = 0.1
    Lz: float = 0.1

    def validate(self) -> "Grid3D":
        if min(self.nx, self.ny, self.nz) < 2:
            raise ValueError("grid needs at least 2 interior cells per axis")
        if abs(self.dx - self.dy) > 1e-12 or abs(self.dx - self.dz) > 1e-12:
            raise ValueError(
                "non-cubic cells are unsupported: the 3-D FCT sweeps keep "
                "the reference's literal scale factors, which are only "
                "consistent on cubic cells"
            )
        return self

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.nx + 2, self.ny + 2, self.nz + 2)

    @property
    def dx(self) -> float:
        xs = _nodes(self.Lx, self.nx)
        return float(xs[3] - xs[2])

    @property
    def dy(self) -> float:
        ys = _nodes(self.Ly, self.ny)
        return float(ys[3] - ys[2])

    @property
    def dz(self) -> float:
        zs = _nodes(self.Lz, self.nz)
        return float(zs[3] - zs[2])

    @property
    def dxi(self) -> float:
        return 1.0 / self.dx

    @property
    def dyi(self) -> float:
        return 1.0 / self.dy

    @property
    def dzi(self) -> float:
        return 1.0 / self.dz

    def node_x(self) -> np.ndarray:
        return _nodes(self.Lx, self.nx)[: self.nx + 2]

    def node_y(self) -> np.ndarray:
        return _nodes(self.Ly, self.ny)[: self.ny + 2]

    def node_z(self) -> np.ndarray:
        return _nodes(self.Lz, self.nz)[: self.nz + 2]

    def as_2d(self) -> Grid2D:
        return Grid2D(self.nx, self.ny, self.Lx, self.Ly)
