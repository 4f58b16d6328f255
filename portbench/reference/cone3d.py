"""The plain 3-D reference on a judged box's dependency cone.

A grid too large for the reference to advance whole (1152³ in float64
is ~60 GB a field set, before its temporaries) is judged on boxes: each
box is advanced from a cone of the frame's input state around it, and only
the box's cells are compared. One step moves information at most
W + 1 = n_jacobi + 5 planes along any axis (the rhs's outer plane, the
Jacobi sweeps' erosion, the correction's p at i - 1 and an FCT sweep's 3
planes; Decomp3D's admission_3d reckons its halo the same way), so after
n steps the box is exact when its cone reaches n (W + 1) planes past it
on every side, clipped where it meets a wall.

Departures from a whole-grid reference, each confined to the margin:
- a cone's cut faces are not walls, but the reference's operations treat
  the cone's outer planes as its ghosts: its BC copies them and its
  Poisson coefficients close them. What that writes is wrong, and moves
  inward W + 1 planes a step at most, so it never reaches the box;
- where a cone meets a wall its planes are the wall's, and the
  reference's own BC and coefficients hold there as in the whole grid;
- the spacing is the whole grid's (Flow3D from the whole configuration),
  the extents are the cone's.
Nothing is compared outside the boxes. The frame line's numbers are not a
reference run of the whole grid either: they are reduced from the
program's own kept output in float64 (the benchmark's route).
"""
from __future__ import annotations

from .flow3d import Flow3D

__all__ = ["reach", "cone", "ConeFlow3D", "crop"]


def reach(n_jacobi: int) -> int:
    """Planes one step's dependency cone reaches along an axis: W + 1,
    W = n_jacobi + 4 (surface tension off)."""
    return n_jacobi + 5


def cone(box: tuple, n_steps: int, n_jacobi: int, n: tuple) -> tuple:
    """The cone of ``box`` (per axis (lo, hi), interior cells from 0) over
    ``n_steps`` steps, as ghosted global index ranges [a, b): the box's
    planes (lo + 1 .. hi) widened by n_steps * reach planes a side,
    clipped to the ghosted grid [0, n + 2)."""
    m = n_steps * reach(n_jacobi)
    return tuple((max(lo + 1 - m, 0), min(hi + 1 + m, na + 2)) for (lo, hi), na in zip(box, n))


def crop(a, box: tuple, cone_ranges: tuple):
    """The box's cells of an array laid out over ``cone_ranges``."""
    return a[tuple(slice(lo + 1 - c0, hi + 1 - c0) for (lo, hi), (c0, _) in zip(box, cone_ranges))]


class ConeFlow3D:
    """The reference (``Flow3D``) advancing cones of one configuration's
    grid: the whole grid's spacing, each cone's own extents."""

    def __init__(self, config: dict):
        self.config = config

    def on(self, shape: tuple) -> Flow3D:
        """The reference on a cone of ghosted ``shape``."""
        ref = Flow3D(self.config)
        ref.n = tuple(int(s) - 2 for s in shape)
        return ref

    def advance(self, state: tuple, n_steps: int, istep0: int) -> tuple:
        """(F, u, v, w, p) of a cone after ``n_steps`` steps after global
        step ``istep0``, the BCs at entry: exact on the cells of any box
        whose cone (``cone``) this is, wrong in its margin."""
        return self.on(tuple(state[0].shape)).advance(state, n_steps, istep0)
