"""Halo exchange between the shards of a device mesh (counterpart of
tpuvof/parallel/halo.py).

tpuvof ships boundary slices with ``lax.ppermute`` inside ``shard_map``;
the port's one controller holds one tensor per shard, in row-major order
of the (px, py) shard grid (shard k at xi = k // py, yi = k % py), and
copies between them with ``Tensor.copy_`` (a peer copy where two shards
sit on different cards). Each block has its owned cells in its middle and
a halo around them; the functions here take the owned extent from the
block's shape.

The x stage runs on every shard before the y stage runs on any: it copies
full-width rows, y halos included, and the y stage then copies
full-height columns that already hold the x stage's rows, so a corner
value crosses two links and no diagonal copy is needed. A side on a wall
keeps what lies beyond it (wall ghosts, or zeros the kernels' global
masks keep inert).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["HaloSpec", "exchange", "refresh_", "widen"]


@dataclass(frozen=True)
class HaloSpec:
    """One shard's place on a px x py mesh: its coordinates (xi along the
    array's axis 0, yi along axis 1) and the walls it owns."""

    px: int
    py: int
    xi: int
    yi: int

    @property
    def is_left(self) -> bool:
        return self.xi == 0

    @property
    def is_right(self) -> bool:
        return self.xi == self.px - 1

    @property
    def is_bottom(self) -> bool:
        return self.yi == 0

    @property
    def is_top(self) -> bool:
        return self.yi == self.py - 1


def refresh_(arrs: list, px: int, py: int, widths=(0, 0), off: int = 0,
             counts: dict | None = None) -> list:
    """Overwrite, in place, the w+1 outermost planes on each side of each
    shard's block (w = widths[axis], counted from ``off``, the layout's
    unused margin) with the neighbour's owned planes; x stage, then y.
    Along an axis a block holds off, w planes of halo, one ghost plane,
    the owned planes, one ghost plane, w planes of halo and off. With w = 0
    this is the one-cell ghost exchange (``exchange``). The neighbour's
    planes must be owned ones: w + 1 <= the owned extent. ``counts``, where
    given, gains each copy: ``copies``, ``peer_copies`` (between two
    devices) and ``bytes``. Returns arrs."""
    for axis, count, step in ((0, px, py), (1, py, 1)):
        if count == 1:
            continue
        w = widths[axis]
        n = arrs[0].shape[axis] - 2 - 2 * (off + w)
        for k, dst in enumerate(arrs):
            pos = (k // py, k % py)[axis]
            if pos > 0:
                _copy(dst.narrow(axis, off, w + 1),
                      arrs[k - step].narrow(axis, off + n, w + 1), counts)
            if pos < count - 1:
                _copy(dst.narrow(axis, off + w + n + 1, w + 1),
                      arrs[k + step].narrow(axis, off + w + 1, w + 1), counts)
    return arrs


def _copy(dst, src, counts: dict | None) -> None:
    dst.copy_(src, non_blocking=True)
    if counts is not None:
        counts["copies"] += 1
        counts["peer_copies"] += dst.device != src.device
        counts["bytes"] += src.numel() * src.element_size()


def exchange(arrs: list, px: int, py: int) -> list:
    """Refresh the one-cell ghost ring of every shard's (n0+2, n1+2, ...)
    block from its neighbours, in place; the sides on a wall keep their
    ghosts. Returns arrs."""
    return refresh_(arrs, px, py)


def widen(arrs: list, px: int, py: int, axis: int, w: int) -> list:
    """Each shard's ghost-ringed block with w more planes (axis 0) or rows
    (axis 1) of current data on each side, each taken from the shard that
    owns it, so a shard one plane thick widens too; zeros beyond the walls.
    Widening along x, then along y, gives the corners the diagonal
    neighbours' data. Returns new contiguous tensors."""
    count = (px, py)[axis]
    n = arrs[0].shape[axis] - 2
    last = n * count + 1  # the global index of the high wall's ghost

    def planes(k, g0, g1):
        # global (ghosted) planes [g0, g1) along ``axis``, over shard k's
        # extent: one slice of each shard that owns some of them
        a, out = arrs[k], []
        while g0 < g1:
            if g0 < 0 or g0 > last:
                e = min(g1, 0) if g0 < 0 else g1
                shape = list(a.shape)
                shape[axis] = e - g0
                out.append(a.new_zeros(shape))
            else:
                t = min(max((g0 - 1) // n, 0), count - 1)
                e = min(g1, last + 1 if t == count - 1 else (t + 1) * n + 1)
                xi, yi = k // py, k % py
                src = arrs[t * py + yi if axis == 0 else xi * py + t]
                out.append(src.narrow(axis, g0 - t * n, e - g0).to(a.device))
            g0 = e
        return out

    out = []
    for k, a in enumerate(arrs):
        base = (k // py, k % py)[axis] * n  # block plane l holds global base + l
        out.append(torch.cat(planes(k, base - w, base) + [a]
                             + planes(k, base + n + 2, base + n + 2 + w), dim=axis))
    return out
