"""The dam break of ``dambreak.py`` made shard by shard on a mesh's cards.

The same jobs (``job_order``: every combination of the seeded shifts) and
the same block of liquid (``floor(n * frac) + 1`` cells past the low ghost
plane along each axis, moved by the job's shift), but each shard's block
(its owned cells and one ghost layer) is made on its own card from the
global indices of its planes and rows, then handed to the program's
resident entry (``Decomp3D.start``). No whole-grid field is made, on a
card or on the host.
"""
from __future__ import annotations

import math

import torch

from portbench.harness import load_module
from portbench.shards import pencils_of, resident

__all__ = ["job_order", "initial_state"]

_DTYPES = {"float32": torch.float32, "float64": torch.float64}
_DAMBREAK = load_module("cases", "dambreak")

job_order = _DAMBREAK.job_order


def shards(config: dict, shift: tuple, dec) -> list:
    """Each shard's (F, u, v, w, p) of one job on its card, in the
    configuration's dtype: ``dambreak.initial_state``'s whole state cut
    as Decomp3D.scatter_state cuts it."""
    from tpuvof_torch.state import State3D

    dtype = _DTYPES[config["dtype"]]
    # the last liquid cell index along each axis
    ext = [math.floor(n * frac) + 1 + s for (n, frac), s in zip(_DAMBREAK._axes(config), shift)]
    out = []
    for (xi, yi), dev in zip(dec.coords, dec.devices):
        starts = (xi * dec.nxl, yi * dec.nyl, 0)
        sizes = (dec.nxl + 2, dec.nyl + 2, dec.g.nz + 2)
        F = torch.ones((), dtype=torch.bool, device=dev)
        for ax, (s0, size, last) in enumerate(zip(starts, sizes, ext)):
            view = [1, 1, 1]
            view[ax] = size
            F = F & (torch.arange(s0, s0 + size, device=dev).reshape(view) <= last)
        F = F.to(dtype).expand(sizes).contiguous()
        out.append(State3D(F, *(torch.zeros(sizes, dtype=dtype, device=dev) for _ in range(4))))
    return out


def initial_state(config: dict, shift: tuple, device) -> tuple:
    """The job's resident state (five ``portbench.shards.Pencils``): the
    shards made on their cards, taken in by the program's entry, on the
    mesh of the route made for this configuration."""
    dec, plan = resident(config, device)
    return pencils_of(dec.start(shards(config, shift, dec)), dec, plan)
