"""The dam break's initial state, made on the device from a job's shift.

A block of liquid (F = 1) in the low corner of the box, at rest, with zero
pressure. Its extent along each axis is ``floor(n * frac) + 1`` cells past
the low ghost plane (index 0 included), moved by the job's shift in cells:
the source's block, tested against node coordinates, covers cell indices
0..floor(n * frac) + 1. Every seed runs the same set of shifts (every
combination of ``shift_cells`` over the axes), in an order drawn from the
seed; job k takes entry k mod the set's size.
"""
from __future__ import annotations

import itertools
import math
import random

import torch

__all__ = ["job_order", "initial_state"]

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _axes(config: dict) -> list[tuple[int, float]]:
    dam = config["dam"]
    names = ("x", "y", "z")[: int(config["dims"])]
    return [(int(config[f"n{a}"]), float(dam[f"{a}_frac"])) for a in names]


def job_order(config: dict, rng: random.Random) -> list[tuple[int, ...]]:
    """The jobs' shifts: every combination of ``shift_cells`` over the
    axes, shuffled by the seed."""
    shifts = [int(s) for s in config["dam"]["shift_cells"]]
    jobs = list(itertools.product(shifts, repeat=int(config["dims"])))
    rng.shuffle(jobs)
    return jobs


def initial_state(config: dict, shift: tuple[int, ...], device) -> tuple:
    """(F, u, v[, w], p) of one job, in the configuration's dtype."""
    dtype = _DTYPES[config["dtype"]]
    axes = _axes(config)
    shape = tuple(n + 2 for n, _ in axes)
    # the last liquid cell index along each axis
    ext = tuple(math.floor(n * frac) + 1 + s for (n, frac), s in zip(axes, shift))
    F = torch.ones((), dtype=torch.bool, device=device)
    for ax, last in enumerate(ext):
        view = [1] * len(shape)
        view[ax] = shape[ax]
        F = F & (torch.arange(shape[ax], device=device).reshape(view) <= last)
    F = F.to(dtype).expand(shape).contiguous()
    zeros = [torch.zeros(shape, dtype=dtype, device=device) for _ in range(len(shape) + 1)]
    return (F, *zeros)
