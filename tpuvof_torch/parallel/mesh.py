"""Device meshes (counterpart of tpuvof/parallel/mesh.py).

tpuvof is single-controller: one process drives a ``jax.sharding.Mesh``
through ``shard_map``. The port is single-controller too: a ``Mesh`` is an
array of ``torch.device``s with axis names, a distributed engine keeps one
tensor per shard on its device and exchanges halos by ``Tensor.copy_``
between shard tensors (a peer copy where the devices differ; tpuvof's
``lax.ppermute``). A device may repeat: four shards on one card, or on the
CPU, form a virtual mesh that runs the same code one shard after another.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["Mesh", "factor2d", "make_mesh", "on_device"]


@dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an object array of ``torch.device`` of shape (px,) or
    (px, py); ``axis_names``: one name per axis."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim not in (1, 2) or self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a mesh has 1 or 2 axes, one name each: devices of shape "
                             f"{self.devices.shape}, axis names {self.axis_names}")
        if not all(isinstance(d, torch.device) for d in self.devices.flat):
            raise TypeError("mesh devices must be torch.device objects")


def factor2d(n: int) -> tuple[int, int]:
    """Most-square factorization of n (px >= py)."""
    py = int(math.isqrt(n))
    while n % py:
        py -= 1
    return n // py, py


def make_mesh(n_devices: int | None = None, axis_names=("mx", "my"),
              devices=None) -> Mesh:
    """A mesh of ``n_devices`` devices (default: all given), shaped (n,) for
    one axis name and ``factor2d(n)`` for two. ``devices`` defaults to the
    machine's CUDA devices, and there must be one: pass CPU devices (e.g.
    ``[torch.device("cpu")] * 4``) for a mesh on the CPU. A device may
    repeat, which makes a virtual mesh on one card or on the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices= (e.g. "
                               "[torch.device('cpu')] * 4) for a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices) if n_devices is None else int(n_devices)
    if not 1 <= n <= len(devices):
        raise ValueError(f"make_mesh: {n} devices asked, {len(devices)} given")
    axis_names = tuple(axis_names)
    shape = (n,) if len(axis_names) == 1 else factor2d(n)
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(shape), axis_names)


def on_device(device: torch.device):
    """Make ``device`` current for the kernels launched under it (a no-op
    for the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
