"""A mesh cell's state as the job loop carries it, and what a kept frame
keeps of it.

The program keeps a decomposed grid resident: each shard's block on its
own card, never the whole grid on one. The loop's state is then five
``Pencils``, one a field (F, u, v, w, p), each holding the shards' blocks.
The loop keeps a frame by ``.cpu()`` of each field, which here copies to
the host only what the check reads: the cone of each judged box
(reference/cone3d.py), assembled from the shards' owned cells and the
walls' ghost planes, and for F the frame line's numbers in float64 over
every owned cell, reduced on the cards by this module's own code. A kept
field (``Kept``) moves and casts as a tensor does, so the harness's check
and the control handle it unchanged.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from portbench.reference.cone3d import cone

__all__ = ["Kept", "Pencils", "Plan", "make_decomp", "register", "resident", "blocks_of",
           "pencils_of"]

#: Planes a float64 partial sum of the line's mass covers.
_CHUNK = 64

#: The route's Decomp3D and Plan of each (configuration, device), for the
#: case that makes the jobs' states; the route registers them when made.
_RESIDENT: dict = {}


def _key(config: dict, device) -> tuple:
    return json.dumps(config, sort_keys=True), str(torch.device(device))


def _mesh_devices(n: int, device) -> list:
    """The mesh's devices: the first ``n`` cards where the machine has
    them; otherwise ``device`` n times (a virtual mesh: the CPU, or one
    card for a trial at a smaller size)."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [device] * n


def make_decomp(config: dict, traffic: dict, device):
    """The program's Decomp3D of a configuration (its ``mesh`` of px x py
    pencils) on the traffic's backend."""
    from tpuvof_torch import Fluid, Grid3D
    from tpuvof_torch.parallel import Decomp3D, Mesh

    px, py = (int(x) for x in config["mesh"])
    devices = np.empty(px * py, dtype=object)
    devices[:] = _mesh_devices(px * py, device)
    grid = Grid3D(config["nx"], config["ny"], config["nz"], config["Lx"], config["Ly"],
                  config["Lz"])
    return Decomp3D(grid, Mesh(devices.reshape(px, py), ("mx", "my")),
                    fl=Fluid(**config["fluid"]), dt=config["dt"], n_jacobi=config["n_jacobi"],
                    backend=traffic["backend"], csf=bool(config["csf"]))


def register(config: dict, device, dec, plan) -> None:
    _RESIDENT[_key(config, device)] = (dec, plan)


def resident(config: dict, device) -> tuple:
    """(Decomp3D, Plan) that the cell's route registered for ``config`` on
    ``device``."""
    try:
        return _RESIDENT[_key(config, device)]
    except KeyError:
        raise LookupError("no mesh route was made for this configuration and device") from None


class Plan:
    """Where a mesh cell's state lies and what a kept frame takes of it:
    the shards' owned ranges (ghosted global indices, walls' ghost planes
    given to the edge shards), the judged boxes and their cones."""

    def __init__(self, config: dict, traffic: dict, dec):
        self.dec = dec
        n = (config["nx"], config["ny"], config["nz"])
        self.boxes = [tuple(zip(b["lo"], b["hi"])) for b in config["boxes"]]
        self.cones = [cone(b, int(traffic["frame_every"]), int(config["n_jacobi"]), n)
                      for b in self.boxes]
        self.n = n

    def _claims(self, k: int) -> list:
        """Shard k's share of the ghosted grid along x and y: its owned
        planes, and the wall's ghost plane where it holds a wall."""
        xi, yi = self.dec.coords[k]
        out = []
        for pos, count, nl, na in ((xi, self.dec.px, self.dec.nxl, self.n[0]),
                                   (yi, self.dec.py, self.dec.nyl, self.n[1])):
            a, b = pos * nl + 1, pos * nl + nl + 1
            out.append((0 if pos == 0 else a, na + 2 if pos == count - 1 else b, pos * nl))
        return out

    def region(self, blocks: list, owned: tuple, ranges: tuple) -> torch.Tensor:
        """The ghosted global index ``ranges`` of a field, on the host,
        from the shards' blocks (``owned``: where a block's owned cells
        start)."""
        shape = tuple(b - a for a, b in ranges)
        out = torch.empty(shape, dtype=blocks[0].dtype)
        (x0, x1), (y0, y1), (z0, z1) = ranges
        for k, blk in enumerate(blocks):
            (ax, bx, ox), (ay, by, oy) = self._claims(k)
            gx0, gx1, gy0, gy1 = max(x0, ax), min(x1, bx), max(y0, ay), min(y1, by)
            if gx0 >= gx1 or gy0 >= gy1:
                continue
            # block index of ghosted global index g: g - origin - 1 + owned start
            lx, ly = owned[0].start - ox - 1, owned[1].start - oy - 1
            out[gx0 - x0:gx1 - x0, gy0 - y0:gy1 - y0] = \
                blk[gx0 + lx:gx1 + lx, gy0 + ly:gy1 + ly, z0:z1].cpu()
        return out

    def line(self, blocks: list, owned: tuple) -> dict:
        """F's line numbers over every owned cell, in float64: the mass
        summed on each card _CHUNK planes at a time, the range."""
        sx, sy, sz = owned
        parts = []
        for blk in blocks:
            F = blk[:, sy, sz]
            mass = torch.zeros((), dtype=torch.float64, device=F.device)
            for i in range(sx.start, sx.stop, _CHUNK):
                mass += F[i:min(i + _CHUNK, sx.stop)].to(torch.float64).sum()
            parts.append(torch.stack((mass, F[sx].min().double(), F[sx].max().double())))
        host = [p.cpu() for p in parts]
        return {"mass": sum(float(p[0]) for p in host), "min": min(float(p[1]) for p in host),
                "max": max(float(p[2]) for p in host)}


class Kept:
    """What a kept frame keeps of one field: the cone of each judged box,
    and for F the float64 line numbers of its every owned cell. Moves and
    casts (``cpu``, ``to``) as a tensor."""

    def __init__(self, cones: list, line: dict | None = None):
        self.cones, self.line = list(cones), line

    @property
    def dtype(self):
        return self.cones[0].dtype

    def cpu(self) -> "Kept":
        return Kept([c.cpu() for c in self.cones], self.line)

    def to(self, *args, **kwargs) -> "Kept":
        return Kept([c.to(*args, **kwargs) for c in self.cones], self.line)


class Pencils:
    """One field of a resident mesh state: each shard's block on its card
    (``owned``: the index of a block's owned cells). ``cpu()`` is what a
    kept frame takes of it (``Kept``)."""

    def __init__(self, blocks: list, owned: tuple, plan: Plan, is_F: bool):
        self.blocks, self.owned, self.plan, self.is_F = blocks, owned, plan, is_F

    def cpu(self) -> Kept:
        cones = [self.plan.region(self.blocks, self.owned, c) for c in self.plan.cones]
        return Kept(cones, self.plan.line(self.blocks, self.owned) if self.is_F else None)


def pencils_of(blocks: list, dec, plan: Plan) -> tuple:
    """The loop's state (five ``Pencils``) of the program's blocks, a
    list of State3D in shard order."""
    return tuple(Pencils([b[f] for b in blocks], dec.owned, plan, f == 0) for f in range(5))


def blocks_of(state: tuple) -> list:
    """The program's blocks (State3D per shard) of the loop's state."""
    from tpuvof_torch.state import State3D

    if not all(isinstance(p, Pencils) for p in state):
        raise TypeError("the state holds no resident blocks (a kept frame's fields have "
                        "only the judged cones)")
    return [State3D(*fields) for fields in zip(*(p.blocks for p in state))]
