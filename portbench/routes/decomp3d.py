"""``tpuvof_torch.parallel.Decomp3D``'s resident driver: the 3-D step on a
mesh of pencils (the configuration's ``mesh``, one card a shard), each
shard's block widened once at a job's start (``start``) and stepped a
frame at a time (``advance``), as ``python -m tpuvof_torch --three-d
--mesh PX,PY`` runs it. The state is the shards' blocks
(``portbench.shards.Pencils``); a frame returns once every card has run
it. Judged on boxes (``reference/cone3d.py``): the reference advances each
box's cone of the kept input, and only the boxes are compared.

A program whose Decomp3D has no resident driver (``init_shards``,
``start``, ``advance``, ``line``) cannot run the cell: the route raises
when it is made, before any job starts.
"""
from __future__ import annotations

import torch

from portbench.harness import compare_states
from portbench.reference.cone3d import ConeFlow3D, crop
from portbench.shards import Kept, Plan, blocks_of, make_decomp, pencils_of, register

FIELDS = ("F", "u", "v", "w", "p")
DRIVER = ("init_shards", "start", "advance", "line", "owned")

__all__ = ["Route", "BoxReference"]


class BoxReference:
    """The plain reference on the judged boxes: each box's cone of a kept
    state (five ``Kept``) advanced by ``ConeFlow3D``."""

    def __init__(self, config: dict, plan: Plan):
        self.cones = ConeFlow3D(config)
        self.plan = plan

    def advance(self, state: tuple, n: int, istep0: int) -> tuple:
        outs = [[] for _ in FIELDS]
        for b in range(len(self.plan.boxes)):
            for f, a in enumerate(self.cones.advance(tuple(k.cones[b] for k in state), n,
                                                     istep0)):
                outs[f].append(a)
        return tuple(Kept(o) for o in outs)

    def boxes(self, state: tuple) -> tuple:
        """Each field's cells of every box, flattened end to end."""
        return tuple(torch.cat([crop(c, box, cone).reshape(-1) for c, box, cone in
                                zip(k.cones, self.plan.boxes, self.plan.cones)])
                     for k in state)


class Route:
    dims = 3

    def __init__(self, config: dict, traffic: dict, device):
        from tpuvof_torch.parallel import Decomp3D

        missing = [m for m in DRIVER if not hasattr(Decomp3D, m)]
        if missing:
            raise RuntimeError(f"tpuvof_torch's Decomp3D has no resident driver (missing "
                               f"{missing}): it cannot keep the mesh's shards on their cards")
        self.dec = make_decomp(config, traffic, device)
        self.plan = Plan(config, traffic, self.dec)
        register(config, device, self.dec, self.plan)
        self.devices = sorted({d for d in self.dec.devices if d.type == "cuda"}, key=str)
        self.cards = len(self.dec.devices)
        self.shape = self.dec.g.shape
        self.cells = config["nx"] * config["ny"] * config["nz"]
        self.n_jacobi = config["n_jacobi"]
        self.dtype = config["dtype"]

    def advance(self, state, n: int, istep0: int):
        blocks = self.dec.advance(blocks_of(state), n, istep0=istep0)
        # the harness fences only the first card
        for d in self.devices:
            torch.cuda.synchronize(d)
        return pencils_of(blocks, self.dec, self.plan), None

    def line(self, state) -> tuple:
        """The program's frame line numbers (mass, min, max) of the state."""
        return self.dec.line(blocks_of(state))

    def reference(self, config: dict) -> BoxReference:
        return BoxReference(config, self.plan)

    @staticmethod
    def judge(ref: BoxReference, sample, dtype=torch.float64):
        """The reference's cones after the frame, and the state numbers on
        the boxes."""
        out = ref.advance(tuple(k.to(dtype) for k in sample.inp), sample.steps, sample.istep0)
        return out, compare_states(ref.boxes(sample.out), ref.boxes(out), FIELDS)
