"""Distributed 3-D solver: x slabs or (x, y) pencils on a device mesh
(counterpart of tpuvof/parallel/dist3d.py, its resident wide-halo engine).

tpuvof runs this engine as ``backend='pallas'`` under ``shard_map``; the
port runs it as ``backend='cuda'`` from one controller: one set of tensors
per shard on its mesh device, the four 3-D kernels of
kernels/step3d_kernels.py on each shard's extended block, and halo
exchange by ``Tensor.copy_`` between shard tensors (tpuvof's
``lax.ppermute``). Given CPU devices, the kernel wrappers run their plain
versions, which is how the CPU tests drive it.

The engine (tpuvof's round-3 design):
- each shard's block is extended once at entry: W planes of neighbour data
  on each x side and, in pencil mode, Wy rows on each y side, zeros beyond
  the walls (the kernels' global masks keep that junk inert);
- each step refreshes the (W+1) outermost planes (and Wy+1 rows) of every
  field in place from the neighbours' owned planes, x stage on every shard
  before the y stage on any, because the y stage copies rows over the full
  x extent, x halos included: the corners arrive without diagonal copies.
  Then the four kernels run on the extended block with the shard's global
  origin, the sweeps in the istep % 3 rotation, the last with mirror_out,
  and the x-edge shards restore their F wall plane;
- the centre is sliced out once at exit, then the exit BC.

W = n_jacobi + 4 (+6 with csf) is the step's dependency cone: after a
refresh every block plane holds current data, and the final F is exact on
the owned planes iff W covers the rhs's outer plane, n_jacobi erosions,
the correction's p at i-1 and the x-sweep's 3 planes. Wy likewise.

Ordering across devices: every kernel launches on the current stream of
its shard's device (the engine enters that device first), and ``copy_``
between two CUDA devices makes the source's and the destination's current
streams wait for each other before and after the copy, so a halo copy runs
after the kernels that wrote its source and before those that read its
destination. On a single device (a virtual mesh) one stream orders it all.
The CPU tests cannot show this ordering: they run on one device.

Not ported (ROADMAP): tpuvof's XLA engine (per-op exchanges, windowed
sweeps: what runs shards too thin for the cone), the distributed hybrid
(rbsor/mg between the kernel phases) and the mesh planner. Where tpuvof
falls back to its XLA engine with a warning, the port raises.
"""
from __future__ import annotations

import contextlib

import torch

from ..config import Fluid
from ..grid import Grid3D
from ..kernels import step3d_kernels as K3
from ..ops import apply_bc_3d_
from ..ops.fct3d import SWEEP_ORDER
from ..state import State3D
from .mesh import Mesh

__all__ = ["Decomp3D", "admission_3d"]


def admission_3d(g: Grid3D, px: int, py: int, n_jacobi: int = 10,
                 pencil: bool | None = None, csf: bool = False) -> dict:
    """Whether the wide-halo engine admits a px x py decomposition, and
    its geometry (tpuvof's pallas_admission_3d). Needs nx % px == ny % py
    == 0 (the caller checks). Returns a dict:

      ok       whether the engine runs at this shape
      pencil   the engine the shape implies (py > 1, or forced)
      W, nloc  x cone and extended interior plane count, nxl + 2W
      Wy, nyE  y cone and extended interior row count (0 and nyl for slabs)
      why      the reason when not ok

    Only tpuvof's decisions are ported: W = n_jacobi + 4 (+6 with csf),
    the step's dependency cone, and Wy likewise; each halo of W+1 planes
    (Wy+1 rows) must come from one neighbour's owned planes, so W+1 <=
    nx/px (and Wy+1 <= ny/py). Its slab-chunk rounding of W (the reason
    for its ``halo_width`` option), its even-nx/px condition and its VMEM
    residency test size the TPU's chunks and scratch and are dropped: a
    wider W only adds sacrificial halo work, since the cells a shard keeps
    do not depend on it, so W is the cone and nothing sets it."""
    nxl, nyl = g.nx // px, g.ny // py
    use_pencil = (py > 1) if pencil is None else bool(pencil)
    # csf widens the predictor's F cone from +-1 to +-3 planes (kappa at
    # i+-1 needs normals at i+-2, which need F at i+-3)
    base = n_jacobi + (6 if csf else 4)
    W = base
    Wy = base if use_pencil else 0
    nloc, nyE = nxl + 2 * W, nyl + 2 * Wy
    ok = W + 1 <= nxl and (not use_pencil or Wy + 1 <= nyl)
    why = ""
    if not ok:
        why = (f"needs nx/px > W={W} (nx/px={nxl})"
               + (f", ny/py > Wy={Wy} (ny/py={nyl})" if use_pencil else ""))
    return dict(ok=ok, pencil=use_pencil, W=W, nloc=nloc, Wy=Wy, nyE=nyE, why=why)


def _on(device: torch.device):
    """Make ``device`` current for the kernels launched under it."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class Decomp3D:
    """Domain decomposition of a 3-D grid: x slabs over a 1-axis mesh, or
    (x, y) pencils over a 2-axis mesh with py > 1. ``pencil=True`` forces
    the pencil engine on a 2-axis mesh with py == 1 (tpuvof's option): it
    computes the slab engine's answer with 2 Wy more rows a block, so it
    serves only to hold the pencil path to the slab and serial ones, as the
    tests do.

    Only ``backend='cuda'`` with the fixed Jacobi exists: ``'torch'`` (the
    counterpart of tpuvof's XLA engine) and the residual-driven solvers
    (its distributed hybrid) raise NotImplementedError, and a shape that
    the engine does not admit raises ValueError where tpuvof would fall
    back to its XLA engine, so no fallback hides the kernels.

    ``simulate`` takes and returns a whole-grid State3D. Its stages are
    public for callers that keep the shards resident: ``scatter_state``,
    ``widen`` (entry BC and extension), ``advance`` (the steps, on the
    extended blocks), ``narrow`` (slice and exit BC) and ``gather_state``.
    Shards are lists in ``coords`` order, (xi, yi) row-major."""

    def __init__(self, g: Grid3D, mesh: Mesh, fl: Fluid | None = None, dt: float = 4e-6,
                 n_jacobi: int = 10, backend: str = "cuda", pencil: bool = False,
                 pressure_solver: str = "jacobi", csf: bool = False):
        axes = tuple(mesh.axis_names)
        if len(axes) not in (1, 2):
            raise ValueError("Decomp3D expects a 1-axis (x slabs) or 2-axis (x, y "
                             "pencils) mesh")
        if backend == "torch":
            raise NotImplementedError(
                "Decomp3D backend='torch' (tpuvof's XLA engine: per-op exchanges and "
                "windowed sweeps) is not ported yet (ROADMAP Queue 1 item 9)")
        if backend != "cuda":
            raise ValueError(f"unknown backend {backend!r}; Decomp3D has 'cuda'")
        if pressure_solver in ("rbsor", "mg", "auto"):
            raise NotImplementedError(
                f"Decomp3D pressure_solver={pressure_solver!r} runs tpuvof's distributed "
                "hybrid (parallel/mg.py), which is not ported yet (ROADMAP Queue 1 "
                "item 9); the port's engine runs the fixed Jacobi")
        if pressure_solver != "jacobi":
            raise ValueError(f"unknown pressure_solver {pressure_solver!r}")
        g.validate()
        self.g = g
        self.px = mesh.devices.shape[0]
        self.py = mesh.devices.shape[1] if len(axes) == 2 else 1
        if g.nx % self.px or g.ny % self.py:
            raise ValueError(f"grid {g.nx}x{g.ny} not divisible by mesh "
                             f"{self.px}x{self.py}")
        if pencil and len(axes) == 1:
            raise ValueError("pencil=True needs a 2-axis mesh")
        self.nxl, self.nyl = g.nx // self.px, g.ny // self.py
        self.fl = fl or Fluid()
        self.dt, self.n_jacobi, self.csf = dt, n_jacobi, bool(csf)
        self.pencil = len(axes) == 2 and (self.py > 1 or bool(pencil))
        adm = admission_3d(g, self.px, self.py, n_jacobi, self.pencil, self.csf)
        if not adm["ok"]:
            raise ValueError(f"Decomp3D: the wide-halo engine {adm['why']}; tpuvof falls "
                             "back to its XLA engine there, which the port does not have "
                             "yet (ROADMAP Queue 1 item 9)")
        self.W, self.nloc, self.Wy, self.nyE = adm["W"], adm["nloc"], adm["Wy"], adm["nyE"]
        self.coords = [(xi, yi) for xi in range(self.px) for yi in range(self.py)]
        flat = mesh.devices.reshape(self.px, self.py)
        self.devices = [flat[xi, yi] for xi, yi in self.coords]

    def _index(self, xi: int, yi: int) -> int:
        return xi * self.py + yi

    # ---- host-side layout ----
    def scatter_state(self, state: State3D) -> list[State3D]:
        """One (nxl+2, nyl+2, nz+2) block per shard, on its device: its
        owned cells and one ghost layer."""
        out = []
        for (xi, yi), dev in zip(self.coords, self.devices):
            i0, j0 = xi * self.nxl, yi * self.nyl
            out.append(State3D(*(a[i0:i0 + self.nxl + 2, j0:j0 + self.nyl + 2]
                                 .to(dev, copy=True).contiguous() for a in state)))
        return out

    def gather_state(self, shards: list[State3D], device=None) -> State3D:
        """The whole-grid state (on ``device``, default the first shard's)
        from the shards' owned cells, its ghosts rebuilt by the BCs."""
        g = self.g
        ref = shards[0].F
        device = ref.device if device is None else torch.device(device)
        fields = [torch.zeros(g.shape, dtype=ref.dtype, device=device) for _ in range(5)]
        for (xi, yi), s in zip(self.coords, shards):
            i0, j0 = xi * self.nxl, yi * self.nyl
            for out, blk in zip(fields, s):
                out[i0 + 1:i0 + self.nxl + 1, j0 + 1:j0 + self.nyl + 1] = blk[1:-1, 1:-1]
        F, u, v, w, p = fields
        u, v, w, F, p = apply_bc_3d_(u, v, w, F, p)
        return State3D(F=F, u=u, v=v, w=w, p=p)

    # ---- masked BCs and the one-layer exchange ----
    def _bc_(self, shards: list[State3D]) -> None:
        """The walls in place on the shards that own them (y faces, then x,
        then z: ops/bc.apply_bc_3d_ on each edge), then the ghost-layer
        exchange."""
        for (xi, yi), (F, u, v, w, p) in zip(self.coords, shards):
            if yi == 0:
                for a in (u, w, F, p):
                    a[:, 0] = a[:, 1]
                v[:, 1] = 0.0
            if yi == self.py - 1:
                for a in (u, w, F, p):
                    a[:, -1] = a[:, -2]
                v[:, -1] = 0.0
            if xi == 0:
                u[1] = 0.0
                for a in (v, w, F, p):
                    a[0] = a[1]
            if xi == self.px - 1:
                u[-1] = 0.0
                for a in (v, w, F, p):
                    a[-1] = a[-2]
            for a in (u, v, F, p):
                a[:, :, 0] = a[:, :, 1]
                a[:, :, -1] = a[:, :, -2]
            w[:, :, 1] = 0.0
            w[:, :, -1] = 0.0
        self._refresh(shards, 0, self.nxl, 0, self.nyl)

    def _refresh(self, shards: list[State3D], W: int, nxl: int, Wy: int, nyl: int) -> None:
        """Overwrite the (W+1) outermost planes on each x side of every
        field with the neighbour's owned planes, then the (Wy+1) outermost
        rows on each y side over the full x extent (tpuvof's _refresh_halo;
        with W = Wy = 0 its one-layer _exchange). Edge shards keep what lies
        beyond their walls."""
        def stage(axis, n, w, lo_nbr, hi_nbr):
            for k, (xi, yi) in enumerate(self.coords):
                lo, hi = lo_nbr(xi, yi), hi_nbr(xi, yi)
                for f in range(5):
                    dst = shards[k][f]
                    if lo is not None:
                        dst.narrow(axis, 0, w + 1).copy_(
                            shards[lo][f].narrow(axis, n, w + 1), non_blocking=True)
                    if hi is not None:
                        dst.narrow(axis, w + n + 1, w + 1).copy_(
                            shards[hi][f].narrow(axis, w + 1, w + 1), non_blocking=True)

        if self.px > 1:
            stage(0, nxl, W,
                  lambda xi, yi: self._index(xi - 1, yi) if xi > 0 else None,
                  lambda xi, yi: self._index(xi + 1, yi) if xi < self.px - 1 else None)
        if self.py > 1:
            stage(1, nyl, Wy,
                  lambda xi, yi: self._index(xi, yi - 1) if yi > 0 else None,
                  lambda xi, yi: self._index(xi, yi + 1) if yi < self.py - 1 else None)

    def _widen(self, shards: list[State3D], axis: int, w: int) -> list[State3D]:
        """Each block with w more planes (axis 0) or rows (axis 1) of
        current neighbour data on each side, zeros beyond the walls
        (tpuvof's _widen / _widen_y): the neighbour's a[-2-w:-2] below and
        a[2:2+w] above."""
        n_ax = self.px if axis == 0 else self.py
        out = []
        for k, ((xi, yi), dev) in enumerate(zip(self.coords, self.devices)):
            pos = xi if axis == 0 else yi
            step = self.py if axis == 0 else 1
            fields = []
            for f, a in enumerate(shards[k]):
                n = a.shape[axis]
                lo = (shards[k - step][f].narrow(axis, n - 2 - w, w).to(dev) if pos > 0
                      else torch.zeros_like(a.narrow(axis, 0, w)))
                hi = (shards[k + step][f].narrow(axis, 2, w).to(dev) if pos < n_ax - 1
                      else torch.zeros_like(a.narrow(axis, 0, w)))
                fields.append(torch.cat([lo, a, hi], dim=axis).contiguous())
            out.append(State3D(*fields))
        return out

    # ---- the engine ----
    def widen(self, shards: list[State3D]) -> list[State3D]:
        """Entry: the BCs and the ghost exchange on copies of the shards,
        then the resident extended blocks, (nloc+2, nyE+2, nz+2) each."""
        shards = [State3D(*(a.clone() for a in s)) for s in shards]
        self._bc_(shards)
        if self.pencil:
            shards = self._widen(shards, 1, self.Wy)
        return self._widen(shards, 0, self.W)

    def narrow(self, blocks: list[State3D]) -> list[State3D]:
        """Exit: each block's centre (owned cells and one ghost layer), with
        the BCs and the ghost exchange."""
        sx = slice(self.W, self.W + self.nxl + 2)
        sy = slice(self.Wy, self.Wy + self.nyl + 2)
        shards = [State3D(*(a[sx, sy].contiguous() for a in b)) for b in blocks]
        self._bc_(shards)
        return shards

    def step(self, blocks: list[State3D], phase: int) -> list[State3D]:
        """One step on the extended blocks: the in-place halo refresh, then
        each shard's kernels (tpuvof's _local_step_pallas). Returns new
        blocks; the refresh writes into the given ones."""
        self._refresh(blocks, self.W, self.nxl, self.Wy, self.nyl)
        return [self._step_shard(k, blocks[k], phase) for k in range(len(blocks))]

    def origin(self, k: int) -> dict:
        """The kernels' block origin of shard k's extended block: gi_base,
        and in pencil mode njl and gj_base."""
        xi, yi = self.coords[k]
        kw = dict(gi_base=xi * self.nxl - self.W)
        if self.pencil:
            kw.update(njl=self.nyE, gj_base=yi * self.nyl - self.Wy)
        return kw

    def _step_shard(self, k: int, block: State3D, phase: int) -> State3D:
        g = self.g
        kw = self.origin(k)
        F, u, v, w, p = block
        with _on(self.devices[k]):
            us, vs, ws, rhs = K3.predict3d_rhs(g, self.fl, self.dt, u, v, w, F, self.csf,
                                               **kw)
            p = K3.jacobi3d(g, self.n_jacobi, p, rhs, **kw)
            vels = K3.correct3d(g, self.fl, self.dt, us, vs, ws, p, F, **kw)
            for idx, axis in enumerate(SWEEP_ORDER[phase]):
                F = K3.fct3d_sweep(g, self.dt, F, vels[axis], axis, idx == 2, **kw)
            self._restore_wall_planes(k, F)
        u, v, w = vels
        return State3D(F=F, u=u, v=v, w=w, p=p)

    def _restore_wall_planes(self, k: int, F: torch.Tensor) -> None:
        """On an x-edge shard the global x-wall plane of F sits mid-block,
        where the in-plane sweeps processed it: restore the fresh mirror the
        next step's sweeps read (the serial last sweep's _ghost_planes_out).
        In place; nothing on an interior shard."""
        xi, W, nxl = self.coords[k][0], self.W, self.nxl
        if xi == 0:
            F[W] = F[W + 1]
        if xi == self.px - 1:
            F[W + nxl + 1] = F[W + nxl]

    def advance(self, blocks: list[State3D], n_steps: int, istep0: int = 0) -> list[State3D]:
        """``n_steps`` steps on the extended blocks; ``istep0`` is the last
        global step already taken, so the istep % 3 rotation continues
        across chunked calls (first step phase (istep0 + 1) % 3)."""
        ph1 = (istep0 % 3 + 1) % 3
        for s in range(n_steps):
            blocks = self.step(blocks, (ph1 + s) % 3)
        return blocks

    def simulate(self, state: State3D, n_steps: int, istep0: int = 0) -> State3D:
        """Advance a whole-grid state ``n_steps`` through the mesh; the
        result lies on the state's device."""
        blocks = self.advance(self.widen(self.scatter_state(state)), n_steps, istep0)
        return self.gather_state(self.narrow(blocks), device=state.F.device)
