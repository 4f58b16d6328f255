"""Distributed 3-D solver: x slabs or (x, y) pencils on a device mesh
(counterpart of tpuvof/parallel/dist3d.py).

tpuvof runs its engines under ``shard_map``; the port runs them from one
controller: one set of tensors per shard on its mesh device, and halo
exchange by ``Tensor.copy_`` between shard tensors (tpuvof's
``lax.ppermute``). Given CPU devices, the kernel wrappers run their plain
versions, which is how the CPU tests drive it. Three engines:

``backend='torch'`` (tpuvof's XLA engine): tpuvof's _local_step on every
shard, plain torch ops on a local grid (the local extents with the global
spacing) and one-layer exchanges of each field it needs fresh: the
normals and kappa with csf, u*, v*, w*, p after each Jacobi sweep or SOR
half sweep, F after each FCT sweep, and the masked wall BCs. The x sweep
runs on a block widened by two planes of the neighbours (global-index
masks keep what lies beyond the walls inert), the y sweep likewise on a
pencil mesh. It needs only nx % px == ny % py == 0: a shard may be one
plane thick.

``backend='cuda'`` with the fixed Jacobi (tpuvof's resident wide-halo
engine, round-3 design):
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

``backend='cuda'`` with rbsor, mg or auto (tpuvof's distributed hybrid):
the same resident blocks with W = 4 (+2 with csf), the cone without the
Jacobi erosion: predict3d_rhs, then the distributed solve (this module's
rbsor, or parallel/mg.py) on each block's ring layout (owned cells and one
ghost layer), the solved p put back into a zeroed block and its halo
refreshed once, then correct3d and the three sweeps. No jacobi3d launch.

Ordering across devices: every kernel launches on the current stream of
its shard's device (the engine enters that device first), and ``copy_``
between two CUDA devices makes the source's and the destination's current
streams wait for each other before and after the copy, so a halo copy runs
after the ops that wrote its source and before those that read its
destination. On a single device (a virtual mesh) one stream orders it all.
The CPU tests cannot show this ordering: they run on one device.

Where tpuvof falls back from its Pallas engine to its XLA engine with a
warning, the port raises: no fallback trades the kernels for plain ops.

Resident driving (the CLI's ``--three-d --mesh``): ``init_shards`` makes
each shard's initial block on its own device from the global coordinates
of its planes and rows, ``start`` turns the shards into the engine's
blocks in place, ``advance`` steps them a frame at a time, ``line`` reduces
the frame's mass and range on each device, and ``finish`` narrows and
gathers the whole grid only where a caller needs it. No whole-grid tensor
is made on the way. ``simulate`` (a whole state in and out) is that path
with a scatter at entry and a gather at exit.

Tracing (utils.profiling.span): ``tv.simulate`` around ``advance``,
``tv.halo`` around each halo refresh, ``tv.shard_line`` around ``line``;
``HALO`` counts the refreshes, the steps and the halo copies over the
process.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import Fluid
from ..grid import Grid3D
from ..kernels import step3d_kernels as K3
from ..ops import apply_bc_3d_, clamp01, mix_properties
from ..ops.fct3d import (SWEEP_ORDER, fct3d_sweep_y, fct3d_sweep_z, sweep_masked_2axis,
                         sweep_x_masked)
from ..ops.mg import _red_mask, mg_levels
from ..ops.momentum3d import predict_velocity_3d, update_velocity_3d
from ..ops.normals3d import curvature_from_normals_3d, young_normals_3d
from ..ops.poisson import jacobi_blocks, poisson_coefficients_3d, rbsor_blocks, rhs_3d
from ..state import State3D, init_block_3d
from ..utils.profiling import span
from . import mg as pmg
from .halo import refresh_, widen
from .mesh import Mesh, on_device

__all__ = ["Decomp3D", "admission_3d", "HALO"]

#: Halo traffic of every Decomp3D over the process, never reset:
#: ``refreshes`` (calls of the in-place refresh: one a wide-halo step, one
#: a ghost exchange of the BCs), ``steps`` (steps taken by ``step``),
#: ``copies`` and ``peer_copies`` (the refreshes' and exchanges'
#: ``Tensor.copy_`` calls, and those between two devices), ``bytes``
#: (what they copied).
HALO = {"refreshes": 0, "steps": 0, "copies": 0, "peer_copies": 0, "bytes": 0}

#: Planes of F a float64 partial sum of ``Decomp3D.line`` covers.
_LINE_CHUNK = 64


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
    the step's dependency cone, and Wy likewise (the hybrid passes
    n_jacobi = 0); each halo of W+1 planes (Wy+1 rows) must come from one
    neighbour's owned planes, so W+1 <= nx/px (and Wy+1 <= ny/py). Its
    slab-chunk rounding of W (the reason for its ``halo_width`` option),
    its even-nx/px condition and its VMEM residency test size the TPU's
    chunks and scratch and are dropped: a wider W only adds sacrificial
    halo work, since the cells a shard keeps do not depend on it, so W is
    the cone and nothing sets it."""
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


@dataclass(frozen=True)
class _LocalGrid3:
    """A shard's grid for the plain ops: the local extents, with the global
    spacing copied, not derived again (a spacing recomputed from a local
    length would not round the same)."""

    nx: int
    ny: int
    nz: int
    dx: float
    dy: float
    dz: float
    dxi: float
    dyi: float
    dzi: float


class Decomp3D:
    """Domain decomposition of a 3-D grid: x slabs over a 1-axis mesh, or
    (x, y) pencils over a 2-axis mesh with py > 1. ``pencil=True`` forces
    the pencil form of the wide-halo engine on a 2-axis mesh with py == 1
    (tpuvof's option): it computes the slab engine's answer with 2 Wy more
    rows a block, so it serves only to hold the pencil path to the slab and
    serial ones, as the tests do; ``backend='torch'`` cannot honour it.

    ``pressure_solver``: 'jacobi' (n_jacobi fixed sweeps), 'rbsor', 'mg',
    or 'auto' (mg where the global grid coarsens, else rbsor), with
    tpuvof's sor_* options. On ``backend='cuda'``, rbsor/mg run the
    distributed hybrid. A shape that the wide-halo engine does not admit
    raises ValueError where tpuvof would fall back to its XLA engine:
    ``backend='torch'`` runs it.

    ``simulate`` takes and returns a whole-grid State3D. Its stages are
    public for callers that keep the shards resident: ``scatter_state``
    (or ``init_shards``, the initial condition made shard by shard),
    ``widen`` (the engine's entry layout; ``start`` does it in place),
    ``advance`` (the steps), ``line`` (the frame's mass and range from
    per-shard reductions), ``narrow`` (back to the ring layout) and
    ``gather_state`` (``finish`` does both). Shards are lists in
    ``coords`` order, (xi, yi) row-major."""

    def __init__(self, g: Grid3D, mesh: Mesh, fl: Fluid | None = None, dt: float = 4e-6,
                 n_jacobi: int = 10, backend: str = "cuda", pencil: bool = False,
                 pressure_solver: str = "jacobi", csf: bool = False, sor_omega: float = 1.7,
                 sor_tol: float = 1e-3, sor_max_iter: int = 200, sor_tol_rel: float = 0.0):
        axes = tuple(mesh.axis_names)
        if len(axes) not in (1, 2):
            raise ValueError("Decomp3D expects a 1-axis (x slabs) or 2-axis (x, y "
                             "pencils) mesh")
        if backend not in ("torch", "cuda"):
            raise ValueError(f"unknown backend {backend!r}; Decomp3D has 'torch' and 'cuda'")
        if pressure_solver == "auto":
            # mg where the global grid coarsens (its coarse levels ride one
            # gather, parallel/mg.py), rbsor where it does not
            pressure_solver = "mg" if len(mg_levels((g.nx, g.ny, g.nz))) >= 2 else "rbsor"
        if pressure_solver not in ("jacobi", "rbsor", "mg"):
            raise ValueError(f"unknown pressure_solver {pressure_solver!r} "
                             "(jacobi | rbsor | mg | auto)")
        g.validate()
        self.g = g
        self.px = mesh.devices.shape[0]
        self.py = mesh.devices.shape[1] if len(axes) == 2 else 1
        if g.nx % self.px or g.ny % self.py:
            raise ValueError(f"grid {g.nx}x{g.ny} not divisible by mesh "
                             f"{self.px}x{self.py}: every engine needs nx % px == ny % py "
                             "== 0, backend='torch' too")
        if pencil and len(axes) == 1:
            raise ValueError("pencil=True needs a 2-axis mesh")
        if pencil and backend != "cuda":
            raise ValueError("pencil=True forces the wide-halo pencil engine; "
                             f"backend={backend!r} cannot honour it")
        self.nxl, self.nyl = g.nx // self.px, g.ny // self.py
        self.fl = fl or Fluid()
        self.dt, self.n_jacobi, self.csf = dt, n_jacobi, bool(csf)
        self.backend, self.pressure_solver = backend, pressure_solver
        self.sor_omega, self.sor_tol = sor_omega, sor_tol
        self.sor_max_iter, self.sor_tol_rel = sor_max_iter, sor_tol_rel
        self.hybrid = backend == "cuda" and pressure_solver != "jacobi"
        self.pencil = backend == "cuda" and len(axes) == 2 and (self.py > 1 or bool(pencil))
        self.W, self.nloc, self.Wy, self.nyE = 0, self.nxl, 0, self.nyl
        if backend == "cuda":
            # the hybrid's cone leaves out the Jacobi erosion: its solve
            # makes p globally valid between predict3d_rhs and correct3d
            adm = admission_3d(g, self.px, self.py, 0 if self.hybrid else n_jacobi,
                               self.pencil, self.csf)
            if not adm["ok"]:
                raise ValueError(f"Decomp3D backend='cuda': the wide-halo engine "
                                 f"{adm['why']}; backend='torch' runs shards of any width "
                                 "(tpuvof falls back to its XLA engine here, the port does "
                                 "not fall back)")
            self.W, self.nloc, self.Wy, self.nyE = adm["W"], adm["nloc"], adm["Wy"], adm["nyE"]
        self.coords = [(xi, yi) for xi in range(self.px) for yi in range(self.py)]
        flat = mesh.devices.reshape(self.px, self.py)
        self.devices = [flat[xi, yi] for xi, yi in self.coords]
        self._gl = _LocalGrid3(nx=self.nxl, ny=self.nyl, nz=g.nz, dx=g.dx, dy=g.dy, dz=g.dz,
                               dxi=g.dxi, dyi=g.dyi, dzi=g.dzi)
        self._cache = {}

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

    def init_shards(self, ic: int = 1, dtype: torch.dtype = torch.float32) -> list[State3D]:
        """``scatter_state(init_state_3d(g, ic))`` without the whole grid:
        each shard's block (owned cells and one ghost layer) made on its
        device from its planes' and rows' global coordinates
        (state.init_block_3d)."""
        return [init_block_3d(self.g, ic, ((xi * self.nxl, xi * self.nxl + self.nxl + 2),
                                           (yi * self.nyl, yi * self.nyl + self.nyl + 2)),
                              dev, dtype)
                for (xi, yi), dev in zip(self.coords, self.devices)]

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

    # ---- halos, exchanges and the masked wall BCs ----
    def _exchange_(self, arrs: list) -> None:
        """The one-layer ghost exchange of one field's ring-layout tensors."""
        refresh_(arrs, self.px, self.py, counts=HALO)

    def _refresh(self, shards: list[State3D], W: int, Wy: int) -> None:
        """On every field of the shards, the (W+1) outermost planes on each
        x side from the neighbour's owned planes, then the (Wy+1) outermost
        rows on each y side over the full x extent (tpuvof's _refresh_halo;
        with W = Wy = 0 its one-layer _exchange); edge shards keep what lies
        beyond their walls (halo.refresh_)."""
        HALO["refreshes"] += 1
        with span("tv.halo"):
            for f in range(5):
                refresh_([s[f] for s in shards], self.px, self.py, (W, Wy), counts=HALO)

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
        self._refresh(shards, 0, 0)

    def _widen(self, shards: list[State3D], axis: int, w: int) -> list[State3D]:
        """``halo.widen`` on every field of the shards: w more planes (axis
        0) or rows (axis 1), each from the shard that holds it, zeros beyond
        the walls (tpuvof's _widen / _widen_y, whose one neighbour serves
        while w <= its extent; here a shard one plane thick widens too)."""
        fields = [widen([s[f] for s in shards], self.px, self.py, axis, w) for f in range(5)]
        return [State3D(*(fields[f][k] for f in range(5))) for k in range(len(shards))]

    # ---- the engine ----
    def widen(self, shards: list[State3D]) -> list[State3D]:
        """Entry, on copies of the shards. 'torch': the shards as they are
        (tpuvof's XLA engine applies no entry BC). 'cuda': the BCs and the
        ghost exchange, then the resident extended blocks, (nloc+2, nyE+2,
        nz+2) each."""
        return self.start([State3D(*(a.clone() for a in s)) for s in shards])

    def start(self, shards: list[State3D]) -> list[State3D]:
        """``widen`` on the shards themselves: their BCs and ghosts are
        written in place, and on 'cuda' the blocks replace them (drop the
        shards to free their memory), so a device holds at most two
        layouts of its shard at once."""
        if self.backend == "torch":
            return shards
        self._bc_(shards)
        if self.pencil:
            shards = self._widen(shards, 1, self.Wy)
        return self._widen(shards, 0, self.W)

    @property
    def owned(self) -> tuple[slice, slice, slice]:
        """The index of the owned cells in the engine's blocks (W = Wy = 0:
        in a shard's ring layout)."""
        return (slice(self.W + 1, self.W + 1 + self.nxl),
                slice(self.Wy + 1, self.Wy + 1 + self.nyl), slice(1, self.g.nz + 1))

    def line(self, blocks: list[State3D]) -> tuple[float, float, float]:
        """The frame line's numbers from per-shard reductions of F over the
        owned cells: (liquid mass, min F, max F). The mass is summed in
        float64 on each device, _LINE_CHUNK planes at a time, and the
        shards' sums are added on the host in shard order. F's ghosts mirror
        owned cells, so the owned range is the whole field's."""
        sx, sy, sz = self.owned
        chunk = _LINE_CHUNK
        with span("tv.shard_line"):
            parts = []
            for k, b in enumerate(blocks):
                with on_device(self.devices[k]):
                    F = b.F[:, sy, sz]
                    mass = torch.zeros((), dtype=torch.float64, device=F.device)
                    for i in range(sx.start, sx.stop, chunk):
                        mass += F[i:min(i + chunk, sx.stop)].sum(dtype=torch.float64)
                    lo, hi = torch.aminmax(F[sx])
                    parts.append(torch.stack((mass, lo.double(), hi.double())))
            host = [t.cpu() for t in parts]
        return (sum(float(t[0]) for t in host), min(float(t[1]) for t in host),
                max(float(t[2]) for t in host))

    def finish(self, blocks: list[State3D], device=None) -> State3D:
        """``gather_state(narrow(blocks), device)``: the whole grid, for a
        caller that needs it (a VTK frame, a checkpoint); ``device="cpu"``
        keeps it off the cards."""
        return self.gather_state(self.narrow(blocks), device=device)

    def narrow(self, blocks: list[State3D]) -> list[State3D]:
        """Exit: on 'cuda', each block's centre (owned cells and one ghost
        layer), with the BCs and the ghost exchange; on 'torch' the shards
        as they are."""
        if self.backend == "torch":
            return blocks
        sx = slice(self.W, self.W + self.nxl + 2)
        sy = slice(self.Wy, self.Wy + self.nyl + 2)
        shards = [State3D(*(a[sx, sy].contiguous() for a in b)) for b in blocks]
        self._bc_(shards)
        return shards

    def step(self, blocks: list[State3D], phase: int) -> list[State3D]:
        """One step: on 'torch' tpuvof's _local_step over the shards; on
        'cuda' the in-place halo refresh of the extended blocks, then each
        shard's kernels (tpuvof's _local_step_pallas), or the hybrid
        (_local_step_hybrid). Returns new blocks; the refresh and the BCs
        write into the given ones."""
        HALO["steps"] += 1
        if self.backend == "torch":
            return self._step_torch(blocks, phase)
        self._refresh(blocks, self.W, self.Wy)
        if self.hybrid:
            return self._step_hybrid(blocks, phase)
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
        with on_device(self.devices[k]):
            us, vs, ws, rhs = K3.predict3d_rhs(g, self.fl, self.dt, u, v, w, F, self.csf,
                                               **kw)
            p = K3.jacobi3d(g, self.n_jacobi, p, rhs, **kw)
            return self._finish_shard(k, F, (us, vs, ws), p, phase)

    def _finish_shard(self, k: int, F, stars, p, phase: int) -> State3D:
        """correct3d and the three sweeps on shard k's block, then its F
        wall planes; the caller has entered the shard's device."""
        g, kw = self.g, self.origin(k)
        vels = K3.correct3d(g, self.fl, self.dt, *stars, p, F, **kw)
        for idx, axis in enumerate(SWEEP_ORDER[phase]):
            F = K3.fct3d_sweep(g, self.dt, F, vels[axis], axis, idx == 2, **kw)
        self._restore_wall_planes(k, F)
        u, v, w = vels
        return State3D(F=F, u=u, v=v, w=w, p=p)

    def _step_hybrid(self, blocks: list[State3D], phase: int) -> list[State3D]:
        """tpuvof's _local_step_hybrid on the refreshed blocks: the solve
        runs on the ring-layout views (the block ghosts at W and W+nxl+1
        hold the neighbours' boundary planes, the ghosts the torch engine's
        solve reads); the solved p goes back into a zeroed block (p
        persists across steps, so the planes beyond the ring must stay
        zero) and one refresh gives its halo the neighbours' owned planes,
        so correct3d reads p as it read the resident Jacobi's."""
        g, W, Wy, nxl, nyl = self.g, self.W, self.Wy, self.nxl, self.nyl
        stars, rhss = [], []
        for k, b in enumerate(blocks):
            with on_device(self.devices[k]):
                *st, rhs = K3.predict3d_rhs(g, self.fl, self.dt, b.u, b.v, b.w, b.F, self.csf,
                                            **self.origin(k))
            stars.append(st)
            rhss.append(rhs[W + 1:W + nxl + 1, Wy + 1:Wy + nyl + 1, 1:g.nz + 1])
        sx, sy = slice(W, W + nxl + 2), slice(Wy, Wy + nyl + 2)
        ps = self._solve_upgraded([b.p[sx, sy].clone() for b in blocks], rhss)
        pjs = []
        for b, p in zip(blocks, ps):
            pj = torch.zeros_like(b.p)
            pj[sx, sy] = p
            pjs.append(pj)
        refresh_(pjs, self.px, self.py, (W, Wy), counts=HALO)
        out = []
        for k, b in enumerate(blocks):
            with on_device(self.devices[k]):
                out.append(self._finish_shard(k, b.F, stars[k], pjs[k], phase))
        return out

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

    # ---- the plain-torch engine (backend='torch') ----
    def _zero_wall_faces_(self, us: list, vs: list) -> None:
        """The serial wall faces (global face 1 of u, and of v when y is
        split) on the edge shards only: the local ops update every face."""
        for (xi, yi), u, v in zip(self.coords, us, vs):
            if xi == 0:
                u[1] = 0.0
            if self.py > 1 and yi == 0:
                v[:, 1] = 0.0

    def _step_torch(self, shards: list[State3D], phase: int) -> list[State3D]:
        gl, fl, dt = self._gl, self.fl, self.dt
        F, u, v, w, p = (list(f) for f in zip(*shards))
        rho, nu = (list(x) for x in zip(*(mix_properties(fl, f) for f in F)))
        if self.csf:
            # local normals (their +-1 F window is the exchanged ghosts),
            # exchanged for the curvature's +-1 window, and kappa exchanged
            # for the predictor's face means; wall ghosts stay the serial
            # op's zeros
            normals = [list(m) for m in zip(*(young_normals_3d(gl, f) for f in F))]
            for m in normals:
                self._exchange_(m)
            kappa = [curvature_from_normals_3d(gl, *m) for m in zip(*normals)]
            self._exchange_(kappa)
        else:
            kappa = [torch.zeros_like(f) for f in F]  # surface tension inert
        # every local face (u_lo = 1; v_lo = 1 when y is split), then the
        # serial wall faces zeroed on the edge shards
        v_lo = 1 if self.py > 1 else 2
        us, vs, ws = (list(x) for x in zip(*(
            predict_velocity_3d(gl, fl, dt, *a, u_lo=1, v_lo=v_lo)
            for a in zip(u, v, w, F, rho, nu, kappa))))
        self._zero_wall_faces_(us, vs)
        for a in (us, vs, ws):
            self._exchange_(a)
        self._bc_([State3D(*s) for s in zip(F, u, v, w, p)])
        # rho needs no exchange: it is pointwise in F, whose ghosts entered
        # the step current
        rhss = [rhs_3d(gl, dt, *a) for a in zip(us, vs, ws, rho)]
        p = self._solve_pressure(p, rhss)
        u, v, w = (list(x) for x in zip(*(
            update_velocity_3d(gl, dt, *a, u_lo=1, v_lo=v_lo)
            for a in zip(u, v, w, us, vs, ws, p, rho))))
        self._zero_wall_faces_(u, v)
        self._bc_([State3D(*s) for s in zip(F, u, v, w, p)])
        vels = (u, v, w)
        for axis in SWEEP_ORDER[phase]:
            F = self._sweep(axis, F, vels[axis])
            self._exchange_(F)
        shards = [State3D(*s) for s in zip((clamp01(f) for f in F), u, v, w, p)]
        self._bc_(shards)
        return shards

    def _sweep(self, axis: int, F: list, vel: list) -> list:
        """One FCT sweep of every shard's F. Along x (and y on a pencil
        mesh) on the block widened by 2, at global-index masks, keeping the
        centre; z, and y on slabs, split nothing the sweep reads across, so
        the serial sweep applies."""
        g, dt = self.g, self.dt
        if axis == 2 or (axis == 1 and self.py == 1):
            sweep = fct3d_sweep_z if axis == 2 else fct3d_sweep_y
            return [sweep(g, dt, f, c) for f, c in zip(F, vel)]
        Fw, cw = (widen(a, self.px, self.py, axis, 2) for a in (F, vel))
        out = []
        for (xi, yi), f, c in zip(self.coords, Fw, cw):
            gi0, gj0 = xi * self.nxl - 2 * (axis == 0), yi * self.nyl - 2 * (axis == 1)
            if axis == 0 and self.py == 1:
                out.append(sweep_x_masked(g, dt, f, c, gi0)[2:-2])
            else:
                o = sweep_masked_2axis(g, dt, f, c, axis, gi0, gj0)
                out.append(o[2:-2] if axis == 0 else o[:, 2:-2])
        return out

    # ---- the distributed pressure solves ----
    def _coeffs(self, k: int, dtype, device):
        """Shard k's 7-point coefficients (ae, aw, an, as, af, ab, ap_inv),
        the serial solver's on its block (only the global walls zero a
        coefficient, ap_inv from the f64 edge classes), and its red mask
        (i + j + k) % 2 == 0 at global indices; cached. tpuvof forms the
        distributed ap_inv in the field's dtype instead, an ulp from the
        serial one in f32 (PERF.md)."""
        key = (k, dtype, device)
        if key not in self._cache:
            xi, yi = self.coords[k]
            origin = (xi * self.nxl, yi * self.nyl, 0)
            extent = (self.nxl, self.nyl, self.g.nz)
            self._cache[key] = (
                poisson_coefficients_3d(self.g, dtype, device, origin, extent),
                _red_mask(extent, device, origin))
        return self._cache[key]

    def _solve_pressure(self, ps: list, rhss: list) -> list:
        """The torch engine's solve: the residual-driven rungs, or the fixed
        Jacobi with one exchange of p per sweep."""
        if self.pressure_solver != "jacobi":
            return self._solve_upgraded(ps, rhss)
        coeffs = [self._coeffs(k, p.dtype, p.device)[0] for k, p in enumerate(ps)]
        return jacobi_blocks(ps, rhss, coeffs, self.n_jacobi, self._exchange_)

    def _solve_upgraded(self, ps: list, rhss: list) -> list:
        """rbsor or mg on ring-layout blocks (ghosted p, interior rhs), for
        the torch engine and the hybrid alike; returns new ghosted blocks."""
        if self.pressure_solver == "rbsor":
            return self._solve_rbsor(ps, rhss)
        g = self.g
        return pmg.mg_solve_dist(pmg.MGDecomp((self.px, self.py, 1)), ps, rhss,
                                 (g.dxi**2, g.dyi**2, g.dzi**2), self.sor_tol,
                                 self.sor_max_iter, tol_rel=self.sor_tol_rel)

    def _solve_rbsor(self, ps: list, rhss: list) -> list:
        """Red-black SOR over the shards (tpuvof's _solve_pressure_rbsor):
        the serial solver's loop (ops.poisson.rbsor_blocks) on the
        shards' blocks, with the nullspace projection as a global mean
        (summed in the serial order, parallel/mg._mean_free), the global
        max, red and black at global (i + j + k), and one exchange per
        half sweep."""
        g = self.g
        spec = pmg.MGDecomp((self.px, self.py, 1))
        npts = g.nx * g.ny * g.nz
        cm = [self._coeffs(k, p.dtype, p.device) for k, p in enumerate(ps)]
        return rbsor_blocks(ps, rhss, [c for c, _ in cm], [red for _, red in cm],
                               self.sor_omega, self.sor_tol, self.sor_tol_rel,
                               self.sor_max_iter,
                               mean_free=lambda xs: pmg._mean_free(spec, xs, npts),
                               exchange=self._exchange_)

    # ---- driving ----
    def advance(self, blocks: list[State3D], n_steps: int, istep0: int = 0) -> list[State3D]:
        """``n_steps`` steps on the engine's blocks; ``istep0`` is the last
        global step already taken, so the istep % 3 rotation continues
        across chunked calls (first step phase (istep0 + 1) % 3)."""
        ph1 = (istep0 % 3 + 1) % 3
        with span("tv.simulate"):
            for s in range(n_steps):
                blocks = self.step(blocks, (ph1 + s) % 3)
        return blocks

    def simulate(self, state: State3D, n_steps: int, istep0: int = 0) -> State3D:
        """Advance a whole-grid state ``n_steps`` through the mesh; the
        result lies on the state's device."""
        blocks = self.advance(self.start(self.scatter_state(state)), n_steps, istep0)
        return self.finish(blocks, device=state.F.device)
