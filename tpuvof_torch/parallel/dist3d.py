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
  origin (solver3d's lean step, ``lean_predict_3d`` and
  ``lean_finish_3d``), the sweeps in the istep % 3 rotation, the last with
  mirror_out, and the x-edge shards restore their F wall plane;
- the centre is sliced out once at exit, then the exit BC.
W = n_jacobi + 4 (+6 with csf) is the step's dependency cone: after a
refresh every block plane holds current data, and the final F is exact on
the owned planes iff W covers the rhs's outer plane, n_jacobi erosions,
the correction's p at i-1 and the x-sweep's 3 planes. Wy likewise.

``backend='cuda'`` with rbsor, mg or auto (tpuvof's distributed hybrid):
the same resident blocks with W = 4 (+2 with csf), the cone without the
Jacobi erosion: predict3d_rhs, then the distributed solve (rbsor or mg,
parallel/shards.py) on each block's ring layout (owned cells and one
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

Resident driving (the CLI's ``--three-d --mesh``; the driver is
parallel/shards.py's): ``init_shards`` makes each shard's initial block on
its own device from the global coordinates of its planes and rows,
``start`` turns the shards into the engine's blocks in place, ``advance``
steps them a frame at a time, ``line`` reduces the frame's mass and range
on each device, and ``finish`` narrows and gathers the whole grid only
where a caller needs it. No whole-grid tensor is made on the way.

Tracing (utils.profiling.span): ``tv.simulate`` around ``advance``,
``tv.halo`` around each halo refresh, ``tv.shard_line`` around ``line``;
``HALO`` (parallel/shards.py's) counts the refreshes, the steps and the
halo copies over the process.
"""
from __future__ import annotations

import torch

from ..config import Fluid
from ..grid import Grid3D
from ..ops import apply_bc_3d_, clamp01, mix_properties
from ..ops.fct3d import (SWEEP_ORDER, fct3d_sweep_y, fct3d_sweep_z, sweep_masked_2axis,
                         sweep_x_masked)
from ..ops.momentum3d import predict_velocity_3d, update_velocity_3d
from ..ops.normals3d import curvature_from_normals_3d, young_normals_3d
from ..ops.poisson import rhs_3d
from ..solver3d import lean_finish_3d, lean_predict_3d, numerics_3d
from ..state import State3D, init_block_3d
from ..utils.profiling import span
from .halo import refresh_, widen
from .mesh import Mesh, on_device
from .shards import HALO, Shards

__all__ = ["Decomp3D", "admission_3d", "HALO"]

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


class Decomp3D(Shards):
    """Domain decomposition of a 3-D grid: x slabs over a 1-axis mesh, or
    (x, y) pencils over a 2-axis mesh with py > 1. ``pencil=True`` forces
    the pencil form of the wide-halo engine on a 2-axis mesh with py == 1
    (tpuvof's option): it computes the slab engine's answer with 2 Wy more
    rows a block, so it serves only to hold the pencil path to the slab and
    serial ones, as the tests do; ``backend='torch'`` cannot honour it.

    ``pressure_solver``: 'jacobi' (n_jacobi fixed sweeps), 'rbsor', 'mg',
    or 'auto' (mg where the global grid coarsens, else rbsor), with
    tpuvof's sor_* options; solver3d.numerics_3d checks the settings as
    simulate_3d does. On ``backend='cuda'``, rbsor/mg run the distributed
    hybrid. A shape that the wide-halo engine does not admit raises
    ValueError where tpuvof would fall back to its XLA engine:
    ``backend='torch'`` runs it.

    ``simulate`` takes and returns a whole-grid State3D. Its stages are
    public for callers that keep the shards resident (parallel/shards.py):
    ``scatter_state`` (or ``init_shards``, the initial condition made shard
    by shard), ``start`` (``widen`` on copies), ``advance``, ``line`` (the
    frame's mass and range from per-shard reductions), ``narrow`` (back to
    the ring layout) and ``gather_state`` (``finish`` does both)."""

    _state = State3D

    def __init__(self, g: Grid3D, mesh: Mesh, fl: Fluid | None = None, dt: float = 4e-6,
                 n_jacobi: int = 10, backend: str = "cuda", pencil: bool = False,
                 pressure_solver: str = "jacobi", csf: bool = False, sor_omega: float = 1.7,
                 sor_tol: float = 1e-3, sor_max_iter: int = 200, sor_tol_rel: float = 0.0):
        num = numerics_3d(g, dt=dt, n_jacobi=n_jacobi, backend=backend,
                          pressure_solver=pressure_solver, sor_omega=sor_omega, sor_tol=sor_tol,
                          sor_max_iter=sor_max_iter, sor_tol_rel=sor_tol_rel)
        g.validate()
        self._place(g, mesh, num)
        two_axes = mesh.devices.ndim == 2
        if pencil and not two_axes:
            raise ValueError("pencil=True needs a 2-axis mesh")
        if pencil and backend != "cuda":
            raise ValueError("pencil=True forces the wide-halo pencil engine; "
                             f"backend={backend!r} cannot honour it")
        self.fl, self.csf = fl or Fluid(), bool(csf)
        self.backend, self.pressure_solver = backend, num.pressure_solver
        self.hybrid = backend == "cuda" and num.pressure_solver != "jacobi"
        self.pencil = backend == "cuda" and two_axes and (self.py > 1 or bool(pencil))
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

    def init_shards(self, ic: int = 1, dtype: torch.dtype = torch.float32) -> list[State3D]:
        """``scatter_state(init_state_3d(g, ic))`` without the whole grid:
        each shard's block (owned cells and one ghost layer) made on its
        device from its planes' and rows' global coordinates
        (state.init_block_3d)."""
        return [init_block_3d(self.g, ic, ((xi * self.nxl, xi * self.nxl + self.nxl + 2),
                                           (yi * self.nyl, yi * self.nyl + self.nyl + 2)),
                              dev, dtype)
                for (xi, yi), dev in zip(self.coords, self.devices)]

    @staticmethod
    def _phase(istep: int) -> int:
        """Global step ``istep``'s sweep rotation, istep % 3."""
        return istep % 3

    @staticmethod
    def _whole_bc(s: State3D) -> State3D:
        u, v, w, F, p = apply_bc_3d_(s.u, s.v, s.w, s.F, s.p)
        return State3D(F=F, u=u, v=v, w=w, p=p)

    # ---- halos and the masked wall BCs ----
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
    def start(self, shards: list[State3D]) -> list[State3D]:
        """The engine's entry layout, written over the shards. 'torch': the
        shards as they are (tpuvof's XLA engine applies no entry BC).
        'cuda': the BCs and the ghost exchange in place, then the resident
        extended blocks, (nloc+2, nyE+2, nz+2) each, which replace the
        shards (drop the shards to free their memory), so a device holds at
        most two layouts of its shard at once."""
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
        if self.backend == "torch":
            return self._step_torch(blocks, phase)
        self._refresh(blocks, self.W, self.Wy)
        if self.hybrid:
            return self._step_hybrid(blocks, phase)
        out = []
        for k, b in enumerate(blocks):
            with on_device(self.devices[k]):
                stars, p, _ = lean_predict_3d(self.g, self.fl, self.num, self.csf, b,
                                              **self.origin(k))
                out.append(self._finish_shard(k, b.F, stars, p, phase))
        return out

    def origin(self, k: int) -> dict:
        """The kernels' block origin of shard k's extended block: gi_base,
        and in pencil mode njl and gj_base."""
        xi, yi = self.coords[k]
        kw = dict(gi_base=xi * self.nxl - self.W)
        if self.pencil:
            kw.update(njl=self.nyE, gj_base=yi * self.nyl - self.Wy)
        return kw

    def _finish_shard(self, k: int, F, stars, p, phase: int) -> State3D:
        """The lean step's second half (solver3d.lean_finish_3d) on shard
        k's block, then its F wall planes; the caller has entered the
        shard's device."""
        out = lean_finish_3d(self.g, self.fl, self.num, F, stars, p, phase, **self.origin(k))
        self._restore_wall_planes(k, out.F)
        return out

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
                st, _, rhs = lean_predict_3d(g, self.fl, self.num, self.csf, b,
                                             **self.origin(k))
            stars.append(st)
            rhss.append(rhs[W + 1:W + nxl + 1, Wy + 1:Wy + nyl + 1, 1:g.nz + 1])
        sx, sy = slice(W, W + nxl + 2), slice(Wy, Wy + nyl + 2)
        ps = self._solve_pressure([b.p[sx, sy].clone() for b in blocks], rhss)
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
        gl, fl, dt = self.gl, self.fl, self.num.dt
        F, u, v, w, p = (list(f) for f in zip(*shards))
        rho, nu = (list(x) for x in zip(*(mix_properties(fl, f) for f in F)))
        if self.csf:
            # local normals (their +-1 F window is the exchanged ghosts),
            # exchanged for the curvature's +-1 window, and kappa exchanged
            # for the predictor's face means; wall ghosts stay the serial
            # op's zeros
            normals = [list(m) for m in zip(*(young_normals_3d(gl, f) for f in F))]
            for m in normals:
                self._exchange(m)
            kappa = [curvature_from_normals_3d(gl, *m) for m in zip(*normals)]
            self._exchange(kappa)
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
            self._exchange(a)
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
            self._exchange(F)
        shards = [State3D(*s) for s in zip((clamp01(f) for f in F), u, v, w, p)]
        self._bc_(shards)
        return shards

    def _sweep(self, axis: int, F: list, vel: list) -> list:
        """One FCT sweep of every shard's F. Along x (and y on a pencil
        mesh) on the block widened by 2, at global-index masks, keeping the
        centre; z, and y on slabs, split nothing the sweep reads across, so
        the serial sweep applies."""
        g, dt = self.g, self.num.dt
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
