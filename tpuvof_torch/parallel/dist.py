"""Distributed 2-D solver: the grid's interior tiled over a (px, py) device
mesh (counterpart of tpuvof/parallel/dist.py).

tpuvof runs its shard engines under ``shard_map``; the port drives them
from one controller, as Decomp3D does: one set of tensors per shard on its
mesh device, halos moved by ``Tensor.copy_`` (parallel/halo.py), the x
stage on every shard before the y stage on any. Given CPU devices, the
kernel wrappers run their plain versions, which is how the CPU tests drive
it. The driver and the solves are parallel/shards.py's. Five shard
engines; the config picks one and ``admission_2d`` says whether it runs:

``'torch'`` (``backend='torch'``; tpuvof's XLA engine, _local_step): the
plain ops on a local grid (the local extents with the global spacing) and
one-layer exchanges of each field as it is needed: the normals and kappa,
u* and v*, p after each Jacobi sweep or SOR half sweep, F after the first
FCT sweep, and the masked wall BCs (j boundaries first, then i) after the
predictor, the correction and the clamp. Each FCT sweep runs on F and the
velocity widened along its axis by two planes of current data, each taken
from the shard that owns it, at the shard's global origin
(ops.window.sweep_values, whose global masks keep what lies beyond a wall
inert), and keeps the centre. It needs only nx % px == ny % py == 0.

``'full'`` (``'cuda'`` or ``'cuda_mono'`` with the fixed Jacobi; tpuvof's
_local_step_pallas): each block is widened once to a resident block
extended by W = STEP_HALO (n_jacobi + 12, the step's dependency cone),
zeros beyond the walls; each step refreshes its W+1 outer bands in place
and makes one ``fullstep_win`` launch per shard at the shard's global
origin. The kernel writes the wall values itself, so no BC or exchange
follows. The block is cut back once at exit. tpuvof's VMEM envelope is not
ported: the port's kernel runs any block, so these backends always take
this engine where the halo comes from one neighbour.

``'tiled'`` (``'cuda_tiled'``, or ``tile=`` on a whole-step backend;
tpuvof's _local_step_pallas_tiled): the same resident blocks; each tile's
window, sliced from the step's entry state, goes through ``fullstep_win``
and the tile keeps its (T+2)-wide centre. The default tile is the serial
route's rule on the local block (solver.TILE_ROWS rows where they divide,
else the whole block); tpuvof's pick_tile_2d sizes VMEM and is not ported.

``'strips'`` (``'cuda_strips'``; tpuvof's _local_step_pallas_strips):
the block sits at (W2, W2) of a layout padded by W2 = strips_halo, whose
W+1 bands are refreshed at offset W2 - W; one ``fullstep_strips`` launch
per shard. The margins outside the bands are never rewritten (the kernel
sanitizes them at load). tpuvof's ``tx`` restricts the TPU's strip height
and is dropped.

``'hybrid'`` (any ``'cuda*'`` backend with rbsor, mg or auto; tpuvof's
_local_step_hybrid): ``predict_win`` on blocks widened by PHASE_HALO,
keeping the centre; the masked BC; the distributed solve (the torch
engine's); the correction; each FCT sweep one ``fct_sweep_win`` on
PHASE_HALO-widened blocks in istep parity order; clamp and BC.

Where tpuvof warns and falls back to its XLA engine (blocks too thin for a
kernel engine's halo), the port raises ValueError naming
``backend='torch'``: no path trades the kernels for plain ops.
"""
from __future__ import annotations

import torch

from ..config import SimConfig
from ..grid import Grid2D
from ..kernels import step_kernels as K
from ..ops import apply_bc_, clamp01, divergence_rhs, mix_properties
from ..ops.common import embed2, merge_interior
from ..ops.momentum import correct_velocity_interior, predict_velocity_interior
from ..ops.normals import curvature_from_normals, young_normals
from ..ops.window import sweep_values
from ..solver import TILE_ROWS, effective_backend, resolve_auto
from ..state import State
from ..utils.profiling import span
from .halo import HaloSpec, refresh_, widen
from .mesh import Mesh, on_device
from .shards import HALO, Shards

__all__ = ["Decomp", "admission_2d"]


def admission_2d(g: Grid2D, px: int, py: int, W: int) -> dict:
    """Whether a kernel engine whose halo is W planes deep admits a px x py
    decomposition of grid ``g`` (nx % px == ny % py == 0, the caller
    checks), and its extents. Returns a dict:

      ok        whether the engine runs at this shape
      why       the reason when not ok
      W         the halo depth
      nxl, nyl  the owned extents of a shard
      nxE, nyE  the extended block's interior, nxl + 2W and nyl + 2W

    Only tpuvof's decisions are ported: each halo of W+1 bands must come
    from one neighbour's owned cells, so W+1 <= nx/px where px > 1, and
    likewise in y (W = STEP_HALO for the whole-step engines, PHASE_HALO
    for the hybrid's phase kernels). Its VMEM envelope (fits_vmem_2d,
    WINDOWED_FIELDS, pick_tile_2d, strips_layout_2d) sizes the TPU's
    memory and is dropped."""
    nxl, nyl = g.nx // px, g.ny // py
    thin = []
    if px > 1 and W + 1 > nxl:
        thin.append(f"nx/px > W={W} (nx/px={nxl})")
    if py > 1 and W + 1 > nyl:
        thin.append(f"ny/py > W={W} (ny/py={nyl})")
    return dict(ok=not thin, why="needs " + " and ".join(thin) if thin else "", W=W,
                nxl=nxl, nyl=nyl, nxE=nxl + 2 * W, nyE=nyl + 2 * W)


class Decomp(Shards):
    """Domain decomposition of a SimConfig over a 2-axis device mesh.

    ``cfg.num.backend`` and ``cfg.num.pressure_solver`` pick the shard
    engine (see the module docstring): 'torch' runs the plain engine; a
    'cuda*' backend runs 'full' ('cuda', 'cuda_mono'), 'tiled'
    ('cuda_tiled') or 'strips' ('cuda_strips') with the fixed Jacobi, and
    the hybrid with rbsor, mg or auto (mg where the global grid coarsens,
    else rbsor). ``tile=T`` (an int, or (Tx, Ty)) runs the tiled engine
    with tiles of T; it raises where that cannot run, with a
    residual-driven solver, and on backend 'torch'.

    ``simulate`` takes and returns a whole-grid State. Its stages are public
    for callers that keep the shards resident (parallel/shards.py):
    ``scatter_state``, ``start`` (``widen`` on copies), ``advance``,
    ``narrow`` (back to the ring layout) and ``gather_state`` (``finish``
    does both)."""

    _state = State

    def __init__(self, cfg: SimConfig, mesh: Mesh, tile: int | tuple[int, int] | None = None):
        cfg = resolve_auto(cfg)
        effective_backend(cfg)  # the serial routes' checks of backend and solver
        if cfg.num.bc_between_sweeps:
            raise NotImplementedError(
                "bc_between_sweeps=True (the FCT test variant's mid-sweep mirror) is "
                "serial only: no shard engine mirrors F between its sweeps")
        if mesh.devices.ndim != 2:
            raise ValueError("Decomp expects a 2-D mesh (axes for x and y)")
        self.cfg = cfg
        self._place(cfg.grid, mesh, cfg.num)
        self.halos = [HaloSpec(self.px, self.py, xi, yi) for xi, yi in self.coords]
        self.W = self.W2 = 0
        self.tile = None
        self.engine = self._route(tile)

    def _route(self, tile) -> str:
        nm, g = self.cfg.num, self.cfg.grid
        if nm.backend == "torch":
            if tile is not None:
                raise ValueError(f"tile={tile!r} runs the tiled kernel engine; "
                                 "backend='torch' runs the plain engine")
            return "torch"
        if nm.pressure_solver != "jacobi":
            if tile is not None:
                raise ValueError(
                    f"tile={tile!r} runs the tiled whole-step engine but "
                    f"pressure_solver={nm.pressure_solver!r} runs the HYBRID shard step "
                    "(phase kernels around the distributed solve); the whole-step engines "
                    "run the fixed-iteration Jacobi")
            adm = admission_2d(g, self.px, self.py, K.PHASE_HALO)
            if not adm["ok"]:
                raise ValueError(
                    f"Decomp backend={nm.backend!r}: the hybrid's phase kernels {adm['why']} "
                    "(each PHASE_HALO widening comes from one neighbour); backend='torch' "
                    "runs shards of any width (tpuvof falls back to its XLA engine here, the "
                    "port does not fall back)")
            self.W = K.PHASE_HALO
            return "hybrid"
        pick = "tiled" if tile is not None else \
            {"cuda_tiled": "tiled", "cuda_strips": "strips"}.get(nm.backend, "full")
        adm = admission_2d(g, self.px, self.py, K.STEP_HALO(self.cfg))
        if not adm["ok"]:
            raise ValueError(
                f"Decomp backend={nm.backend!r}: the {pick} engine {adm['why']} (each "
                "(W+1)-band halo comes from one neighbour); backend='torch' runs shards of any "
                "width (tpuvof falls back to its XLA engine here, the port does not fall back)")
        self.W = adm["W"]
        if pick == "strips":
            self.W2 = K.strips_halo(self.cfg)
        if pick == "tiled":
            self.tile = self._shard_tile(tile)
        return pick

    def _shard_tile(self, tile) -> tuple[int, int]:
        nxl, nyl = self.nxl, self.nyl
        if tile is None:
            return (TILE_ROWS, nyl) if nxl % TILE_ROWS == 0 else (nxl, nyl)
        T = (tile, tile) if isinstance(tile, int) else tuple(tile)
        if len(T) != 2 or min(T) < 1 or nxl % T[0] or nyl % T[1]:
            raise ValueError(f"tile={tile!r} does not divide local blocks {nxl}x{nyl}")
        return T

    def origin(self, k: int, w: int) -> tuple[int, int]:
        """The global (ghost-included) index of the (0, 0) cell of shard
        k's block widened by w beyond its ghost ring."""
        xi, yi = self.coords[k]
        return xi * self.nxl - w, yi * self.nyl - w

    @staticmethod
    def _phase(istep: int) -> bool:
        """Whether global step ``istep`` is even: its sweep order."""
        return istep % 2 == 0

    @staticmethod
    def _whole_bc(s: State) -> State:
        u, v, F, p = apply_bc_(s.u, s.v, s.F, s.p)
        return State(F=F, u=u, v=v, p=p)

    # ---- halos and the masked wall BCs ----
    def _extend(self, arrs: list, w: int) -> list:
        """Each ring-layout block widened by w on every side, x then y (the
        corners from the diagonal neighbours), zeros beyond the walls."""
        return widen(widen(arrs, self.px, self.py, 0, w), self.px, self.py, 1, w)

    def _refresh(self, blocks: list[State], W: int, Wy: int, off: int = 0) -> None:
        """The W+1 outer planes along x and Wy+1 along y of every field of
        the resident blocks, in place, from the neighbours' owned cells
        (tpuvof's _refresh_halo_2d; at offset ``off`` its
        _refresh_halo_strips)."""
        HALO["refreshes"] += 1
        with span("tv.halo"):
            for f in range(4):
                refresh_([b[f] for b in blocks], self.px, self.py, (W, Wy), off, counts=HALO)

    def _bc_(self, u: list, v: list, F: list, p: list, rho: list | None = None) -> None:
        """The wall BCs in place on the shards that own a wall (j boundaries
        first, then i: ops/bc.apply_bc_ on each edge), then the ghost
        exchange of every field (tpuvof's _bc)."""
        scalars = [F, p] + ([rho] if rho is not None else [])
        for k, h in enumerate(self.halos):
            uk, vk, sk = u[k], v[k], [a[k] for a in scalars]
            if h.is_bottom:
                uk[:, 0] = uk[:, 1]
                vk[:, 1] = 0.0
                for a in sk:
                    a[:, 0] = a[:, 1]
            if h.is_top:
                uk[:, -1] = uk[:, -2]
                vk[:, -1] = 0.0
                for a in sk:
                    a[:, -1] = a[:, -2]
            if h.is_left:
                uk[1] = 0.0
                vk[0] = vk[1]
                for a in sk:
                    a[0] = a[1]
            if h.is_right:
                uk[-1] = 0.0
                vk[-1] = vk[-2]
                for a in sk:
                    a[-1] = a[-2]
        for a in [u, v] + scalars:
            self._exchange(a)

    # ---- the engine ----
    def start(self, shards: list[State]) -> list[State]:
        """The engine's entry layout, written over the shards: the BCs and
        the ghost exchange, as serial ``simulate`` applies the BCs at entry;
        then, for 'full' and 'tiled', the resident extended blocks
        (nxl+2W+2, nyl+2W+2), and for 'strips' the padded layout
        (nxl+2+2*W2, nyl+2+2*W2)."""
        F, u, v, p = (list(f) for f in zip(*shards))
        self._bc_(u, v, F, p)
        if self.engine in ("full", "tiled"):
            fields = [self._extend(a, self.W) for a in (F, u, v, p)]
            return [State(*f) for f in zip(*fields)]
        if self.engine == "strips":
            w2 = self.W2
            return [State(*(torch.nn.functional.pad(a, (w2, w2, w2, w2)) for a in s))
                    for s in zip(F, u, v, p)]
        return [State(*s) for s in zip(F, u, v, p)]

    def narrow(self, blocks: list[State]) -> list[State]:
        """Exit: each block's ring layout (owned cells and one ghost ring)."""
        w = {"full": self.W, "tiled": self.W, "strips": self.W2}.get(self.engine)
        if w is None:
            return blocks
        sx, sy = slice(w, w + self.nxl + 2), slice(w, w + self.nyl + 2)
        return [State(*(a[sx, sy].contiguous() for a in b)) for b in blocks]

    def step(self, blocks: list[State], even_step: bool) -> list[State]:
        """One step of the engine on its blocks (``start``'s layout); returns
        new blocks. The halo refresh and the BCs write into the given ones,
        which leaves a state the last step or ``start`` made as it was."""
        return getattr(self, f"_step_{self.engine}")(blocks, even_step)

    def _step_full(self, blocks: list[State], even: bool) -> list[State]:
        self._refresh(blocks, self.W, self.W)
        out = []
        for k, b in enumerate(blocks):
            with on_device(self.devices[k]):
                out.append(State(*K.fullstep_win(self.cfg, *b, *self.origin(k, self.W), even)))
        return out

    def _step_tiled(self, blocks: list[State], even: bool) -> list[State]:
        """Every tile's W-extended window is sliced from the refreshed entry
        block, never from the block being written: overlapping windows all
        read the step's entry values. The tiles' (T+2)-wide centres cover
        the ring layout; the outer bands keep their entry values, which is
        all the next refresh needs (it copies owned cells only)."""
        self._refresh(blocks, self.W, self.W)
        W, (tx, ty) = self.W, self.tile
        ex, ey = tx + 2 * W + 2, ty + 2 * W + 2
        out = []
        for k, b in enumerate(blocks):
            oi, oj = self.origin(k, W)
            res = [a.clone() for a in b]
            with on_device(self.devices[k]):
                for r0 in range(0, self.nxl, tx):
                    for c0 in range(0, self.nyl, ty):
                        win = [a[r0:r0 + ex, c0:c0 + ey].contiguous() for a in b]
                        for acc, o in zip(res, K.fullstep_win(self.cfg, *win, oi + r0, oj + c0,
                                                              even)):
                            acc[r0 + W:r0 + W + tx + 2, c0 + W:c0 + W + ty + 2] = \
                                o[W:W + tx + 2, W:W + ty + 2]
            out.append(State(*res))
        return out

    def _step_strips(self, blocks: list[State], even: bool) -> list[State]:
        self._refresh(blocks, self.W, self.W, self.W2 - self.W)
        out = []
        for k, b in enumerate(blocks):
            oi, oj = self.origin(k, 0)
            with on_device(self.devices[k]):
                out.append(State(*K.fullstep_strips(self.cfg, *b, even, extents=(self.nxl, self.nyl),
                                                    oi0=oi, oj0=oj)))
        return out

    def _correct(self, u: list, v: list, u_star: list, v_star: list, p: list, rho: list):
        """The corrected u and v of every shard: the correction over all
        local faces, the serial wall faces (global face 1) kept at zero on
        the edge shards."""
        out_u, out_v = [], []
        for k, h in enumerate(self.halos):
            uc, vc = correct_velocity_interior(self.gl, self.cfg.num, u_star[k], v_star[k],
                                               p[k], rho[k])
            if h.is_left:
                uc[0] = 0.0
            if h.is_bottom:
                vc[:, 0] = 0.0
            out_u.append(merge_interior(u[k], uc))
            out_v.append(merge_interior(v[k], vc))
        return out_u, out_v

    def _step_torch(self, shards: list[State], even: bool) -> list[State]:
        gl, fl, nm = self.gl, self.cfg.fluid, self.cfg.num
        F, u, v, p = (list(f) for f in zip(*shards))
        rho, nu = (list(x) for x in zip(*(mix_properties(fl, f) for f in F)))
        # local normals (their +-1 F window is the exchanged ghosts),
        # exchanged for the curvature's +-1 window, and kappa exchanged for
        # the predictor's face means; wall ghosts stay the serial op's zeros
        mx, my = (list(m) for m in zip(*(young_normals(gl, f) for f in F)))
        self._exchange(mx)
        self._exchange(my)
        kappa = [curvature_from_normals(gl, a, b) for a, b in zip(mx, my)]
        self._exchange(kappa)
        u_star, v_star = [], []
        for k, h in enumerate(self.halos):
            us, vs = predict_velocity_interior(gl, fl, nm, u[k], v[k], F[k], rho[k], nu[k],
                                               kappa[k])
            us, vs = embed2(us, 1, 1, 1, 1), embed2(vs, 1, 1, 1, 1)
            if h.is_left:
                us[1] = 0.0
            if h.is_bottom:
                vs[:, 1] = 0.0
            u_star.append(us)
            v_star.append(vs)
        self._exchange(u_star)
        self._exchange(v_star)
        self._bc_(u, v, F, p, rho)
        rhss = [divergence_rhs(gl, nm, *a) for a in zip(u_star, v_star, rho)]
        p = self._solve_pressure(p, rhss)
        u, v = self._correct(u, v, u_star, v_star, p, rho)
        self._bc_(u, v, F, p, rho)
        for i, axis in enumerate((1, 0) if even else (0, 1)):
            F = self._sweep(axis, F, v if axis else u)
            if i == 0:
                self._exchange(F)  # the second sweep's cross-axis ghosts
        F = [clamp01(f) for f in F]
        self._bc_(u, v, F, p, rho)
        return [State(*s) for s in zip(F, u, v, p)]

    def _sweep(self, axis: int, F: list, vel: list) -> list:
        """One FCT sweep of every shard's F on blocks widened by two planes
        along the sweep axis (with the ghost ring, the sweep's three-plane
        cone), at the shard's global origin; keeps the centre."""
        Fw, cw = (widen(a, self.px, self.py, axis, 2) for a in (F, vel))
        out = []
        for k, (f, c) in enumerate(zip(Fw, cw)):
            oi, oj = self.origin(k, 0)
            o = sweep_values(self.cfg, f, c, axis, oi - 2 * (axis == 0), oj - 2 * (axis == 1))
            out.append(o[2:-2] if axis == 0 else o[:, 2:-2])
        return out

    def _step_hybrid(self, shards: list[State], even: bool) -> list[State]:
        cfg, W = self.cfg, self.W
        F, u, v, p = (list(f) for f in zip(*shards))
        ctr = (slice(W, -W), slice(W, -W))
        ue, ve, Fe = (self._extend(a, W) for a in (u, v, F))
        u_star, v_star = [], []
        for k in range(len(shards)):
            with on_device(self.devices[k]):
                us, vs = K.predict_win(cfg, ue[k], ve[k], Fe[k], *self.origin(k, W))
            u_star.append(us[ctr])
            v_star.append(vs[ctr])
        rho = [mix_properties(cfg.fluid, f)[0] for f in F]
        self._bc_(u, v, F, p, rho)
        rhss = [divergence_rhs(self.gl, cfg.num, *a) for a in zip(u_star, v_star, rho)]
        p = self._solve_pressure(p, rhss)
        u, v = self._correct(u, v, u_star, v_star, p, rho)
        self._bc_(u, v, F, p, rho)
        for axis in (1, 0) if even else (0, 1):
            Fe, ce = (self._extend(a, W) for a in (F, v if axis else u))
            out = []
            for k in range(len(shards)):
                with on_device(self.devices[k]):
                    out.append(K.fct_sweep_win(cfg, Fe[k], ce[k], axis,
                                               *self.origin(k, W))[ctr])
            F = out
        F = [clamp01(f) for f in F]
        self._bc_(u, v, F, p, rho)
        return [State(*s) for s in zip(F, u, v, p)]
