"""The shard driver under both decompositions (Decomp in 2-D, Decomp3D in
3-D): a grid's interior tiled over a px x py device mesh, one block per
shard on its mesh device, all driven from one controller.

``Shards`` holds what the two do alike: the mesh's geometry, the
scatter of a whole-grid state into ghost-ringed shards and its gather,
the shards' Poisson coefficients and the distributed solves (the fixed
Jacobi, rbsor and mg), and the driver. ``start`` turns the shards into the
engine's blocks in place, ``advance`` steps them, ``finish`` narrows and
gathers them where a caller needs the whole grid; ``simulate`` is a
scatter, ``start``, ``advance`` and ``finish``. A subclass keeps its own
walls, engines and step, its block layouts, its halo refresh and its step
schedule.

Tracing (utils.profiling.span): ``tv.simulate`` around ``advance``,
``tv.halo`` around each halo refresh of a subclass's ``_refresh``.
``HALO`` counts the halo traffic.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..config import Numerics
from ..ops.mg import _red_mask
from ..ops.poisson import (jacobi_blocks, poisson_coefficients, poisson_coefficients_3d,
                           rbsor_blocks)
from ..utils.profiling import span
from . import mg as pmg
from .halo import refresh_
from .mesh import Mesh

__all__ = ["HALO", "Shards"]

#: Halo traffic of every decomposition over the process, never reset:
#: ``refreshes`` (calls of a ``_refresh``: one a wide-halo step, and in
#: 3-D one a ghost exchange of the BCs), ``steps`` (steps taken by
#: ``advance``), ``copies`` and ``peer_copies`` (the refreshes' and
#: exchanges' ``Tensor.copy_`` calls, and those between two devices),
#: ``bytes`` (what they copied).
HALO = {"refreshes": 0, "steps": 0, "copies": 0, "peer_copies": 0, "bytes": 0}


@dataclass(frozen=True)
class _LocalGrid:
    """A shard's grid for the plain ops: the local extents, with the global
    spacing copied, not derived again (a spacing recomputed from a local
    length would not round the same). The z fields are the 3-D grid's."""

    nx: int
    ny: int
    dx: float
    dy: float
    dxi: float
    dyi: float
    nz: int = 0
    dz: float = 0.0
    dzi: float = 0.0


class Shards:
    """The geometry, layouts, solves and driver of a decomposition. A
    subclass sets ``_state`` (its State class), calls ``_place`` first and
    defines ``start``, ``narrow``, ``step``, ``_phase`` (a global step
    index's schedule argument of ``step``) and ``_whole_bc`` (the whole
    grid's BCs). Shards are lists in ``coords`` order, (xi, yi)
    row-major."""

    def _place(self, g, mesh: Mesh, num: Numerics) -> None:
        """Grid ``g`` over ``mesh`` (x along its axis 0, y along its axis 1
        where it has one), stepped with the settings ``num``."""
        self.g, self.num = g, num
        self.px = mesh.devices.shape[0]
        self.py = mesh.devices.shape[1] if mesh.devices.ndim == 2 else 1
        if g.nx % self.px or g.ny % self.py:
            raise ValueError(f"grid {g.nx}x{g.ny} not divisible by mesh {self.px}x{self.py}: "
                             "every engine needs nx % px == ny % py == 0, backend='torch' too")
        self.nxl, self.nyl = g.nx // self.px, g.ny // self.py
        self.coords = [(xi, yi) for xi in range(self.px) for yi in range(self.py)]
        flat = mesh.devices.reshape(self.px, self.py)
        self.devices = [flat[xi, yi] for xi, yi in self.coords]
        self._n = tuple(s - 2 for s in g.shape)  # the global interior extents
        z = dict(nz=g.nz, dz=g.dz, dzi=g.dzi) if len(self._n) == 3 else {}
        self.gl = _LocalGrid(self.nxl, self.nyl, g.dx, g.dy, g.dxi, g.dyi, **z)
        self._cache = {}

    # ---- host-side layout ----
    def scatter_state(self, state):
        """One (nxl+2, nyl+2[, nz+2]) block per shard, on its device: its
        owned cells and one ghost ring (the neighbours' cells, as an
        exchange would leave them)."""
        out = []
        for (xi, yi), dev in zip(self.coords, self.devices):
            i0, j0 = xi * self.nxl, yi * self.nyl
            out.append(self._state(*(a[i0:i0 + self.nxl + 2, j0:j0 + self.nyl + 2]
                                   .to(dev, copy=True).contiguous() for a in state)))
        return out

    def gather_state(self, shards: list, device=None):
        """The whole-grid state (on ``device``, default the first shard's)
        from the shards' owned cells, its ghost ring rebuilt by the real
        BCs: a blanket mirror would put nonzero values on the wall faces the
        BCs zero."""
        ref = shards[0].F
        device = ref.device if device is None else torch.device(device)
        fields = [torch.zeros(self.g.shape, dtype=ref.dtype, device=device) for _ in shards[0]]
        for (xi, yi), s in zip(self.coords, shards):
            i0, j0 = xi * self.nxl, yi * self.nyl
            for out, blk in zip(fields, s):
                out[i0 + 1:i0 + self.nxl + 1, j0 + 1:j0 + self.nyl + 1] = blk[1:-1, 1:-1]
        return self._whole_bc(self._state(*fields))

    def _exchange(self, arrs: list) -> None:
        """The one-layer ghost exchange of one field's ring-layout tensors."""
        refresh_(arrs, self.px, self.py, counts=HALO)

    # ---- the distributed pressure solves ----
    def _coeffs(self, k: int, dtype, device):
        """Shard k's 5- or 7-point coefficients (ap_inv last), the serial
        solver's on its block (only the global walls zero a coefficient,
        ap_inv from the f64 edge classes), and its red mask (an even global
        index sum); cached. tpuvof forms the distributed ap_inv in the
        field's dtype instead, an ulp from the serial one in f32, which can
        part an f32 rbsor's trip count from the serial one and with it p
        (PERF.md)."""
        key = (k, dtype, device)
        if key not in self._cache:
            xi, yi = self.coords[k]
            origin = (xi * self.nxl, yi * self.nyl) + (0,) * (len(self._n) - 2)
            extent = (self.nxl, self.nyl) + self._n[2:]
            coeffs = poisson_coefficients_3d if len(self._n) == 3 else poisson_coefficients
            self._cache[key] = (coeffs(self.g, dtype, device, origin, extent),
                                _red_mask(extent, device, origin))
        return self._cache[key]

    def _solve_pressure(self, ps: list, rhss: list) -> list:
        """The solve on ring-layout blocks (ghosted p, interior rhs); new
        ghosted blocks. The fixed Jacobi with one exchange of p per sweep;
        or rbsor, the serial solver's loop (ops.poisson.rbsor_blocks) on the
        shards' blocks with the nullspace projection as a global mean summed
        in the serial order (parallel/mg._mean_free), the global max, red
        and black at the global index sum and one exchange per half sweep;
        or parallel/mg.py's mg."""
        nm, g, n = self.num, self.g, self._n
        spec = pmg.MGDecomp((self.px, self.py) + (1,) * (len(n) - 2))
        if nm.pressure_solver == "mg":
            inv2 = (g.dxi**2, g.dyi**2) + ((g.dzi**2,) if len(n) == 3 else ())
            return pmg.mg_solve_dist(spec, ps, rhss, inv2, nm.sor_tol, nm.sor_max_iter,
                                     tol_rel=nm.sor_tol_rel)
        cm = [self._coeffs(k, p.dtype, p.device) for k, p in enumerate(ps)]
        if nm.pressure_solver == "jacobi":
            return jacobi_blocks(ps, rhss, [c for c, _ in cm], nm.n_jacobi, self._exchange)
        return rbsor_blocks(ps, rhss, [c for c, _ in cm], [red for _, red in cm],
                            nm.sor_omega, nm.sor_tol, nm.sor_tol_rel, nm.sor_max_iter,
                            mean_free=lambda xs: pmg._mean_free(spec, xs, math.prod(n)),
                            exchange=self._exchange)

    # ---- driving ----
    def advance(self, blocks: list, n_steps: int, istep0: int = 0) -> list:
        """``n_steps`` steps on the engine's blocks; ``istep0`` is the last
        global step already taken, so the step schedule (the 2-D sweep
        parity, the 3-D istep % 3 rotation) continues across chunked
        calls."""
        with span("tv.simulate"):
            for istep in range(istep0 + 1, istep0 + n_steps + 1):
                HALO["steps"] += 1
                blocks = self.step(blocks, self._phase(istep))
        return blocks

    def widen(self, shards: list) -> list:
        """``start`` on copies of the shards, which keeps them as they are."""
        return self.start([self._state(*(a.clone() for a in s)) for s in shards])

    def finish(self, blocks: list, device=None):
        """``gather_state(narrow(blocks), device)``: the whole grid, for a
        caller that needs it (a frame, a checkpoint); ``device="cpu"`` keeps
        it off the cards. The blocks stay as they are."""
        return self.gather_state(self.narrow(blocks), device=device)

    def simulate(self, state, n_steps: int, istep0: int = 0):
        """Advance a whole-grid state ``n_steps`` through the mesh; the
        result lies on the state's device."""
        blocks = self.advance(self.start(self.scatter_state(state)), n_steps, istep0)
        return self.finish(blocks, device=state.F.device)
