"""Distributed geometric multigrid for the sharded pressure solve
(counterpart of tpuvof/parallel/mg.py), for any number of dimensions.

The sharded form of ops/mg.py, the 'mg' rung of the ladder on a mesh. A
distributed array is a list of local blocks, one per shard, in row-major
order of the shard grid (``MGDecomp.coords``, the order of Decomp3D's
shards); one controller drives them all, as the port's Decomp3D does, and
a block may lie on any device.

  - Fine levels run sharded: red-black smoothing with one ghost exchange
    per half sweep (``Tensor.copy_`` between blocks: tpuvof's
    ``lax.ppermute``), restriction shard-local, prolongation with one
    plane of the neighbour at each shard boundary. Every per-cell
    operation is ops/mg.py's, on coefficients and red masks built from
    global indices.
  - Coarse levels are gathered: from the first level whose global volume
    is at most ``GATHER_VOLUME``, or which the mesh no longer divides, the
    restricted problem is assembled on the first block's device and the
    rest of the ladder runs there through the serial V-cycle, once.
    tpuvof runs an identical replica on every shard; the values are the
    same. The error is sliced back to the blocks.

The outer loop is ops.mg.mg_solve's (the same exits, ``STALL_CYCLES``),
reading the global residual on the host once per V-cycle. The global
reductions land on the first block's device; the sums (the nullspace
means) add the blocks in the serial solve's order
(ops.poisson.cell_mean: along the last axis, which no mesh splits, then
the plane of those sums), and a max is exact in any order. So the
distributed solve computes the serial one's values: tpuvof's psum
reassociates against its serial mean, and its trip counts can part from
the serial ones where a residual sits near the tolerance.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch
import torch.nn.functional as nnf

from ..ops.mg import (STALL_CYCLES, _build_levels, _coeffs, _nu_policy, _prolong, _red_mask,
                      _restrict, _vcycle, mg_levels, mg_solve)
from ..ops.poisson import block_max, effective_tol_blocks, keep_iterating

__all__ = ["MGDecomp", "mg_solve_dist", "GATHER_VOLUME"]

#: Gather crossover: from the first level whose global volume is at most
#: this, the rest of the ladder runs gathered on one device. Read at each
#: call, so tests can patch it to force either extreme.
GATHER_VOLUME = 4096


@dataclass(frozen=True)
class MGDecomp:
    """The shard count of each array axis (1: not split). tpuvof's also
    names each split axis's mesh axis for its collectives; the port's
    blocks are a list, so the counts say it all."""

    shards: tuple

    def __post_init__(self):
        if not self.shards or any(int(n) < 1 for n in self.shards):
            raise ValueError(f"shard counts must be >= 1, got {self.shards}")

    @cached_property
    def coords(self) -> list[tuple[int, ...]]:
        """Each block's position in the shard grid, row-major."""
        return list(itertools.product(*(range(n) for n in self.shards)))

    def neighbour(self, k: int, ax: int, d: int) -> int | None:
        """The block d positions from block k along ``ax``; None past a wall."""
        c = list(self.coords[k])
        c[ax] += d
        if not 0 <= c[ax] < self.shards[ax]:
            return None
        return int(np.ravel_multi_index(c, self.shards))


def _exchange_nd(spec: MGDecomp, blocks):
    """Refresh the one-cell ghost shell of ghosted blocks, in place, along
    every split axis from the neighbours' boundary cells; edge blocks keep
    their ghosts. Axis by axis, every block before the next axis, so the
    corners arrive through two copies. Returns ``blocks``."""
    for ax, n in enumerate(spec.shards):
        if n == 1:
            continue
        for k in range(len(blocks)):
            dst = blocks[k]
            lo, hi = spec.neighbour(k, ax, -1), spec.neighbour(k, ax, 1)
            if lo is not None:
                src = blocks[lo]
                dst.select(ax, 0).copy_(src.select(ax, src.shape[ax] - 2))
            if hi is not None:
                dst.select(ax, dst.shape[ax] - 1).copy_(blocks[hi].select(ax, 1))
    return blocks


def _gsum(spec: MGDecomp, xs):
    """The sum over all blocks on the first block's device, in
    ops.poisson.cell_mean's order: each block's sums along the last axis,
    assembled into the whole plane of them, then summed as the serial solve
    sums that plane (where a mesh splits the last axis, the whole array is
    assembled first). The same bits as the serial sum, on any mesh."""
    if spec.shards[-1] == 1 and len(spec.shards) > 1:
        return _allgather_nd(MGDecomp(spec.shards[:-1]), [x.sum(-1) for x in xs]).sum()
    return _allgather_nd(spec, xs).sum(-1).sum()


def _mean_free(spec: MGDecomp, xs, npts: int):
    """Each block less the global mean (ops.poisson.cell_mean's)."""
    mean = _gsum(spec, xs) / npts
    return [x - mean.to(x.device) for x in xs]


def _allgather_nd(spec: MGDecomp, xs):
    """The whole array, assembled from its blocks on the first block's device."""
    lshape = xs[0].shape
    full = torch.empty([n * s for n, s in zip(lshape, spec.shards)], dtype=xs[0].dtype,
                       device=xs[0].device)
    for c, x in zip(spec.coords, xs):
        full[_block(c, lshape)].copy_(x)
    return full


def _block(c, lshape):
    return tuple(slice(ci * n, (ci + 1) * n) for ci, n in zip(c, lshape))


def _local_slice(spec: MGDecomp, full, lshape, devices):
    """Each block's part of a whole array, on the block's device."""
    return [full[_block(c, lshape)].to(dev) for c, dev in zip(spec.coords, devices)]


def _neigh_g(axes, pg, rhs):
    """ops.mg._neigh on a ghosted block: rhs less the neighbour terms, read
    from the ghost shell where the serial form rolls (the wall ghosts meet
    exactly-zero coefficients); the same subtractions in the same order."""
    nd = rhs.ndim

    def sl(ax, lo, hi):
        return tuple(slice(lo, hi) if k == ax else slice(1, -1) for k in range(nd))

    out = rhs
    for ax, (apl, ami) in enumerate(axes):
        out = out - apl * pg[sl(ax, 2, None)] - ami * pg[sl(ax, 0, -2)]
    return out


def _padded(spec: MGDecomp, ps):
    """Each interior-shaped block with a ghost shell: zeros, then the
    neighbours' boundary cells."""
    return _exchange_nd(spec, [nnf.pad(p, (1, 1) * p.ndim) for p in ps])


def _rb_sweep_dist(spec: MGDecomp, level, ps, rhss):
    """One red-black Gauss-Seidel sweep on interior-shaped blocks, with a
    ghost exchange before each half sweep (each colour reads the other's
    fresh values across shard boundaries)."""
    for half in (3, 4):  # the red, then the black mask of each block's level
        pgs = _padded(spec, ps)
        ps = [torch.where(lv[half], _neigh_g(lv[0], pg, rhs) * lv[2], p)
              for lv, pg, rhs, p in zip(level, pgs, rhss, ps)]
    return ps


def _prolong_axis_dist(spec: MGDecomp, es, ax: int):
    """ops.mg._prolong_axis on blocks: the edge clamp only at the global
    walls; at a shard boundary the neighbour's first or last plane."""
    out = []
    for k, e in enumerate(es):
        n = e.shape[ax]
        first, last = e.narrow(ax, 0, 1), e.narrow(ax, n - 1, 1)
        lo, hi = spec.neighbour(k, ax, -1), spec.neighbour(k, ax, 1)
        ghost_lo = first if lo is None else es[lo].narrow(ax, n - 1, 1).to(e.device)
        ghost_hi = last if hi is None else es[hi].narrow(ax, 0, 1).to(e.device)
        lo_e = torch.cat([ghost_lo, e.narrow(ax, 0, n - 1)], dim=ax)
        hi_e = torch.cat([e.narrow(ax, 1, n - 1), ghost_hi], dim=ax)
        a = 0.25 * lo_e + 0.75 * e
        b = 0.75 * e + 0.25 * hi_e
        out.append(torch.stack([a, b], dim=ax + 1)
                   .reshape(e.shape[:ax] + (2 * n,) + e.shape[ax + 1:]))
    return out


def _prolong_dist(spec: MGDecomp, es):
    for ax in range(es[0].ndim):
        es = _prolong_axis_dist(spec, es, ax)
    return es


def mg_solve_dist(spec: MGDecomp, ps, rhss, inv2, tol, max_cycles, nu: int | None = None,
                  coarse_iters: int = 50, tol_rel: float = 0.0,
                  gather_volume: int | None = None):
    """ops.mg.mg_solve on a sharded grid.

    ps: the ghosted local blocks of p (their ghosts are kept, then the
    shard-boundary ghosts refreshed); rhss: the interior-shaped local
    right-hand sides; spec: the shard counts. The other arguments are
    mg_solve's: the same ladder, tolerance (sor_tol_rel with the global
    max as its scale) and V(1,1)/V(2,2) policy. Returns new ghosted blocks.

    Three regimes, by where the crossover level L falls: L = 0 gathers the
    fine problem once and runs the serial mg_solve (the serial exits, bit
    for bit); 0 < L < levels runs the fine levels sharded and the rest
    gathered; L = levels runs every level sharded. Raises ValueError where
    the global grid does not coarsen (a block may be one cell thick)."""
    if gather_volume is None:
        gather_volume = GATHER_VOLUME
    nu = _nu_policy(nu, tol_rel)
    nd = rhss[0].ndim
    local0 = tuple(rhss[0].shape)
    gshape = tuple(n * s for n, s in zip(local0, spec.shards))
    shapes = mg_levels(gshape)
    if len(shapes) < 2:
        raise ValueError(
            f"pressure_solver='mg' needs a coarsenable interior grid (all extents even "
            f"and >= 8); got global {gshape} - use 'rbsor'")
    dtype = rhss[0].dtype
    devices = [r.device for r in rhss]
    npts = int(np.prod(gshape))
    interior = (slice(1, -1),) * nd

    def dist_ok(shape):
        return all(n % s == 0 for n, s in zip(shape, spec.shards))

    # levels [0, L) run sharded, [L, end) gathered
    L = len(shapes)
    for lvl, shape in enumerate(shapes):
        if not dist_ok(shape) or int(np.prod(shape)) <= gather_volume:
            L = lvl
            break

    def finish(p_ints):
        outs = []
        for p, p_int in zip(ps, p_ints):
            out = p.clone()
            out[interior] = p_int
            outs.append(out)
        return _exchange_nd(spec, outs)

    if L == 0:
        rhs_full = _allgather_nd(spec, rhss)
        p_full = torch.zeros([n + 2 for n in gshape], dtype=dtype, device=devices[0])
        p_full[interior] = _allgather_nd(spec, [p[interior] for p in ps])
        out = mg_solve(p_full, rhs_full, inv2, tol, max_cycles, nu=nu,
                       coarse_iters=coarse_iters, tol_rel=tol_rel)
        return finish(_local_slice(spec, out[interior], local0, devices))

    # per sharded level: its block shape and each block's (axes, ap, ap_inv,
    # red, black), from global indices
    dlevels = []
    for lvl in range(L):
        lshape = tuple(n // s for n, s in zip(shapes[lvl], spec.shards))
        blocks = []
        for c, dev in zip(spec.coords, devices):
            offsets = tuple(ci * n for ci, n in zip(c, lshape))
            axes, ap, ap_inv = _coeffs(lshape, tuple(x / 4.0**lvl for x in inv2), dtype, dev,
                                       offsets, shapes[lvl])
            red = _red_mask(lshape, dev, offsets)
            blocks.append((axes, ap, ap_inv, red, ~red))
        dlevels.append((lshape, blocks))
    if L < len(shapes):
        tail = _build_levels(shapes[L:], tuple(x / 4.0**L for x in inv2), dtype, devices[0])

    rhss = _mean_free(spec, rhss, npts)
    tol = effective_tol_blocks(tol, tol_rel, rhss)

    def residual(level, ps_l, rhss_l):
        pgs = _padded(spec, ps_l)
        return [_neigh_g(lv[0], pg, rhs) - lv[1] * p
                for lv, pg, rhs, p in zip(level, pgs, rhss_l, ps_l)]

    def vcycle(lvl, ps_l, rhss_l):
        lshape, level = dlevels[lvl]
        if lvl == len(shapes) - 1:  # every level sharded: the coarsest
            for _ in range(coarse_iters):
                ps_l = _rb_sweep_dist(spec, level, ps_l, rhss_l)
            return ps_l
        for _ in range(nu):
            ps_l = _rb_sweep_dist(spec, level, ps_l, rhss_l)
        rs = residual(level, ps_l, rhss_l)
        if lvl + 1 == L:
            # restrict on the blocks while the next level divides the mesh
            # (block means are per cell, so both orders give one value)
            if dist_ok(shapes[lvl + 1]):
                rhs_next = _allgather_nd(spec, [_restrict(r) for r in rs])
            else:
                rhs_next = _restrict(_allgather_nd(spec, rs))
            e_full = _vcycle(tail, nu, coarse_iters, 0, torch.zeros_like(rhs_next), rhs_next)
            es = _local_slice(spec, _prolong(e_full), lshape, devices)
        else:
            rns = [_restrict(r) for r in rs]
            es = _prolong_dist(spec, vcycle(lvl + 1, [torch.zeros_like(r) for r in rns], rns))
        ps_l = [p + e for p, e in zip(ps_l, es)]
        for _ in range(nu):
            ps_l = _rb_sweep_dist(spec, level, ps_l, rhss_l)
        return ps_l

    def resid(ps_l):
        rs = _mean_free(spec, residual(dlevels[0][1], ps_l, rhss), npts)
        return block_max([r.abs() for r in rs]).item()

    p_l = [p[interior] for p in ps]
    r = best = resid(p_l)
    it = stall = 0
    while keep_iterating(it, max_cycles, r, tol, best, stall, STALL_CYCLES):
        p_l = vcycle(0, p_l, rhss)
        r = resid(p_l)
        stall = 0 if r < best else stall + 1
        best = min(best, r)
        it += 1
    return finish(p_l)
