#!/usr/bin/env python3
"""A/B of the 2-D kernels of two tpuvof_torch trees on one CUDA card.

    python3 scripts/torch_ab2d.py TREE_A TREE_B [--sass] [--stamps] [--variants]
                                  [--out FILE]

Each tree is a directory holding a ``tpuvof_torch`` package (for example
the parent commit unpacked with ``git archive`` into a git-ignored
directory of the checkout, against ``.``). The legs run in the order A, B,
B, A, each in a process of its own that imports that tree's package and
builds its kernels from that tree's sources. On dam-break states developed
on the plain path (which both trees share, so both legs' kernels see the
same inputs) and perturbed from a seed, each leg:

- times on the device alone (CUDA events around the replay of a CUDA graph
  of the calls, best of 5), in f32: ``fullstep`` and ``project`` at 514^2,
  1026^2 and 2050^2; ``fullstep_win`` on the tiled engine's 174 x 558
  block; ``fullstep_strips`` at 562^2 (the strips engine's padded layout);
  ``fullstep_dma`` at the three sizes; ``fullstep`` and ``fullstep_dma``
  in f64 at 514^2 and 2050^2; ``fullstep`` at n_jacobi 1, 2, 10 and 20 at
  514^2 and 2050^2, whose slope is the cost of one Jacobi stage;
  ``predict`` and ``fct_sweep`` x and y at 514^2, 1026^2, 2050^2 and 65^2;
  ``predict_win`` and ``fct_sweep_win`` x and y on the 136^2 block of the
  hybrid tiled engine's interior tile and on a 29 x 45 block; the 512^2
  step of the ``'cuda'`` and ``'cuda_mono'`` routes on the device alone (a
  step pair), and their host-clock ms/step (``simulate``, 1000 steps from
  the initial state, best of 3);
- the first A and B legs also hash every output (SHA-256 of its bytes) of
  ``fullstep`` at the three sizes, of ``fullstep_win`` (the whole block and
  the region its engine keeps, the block minus STEP_HALO) and of
  ``fullstep_strips`` (NaN in the margins; the whole block and the grid
  inside its margin), at both parities and n_jacobi 1, 2 and 10, f32 and
  f64; of ``predict`` and ``fct_sweep`` x/y at the three sizes and 65^2, of
  ``predict_win`` and ``fct_sweep_win`` x/y on a 136^2 and a 29 x 45 block
  at each corner of the 514^2 grid (origins past both walls; the block
  minus PHASE_HALO, and the whole block), the sweeps under FCT_FORWARD,
  FCT_DIFF and FCT_SCHEME_TEST, f32 and f64; and of ``project`` at the
  three sizes, n_jacobi 1 to 11, f32 and f64; and of ``fullstep_dma`` at
  the three sizes, n_jacobi 1, 2 and 10, both parities, f32 and f64; each
  leg also checks ``fullstep_dma`` == ``fullstep`` bit for bit on all of
  those. The script compares A's
  hashes with B's and exits 1 unless every kept output is equal (a
  redesign that changes only where values are computed keeps them bit for
  bit); it reports whether the junk margins changed;
- with ``--sass``, the first A and B legs compile the tree's 2-D sources to
  cubins with its nvcc flags and report ptxas's registers, stack and spills
  and the SASS count per kernel function (``torch_ab3d.sass_counts``), and
  the launch shapes (threads and shared bytes a CTA, CTAs an SM, CTAs
  launched, tile rows): the whole-step kernel's from ``tv_fullstep_shape_*``
  where the tree exports it, else computed from the registers; those of
  ``project``, ``predict``, each sweep axis and ``fullstep_dma`` where the
  tree exports ``tv_project_shape_*``,
  ``tv_predict_shape_*``, ``tv_fct_sweep_shape_*``,
  ``tv_fullstep_dma_shape_*``;
- with ``--variants``, every leg of a tree whose ``predict`` takes a tile
  height also times it at 8 and 24 rows on the phase kernels' grids and
  blocks;
- with ``--stamps``, every leg builds a copy of the tree's ``fullstep.cu``,
  and of its ``fullstep_dma.cu`` where that runs ``step_groups.cuh``'s
  groups (in a temporary directory, never in the tree; the tree's
  ``step_groups.cuh``, ``phase_tiles.cuh`` and ``stage_groups.cuh``, where
  it has them, inlined in their place), whose barriers are stamped with
  ``clock64()``: block 0's clock at the kernel's start, after each
  grid-wide and each CTA barrier, and at its end. It prints, at 514^2 and
  2050^2 (both kernels) and on the tiled engine's block (``fullstep``),
  f32, n_jacobi 10, block 0's time between stamps scaled to the stamped
  kernel's device time, summed a stage (up to a grid barrier) with its CTA
  barriers' parts beside it.

It prints one line per leg, the comparison, a table of the four legs, and
the card's name and power limit; ``--out`` also writes the legs as JSON.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch_ab3d as ab3

SIZES = (512, 1024, 2048)
SLOPE_SIZES = (512, 2048)
SLOPE_N_JACOBI = (1, 2, 10, 20)
N_JACOBI = (1, 2, 10)
PROJECT_N_JACOBI = tuple(range(1, 12))  # every split of the stage groups up to three
TILE_ROWS = 128  # the tiled engine's tile (solver.TILE_ROWS): blocks of 128 + 2W + 2 rows
DEVELOP_STEPS = 20
SEED = 0
SOURCES_2D = ("fullstep.cu", "fullstep_dma.cu", "predict.cu", "project.cu", "fct_sweep.cu")
F64_SIZES = (512, 2048)  # fullstep and fullstep_dma timed in f64
N_ODD = 63  # the phase kernels' odd grid (65^2 arrays), as chip_smoke.py's
FCT_VARIANTS = ("FCT_FORWARD", "FCT_DIFF", "FCT_SCHEME_TEST")
WIN = 136  # the hybrid tiled engine's phase block: a 128^2 tile + 2 * PHASE_HALO + 2
RAGGED = (29, 45)  # a phase block whose sides are a multiple of no tile
TILE_ROWS_TRIED = (8, 24)  # predict's tile heights, timed with --variants
STAMP_SIZES = (512, 2048)
ROUTE_STEPS = 1000  # the 512^2 routes' host-clock run, as chip_smoke.py's

# Stamps of the barriers, inserted into a copy of fullstep.cu: block 0's
# thread (0, 0) reads clock64() at the kernel's start, after every
# grid-wide barrier and every CTA barrier, and at its end, into tv_rel (SM
# clock cycles), and notes which barrier each stamp follows in tv_kind
# (1 grid, 2 CTA, 0 start and end). One thread of one CTA writes, so the
# stamps add no barrier and no atomic.
STAMP_HEAD = r"""
__device__ long long tv_rel[512];
__device__ int tv_kind[512];
__device__ int tv_n;
__device__ __forceinline__ void tv_stamp(int kind) {
  if (blockIdx.x == 0 && threadIdx.x == 0 && threadIdx.y == 0) {
    const int k = tv_n;
    if (k < 512) {
      tv_rel[k] = clock64();
      tv_kind[k] = kind;
    }
    tv_n = k + 1;
  }
}
#define TV_SYNC(g) { g.sync(); tv_stamp(1); }
#define TV_BAR { __syncthreads(); tv_stamp(2); }
"""
STAMP_TAIL = r"""
extern "C" int tv_stamps_reset() {
  const int z = 0;
  return static_cast<int>(cudaMemcpyToSymbol(tv_n, &z, sizeof(int)));
}
extern "C" int tv_stamps_read(long long* rel, int* kind, int* n) {
  cudaMemcpyFromSymbol(rel, tv_rel, sizeof(long long) * 512);
  cudaMemcpyFromSymbol(kind, tv_kind, sizeof(int) * 512);
  return static_cast<int>(cudaMemcpyFromSymbol(n, tv_n, sizeof(int)));
}
"""


def stamped_source(text: str, csrc: Path, kernel: str = "fullstep_kernel") -> str:
    """fullstep.cu with its barriers stamped: the tree's step_groups.cuh,
    phase_tiles.cuh and stage_groups.cuh (where it includes them) inlined,
    then ``grid.sync()`` becomes
    TV_SYNC(grid) and ``__syncthreads()`` TV_BAR everywhere in the file,
    and ``kernel``'s body starts and ends with a stamp (the kernel body
    has no early return: every thread reaches every barrier)."""
    for name in ("step_groups.cuh", "phase_tiles.cuh", "stage_groups.cuh"):  # outermost first
        inc = f'#include "{name}"'
        if inc in text:
            header = (csrc / name).read_text().replace("#pragma once", "")
            text = text.replace(inc, '#include "step_cell.cuh"\n' + header, 1)
    m = re.search(kernel + r"\([^)]*\)\s*\{", text)
    if not m:
        raise RuntimeError(f"no {kernel} definition")
    depth, pos = 1, m.end()
    while depth:
        ch = text[pos]
        depth += ch == "{"
        depth -= ch == "}"
        pos += 1
    out = (text[:m.end()] + "\n  tv_stamp(0);\n" + text[m.end():pos - 1]
           + "\n  tv_stamp(0);\n}" + text[pos:])
    out = out.replace("grid.sync();", "TV_SYNC(grid);").replace("__syncthreads();", "TV_BAR;")
    if "TV_SYNC" not in out:
        raise RuntimeError(f"{kernel} has no grid.sync()")
    out = out.replace('#include "step_cell.cuh"', '#include "step_cell.cuh"\n' + STAMP_HEAD, 1)
    return out + STAMP_TAIL


def build_stamped(build, csrc: Path, tmp: Path, source: str = "fullstep.cu",
                  kernel: str = "fullstep_kernel") -> ctypes.CDLL:
    nvcc = build._nvcc()
    src = tmp / f"{Path(source).stem}_stamped.cu"
    src.write_text(stamped_source((csrc / source).read_text(), csrc, kernel))
    so = tmp / f"lib{Path(source).stem}_stamped.so"
    cmd = [nvcc, *build._FLAGS, "-I", str(csrc), "-shared", "-o", str(so), str(src)]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed on the stamped copy:\n{out.stderr}")
    lib = ctypes.CDLL(str(so))
    entry = "tv_" + Path(source).stem
    for suffix in ("_f32", "_f64"):
        fn = getattr(lib, entry + suffix)
        fn.argtypes = build._SIGNATURES[entry]
        fn.restype = ctypes.c_int
    lib.tv_stamps_read.argtypes = [ctypes.c_void_p] * 3
    lib.tv_stamps_reset.argtypes = []
    return lib


def call_fullstep(torch, K, fn, cfg, F, u, v, p, even, oi=0, oj=0):
    """fullstep's (or, with an origin, fullstep_win's) launch through
    another library's entry point ``fn``."""
    g, nm = cfg.grid, cfg.num
    outs = [torch.empty_like(F) for _ in range(4)]
    # the tree's scratch count (7 in trees that do not state it; a dict of
    # them by entry point in trees before fullstep_dma's stage groups)
    n_scratch = getattr(K, "_SCRATCH_BLOCKS", 7)
    if isinstance(n_scratch, dict):
        n_scratch = n_scratch["fullstep"]
    scratch = torch.empty((n_scratch,) + tuple(F.shape), dtype=F.dtype, device=F.device)
    ins = (ctypes.c_void_p * 4)(*(t.data_ptr() for t in (F, u, v, p)))
    out_ptrs = (ctypes.c_void_p * 4)(*(t.data_ptr() for t in outs))
    status = fn(ins, out_ptrs, scratch.data_ptr(), *F.shape, oi, oj, g.nx, g.ny, nm.n_jacobi,
                int(bool(even)), K._predict_constants(cfg), K._project_constants(cfg),
                K._sweep_args(cfg, 0), K._sweep_args(cfg, 1), int(nm.fct.full_dv),
                int(nm.fct.clamp), torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError(f"stamped fullstep failed: {status}")
    return outs


def stamps(torch, tt, K, build, csrc, states) -> dict:
    """{block: {kernel_us, marks}} of the stamped copy at n_jacobi 10, f32,
    on the whole grid at STAMP_SIZES and on the tiled engine's block, and,
    in a tree whose fullstep_dma.cu runs step_groups.cuh's groups, of a
    stamped copy of it at STAMP_SIZES ("dma" blocks): block 0's intervals
    between consecutive stamps as [kind of the stamp that ends it (G grid
    barrier, b CTA barrier, E end), µs], scaled to the stamped kernel's
    device time."""
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        lib = build_stamped(build, csrc, Path(tmp))
        dma = "step_groups.cuh" in (csrc / "fullstep_dma.cu").read_text()
        lib_dma = (build_stamped(build, csrc, Path(tmp), "fullstep_dma.cu",
                                 "fullstep_dma_kernel") if dma else None)
        cases = []
        for n in STAMP_SIZES:
            cfg = tt.dam_break_2d(n, num=tt.Numerics(backend="cuda_mono"))
            cases.append((f"{n + 2}^2", cfg, [a.float().contiguous() for a in states[n]],
                          (0, 0)))
        cfg = tt.dam_break_2d(SIZES[0], num=tt.Numerics(backend="cuda_mono"))
        blocks, origin, _ = win_block(torch, K, cfg, [a.float() for a in states[SIZES[0]]])
        cases.append((f"win {blocks[0].shape[0]}x{blocks[0].shape[1]}", cfg, blocks, origin))
        if dma:
            cases += [(f"dma {label}", cfg, s, None) for label, cfg, s, _ in cases[:-1]]
        for label, cfg, s, origin in cases:
            def call(cfg=cfg, s=s, origin=origin):
                if origin is None:
                    return call_dma(torch, K, lib_dma.tv_fullstep_dma_f32, cfg, *s, False)
                return call_fullstep(torch, K, lib.tv_fullstep_f32, cfg, *s, False, *origin)
            stamped = lib if origin is not None else lib_dma
            us = 1e3 * ab3.device_ms(torch, call, 20)
            stamped.tv_stamps_reset()
            call()
            torch.cuda.synchronize()
            rel = (ctypes.c_longlong * 512)()
            kind = (ctypes.c_int * 512)()
            nst = ctypes.c_int()
            stamped.tv_stamps_read(rel, kind, ctypes.byref(nst))
            n = min(nst.value, 512)
            total = rel[n - 1] - rel[0]
            marks = [["EGb"[kind[k]], us * (rel[k] - rel[k - 1]) / total] for k in range(1, n)]
            res[label] = {"kernel_us": us, "marks": marks}
    return res


def states_of(torch, tt):
    """{n: (F, u, v, p)} in f64: the n^2 dam break developed DEVELOP_STEPS on
    the plain path in f32, plus a seeded uniform perturbation of 1e-3, BCs
    applied."""
    import numpy as np

    from tpuvof_torch.ops import apply_bc

    out = {}
    for n in SIZES + (N_ODD,):
        cfg = tt.dam_break_2d(n, num=tt.Numerics(backend="torch"))
        s = tt.simulate(cfg, tt.init_state(cfg, 1, "cuda", torch.float32), DEVELOP_STEPS)
        rng = np.random.default_rng(SEED + n)
        F, u, v, p = (a.double() + torch.as_tensor(rng.uniform(-1e-3, 1e-3, a.shape),
                                                   device="cuda") for a in s)
        u, v, F, p = apply_bc(u, v, F, p)
        out[n] = (F, u, v, p)
    return out


def with_jacobi(tt, cfg, n_jacobi):
    return cfg.replace(num=dataclasses.replace(cfg.num, n_jacobi=n_jacobi))


def win_block(torch, K, cfg, st):
    """The tiled engine's block of the tile at rows n/2 .. n/2 + 128 (all
    columns), W = STEP_HALO from it, zeros beyond the walls; its origin."""
    W = K.STEP_HALO(cfg)
    n = cfg.grid.nx
    r0 = n // 2
    blocks = [torch.nn.functional.pad(a, (W,) * 4)[r0:r0 + TILE_ROWS + 2 * W + 2].contiguous()
              for a in st]
    return blocks, (r0 - W, -W), W


def strips_block(torch, K, cfg, st):
    w2 = K.strips_halo(cfg)
    return [torch.nn.functional.pad(a, (w2,) * 4, value=float("nan")) for a in st], w2


def with_fct(tt, cfg, name):
    return cfg.replace(num=dataclasses.replace(cfg.num, fct=getattr(tt, name)))


def phase_blocks(torch, K, st):
    """[(label, blocks, (oi, oj))] of the windowed phase kernels on state
    ``st``: a WIN^2 window and a RAGGED block at each corner of the grid
    padded by PHASE_HALO (origins past both walls, as the hybrid tiled
    engine cuts its edge tiles)."""
    W = K.PHASE_HALO
    padded = [torch.nn.functional.pad(a, (W,) * 4) for a in st]
    L = padded[0].shape[0]
    out = []
    for e0, e1 in ((WIN, WIN), RAGGED):
        for r0 in (0, L - e0):
            for c0 in (0, L - e1):
                blocks = [a[r0:r0 + e0, c0:c0 + e1].contiguous() for a in padded]
                out.append((f"{e0}x{e1}@({r0 - W},{c0 - W})", blocks, (r0 - W, c0 - W)))
    return out


def hash_phase(torch, tt, K, states, dtype, out):
    """Adds the SHA-256 of every output of the phase kernels to ``out``:
    predict and fct_sweep x/y on the whole grid at SIZES and N_ODD,
    predict_win and fct_sweep_win on phase_blocks of the SIZES[0] state
    (the block minus PHASE_HALO [kept], the whole block [whole]); the
    sweeps under every FCT variant."""
    dt = str(dtype)[6:]
    W = K.PHASE_HALO
    for n in SIZES + (N_ODD,):
        F, u, v, p = (a.to(dtype).contiguous() for a in states[n])
        base = tt.dam_break_2d(n, num=tt.Numerics(backend="cuda"))
        for name, t in zip(("u*", "v*"), K.predict(base, u, v, F)):
            out[f"predict {n + 2}^2 {dt} {name} [kept]"] = digest(t)
        for var in FCT_VARIANTS:
            cfg = with_fct(tt, base, var)
            for axis, vel in ((0, u), (1, v)):
                out[f"fct_sweep {'xy'[axis]} {n + 2}^2 {dt} {var} [kept]"] = digest(
                    K.fct_sweep(cfg, F, vel, axis))
        if n != SIZES[0]:
            continue
        for label, (Fb, ub, vb, _), (oi, oj) in phase_blocks(torch, K, (F, u, v, p)):
            for name, t in zip(("u*", "v*"), K.predict_win(base, ub, vb, Fb, oi, oj)):
                out[f"predict_win {label} {dt} {name} [kept]"] = digest(t[W:-W, W:-W])
                out[f"predict_win {label} {dt} {name} [whole]"] = digest(t)
            for var in FCT_VARIANTS:
                cfg = with_fct(tt, base, var)
                for axis, vel in ((0, ub), (1, vb)):
                    t = K.fct_sweep_win(cfg, Fb, vel, axis, oi, oj)
                    key = f"fct_sweep_win {'xy'[axis]} {label} {dt} {var}"
                    out[f"{key} [kept]"] = digest(t[W:-W, W:-W])
                    out[f"{key} [whole]"] = digest(t)


def digest(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def hash_outputs(torch, tt, K, states) -> dict:
    """{name: sha256} of every compared output; names ending in ``[kept]``
    must be equal between the trees, ``[whole]`` ones are reported."""
    out = {}
    dma_same = True
    for dtype in (torch.float32, torch.float64):
        dt = str(dtype)[6:]
        for n in SIZES:
            st = [a.to(dtype).contiguous() for a in states[n]]
            base = tt.dam_break_2d(n, num=tt.Numerics(backend="cuda_mono"))
            for nj in N_JACOBI:
                cfg = with_jacobi(tt, base, nj)
                for even in (False, True):
                    key = f"{n + 2}^2 {dt} n_jacobi={nj} even={even}"
                    outs = K.fullstep(cfg, *st, even)
                    for name, t in zip("Fuvp", outs):
                        out[f"fullstep {key} {name} [kept]"] = digest(t)
                    dma = K.fullstep_dma(cfg, *st, even)
                    dma_same &= all(torch.equal(a, b) for a, b in zip(dma, outs))
                    for name, t in zip("Fuvp", dma):
                        out[f"fullstep_dma {key} {name} [kept]"] = digest(t)
                    if n == SIZES[0]:
                        blocks, (oi, oj), W = win_block(torch, K, cfg, st)
                        wkey = f"{tuple(blocks[0].shape)} {dt} n_jacobi={nj} even={even}"
                        for name, t in zip("Fuvp", K.fullstep_win(cfg, *blocks, oi, oj, even)):
                            out[f"fullstep_win {wkey} {name} [kept]"] = digest(t[W:-W, W:-W])
                            out[f"fullstep_win {wkey} {name} [whole]"] = digest(t)
                        padded, w2 = strips_block(torch, K, cfg, st)
                        skey = f"{tuple(padded[0].shape)} {dt} n_jacobi={nj} even={even}"
                        for name, t in zip("Fuvp", K.fullstep_strips(cfg, *padded, even)):
                            out[f"fullstep_strips {skey} {name} [kept]"] = digest(
                                t[w2:-w2, w2:-w2])
                            out[f"fullstep_strips {skey} {name} [whole]"] = digest(t)
            F, u, v, p = st
            us, vs = K.predict_plain(base, u, v, F)
            for nj in PROJECT_N_JACOBI:
                outs = K.project(with_jacobi(tt, base, nj), F, us, vs, p, u, v)
                for name, t in zip("puv", outs):
                    out[f"project {n + 2}^2 {dt} n_jacobi={nj} {name} [kept]"] = digest(t)
            torch.cuda.synchronize()
        hash_phase(torch, tt, K, states, dtype, out)
        torch.cuda.synchronize()
    out["fullstep_dma == fullstep bit for bit [in-leg]"] = str(dma_same)
    return out


def phase_timed(torch, tt, K, states) -> dict:
    """{name: call} of the phase kernels in f32 under FCT_FORWARD: predict
    and fct_sweep x/y on the whole grid at SIZES and N_ODD; predict_win and
    fct_sweep_win x/y on the WIN^2 block at rows n/2, columns n/4 of the
    SIZES[0] grid (the hybrid tiled engine's interior tile) and on the
    RAGGED block at the grid's low corner."""
    timed = {}
    for n in SIZES + (N_ODD,):
        cfg = tt.dam_break_2d(n, num=tt.Numerics(backend="cuda"))
        F, u, v, _ = (a.float().contiguous() for a in states[n])
        timed[f"predict {n + 2}^2"] = lambda cfg=cfg, u=u, v=v, F=F: K.predict(cfg, u, v, F)
        for axis, vel in ((0, u), (1, v)):
            timed[f"fct_sweep {'xy'[axis]} {n + 2}^2"] = (
                lambda cfg=cfg, F=F, vel=vel, axis=axis: K.fct_sweep(cfg, F, vel, axis))
    for label, (Fb, ub, vb), (oi, oj) in win_blocks(torch, K, states):
        cfg = tt.dam_break_2d(SIZES[0], num=tt.Numerics(backend="cuda"))
        timed[f"predict_win {label}"] = (lambda cfg=cfg, ub=ub, vb=vb, Fb=Fb, oi=oi, oj=oj:
                                         K.predict_win(cfg, ub, vb, Fb, oi, oj))
        for axis, vel in ((0, ub), (1, vb)):
            timed[f"fct_sweep_win {'xy'[axis]} {label}"] = (
                lambda cfg=cfg, Fb=Fb, vel=vel, axis=axis, oi=oi, oj=oj:
                K.fct_sweep_win(cfg, Fb, vel, axis, oi, oj))
    return timed


def win_blocks(torch, K, states):
    """[(label, (F, u, v) blocks in f32, origin)]: phase_timed's two blocks."""
    W = K.PHASE_HALO
    n = SIZES[0]
    padded = [torch.nn.functional.pad(a.float(), (W,) * 4) for a in states[n][:3]]
    out = []
    for (e0, e1), (r0, c0) in (((WIN, WIN), (n // 2, n // 4)), (RAGGED, (0, 0))):
        out.append((f"{e0}x{e1}", [a[r0:r0 + e0, c0:c0 + e1].contiguous() for a in padded],
                    (r0 - W, c0 - W)))
    return out


def variant_timed(torch, tt, K, lib, states) -> dict:
    """{name: call} of ``predict`` at each of TILE_ROWS_TRIED where the
    tree's library takes a tile height (``tv_predict_*``'s rows argument,
    present where the tree exports ``tv_predict_shape_*``), on
    phase_timed's grids and blocks."""
    timed = {}
    if not hasattr(lib, "tv_predict_shape_f32"):
        return timed

    def rows(cfg, u, v, F, oi, oj, r):
        us, vs = torch.empty_like(F), torch.empty_like(F)
        g = cfg.grid
        if lib.tv_predict_f32(u.data_ptr(), v.data_ptr(), F.data_ptr(), us.data_ptr(),
                              vs.data_ptr(), *F.shape, oi, oj, g.nx, g.ny,
                              K._predict_constants(cfg), r,
                              torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError(f"predict at {r} rows failed")

    cases = []
    for n in SIZES:
        F, u, v, _ = (a.float().contiguous() for a in states[n])
        cases.append((f"{n + 2}^2", tt.dam_break_2d(n, num=tt.Numerics(backend="cuda")),
                      (F, u, v), (0, 0)))
    cfg = tt.dam_break_2d(SIZES[0], num=tt.Numerics(backend="cuda"))
    cases += [(label, cfg, tuple(b), org) for label, b, org in win_blocks(torch, K, states)]
    for label, c, (F, u, v), (oi, oj) in cases:
        for r in TILE_ROWS_TRIED:
            timed[f"predict rows={r} {label}"] = (
                lambda c=c, u=u, v=v, F=F, oi=oi, oj=oj, r=r: rows(c, u, v, F, oi, oj, r))
    return timed


def phase_shapes(lib) -> dict:
    """{"kernel dtype block": [threads a CTA, shared bytes a CTA, CTAs an SM,
    CTAs launched, tile rows, tile columns]} of predict and of each sweep
    axis at SIZES, N_ODD and the two win_blocks, where the tree exports
    ``tv_predict_shape_*`` and ``tv_fct_sweep_shape_*``."""
    out = {}
    blocks = [(n + 2, n + 2) for n in SIZES + (N_ODD,)] + [(WIN, WIN), RAGGED]
    for dt in ("f32", "f64"):
        fn = getattr(lib, f"tv_predict_shape_{dt}", None)
        sw = getattr(lib, f"tv_fct_sweep_shape_{dt}", None)
        for e0, e1 in blocks:
            shape = (ctypes.c_int * 6)()
            if fn is not None:
                fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
                if fn(e0, e1, shape) != 0:
                    raise RuntimeError("tv_predict_shape failed")
                out[f"predict {dt} {e0}x{e1}"] = list(shape)
            if sw is not None:
                sw.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
                for axis in (0, 1):
                    if sw(e0, e1, axis, shape) != 0:
                        raise RuntimeError("tv_fct_sweep_shape failed")
                    out[f"fct_sweep {'xy'[axis]} {dt} {e0}x{e1}"] = list(shape)
    return out


def kernel_shape(lib, sass: dict) -> dict:
    """{dtype: [threads a CTA, shared bytes a CTA, CTAs an SM, CTAs launched
    at 514^2]} of fullstep_kernel: the tree's own report where it exports
    tv_fullstep_shape_*, else 256 threads, no shared memory, and the CTAs
    an SM computed from the registers (the grid is then CTAs an SM x 132);
    and, where the tree exports tv_project_shape_*, {"project dtype n^2":
    [threads, shared bytes, CTAs an SM, CTAs launched, tile rows]} at each
    size."""
    out = {}
    for suffix, t in (("_f32", "f"), ("_f64", "d")):
        if hasattr(lib, "tv_fullstep_shape" + suffix):
            shape = (ctypes.c_int * 5)()
            fn = getattr(lib, "tv_fullstep_shape" + suffix)
            fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            if fn(514, 514, shape) != 0:
                raise RuntimeError("tv_fullstep_shape failed")
            out[suffix[1:]] = list(shape)[:4]
        else:
            regs = [v["regs"] for k, v in sass.items() if k == f"fullstep_kernel<{t}>"]
            ctas = ab3.occupancy(regs[0], 256, 0)[0] if regs else None
            out[suffix[1:]] = [256, 0, ctas, ctas and ctas * 132]
        if hasattr(lib, "tv_fullstep_dma_shape" + suffix):
            fn = getattr(lib, "tv_fullstep_dma_shape" + suffix)
            fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            for n in SIZES:
                shape = (ctypes.c_int * 5)()
                if fn(n + 2, n + 2, shape) != 0:
                    raise RuntimeError("tv_fullstep_dma_shape failed")
                out[f"fullstep_dma {suffix[1:]} {n + 2}^2"] = list(shape)
        if hasattr(lib, "tv_project_shape" + suffix):
            fn = getattr(lib, "tv_project_shape" + suffix)
            fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            for n in SIZES:
                shape = (ctypes.c_int * 5)()
                if fn(n + 2, n + 2, shape) != 0:
                    raise RuntimeError("tv_project_shape failed")
                out[f"project {suffix[1:]} {n + 2}^2"] = list(shape)
    return out


def call_dma(torch, K, fn, cfg, F, u, v, p, even):
    """fullstep_dma's launch through another library's entry point ``fn``,
    with the scratch its wrapper allocates."""
    g, nm = cfg.grid, cfg.num
    outs = [torch.empty_like(F) for _ in range(4)]
    scratch = torch.empty(K.scratch_cells("fullstep_dma", F.shape, F.dtype), dtype=F.dtype,
                          device=F.device)
    ins = (ctypes.c_void_p * 4)(*(t.data_ptr() for t in (F, u, v, p)))
    out_ptrs = (ctypes.c_void_p * 4)(*(t.data_ptr() for t in outs))
    status = fn(ins, out_ptrs, scratch.data_ptr(), *F.shape, 0, 0, g.nx, g.ny, nm.n_jacobi,
                int(bool(even)), K._predict_constants(cfg), K._project_constants(cfg),
                K._sweep_args(cfg, 0), K._sweep_args(cfg, 1), int(nm.fct.full_dv),
                int(nm.fct.clamp), torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError(f"stamped fullstep_dma failed: {status}")
    return outs


def leg(tree: str, sass: bool, dump: bool, stamp: bool, variants: bool) -> dict:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    import tpuvof_torch as tt
    from tpuvof_torch.kernels import build
    from tpuvof_torch.kernels import step_kernels as K

    pkg = Path(tt.__file__).resolve().parent
    if not str(pkg).startswith(tree):
        raise RuntimeError(f"imported {pkg}, not the package of {tree}")
    build.load_library()
    states = states_of(torch, tt)
    res = {"tree": tree}
    if dump:
        res["hashes"] = hash_outputs(torch, tt, K, states)
    timed = {}
    for n in SIZES:
        cfg = tt.dam_break_2d(n, num=tt.Numerics(backend="cuda_mono"))
        st = [a.float().contiguous() for a in states[n]]
        timed[f"fullstep {n + 2}^2"] = lambda cfg=cfg, st=st: K.fullstep(cfg, *st, False)
        F, u, v, p = st
        us, vs = K.predict_plain(cfg, u, v, F)
        timed[f"project {n + 2}^2"] = (lambda cfg=cfg, F=F, us=us, vs=vs, p=p, u=u, v=v:
                                       K.project(cfg, F, us, vs, p, u, v))
        if n in SLOPE_SIZES:
            for nj in SLOPE_N_JACOBI:
                c = with_jacobi(tt, cfg, nj)
                timed[f"fullstep {n + 2}^2 n_jacobi={nj}"] = (
                    lambda c=c, st=st: K.fullstep(c, *st, False))
        if n == SIZES[0]:
            blocks, (oi, oj), _ = win_block(torch, K, cfg, st)
            timed[f"fullstep_win {blocks[0].shape[0]}x{blocks[0].shape[1]}"] = (
                lambda cfg=cfg, b=blocks, oi=oi, oj=oj: K.fullstep_win(cfg, *b, oi, oj, False))
            padded, _ = strips_block(torch, K, cfg, st)
            timed[f"fullstep_strips {padded[0].shape[0]}^2"] = (
                lambda cfg=cfg, b=padded: K.fullstep_strips(cfg, *b, False))
        timed[f"fullstep_dma {n + 2}^2"] = lambda cfg=cfg, st=st: K.fullstep_dma(
            cfg, *st, False)
        if n in F64_SIZES:
            s64 = [a.double().contiguous() for a in states[n]]
            timed[f"fullstep f64 {n + 2}^2"] = lambda cfg=cfg, st=s64: K.fullstep(
                cfg, *st, False)
            timed[f"fullstep_dma f64 {n + 2}^2"] = lambda cfg=cfg, st=s64: K.fullstep_dma(
                cfg, *st, False)
    timed.update(phase_timed(torch, tt, K, states))
    if variants:
        timed.update(variant_timed(torch, tt, K, build.load_library(), states))
    res["us"] = {name: 1e3 * ab3.device_ms(torch, fn, 20) for name, fn in timed.items()}
    n = SIZES[0]
    s32 = tt.State(*(a.float().contiguous() for a in states[n]))
    for backend in ("cuda", "cuda_mono"):
        cfg = tt.dam_break_2d(n, num=tt.Numerics(backend=backend))
        s0 = tt.init_state(cfg)

        def route(cfg=cfg, s0=s0):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tt.simulate(cfg, s0, ROUTE_STEPS)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        res["us"][f"'{backend}' step {n}^2"] = 1e3 * ab3.device_ms(
            torch, lambda cfg=cfg: tt.step_pair(cfg, s32, lean=True), 10) / 2
        route()
        res["us"][f"'{backend}' route {n}^2, host clock a step"] = (
            1e6 * min(route() for _ in range(3)) / ROUTE_STEPS)
    for n in SLOPE_SIZES:
        t = [res["us"][f"fullstep {n + 2}^2 n_jacobi={nj}"] for nj in SLOPE_N_JACOBI]
        # least-squares slope of µs against n_jacobi
        mx = sum(SLOPE_N_JACOBI) / len(t)
        my = sum(t) / len(t)
        res[f"slope {n + 2}^2"] = (sum((x - mx) * (y - my) for x, y in zip(SLOPE_N_JACOBI, t))
                                   / sum((x - mx) ** 2 for x in SLOPE_N_JACOBI))
    if sass:
        res["sass"] = ab3.sass_counts(build, pkg / "csrc", SOURCES_2D)
        res["shape"] = kernel_shape(build.load_library(), res["sass"])
        res["shape"].update(phase_shapes(build.load_library()))
    if stamp:
        res["stamps"] = stamps(torch, tt, K, build, pkg / "csrc", states)
    return res


def format_marks(marks) -> str:
    """Block 0's intervals a stage group, up to its grid barrier (G) or
    the kernel's end (E): "G 4.12 [1.01 0.50 ...]", the group's µs and
    its parts between CTA barriers."""
    out, group = [], []
    for kind, us in marks:
        group.append((kind, us))
        if kind in "GE":
            total = sum(u for _, u in group)
            parts = " ".join(f"{u:.2f}" for _, u in group)
            out.append(f"{kind} {total:.2f} [{parts}]")
            group = []
    return "; ".join(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", help="TREE_A TREE_B")
    ap.add_argument("--sass", action="store_true", help="count registers and SASS")
    ap.add_argument("--stamps", action="store_true", help="time the barriers with clock64()")
    ap.add_argument("--variants", action="store_true",
                    help="also time each tree's kernels at other launch choices")
    ap.add_argument("--out", help="write the legs as JSON here")
    ap.add_argument("--leg", help=argparse.SUPPRESS)
    ap.add_argument("--dump", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.leg:
        print("LEG " + json.dumps(leg(args.leg, args.sass, args.dump, args.stamps,
                                      args.variants)))
        return 0
    if len(args.trees) != 2:
        ap.error("give two trees")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card)
    a, b = args.trees
    legs = []
    for label, tree in (("A", a), ("B", b), ("B", b), ("A", a)):
        cmd = [sys.executable, os.path.abspath(__file__), "--leg", tree]
        if len(legs) < 2:  # the first A and B legs: SASS and the outputs
            cmd += ["--dump"] + (["--sass"] if args.sass else [])
        if args.stamps:
            cmd.append("--stamps")
        if args.variants:
            cmd.append("--variants")
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout + out.stderr)
            raise SystemExit(f"leg {label} ({tree}) failed")
        res = json.loads(out.stdout.split("LEG ", 1)[1])
        res["label"] = label
        legs.append(res)
        print(f"leg {label} {tree}: " + ", ".join(f"{k} {v:.2f} us"
                                                  for k, v in res["us"].items()))
    ha, hb = legs[0]["hashes"], legs[1]["hashes"]
    bad = [k for k in ha if k.endswith("[kept]") and ha[k] != hb.get(k)]
    bad += [k for k in hb if k not in ha]
    bad += [f"{k}: A {ha[k]}, B {hb[k]}" for k in ha
            if k.endswith("[in-leg]") and (ha[k] != "True" or hb[k] != "True")]
    margins = [k for k in ha if k.endswith("[whole]") and ha[k] != hb.get(k)]
    n_kept = sum(k.endswith("[kept]") for k in ha)
    print(f"bitwise A vs B: {n_kept} outputs (fullstep and fullstep_dma {SIZES} + 2, "
          f"fullstep_win, "
          f"fullstep_strips; n_jacobi {N_JACOBI}, both parities, f32 and f64; predict and "
          f"fct_sweep at {SIZES + (N_ODD,)} + 2, predict_win and fct_sweep_win on {WIN}^2 "
          f"and {RAGGED[0]}x{RAGGED[1]} blocks at the four corners, the sweeps under "
          f"{', '.join(FCT_VARIANTS)}, f32 and f64; project at {SIZES} + 2, n_jacobi "
          f"{PROJECT_N_JACOBI[0]}-{PROJECT_N_JACOBI[-1]}, f32 and f64): "
          + ("all equal" if not bad else f"{len(bad)} differ"))
    print("fullstep_dma == fullstep bit for bit in every leg: "
          f"{ha['fullstep_dma == fullstep bit for bit [in-leg]']} / "
          f"{hb['fullstep_dma == fullstep bit for bit [in-leg]']}")
    print(f"junk margins (whole blocks of fullstep_win, fullstep_strips, predict_win, "
          f"fct_sweep_win): "
          + ("unchanged" if not margins else f"{len(margins)} of "
             f"{sum(k.endswith('[whole]') for k in ha)} changed"))
    for line in bad:
        print(f"  DIFFERS {line}")
    names = list(legs[0]["us"]) + [k for k in legs[1]["us"] if k not in legs[0]["us"]]
    print(f"[{card}] device us per call, f32, order A B B A (A = {a}, B = {b}; - where a "
          "tree has no such call):")
    for name in names:
        print(f"  {name:34s} " + " / ".join(f"{r['us'][name]:.2f}" if name in r["us"] else "-"
                                             for r in legs))
    for n in SLOPE_SIZES:
        key = f"slope {n + 2}^2"
        print(f"  Jacobi stage (slope of fullstep over n_jacobi {SLOPE_N_JACOBI}) at "
              f"{n + 2}^2: " + " / ".join(f"{r[key]:.3f}" for r in legs) + " us")
    if args.sass:
        def row(r):
            if r is None:
                return "-"
            return (f"{r.get('regs')} regs, stack {r.get('stack')} B, spill st/ld "
                    f"{r.get('spill_st')}/{r.get('spill_ld')} B, {r['sass']} SASS")

        print("ptxas and cuobjdump per kernel function (A | B):")
        for fn in sorted(set(legs[0]["sass"]) | set(legs[1]["sass"])):
            print(f"  {fn:34s} {row(legs[0]['sass'].get(fn))} | "
                  f"{row(legs[1]['sass'].get(fn))}")
        print("launch shapes, fullstep_kernel at 514^2, project, predict and fct_sweep at each "
              "size: threads/CTA, shared bytes/CTA, CTAs/SM, CTAs, tile rows (A | B): "
              f"{legs[0]['shape']} | {legs[1]['shape']}")
    if args.stamps:
        for r in legs:
            for label, st in r["stamps"].items():
                print(f"  stamps leg {r['label']} {label} (stamped kernel "
                      f"{st['kernel_us']:.2f} us): {format_marks(st['marks'])}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "legs": legs, "differ": bad},
                                             indent=1))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
