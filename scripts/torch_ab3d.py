#!/usr/bin/env python3
"""A/B of the 3-D kernels of two tpuvof_torch trees on one CUDA card.

    python3 scripts/torch_ab3d.py TREE_A TREE_B [--sass] [--out FILE]

Each tree is a directory holding a ``tpuvof_torch`` package (for example
the parent commit unpacked with ``git archive`` into a git-ignored
directory of the checkout, against ``.``). The legs run in the order A, B, B, A,
each in a process of its own that imports that tree's package and builds
its kernels from that tree's sources. On a 200^3 dam-break state developed
for 20 steps on the plain path (which both trees share, so both legs'
kernels see the same inputs), each leg:

- times on the device alone (CUDA events around the replay of a CUDA graph
  of the calls, best of 5), in f32: each serial 3-D kernel
  (``predict3d_rhs``, ``jacobi3d`` for 10 iterations, ``correct3d``, the
  three sweeps, and the z sweep with ``mirror_out``), ``predict3d_rhs``,
  ``jacobi3d`` and the three sweeps on the 2x2 pencil engine's block of
  shard (1, 1), ``jacobi3d`` for 10 iterations on the four-card cell's
  block (the 2x2 pencil engine's block of shard (1, 1) of a 1152^3 grid,
  606 x 606 x 1154, random values), the serial step (a step triple,
  without and with csf), the
  csf route's host-clock ms/step (``simulate_3d(csf=True)``, 100 steps from
  the initial state, best of 3), ``predict3d_rhs`` with
  csf, serial and on the pencil block (and its curvature pre-pass
  ``kappa3d_kernel`` alone, from torch.profiler's device activity where it
  shows one), and, in
  a tree whose plan has a depth (``JACOBI_LEVELS``), ``jacobi3d`` at every
  depth up to it on the three blocks (the whole grid, the small and the
  large pencil block), and, in a tree that reports it
  (``jacobi3d_geometry``), the launch of each depth on the whole grid and
  the large pencil block: its CTAs, planes a chunk and the cell-levels its
  threads compute over the block's;
- the first A and B legs also write every output of ``predict3d_rhs``
  (csf off and on), ``jacobi3d`` (1, 2, 3 and 10 iterations) and
  ``fct3d_sweep`` (x, y and z, with and without ``mirror_out``, at a
  step of 4e-4 on velocities perturbed by 0.5 from a seed, so that the
  limiter fires), f32 and f64, on the whole grid, an i-slab (gi_base 40)
  and the pencil block, and of ``predict3d_rhs`` with csf on the same
  blocks of the dam break's noise-free initial state (F exactly 0 or 1:
  degenerate normals and zero differences almost everywhere); the
  script compares A's and B's with ``torch.equal`` and exits 1 unless all
  are equal (a redesign that changes only where values are computed keeps
  them bit for bit);
- with ``--sass``, the first A and B legs compile the tree's four 3-D
  sources to cubins with the tree's own nvcc flags and report, per kernel
  function, ptxas's registers, stack frame and spill stores and loads
  (``-Xptxas -v``) and the SASS instruction count (``cuobjdump``), and the
  launch shape of ``predict3d_kernel``, ``jacobi3d_kernel`` and each
  sweep's kernel (threads and shared bytes a CTA, CTAs resident an SM; for
  a ``jacobi3d_kernel`` that reports them, the k positions a thread
  computes, the region's rows and columns and its owned share).

It prints one line per leg, the comparison, a table of the four legs, and
the card's name and power limit; ``--out`` also writes the legs as JSON.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

N = 200
DEVELOP_STEPS = 20
SLAB = (40, 50)  # (gi_base, nloc) of the i-slab
PENCIL_SHARD = (1, 1)  # of the 2x2 engine: gi_base = gj_base = 86
PENCIL_SHAPE = (130, 130, 202)
BIG_N = 1152  # the four-card cell's grid: its 2x2 engine's block of shard (1, 1)
BIG_SHAPE = (606, 606, 1154)
N_ITERS = (1, 2, 3, 10)
SOURCES = ("predict3d.cu", "correct3d.cu", "fct3d.cu", "jacobi3d.cu")
DT_SWEEP = 4e-4  # the sweeps' dump: Courant numbers up to ~0.3, the limiter fires
VEL_NOISE = 0.5
CSF_STEPS = 100  # the csf route's host-clock run, as chip_smoke.py's


def device_ms(torch, fn, n: int) -> float:
    """ms per call of ``fn`` on the device alone: the replay of a CUDA graph
    of ``n`` calls between CUDA events, best of 5."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / n)
    return best


def profiled_us(torch, fn, n: int, kernel: str) -> float | None:
    """Mean device µs of the launches of kernels whose name holds
    ``kernel`` over ``n`` calls of ``fn``, from torch.profiler's CUDA
    activity; None where the profiler shows no device time for it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if kernel in ev.key:
            total += getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0.0))
            count += ev.count
    return total / count if count and total > 0 else None


def occupancy(regs: int, threads: int, smem: int) -> tuple[int, float]:
    """(CTAs resident per SM, share of the SM's 64 warp slots) of a kernel
    with ``regs`` registers a thread, ``threads`` a CTA and ``smem`` bytes of
    shared memory a CTA, on an H100 SM (65536 registers allocated in units
    of 256 a warp, 2048 threads, 32 CTAs, 228 KB of shared memory of which
    1 KB a CTA is reserved)."""
    warps = -(-threads // 32)
    per_warp = -(-regs * 32 // 256) * 256
    ctas = min(32, 2048 // threads, (65536 // per_warp) // warps,
               233472 // (smem + 1024))
    return ctas, ctas * warps / 64


def kernel_key(mangled: str) -> str | None:
    """``name<template arguments>`` of a mangled kernel function, without
    its namespaces (an anonymous namespace's name carries a per-file hash,
    so the two trees' names would not match): the last length-prefixed
    name of the nested name, then the arguments up to the end of the
    template argument list."""
    if not mangled.startswith("_ZN"):
        return None
    pos, name = 3, None
    while pos < len(mangled) and mangled[pos].isdigit():
        end = pos
        while mangled[end].isdigit():
            end += 1
        size = int(mangled[pos:end])
        name, pos = mangled[end:end + size], end + size
    args = re.match(r"I(\w*?)EEv", mangled[pos:])
    return f"{name}<{args.group(1)}>" if name and args else None


def sass_counts(build, csrc: Path, sources=SOURCES) -> dict:
    """{kernel function: {regs, stack, spill_st, spill_ld, sass}} of the
    tree's ``sources`` (its 3-D ones by default), compiled with its flags
    (one nvcc per source, in
    parallel): ptxas's registers, stack frame and spill stores and loads
    in bytes (``-Xptxas -v``), and the SASS instruction count
    (``cuobjdump``)."""
    nvcc = build._nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    flags = [f for f in build._FLAGS if f not in ("-Xcompiler", "-fPIC")]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for src in sources:
            cubin = Path(tmp) / (Path(src).stem + ".cubin")
            procs.append((cubin, subprocess.Popen(
                [nvcc, *flags, "-cubin", "-o", str(cubin), str(csrc / src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        for cubin, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {cubin.stem}.cu:\n{err}")
            ptxas = {}
            for chunk in err.split("Compiling entry function '")[1:]:
                name = chunk.split("'", 1)[0]
                frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                                  r"(\d+) bytes spill loads", chunk)
                regs = re.search(r"Used (\d+) registers", chunk)
                ptxas[name] = {"regs": int(regs.group(1)) if regs else None,
                               **dict(zip(("stack", "spill_st", "spill_ld"),
                                          map(int, frame.groups() if frame else (-1,) * 3)))}
            dump = subprocess.run([cuobjdump, "-sass", str(cubin)], capture_output=True,
                                  text=True, check=True).stdout
            for block in dump.split("Function : ")[1:]:
                mangled = block.split()[0]
                n_ins = len(re.findall(r"/\*[0-9a-f]{4,}\*/", block))
                # the kernel and its template arguments, without the
                # per-file namespace hash, so the two trees' names match
                short = kernel_key(mangled)
                key = short or mangled
                out[key] = {**ptxas.get(mangled, {}), "sass": n_ins}
    return out


def launch_shapes(lib, sass: dict, depth: int | None) -> dict:
    """{kernel: [threads a CTA, shared bytes a CTA, CTAs resident per SM,
    share of the SM's warp slots]} of predict3d_kernel, jacobi3d_kernel
    (at ``depth`` iterations a launch) and the sweeps' kernels on the whole
    grid without csf, f32 and f64. A tree whose library reports its launch shapes (``tv_*_shape``,
    with the runtime's own occupancy) is read; an older one launches 32 x 8
    threads with no shared memory (``tv::block3d()``) and is computed from
    its registers."""
    out = {}
    for kern, stem in (("predict3d", "tv_predict3d_shape"), ("jacobi3d", "tv_jacobi3d_shape")):
        for suffix, t in (("_f32", "f"), ("_f64", "d")):
            label = f"{kern} {suffix[1:]}"
            if hasattr(lib, stem + suffix):
                # room for jacobi3d's eight (a tree whose export has three
                # leaves the rest 0)
                shape = (ctypes.c_int * 8)()
                args = (0, 0, shape) if kern == "predict3d" else (0, depth, shape)
                if getattr(lib, stem + suffix)(*args) != 0:
                    raise RuntimeError(f"{stem}{suffix} failed")
                threads, smem, ctas, run, rows, cols, own_k, own_j = shape
                out[label] = [threads, smem, ctas, ctas * threads / 2048]
                if run:  # k positions a thread, region rows x columns, owned share
                    out[label] += [run, f"{rows}x{cols}", own_k * own_j / (rows * cols)]
            else:
                regs = [v["regs"] for k, v in sass.items()
                        if k.startswith(f"{kern}_kernel<{t}Lb0")]
                out[label] = [256, 0, *occupancy(regs[0], 256, 0)] if regs else None
    for axis in range(3):
        for suffix, t in (("_f32", "f"), ("_f64", "d")):
            label = f"fct3d {'xyz'[axis]} {suffix[1:]}"
            if hasattr(lib, "tv_fct3d_shape" + suffix):
                shape = (ctypes.c_int * 3)()
                fn = getattr(lib, "tv_fct3d_shape" + suffix)
                fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
                if fn(axis, 0, shape) != 0:
                    raise RuntimeError(f"tv_fct3d_shape{suffix} failed")
                threads, smem, ctas = shape
                out[label] = [threads, smem, ctas, ctas * threads / 2048]
            else:
                regs = [v["regs"] for k, v in sass.items()
                        if k.startswith(f"fct3d_kernel<{t}Li{axis}E")]
                out[label] = [256, 0, *occupancy(max(regs), 256, 0)] if regs else None
    return out


def jacobi_geometry(K3, depth: int) -> dict:
    """{block: [CTAs along k, j, l, planes a chunk, computed over owned
    cell-levels]} of jacobi3d at ``depth`` levels a launch, f32, on the
    whole 202^3 grid and the large pencil block, from a tree that reports
    its launch (``jacobi3d_geometry``); {} from one that does not."""
    if not hasattr(K3, "jacobi3d_geometry"):
        return {}
    out = {}
    for label, shape, pencil in (("grid", (N + 2,) * 3, False), ("big pencil", BIG_SHAPE, True)):
        geo = K3.jacobi3d_geometry(shape, depth, pencil=pencil)
        out[label] = [*geo["grid"], geo["chunk"], geo["computed_over_owned"]]
    return out


def big_pencil(torch, tt):
    """(grid, p, rhs, origin) of the four-card cell's block (2x2 engine, shard
    (1, 1) of a BIG_N^3 grid), f32, random values: the Jacobi's time does
    not depend on them."""
    from tpuvof_torch.parallel import Decomp3D, make_mesh

    g = tt.Grid3D(BIG_N, BIG_N, BIG_N)
    dec = Decomp3D(g, make_mesh(devices=[torch.device("cuda")] * 4))
    org = dec.origin(dec.coords.index(PENCIL_SHARD))
    gen = torch.Generator(device="cuda").manual_seed(0)
    p, rhs = (torch.randn(BIG_SHAPE, device="cuda", generator=gen) for _ in range(2))
    return g, p, rhs, org


def blocks_of(tt, g, s, dtype):
    """(tag, state, origin) of the three block kinds the kernels run on: the
    whole grid, an i-slab with gi_base != 0, and the 2x2 pencil engine's
    block of shard (1, 1) (its high x and y walls mid-block)."""
    from tpuvof_torch.parallel import Decomp3D, make_mesh

    s = tt.State3D(*(a.to(dtype).contiguous() for a in s))
    gi0, nloc = SLAB
    slab = tt.State3D(*(a[gi0:gi0 + nloc + 2].contiguous() for a in s))
    dec = Decomp3D(g, make_mesh(devices=[s.F.device] * 4))
    k = dec.coords.index(PENCIL_SHARD)
    pencil = dec.widen(dec.scatter_state(s))[k]
    return (("grid", s, {}), (f"slab@{gi0}", slab, {"gi_base": gi0}),
            (f"pencil{PENCIL_SHARD}", pencil, dec.origin(k)))


def dump_outputs(torch, tt, K3, g, fl, dt, s, s_init, where: Path) -> list[str]:
    """Write every compared output of predict3d_rhs (csf off and on),
    jacobi3d (N_ITERS, from the plain version's rhs, so that both trees'
    Jacobi inputs are the same) and fct3d_sweep (each axis, with and
    without mirror_out, at DT_SWEEP on velocities with seeded noise), f32
    and f64, on each block kind, and of predict3d_rhs with csf on each
    block kind of the initial state ``s_init``, one file each under
    ``where``; returns their names in order."""
    import numpy as np

    rng = np.random.default_rng(0)
    noise = [torch.as_tensor(rng.uniform(-VEL_NOISE, VEL_NOISE, s.F.shape), device=s.F.device)
             for _ in range(3)]
    s_sw = tt.State3D(s.F, *(a + d for a, d in zip((s.u, s.v, s.w), noise)), s.p)
    sweep_blocks = {dtype: blocks_of(tt, g, s_sw, dtype)
                    for dtype in (torch.float32, torch.float64)}
    names = []

    def put(name, t):
        torch.save(t.cpu(), where / f"{len(names)}.pt")
        names.append(name)

    for dtype in (torch.float32, torch.float64):
        for tag, (F, u, v, w, p), org in blocks_of(tt, g, s, dtype):
            key = f"{tag} {str(dtype)[6:]}"
            for field, t in zip("Fuvwp", (F, u, v, w, p)):
                put(f"{key} input {field}", t)
            for csf in (False, True):
                outs = K3.predict3d_rhs(g, fl, dt, u, v, w, F, csf, **org)
                for out_name, t in zip(("u*", "v*", "w*", "rhs"), outs):
                    put(f"{key} predict3d_rhs csf={csf} {out_name}", t)
            rhs = K3.predict3d_rhs_plain(g, fl, dt, u, v, w, F, False, **org)[3]
            for n in N_ITERS:
                put(f"{key} jacobi3d n_iter={n}", K3.jacobi3d(g, n, p, rhs, **org))
            Fs, us_, vs_, ws_, _ = next(b[1] for b in sweep_blocks[dtype] if b[0] == tag)
            for axis, vel in enumerate((us_, vs_, ws_)):
                for mirror in (False, True):
                    put(f"{key} fct3d_sweep axis={'xyz'[axis]} mirror_out={mirror}",
                        K3.fct3d_sweep(g, DT_SWEEP, Fs, vel, axis, mirror, **org))
            torch.cuda.synchronize()
        for tag, (F, u, v, w, _), org in blocks_of(tt, g, s_init, dtype):
            outs = K3.predict3d_rhs(g, fl, dt, u, v, w, F, True, **org)
            for out_name, t in zip(("u*", "v*", "w*", "rhs"), outs):
                put(f"{tag} {str(dtype)[6:]} initial state predict3d_rhs csf=True {out_name}", t)
            torch.cuda.synchronize()
    return names


def leg(tree: str, sass: bool, dump: str | None) -> dict:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    import tpuvof_torch as tt
    from tpuvof_torch import solver3d as S3
    from tpuvof_torch.kernels import build
    from tpuvof_torch.kernels import step3d_kernels as K3

    pkg = Path(tt.__file__).resolve().parent
    if not str(pkg).startswith(tree):
        raise RuntimeError(f"imported {pkg}, not the package of {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load_library()
    g = tt.Grid3D(N, N, N)
    fl = tt.Fluid()
    dt = 4e-6
    # developed on the plain path, which both trees share, so that both
    # legs' kernels see the same inputs
    s_init = S3._with_bc(tt.init_state_3d(g))
    s = S3._with_bc(tt.simulate_3d(g, tt.init_state_3d(g), DEVELOP_STEPS, backend="torch"))
    res = {"tree": tree}
    if dump:
        res["outputs"] = dump_outputs(torch, tt, K3, g, fl, dt, s, s_init, Path(dump))
    F, u, v, w, p = s
    us, vs, ws, rhs = K3.predict3d_rhs(g, fl, dt, u, v, w, F)
    timed = {
        "predict3d_rhs": lambda: K3.predict3d_rhs(g, fl, dt, u, v, w, F),
        "jacobi3d (10)": lambda: K3.jacobi3d(g, 10, p, rhs),
        "correct3d": lambda: K3.correct3d(g, fl, dt, us, vs, ws, p, F),
    }
    for axis, vel in enumerate((u, v, w)):
        timed[f"fct3d_sweep {'xyz'[axis]}"] = (
            lambda axis=axis, vel=vel: K3.fct3d_sweep(g, dt, F, vel, axis))
    timed["fct3d_sweep z mirror_out"] = lambda: K3.fct3d_sweep(g, dt, F, w, 2, True)
    _, (Fp, up, vp, wp, pp), org = blocks_of(tt, g, s, torch.float32)[2]
    rhs_p = K3.predict3d_rhs(g, fl, dt, up, vp, wp, Fp, **org)[3]
    timed["pencil predict3d_rhs"] = lambda: K3.predict3d_rhs(g, fl, dt, up, vp, wp, Fp, **org)
    timed["pencil jacobi3d (10)"] = lambda: K3.jacobi3d(g, 10, pp, rhs_p, **org)
    for axis, vel in enumerate((up, vp, wp)):
        timed[f"pencil fct3d_sweep {'xyz'[axis]}"] = (
            lambda axis=axis, vel=vel: K3.fct3d_sweep(g, dt, Fp, vel, axis, **org))

    nm = S3.numerics_3d(g, dt=dt, n_jacobi=10)

    def triple(csf=False):
        for ph in (1, 2, 0):
            S3._step_3d_cuda_lean(g, fl, nm, csf, s, ph)

    def csf_route():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tt.simulate_3d(g, s_init, CSF_STEPS, csf=True)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    res["us"] = {name: 1e3 * device_ms(torch, fn, 20) for name, fn in timed.items()}
    res["us"]["step"] = 1e3 * device_ms(torch, triple, 5) / 3
    res["us"]["step csf"] = 1e3 * device_ms(torch, lambda: triple(True), 5) / 3
    csf_route()
    res["us"]["csf route, host clock a step"] = 1e6 * min(csf_route() for _ in range(3)) / CSF_STEPS
    res["us"]["predict3d_rhs csf"] = 1e3 * device_ms(
        torch, lambda: K3.predict3d_rhs(g, fl, dt, u, v, w, F, True), 20)
    res["us"]["pencil predict3d_rhs csf"] = 1e3 * device_ms(
        torch, lambda: K3.predict3d_rhs(g, fl, dt, up, vp, wp, Fp, True, **org), 20)
    for label, call in (
            ("", lambda: K3.predict3d_rhs(g, fl, dt, u, v, w, F, True)),
            ("pencil ", lambda: K3.predict3d_rhs(g, fl, dt, up, vp, wp, Fp, True, **org))):
        kappa = profiled_us(torch, call, 20, "kappa3d_kernel")
        if kappa is not None:
            res["us"][f"{label}kappa3d_kernel (profiler)"] = kappa
    gb, pb, rb, orgb = big_pencil(torch, tt)

    def big():
        return K3.jacobi3d(gb, 10, pb, rb, **orgb)

    # 3 calls a graph: each call's two 1.7 GB blocks
    res["us"]["big pencil jacobi3d (10)"] = 1e3 * device_ms(torch, big, 3)
    if hasattr(K3, "JACOBI_LEVELS"):  # the Jacobi at each depth a launch
        chosen = K3.JACOBI_LEVELS
        res["geometry"] = {}
        for depth in range(1, chosen + 1):
            K3.JACOBI_LEVELS = depth
            res["us"][f"jacobi3d (10) depth {depth}"] = 1e3 * device_ms(
                torch, timed["jacobi3d (10)"], 20)
            res["us"][f"pencil jacobi3d (10) depth {depth}"] = 1e3 * device_ms(
                torch, timed["pencil jacobi3d (10)"], 20)
            res["us"][f"big pencil jacobi3d (10) depth {depth}"] = 1e3 * device_ms(
                torch, big, 3)
            res["geometry"][depth] = jacobi_geometry(K3, depth)
        K3.JACOBI_LEVELS = chosen
    del pb, rb
    if sass:
        res["sass"] = sass_counts(build, pkg / "csrc")
        res["occupancy"] = launch_shapes(build.load_library(), res["sass"],
                                         getattr(K3, "JACOBI_LEVELS", None))
    return res


def compare(torch, dir_a: Path, names_a: list, dir_b: Path, names_b: list) -> list[str]:
    """The names of the outputs that differ between the two dumps (not
    torch.equal), with their max |A - B|."""
    if names_a != names_b:
        return [f"the legs dumped different outputs: {names_a} != {names_b}"]
    bad = []
    for i, name in enumerate(names_a):
        a = torch.load(dir_a / f"{i}.pt")
        b = torch.load(dir_b / f"{i}.pt")
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
            diff = (a.double() - b.double()).abs().max().item() if a.shape == b.shape else None
            bad.append(f"{name}: max|A - B| {diff}")
    return bad


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", help="TREE_A TREE_B")
    ap.add_argument("--sass", action="store_true", help="count registers and SASS")
    ap.add_argument("--out", help="write the legs as JSON here")
    ap.add_argument("--leg", help=argparse.SUPPRESS)
    ap.add_argument("--dump", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.leg:
        print("LEG " + json.dumps(leg(args.leg, args.sass, args.dump)))
        return 0
    if len(args.trees) != 2:
        ap.error("give two trees")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card)
    a, b = args.trees
    legs = []
    dumps = tempfile.TemporaryDirectory()
    for label, tree in (("A", a), ("B", b), ("B", b), ("A", a)):
        cmd = [sys.executable, os.path.abspath(__file__), "--leg", tree]
        if len(legs) < 2:  # the first A and B legs: SASS and the outputs
            where = Path(dumps.name) / label
            where.mkdir()
            cmd += ["--dump", str(where)] + (["--sass"] if args.sass else [])
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout + out.stderr)
            raise SystemExit(f"leg {label} ({tree}) failed")
        res = json.loads(out.stdout.split("LEG ", 1)[1])
        res["label"] = label
        legs.append(res)
        print(f"leg {label} {tree}: " + ", ".join(f"{k} {v:.2f} us"
                                                  for k, v in res["us"].items()))
    import torch

    bad = compare(torch, Path(dumps.name) / "A", legs[0]["outputs"],
                  Path(dumps.name) / "B", legs[1]["outputs"])
    dumps.cleanup()
    n_out = len(legs[0]["outputs"])
    print(f"bitwise A vs B: {n_out} tensors (inputs, predict3d_rhs csf off and on, jacobi3d "
          f"n_iter {N_ITERS}, fct3d_sweep x/y/z with and without mirror_out; predict3d_rhs "
          "csf on the initial state; f32 and f64; grid, slab, pencil block): "
          + ("all torch.equal" if not bad else f"{len(bad)} differ"))
    for line in bad:
        print(f"  DIFFERS {line}")
    names = [k for k in legs[0]["us"] if all(k in r["us"] for r in legs)]
    print(f"[{card}] device us per call, f32, 200^3 and the pencil block "
          f"{PENCIL_SHAPE}, order A B B A (A = {a}, B = {b}):")
    for name in names:
        print(f"  {name:22s} " + " / ".join(f"{r['us'][name]:.2f}" for r in legs))
    for name in sorted(set(legs[1]["us"]) - set(names)):
        print(f"  {name:22s} B only: " + " / ".join(
            f"{r['us'][name]:.2f}" for r in legs if name in r["us"]))
    for lab, res in (("A", legs[0]), ("B", legs[1])):
        for depth, geo in res.get("geometry", {}).items():
            for block, (gx, gy, gz, lc, ratio) in geo.items():
                print(f"jacobi3d launch {lab} depth {depth} {block}: {gx} x {gy} x {gz} CTAs "
                      f"({gx * gy * gz}), {lc} planes a chunk, computed / owned cell-levels "
                      f"{ratio:.3f}")
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
        print("launch shape: threads/CTA, shared bytes/CTA, CTAs/SM, warp-slot share (A | B):")
        for k in legs[0]["occupancy"]:
            print(f"  {k:14s} {legs[0]['occupancy'][k]} | {legs[1]['occupancy'][k]}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "legs": legs, "differ": bad},
                                             indent=1))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
