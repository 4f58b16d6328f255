#!/usr/bin/env python3
"""A/B of the serial 3-D kernels of two tpuvof_torch trees on one CUDA card.

    python3 scripts/torch_ab3d.py TREE_A TREE_B [--sass] [--out FILE]

Each tree is a directory holding a ``tpuvof_torch`` package (for example
the parent commit unpacked with ``git archive`` beside the working tree).
The legs run in the order A, B, B, A, each in a process of its own that
imports that tree's package, builds its kernels from that tree's sources
and times, at 200^3 f32 on a developed dam-break state, each serial 3-D
kernel (``predict3d_rhs``, ``jacobi3d`` for 10 iterations, ``correct3d``,
the three sweeps) and the serial step (a step triple), on the device alone:
CUDA events around the replay of a CUDA graph of the calls, best of 5.
With ``--sass`` each leg also compiles the tree's four 3-D sources to
cubins with the tree's own nvcc flags and counts, per kernel function, its
registers and its SASS instructions (``cuobjdump``). It prints one line
per leg, a table of the four legs, and the card's name and power limit;
``--out`` also writes the legs as JSON.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

N = 200
DEVELOP_STEPS = 20
SOURCES = ("predict3d.cu", "correct3d.cu", "fct3d.cu", "jacobi3d.cu")


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


def sass_counts(build, csrc: Path) -> dict:
    """{kernel function: [registers, SASS instructions]} of the tree's 3-D
    sources, compiled with its flags (one nvcc per source, in parallel)."""
    nvcc = build._nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    flags = [f for f in build._FLAGS if f not in ("-Xcompiler", "-fPIC")]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for src in SOURCES:
            cubin = Path(tmp) / (Path(src).stem + ".cubin")
            procs.append((cubin, subprocess.Popen(
                [nvcc, *flags, "-cubin", "-o", str(cubin), str(csrc / src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        for cubin, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {cubin.stem}.cu:\n{err}")
            regs = {}
            for m in re.finditer(r"Compiling entry function '(\w+)'.*?Used (\d+) registers",
                                 err, re.S):
                regs[m.group(1)] = int(m.group(2))
            dump = subprocess.run([cuobjdump, "-sass", str(cubin)], capture_output=True,
                                  text=True, check=True).stdout
            for block in dump.split("Function : ")[1:]:
                mangled = block.split()[0]
                n_ins = len(re.findall(r"/\*[0-9a-f]{4,}\*/", block))
                # the kernel and its template arguments, without the
                # per-file namespace hash, so the two trees' names match
                short = re.search(r"((?:predict3d|kappa3d|correct3d|fct3d|jacobi3d)_kernel)"
                                  r"I(\w*?)EEvP", mangled)
                key = f"{short.group(1)}<{short.group(2)}>" if short else mangled
                out[key] = [regs.get(mangled), n_ins]
    return out


def leg(tree: str, sass: bool) -> dict:
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
    s = S3._with_bc(tt.simulate_3d(g, tt.init_state_3d(g), DEVELOP_STEPS))
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

    def triple():
        for ph in (1, 2, 0):
            S3._step_3d_cuda_lean(g, fl, dt, 10, s, ph, "jacobi", 1.7, 1e-3, 200, False, 0.0)

    res = {"tree": tree, "us": {name: 1e3 * device_ms(torch, fn, 20)
                                for name, fn in timed.items()}}
    res["us"]["step"] = 1e3 * device_ms(torch, triple, 5) / 3
    if sass:
        res["sass"] = sass_counts(build, pkg / "csrc")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", help="TREE_A TREE_B")
    ap.add_argument("--sass", action="store_true", help="count registers and SASS")
    ap.add_argument("--out", help="write the legs as JSON here")
    ap.add_argument("--leg", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.leg:
        print("LEG " + json.dumps(leg(args.leg, args.sass)))
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
        if args.sass and len(legs) < 2:
            cmd.append("--sass")
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout + out.stderr)
            raise SystemExit(f"leg {label} ({tree}) failed")
        res = json.loads(out.stdout.split("LEG ", 1)[1])
        res["label"] = label
        legs.append(res)
        print(f"leg {label} {tree}: " + ", ".join(f"{k} {v:.2f} us"
                                                  for k, v in res["us"].items()))
    names = list(legs[0]["us"])
    print(f"[{card}] device us per call, 200^3 f32, order A B B A "
          f"(A = {a}, B = {b}):")
    for name in names:
        print(f"  {name:16s} " + " / ".join(f"{r['us'][name]:.2f}" for r in legs))
    if args.sass:
        print("registers, SASS instructions (A | B):")
        for fn in sorted(set(legs[0]["sass"]) | set(legs[1]["sass"])):
            print(f"  {fn:40s} {legs[0]['sass'].get(fn)} | {legs[1]['sass'].get(fn)}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "legs": legs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
