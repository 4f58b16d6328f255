#!/usr/bin/env python3
"""On-card smoke run of the tpuvof_torch port (PyTorch + hand-written CUDA).

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: the card's name and power limit; TF32 off.
  2. build: the kernels of tpuvof_torch/csrc, compiled from this checkout.
  3. kernel vs plain: each phase kernel against its plain PyTorch version on
     a perturbed, developed 512^2 dam-break state, in f64 and f32.
  4. golden: the 64^2 dam break through the kernels in f64 against
     tests/golden_dambreak_64_1000.npz at 300 and 1000 steps.
  5. main path: the 512^2 dam break, f32, 1000 steps through the kernels;
     launch counts, finiteness, 0 <= F <= 1, mass; the 64^2 f32 drift.
  6. timing: the 512^2 x 1000 run on the kernel path and on the plain-torch
     path (host clock), each path's step on the device alone (a replayed
     CUDA graph), and each kernel's time per launch beside its plain
     version's, on the device alone and per call from Python.

It prints one JSON line of per-kernel results and, last, the JSON status
line. With no CUDA device it exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

N_MAIN = 512  # the size bench.py has always timed
STEPS_MAIN = 1000
SEED = 0
# |kernel - plain| / max|plain| bars. f64: both sides do the same IEEE
# operations in the same order (the kernels are built with --fmad=false),
# so only rounding may differ. f32: the same, with p looser because the
# Jacobi sweeps carry rounding differences through ten iterations.
TOL_F64 = 1e-12
TOL_F32 = {"p": 1e-4}
TOL_F32_DEFAULT = 1e-5


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want| / max(max |want|, tiny), max |got - want|)."""
    diff = (got - want).abs().max().item()
    scale = max(want.abs().max().item(), torch.finfo(want.dtype).tiny)
    return diff / scale, diff


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def perturbed_state(tt, n: int, steps: int):
    """The n^2 dam break advanced ``steps`` by the plain path in f64, plus
    a seeded uniform perturbation of amplitude 1e-3, BCs applied."""
    from tpuvof_torch.ops import apply_bc

    cfg = tt.dam_break_2d(n, num=tt.Numerics(backend="torch"))
    s = tt.simulate(cfg, tt.init_state(cfg, 1, "cuda", torch.float64), steps)
    rng = np.random.default_rng(SEED)
    F, u, v, p = (a + torch.as_tensor(rng.uniform(-1e-3, 1e-3, a.shape), device="cuda")
                  for a in s)
    u, v, F, p = apply_bc(u, v, F, p)
    return tt.State(F=F, u=u, v=v, p=p)


def kernel_cases(K, cfg, s):
    """(kernel name, outputs of the kernel, outputs of its plain version,
    output names) for every phase kernel on state ``s``."""
    F, u, v, p = s
    us, vs = K.predict_plain(cfg, u, v, F)
    return [
        ("predict", K.predict(cfg, u, v, F), (us, vs), ("u*", "v*")),
        ("project", K.project(cfg, F, us, vs, p, u, v),
         K.project_plain(cfg, F, us, vs, p, u, v), ("p", "u", "v")),
        ("fct_sweep", (K.fct_sweep(cfg, F, u, 0),),
         (K.fct_sweep_plain(cfg, F, u, 0),), ("F(x)",)),
        ("fct_sweep", (K.fct_sweep(cfg, F, v, 1),),
         (K.fct_sweep_plain(cfg, F, v, 1),), ("F(y)",)),
    ]


def host_ms(fn, n: int) -> float:
    """Milliseconds per call of ``fn`` from CUDA events around ``n`` calls
    made from Python, after a warm-up: the device's time, or the host's
    where the host cannot keep the device busy."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, n: int) -> float:
    """Milliseconds per call of ``fn`` on the device alone: CUDA events
    around the replay of a CUDA graph of ``n`` calls (best of 5), so no
    host work sits between the launches."""
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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA card")
    import tpuvof_torch as tt
    from tpuvof_torch.kernels import build
    from tpuvof_torch.kernels import step_kernels as K

    # ---- 1. device ----
    card = card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} (count "
          f"{torch.cuda.device_count()}); torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}")
    tag = f"[{card}]"

    # ---- 2. build ----
    build.load_library()
    print(f"build: {build.build_seconds():.1f} s")
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    # ---- 3. kernel vs plain on the card ----
    cfg64 = tt.dam_break_2d(N_MAIN, num=tt.Numerics(backend="cuda"))
    s64 = perturbed_state(tt, N_MAIN, 50)
    results = {}
    for dtype in (torch.float64, torch.float32):
        s = tt.State(*(a.to(dtype).contiguous() for a in s64))
        for name, got, want, outs in kernel_cases(K, cfg64, s):
            torch.cuda.synchronize()
            for out_name, g_, w_ in zip(outs, got, want):
                rel, diff = rel_err(g_, w_)
                if dtype == torch.float64:
                    tol = TOL_F64
                else:
                    tol = TOL_F32.get(out_name, TOL_F32_DEFAULT)
                key = "f64" if dtype == torch.float64 else "f32"
                r = results.setdefault(name, {"rel_f64": 0.0, "rel_f32": 0.0,
                                              "abs_f32": 0.0})
                r[f"rel_{key}"] = max(r[f"rel_{key}"], rel)
                if key == "f32":
                    r["abs_f32"] = max(r["abs_f32"], diff)
                print(f"kernel vs plain {key} {name:9s} {out_name:5s} "
                      f"rel {rel:.3e} (bar {tol:.0e}) abs {diff:.3e}")
                check(rel <= tol, f"{name} {out_name} {key}: rel {rel:.3e} > {tol:.0e}")

    # ---- 4. the slice in f64 against the golden ----
    golden = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "tests", "golden_dambreak_64_1000.npz"))
    n_g = int(golden["n"])
    cfg_g = tt.dam_break_2d(n_g, num=tt.Numerics(backend="cuda"))
    s = tt.init_state(cfg_g, 1, "cuda", torch.float64)
    s300 = tt.simulate(cfg_g, s, int(golden["checkpoint"]))
    s1000 = tt.simulate(cfg_g, s300, int(golden["n_steps"]) - int(golden["checkpoint"]),
                        istep0=int(golden["checkpoint"]))
    errs = {
        "F300": np.abs(s300.F.cpu().numpy() - golden["F300"]).max(),
        "u300": np.abs(s300.u.cpu().numpy() - golden["u300"]).max(),
        "F1000": np.abs(s1000.F.cpu().numpy() - golden["F"]).max(),
        "u1000": np.abs(s1000.u.cpu().numpy() - golden["u"]).max(),
    }
    for key, err in errs.items():
        bar = 1e-8 if key.endswith("300") else 1e-5
        print(f"golden f64 {n_g}^2 {key}: {err:.3e} (bar {bar:.0e})")
        check(err <= bar, f"golden {key} {err:.3e} > {bar:.0e}")

    # ---- 5. the main path: 512^2 f32, 1000 steps through the kernels ----
    cfg = tt.dam_break_2d(N_MAIN, num=tt.Numerics(backend="cuda"))
    s0 = tt.init_state(cfg, 1, "cuda", torch.float32)
    mass0 = tt.compute_metrics(cfg, s0).mass.item()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    s_end = tt.simulate(cfg, s0, STEPS_MAIN)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    print(f"main path launches: {launches}")
    want = {"predict": STEPS_MAIN, "project": STEPS_MAIN, "fct_sweep": 2 * STEPS_MAIN}
    check(launches == want, f"launch counts {launches} != {want}")
    m = tt.compute_metrics(cfg, s_end)
    drift = abs(m.mass.item() - mass0) / mass0
    Fmin, Fmax = s_end.F.min().item(), s_end.F.max().item()
    print(f"main path {N_MAIN}^2 f32 x{STEPS_MAIN}: finite={bool(m.finite)} "
          f"F in [{Fmin:.3e}, {Fmax:.3e}] mass drift {drift:.3e} "
          f"max|u| {m.max_u.item():.3e} max|v| {m.max_v.item():.3e} "
          f"CFL ({m.cfl_u.item():.3e}, {m.cfl_v.item():.3e})")
    check(bool(m.finite), "non-finite fields")
    check(0.0 <= Fmin and Fmax <= 1.0, f"F outside [0, 1]: [{Fmin}, {Fmax}]")
    check(drift <= 1e-3, f"mass drift {drift:.3e} > 1e-3")
    s = tt.simulate(cfg_g, tt.init_state(cfg_g, 1, "cuda", torch.float32),
                    int(golden["n_steps"]))
    err32 = np.abs(s.F.double().cpu().numpy() - golden["F"]).max()
    print(f"golden f32 {n_g}^2 x{int(golden['n_steps'])} F drift {err32:.3e} (bar 5e-3)")
    check(err32 <= 5e-3, f"f32 golden drift {err32:.3e} > 5e-3")

    # ---- 6. timing ----
    cfg_plain = cfg.replace(num=tt.Numerics(backend="torch"))
    runs = {"kernel": [], "plain": []}

    def run(c):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tt.simulate(c, s0, STEPS_MAIN)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(cfg)  # warm-up
    run(cfg_plain)
    for r in range(3):  # alternate which path goes first
        order = (("kernel", cfg), ("plain", cfg_plain))
        for path, c in order if r % 2 == 0 else order[::-1]:
            runs[path].append(run(c))
    cells = N_MAIN * N_MAIN * STEPS_MAIN
    s32 = tt.State(*(a.to(torch.float32).contiguous() for a in s64))
    for path, c in (("kernel", cfg), ("plain", cfg_plain)):
        best = min(runs[path])
        step_ms = 1e3 * best / STEPS_MAIN
        # the device's own time per step: a CUDA graph of one step pair
        dev_ms = device_ms(lambda: tt.step_pair(c, s32, lean=True), 10) / 2
        print(f"{tag} {path} path {N_MAIN}^2 x{STEPS_MAIN} f32: best {best:.4f} s "
              f"of {[round(t, 4) for t in runs[path]]}, {cells / best:.4e} "
              f"cell-updates/s, {step_ms:.4f} ms/step; device alone {dev_ms:.4f} "
              f"ms/step, idle {100 * (1 - dev_ms / step_ms):.1f}% of the host-clock step")

    F, u, v, p = s32
    us, vs = K.predict_plain(cfg64, u, v, F)
    timed = {
        "predict": (lambda: K.predict(cfg64, u, v, F),
                    lambda: K.predict_plain(cfg64, u, v, F)),
        "project": (lambda: K.project(cfg64, F, us, vs, p, u, v),
                    lambda: K.project_plain(cfg64, F, us, vs, p, u, v)),
        "fct_sweep_x": (lambda: K.fct_sweep(cfg64, F, u, 0),
                        lambda: K.fct_sweep_plain(cfg64, F, u, 0)),
        "fct_sweep_y": (lambda: K.fct_sweep(cfg64, F, v, 1),
                        lambda: K.fct_sweep_plain(cfg64, F, v, 1)),
    }
    times = {}
    for name, (kern, plain) in timed.items():
        t = times[name] = {"ms": device_ms(kern, 20), "plain_ms": device_ms(plain, 20),
                           "host_ms": host_ms(kern, 200), "plain_host_ms": host_ms(plain, 20)}
        print(f"{tag} {name:11s} {N_MAIN}^2 f32: kernel {1e3 * t['ms']:.2f} us/launch "
              f"on the device ({1e3 * t['host_ms']:.2f} us per call from Python); plain "
              f"{1e3 * t['plain_ms']:.2f} us/call on the device "
              f"({1e3 * t['plain_host_ms']:.2f} us from Python)")
    # the main path runs both sweeps equally often: one entry, their mean
    times["fct_sweep"] = {k: (times["fct_sweep_x"][k] + times["fct_sweep_y"][k]) / 2
                          for k in times["fct_sweep_x"]}

    sources = {"predict": ("tpuvof_torch/csrc/predict.cu",
                           "tpuvof/pallas_kernels/step_kernels.py:444"),
               "project": ("tpuvof_torch/csrc/project.cu",
                           "tpuvof/pallas_kernels/step_kernels.py:237"),
               "fct_sweep": ("tpuvof_torch/csrc/fct_sweep.cu",
                             "tpuvof/pallas_kernels/step_kernels.py:330")}
    kernels = []
    for name, (src, rep) in sources.items():
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "launches": launches[name], "max_abs_err": r["abs_f32"],
                        "max_rel_err_f32": r["rel_f32"], "max_rel_err_f64": r["rel_f64"],
                        **times[name]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
