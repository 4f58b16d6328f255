#!/usr/bin/env python3
"""A/B on one CUDA card: the bulk-copy whole-step kernel against the mono.

    python3 scripts/torch_mono_dma_ab.py [N]

The counterpart of scripts/tpu_mono_dma_ab.py for tpuvof_torch. On the
N^2 dam break (default 512), f32, from init_state with the BCs applied,
it runs STEPS = 500 steps as (odd, even) parity pairs, the
order simulate takes from istep0 = 0, three times: through
``fullstep`` (the mono kernel, csrc/fullstep.cu), through
``fullstep_dma`` (csrc/fullstep_dma.cu), then through ``fullstep`` again.
Each run gets a warm-up, then the best of 3 host-clock timings between
``torch.cuda.synchronize()`` fences. It prints us/step and cell-updates/s
of each run, the trajectory's max|delta| between the two kernels (which
must be 0: the kernels do the same operations on the same values), the
dma/mono ratio beside the mono re-run's drift, and the card's name and
power limit. It exits non-zero without a CUDA card or when the
trajectories differ.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

STEPS = 500


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=512, help="interior cells per axis")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_mono_dma_ab: no CUDA card (torch.cuda.is_available() is False)")

    import tpuvof_torch as tt
    from tpuvof_torch.kernels import step_kernels as K
    from tpuvof_torch.ops import apply_bc

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    n, steps = args.n, STEPS
    cfg = tt.dam_break_2d(n, num=tt.Numerics(backend="cuda_mono"))
    s0 = tt.init_state(cfg)
    u, v, F, p = apply_bc(s0.u, s0.v, s0.F, s0.p)
    s0 = (F, u, v, p)

    def run(kernel):
        s = s0
        for _ in range(steps // 2):
            s = kernel(cfg, *s, False)
            s = kernel(cfg, *s, True)
        return s

    def timed(label, kernel):
        out = run(kernel)  # warm-up
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run(kernel)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        print(f"{label:14s}: {best / steps * 1e6:8.2f} us/step "
              f"({n * n * steps / best:.4e} cell-updates/s), best of 3", flush=True)
        return best, out

    print(f"{card}; {n}^2 f32, {steps} steps", flush=True)
    mono_t, mono_out = timed("window mono", K.fullstep)
    dma_t, dma_out = timed("dma mono", K.fullstep_dma)
    mono2_t, _ = timed("window re-run", K.fullstep)
    delta = max((a - b).abs().max().item() for a, b in zip(mono_out, dma_out))
    print(f"\n{steps}-step trajectory max|delta|: {delta:.3e} (must be 0)")
    print(f"dma/mono: {dma_t / mono_t:.4f} (re-run drift {mono2_t / mono_t:.4f}) [{card}]")
    return 0 if delta == 0.0 else 1


if __name__ == "__main__":
    sys.exit(main())
