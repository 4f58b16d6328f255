#!/usr/bin/env python3
"""The benchmark of tpuvof_torch: one run of one cell on one card.

    python portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs the cell's job loop (portbench/harness.py) for ``--seconds`` after a
set-up that builds or loads the kernel library and warms up one frame, then
checks the frames it kept against the plain reference. Prints the numbers
it compared, each beside its limit, as the last lines of standard error,
and one JSON object as the last line of standard output: with ``--trace 0``
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
from a profiled sub-window after the window. Exits non-zero, printing no
result, without a CUDA card (or fewer than the cell needs), without the
package under test, or when jax, jaxlib, flax or tpuvof was loaded.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: Top-level module names that may not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "tpuvof")


def forbidden_modules() -> list[str]:
    """Forbidden top-level names in sys.modules, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, str(ROOT))

    import torch

    from portbench.harness import load_cell, load_json, run_cell

    manifest_path = ROOT / "BENCHMARK.json"
    if not manifest_path.exists():
        print(f"error: {manifest_path} not found", file=sys.stderr)
        return 2
    cell = load_cell(args.workload, load_json(manifest_path))
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"error: the cell needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    try:
        import tpuvof_torch  # noqa: F401
    except ImportError as e:
        print(f"error: the package under test does not import: {e}", file=sys.stderr)
        return 3
    device = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T_START, kind)
    found = forbidden_modules()
    if found:
        print(f"error: modules loaded that the port may not use: {found}", file=sys.stderr)
        return 4

    if res["error"]:
        print(f"a frame failed, which ends the window:\n{res['error']}", file=sys.stderr)
    limit = power_limit()
    print(f"card: {kind}, power limit {limit}; frames kept {res['samples']}", file=sys.stderr)
    for k, v in res["notes"].items():
        print(f"note {k} = {v}", file=sys.stderr)
    for k, v in sorted(res["numbers"].items()):
        print(f"reading {k} = {v!r}", file=sys.stderr)
    for k, c in res["check"].items():
        print(f"check {k} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    device_block = {"platform": "gpu", "kind": kind, "count": cell.chips,
                    "memory_peak_bytes": res["memory_peak_bytes"], "power_limit": limit}
    device_block.update(res["device_extra"])
    out = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
           "metrics": res["metrics"], "device": device_block}
    if args.trace and res["breakdown"] is not None:
        out["breakdown"] = res["breakdown"]
    out["check"] = res["check"]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
