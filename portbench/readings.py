#!/usr/bin/env python3
"""The readings a cell's limits are set from, in one process on one card.

    python portbench/readings.py --workload <name> --seeds 1,2,... [--control] [--starts N]

For each seed: the cell's loop on the program until every frame of the
check's plan is kept, and the check of those frames, printing every number
of every kept frame (one JSON line a seed). With ``--control``, also the
control's numbers on the same frames: the reference in bfloat16 put in the
program's place, advancing each kept frame's input state (the same input
the program's frame had), with the frame's host work run on its result,
judged as the program's frame is; the frame's lines are the reference's,
computed in bfloat16 too. Set-up is paid once.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench.control import StandIn  # noqa: E402
from portbench.harness import (Loop, check, load_cell, make_route, on_device,  # noqa: E402
                               outdir_for, worst)


def control_samples(loop: Loop, stand: StandIn) -> list:
    """The kept frames recomputed by ``stand`` from their own input states,
    with the frame's host work run on the result (None where it fails)."""
    out = []
    for k, s in enumerate(loop.samples):
        s = on_device(s, loop.device)
        state, report = stand.advance(s.inp, s.steps, s.istep0)
        outputs = {}
        for f in loop.frames:
            try:
                outputs[f.name] = stand.frame_output(f.name, state)
                if outputs[f.name] is None:
                    outputs[f.name] = f.run(state, s.istep0 + s.steps, 10 ** 6 + k)
            except Exception as e:  # the control's frame failing is a reading too
                print(f"control frame {k} {f.name}: {e!r}", file=sys.stderr)
                outputs[f.name] = None
        out.append(dataclasses.replace(s, out=tuple(state), report=report, outputs=outputs))
    return out


def one(cell, seed: int, route, device, control: bool, starts: int = 0) -> dict:
    """One seed's readings; with ``starts``, instead the first ``starts``
    frames of a job from every initial state the configuration has, in
    its own order (the seed is unused)."""
    outdir = outdir_for(cell.name)
    loop = Loop(cell, seed, device, outdir, route=route)
    if starts:
        loop.jobs = sorted(loop.jobs)
        loop.steps = starts * loop.frame_every
        loop.frames_per_job = starts
        loop.plan = {j: set(range(starts)) for j in range(len(loop.jobs))}
    try:
        t0 = time.perf_counter()
        loop.warm_up()
        window_s = loop.window(0.0, until_samples=True)
        t1 = time.perf_counter()
        per_frame = check(loop)
        t2 = time.perf_counter()
        res = {"seed": seed, "error": loop.error, "frames": len(loop.spans),
               "window_s": window_s, "setup_and_window_s": t1 - t0, "check_s": t2 - t1,
               "kept": [(s.job, s.frame) for s in loop.samples],
               "per_frame": per_frame, "worst": worst(per_frame)}
        if control:
            loop.samples = control_samples(loop, StandIn(route, cell.config, torch.bfloat16))
            ctrl = check(loop)
            res["control_per_frame"] = ctrl
            res["control_worst"] = worst(ctrl)
            res["control_s"] = time.perf_counter() - t2
        return res
    finally:
        loop.close()
        shutil.rmtree(outdir, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--starts", type=int, default=0,
                   help="read the first N frames from every initial state instead")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    cell = load_cell(args.workload)
    route = make_route(cell, device)
    kind = torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"
    print(json.dumps({"workload": cell.name, "device": kind, "limits": cell.limits}), flush=True)
    for seed in (int(s) for s in args.seeds.split(",") if s):
        print(json.dumps(one(cell, seed, route, device, args.control, args.starts)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
