"""The command line (counterpart of tpuvof/cli.py).

CLI parity with the reference (`-ic {1,2,3}` and `-s`, 2dvof.py:11-17) plus
the knobs the reference hard-codes as module constants: grid size, step
count, frame cadence, view mode, checkpointing. Headless by design: frames
render on the card and land as PNGs (the reference's interactive GUI
window is replaced by the frame stream; the SPACE-cycled view modes map to
--view / --cycle-views).

Every flag, default, message, file name and exit code is tpuvof's, except:
--backend names the port's routes (default 'cuda', the port's own
Numerics default); --device {cuda,cpu} (default cuda) places the state,
and nothing falls back to the CPU: without a card, --device cuda is an
error, as is a 'cuda*' backend on --device cpu. --mesh PX,PY runs the
port's Decomp and --three-d --mesh its Decomp3D: --backend torch on any
mesh whose sizes divide the grid, a 'cuda*' backend on the kernel engines
(or the hybrid with --pressure-solver rbsor/mg/auto), which exit 2 on a
mesh too fine for their halo where tpuvof falls back to its XLA engine.
--three-d --mesh keeps the shards resident on their cards from the first
step to the last: each card makes its own initial block, and each frame's
mass and range line comes from per-card reductions; only a VTK frame or a
checkpoint gathers the whole grid, to the host.
--plan-mesh N ranks the mesh shapes with the port's planner.

Usage examples:
  python -m tpuvof_torch -ic 1 -s --steps 2000 --backend cuda_mono
  python -m tpuvof_torch -ic 2 --nx 256 --steps 10000 --frame-every 500 --view vnorm
  python -m tpuvof_torch --resume output/ckpt_001000.npz --steps 1000
  python -m tpuvof_torch --three-d --nx 200 --steps 1000
  python -m tpuvof_torch --device cpu --backend torch --nx 64 --steps 200
  python -m tpuvof_torch --mesh 2,2 --nx 512 --steps 1000 --backend cuda_mono
  python -m tpuvof_torch --three-d --nx 1152 --mesh 2,2 --no-frames --steps 2000
  python -m tpuvof_torch --plan-mesh 8 --nx 1024
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from .utils.profiling import span

BACKENDS = ["torch", "cuda", "cuda_mono", "cuda_tiled", "cuda_strips"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpuvof_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    # reference-parity flags (2dvof.py:11-17)
    p.add_argument("-ic", type=int, choices=[1, 2, 3], default=1,
                   help="initial condition: 1 dam break, 2 rising bubble, 3 liquid drop")
    p.add_argument("-s", action="store_true", dest="save_fig",
                   help="also save the reference-style contourf PNG per frame")
    # grid / physics
    p.add_argument("--nx", type=int, default=200)
    p.add_argument("--ny", type=int, default=None, help="defaults to nx")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--dt", type=float, default=4e-6)
    p.add_argument("--jacobi", type=int, default=10, help="pressure iterations per step")
    p.add_argument("--backend", choices=BACKENDS, default="cuda",
                   help="step implementation: plain torch ops, the hand-written "
                        "phase kernels, the whole-step kernel on the grid "
                        "(one launch a step), on halo tiles, or on the strips "
                        "engine's padded resident layout; --three-d runs "
                        "'cuda' for every cuda* choice")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the state lives: the card (default; an error "
                        "without one) or the CPU (with --backend torch)")
    p.add_argument("--no-cfl-warn", action="store_true",
                   help="disable the per-step Courant tracking (the "
                        "reference's in-kernel CFL warning, surfaced at "
                        "frame boundaries with the exact step/cell; "
                        "2-D serial runs only)")
    p.add_argument("--pressure-solver",
                   choices=["jacobi", "rbsor", "mg", "auto"],
                   default="jacobi", dest="pressure_solver",
                   help="jacobi = reference-parity fixed sweeps; rbsor = "
                        "residual-driven red-black SOR; mg = residual-driven "
                        "geometric multigrid; auto = mg wherever the grid "
                        "coarsens (all extents even and >= 8), rbsor "
                        "otherwise")
    p.add_argument("--sor-tol", type=float, default=1e-3, dest="sor_tol",
                   help="absolute residual tolerance for the rbsor/mg "
                        "pressure upgrades (max|Ap-rhs| on the projected "
                        "system)")
    p.add_argument("--sor-tol-rel", type=float, default=0.0,
                   dest="sor_tol_rel",
                   help="relative residual tolerance for rbsor/mg: stop at "
                        "max(--sor-tol, REL * max|rhs|) per solve, the "
                        "bounded-cost production mode. Try 1e-2.")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the run to this dir")
    # output
    p.add_argument("--frame-every", type=int, default=100, dest="frame_every",
                   help="steps between frames (reference nstep, 2dvof.py:497)")
    p.add_argument("--view", choices=["vof", "u", "v", "vnorm", "vectors"],
                   default="vof")
    p.add_argument("--cycle-views", action="store_true",
                   help="advance the view mode every frame (like SPACE in the reference GUI)")
    p.add_argument("--outdir", default="output")
    p.add_argument("--no-frames", action="store_true",
                   help="metrics only, no PNGs (with --three-d: no VTK volumes; "
                        "with --three-d --mesh a VTK frame gathers the whole F "
                        "to the host, 6 GB at 1152^3)")
    p.add_argument("--gif", action="store_true",
                   help="assemble the run's frames into <outdir>/movie.gif "
                        "(replaces the reference's `ti video`/`ti gif` step)")
    # checkpointing (superset of the reference)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", default=None, help="npz checkpoint to resume from")
    # advection-only scheme cases (test/forward_fct.py equivalents)
    p.add_argument("--case", default=None,
                   choices=[None, "single_vortex", "zalesak_disk", "translation",
                            "checkerboard"],
                   help="run a pure-advection scheme case instead of the NS solver")
    # differentiable optimisation (diff_vof.py equivalent)
    p.add_argument("--optimize", type=int, choices=[1, 2, 3], default=None,
                   help="optimize F0 toward the diff target shape for this ic")
    p.add_argument("--target-npy", default=None,
                   help="optimize F0 toward a target loaded from a .npy file "
                        "(painted-target replacement)")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--opt-steps", type=int, default=999, dest="opt_steps",
                   help="forward steps per optimization epoch")
    p.add_argument("--view-every", type=int, default=0, dest="view_every",
                   metavar="N",
                   help="during --optimize, render current-vs-target every "
                        "N steps INSIDE each epoch's forward (the "
                        "reference's in-forward rendering, "
                        "diff_vof.py:524-554); 0 = per-epoch frames only")
    p.add_argument("--optimize-case", default=None, dest="optimize_case",
                   choices=[None, "single_vortex", "zalesak_disk", "translation",
                            "checkerboard"],
                   help="gradient-optimize F0 through pure advection toward "
                        "the case's target (test/diff_fct.py equivalent)")
    p.add_argument("--adjoint", choices=["unrolled", "selfadjoint"],
                   default="selfadjoint",
                   help="pressure-solve adjoint: selfadjoint runs the "
                        "hand-written adjoints; unrolled differentiates "
                        "through the iterations")
    # 3-D mode (3dvof.py equivalent: dam break + VTK dumps)
    p.add_argument("--three-d", action="store_true", dest="three_d",
                   help="run the 3-D dam break (VTK volume every frame interval)")
    p.add_argument("--csf", action="store_true",
                   help="with --three-d: enable 3-D surface tension (Youngs "
                        "normals + Brackbill curvature), an upgrade over the "
                        "reference, whose 3-D normals kernel is disabled; "
                        "2-D runs always apply CSF like the reference")
    # interactive surfaces (reference GUI loop 2dvof.py:502-561 and
    # paint-a-target diff_vof.py:188-198)
    p.add_argument("--live", action="store_true",
                   help="open the live interactive viewer (SPACE cycles "
                        "view modes, p pauses, q quits); needs a display")
    p.add_argument("--paint", action="store_true",
                   help="with --optimize: paint the target interactively "
                        "before optimizing (needs a display)")
    # distributed execution
    p.add_argument("--mesh", default=None, metavar="PX,PY",
                   help="run domain-decomposed over a PXxPY mesh of cards, "
                        "cuda:0 onwards (with --three-d: PX x slabs or PXxPY "
                        "pencils, resident on their cards: a VTK frame or a "
                        "checkpoint gathers the whole grid to the host); the "
                        "grid must divide evenly. On --device cpu the shards "
                        "share the CPU")
    p.add_argument("--plan-mesh", type=int, default=0, metavar="N",
                   dest="plan_mesh",
                   help="print the ranked (PX, PY) mesh shapes for this "
                        "grid at N chips (admission + relative-cost "
                        "model; pure shape math, needs no devices) and "
                        "exit")
    return p


def _device_error(args) -> str | None:
    """The reason --device and --backend cannot run here, or None."""
    if args.device == "cpu" and args.backend != "torch":
        return (f"--backend {args.backend} runs the CUDA kernels, which need "
                "--device cuda; on the CPU use --device cpu --backend torch")
    if args.device == "cuda" and not torch.cuda.is_available():
        return ("--device cuda: no CUDA device is available; to run on the "
                "CPU pass --device cpu --backend torch")
    return None


def _profile_ctx(args):
    """--profile-dir as a context manager: a torch.profiler trace around
    the step loop (utils.profiling.trace), or a no-op."""
    import contextlib

    if not args.profile_dir:
        return contextlib.nullcontext()
    from .utils.profiling import trace

    return trace(args.profile_dir)


def run_distributed(args, cfg, state, istep) -> int:
    """Domain-decomposed run: scatter and start the engine's blocks once,
    advance them in frame-sized chunks, and gather each frame's state
    (``finish``) for its metrics and PNGs."""
    from .io_utils import save_contour_png, save_frame_png
    from .metrics import banner, compute_metrics, format_frame
    from .parallel import Decomp
    from .viz import MODES, render_frame

    mesh, rc = _mesh_2d(args)
    if mesh is None:
        return rc
    try:
        dec = Decomp(cfg, mesh)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    px, py = dec.px, dec.py
    blocks = dec.start(dec.scatter_state(state))

    os.makedirs(args.outdir, exist_ok=True)
    print(banner(cfg))
    print(f">>> distributed over a {px}x{py} mesh ({dec.devices[0].type} devices, "
          f"{dec.engine} engine); compiling...")
    t0 = time.time()
    target_step = istep + args.steps
    # seed from the resumed step so a --resume run continues the frame
    # numbering instead of overwriting the pre-resume frames
    frame_idx = -(-istep // args.frame_every)  # ceil: a non-frame-aligned
    # prior run wrote a final partial-chunk frame at floor+1
    vis_idx = MODES.index(args.view)
    with _profile_ctx(args):
        while istep < target_step:
            n = min(args.frame_every, target_step - istep)
            blocks = dec.advance(blocks, n, istep)  # istep0: parity continues
            istep += n
            state = dec.finish(blocks, device=state.F.device)
            m = compute_metrics(cfg, state)
            print(format_frame(istep, cfg.num.dt, m, "vof"))
            if not bool(m.finite):
                print(">>> aborting: non-finite fields", file=sys.stderr)
                return 1
            if not args.no_frames:
                mode = MODES[vis_idx % len(MODES)]
                with span("tv.render"):
                    save_frame_png(os.path.join(args.outdir, f"{frame_idx:06d}-{mode}.png"),
                                   render_frame(cfg, state, mode))
                if args.save_fig:
                    save_contour_png(os.path.join(args.outdir, f"{frame_idx:06d}-f.png"),
                                     state.F, cfg.grid.Lx, cfg.grid.Ly)
                frame_idx += 1
            if args.cycle_views:
                vis_idx += 1
            if args.checkpoint_every and istep % args.checkpoint_every == 0:
                # the gathered state and istep, as the serial run writes
                # them: a --resume of it continues with or without --mesh
                from .io_utils import save_checkpoint

                path = os.path.join(args.outdir, f"ckpt_{istep:06d}.npz")
                save_checkpoint(path, cfg, state, istep)
                print(f">>> checkpoint saved: {path}")
    if args.profile_dir:
        print(f">>> profiler trace written to {args.profile_dir}")
    if args.gif and not args.no_frames:
        import glob

        from .io_utils import frames_to_gif

        pat = "*" if args.cycle_views else MODES[vis_idx % len(MODES)]
        frames = [f for f in glob.glob(os.path.join(args.outdir, f"*-{pat}.png"))
                  if not f.endswith("-f.png")]
        if frames:
            gif = frames_to_gif(frames, os.path.join(args.outdir, "movie.gif"))
            print(f">>> assembled {len(frames)} frames into {gif}")
    wall = time.time() - t0
    cups = cfg.grid.nx * cfg.grid.ny * args.steps / wall
    print(f">>> {args.steps} steps in {wall:.2f}s on {px}x{py} mesh "
          f"({cups:.3e} cell-updates/s incl. gather/frame I/O)")
    return 0


def _devices(args, px: int, py: int):
    """An object array of the px * py devices of a mesh: the cards cuda:0
    onwards, or on --device cpu the CPU px * py times (a virtual mesh);
    None after an error message where there are too few."""
    n = px * py
    if args.device == "cuda":
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device("cpu")] * n
    if n > len(devs):
        print(f"error: mesh {px}x{py} needs {n} devices, have {len(devs)}", file=sys.stderr)
        return None
    arr = np.empty(n, dtype=object)
    arr[:] = devs[:n]
    return arr


def _mesh_2d(args):
    """(Mesh, None) for a 2-D --mesh PX,PY, or (None, rc) after an error
    message."""
    from .parallel import Mesh

    parts = [int(x) for x in args.mesh.split(",")]
    if len(parts) != 2:
        print("error: the 2-D solver decomposes along x and y; use --mesh PX,PY "
              "(--three-d takes --mesh PX or PX,PY)", file=sys.stderr)
        return None, 2
    devs = _devices(args, *parts)
    if devs is None:
        return None, 2
    return Mesh(devs.reshape(*parts), ("mx", "my")), None


def _mesh_3d(args):
    """(Mesh, None) for a 3-D --mesh PX[,PY], or (None, rc) after an error
    message. The cards are cuda:0 onwards; on --device cpu the shards
    share the CPU (a virtual mesh)."""
    from .parallel import Mesh

    parts = [int(x) for x in args.mesh.split(",")]
    px = parts[0]
    py = parts[1] if len(parts) > 1 else 1
    if len(parts) > 2 and any(p != 1 for p in parts[2:]):
        print("error: the 3-D solver decomposes along x (and y); use "
              "--mesh PX or --mesh PX,PY", file=sys.stderr)
        return None, 2
    arr = _devices(args, px, py)
    if arr is None:
        return None, 2
    if py > 1:
        return Mesh(arr.reshape(px, py), ("mx", "my")), None
    return Mesh(arr, ("mx",)), None


def run_3d(args) -> int:
    from .grid import Grid3D

    n = args.nx
    g = Grid3D(n, n, n)
    istep0 = 0
    state = None
    if args.resume:
        from .io_utils import load_checkpoint_3d

        # a mesh run scatters the checkpoint from the host
        state, istep0, _ = load_checkpoint_3d(args.resume,
                                              device="cpu" if args.mesh else args.device)
        if tuple(state.F.shape) != g.shape:
            print(f"error: checkpoint grid {tuple(state.F.shape)} != requested "
                  f"{g.shape}", file=sys.stderr)
            return 2
        print(f">>> resumed from {args.resume} at step {istep0}")
    backend = "torch" if args.backend == "torch" else "cuda"
    dec = None
    if args.mesh:
        from .parallel import Decomp3D

        mesh, rc = _mesh_3d(args)
        if mesh is None:
            return rc
        try:
            dec = Decomp3D(g, mesh, dt=args.dt, n_jacobi=args.jacobi,
                           backend=backend, pressure_solver=args.pressure_solver,
                           sor_tol=args.sor_tol, sor_tol_rel=args.sor_tol_rel,
                           csf=args.csf)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    elif state is None:
        from .state import init_state_3d

        state = init_state_3d(g, ic=args.ic, device=args.device)
    os.makedirs(args.outdir, exist_ok=True)
    print(f">>> 3-D VOF dam break: {n}^3, dt = {args.dt:4.2e}, "
          f"{args.steps} steps, VTK every {args.frame_every}"
          + (f", decomposed {dec.px}x{dec.py} over {dec.px * dec.py} "
             "devices" if dec else ""))
    t0 = time.time()
    with _profile_ctx(args):
        if dec is None:
            _frames_3d(args, g, state, istep0, backend)
        else:
            _frames_3d_mesh(args, g, dec, state, istep0)
    if args.profile_dir:
        print(f">>> profiler trace written to {args.profile_dir}")
    wall = time.time() - t0
    print(f">>> {args.steps} steps in {wall:.2f}s "
          f"({n**3 * args.steps / wall:.3e} cell-updates/s)")
    return 0


def _export_line(done: int, mass: float, fmin: float, fmax: float) -> str:
    return (f">>> Exporting step-{done:05d} result... "
            f"mass={mass:.1f} range=[{fmin:.3f},{fmax:.3f}]")


def _frames_3d(args, g, state, done: int, backend: str) -> None:
    """The serial 3-D frame loop: simulate_3d a frame at a time, F read
    back for its line and VTK volume, the checkpoints."""
    from .io_utils import save_checkpoint_3d, write_vtk
    from .solver3d import simulate_3d

    target = done + args.steps
    while done < target:
        k = min(args.frame_every, target - done)
        # istep0 keeps the reference's continuous istep % 3 sweep
        # rotation across frame chunks (and across --resume)
        state = simulate_3d(g, state, k, args.dt, args.jacobi, backend=backend,
                            istep0=done, pressure_solver=args.pressure_solver,
                            sor_tol=args.sor_tol, sor_tol_rel=args.sor_tol_rel, csf=args.csf)
        done += k
        F = state.F.cpu().numpy()
        print(_export_line(done, F[1:-1, 1:-1, 1:-1].sum(), F.min(), F.max()))
        if not args.no_frames:
            write_vtk(os.path.join(args.outdir, f"step-{done:05d}"), {"VOF": F})
        if args.checkpoint_every and done % args.checkpoint_every == 0:
            path = os.path.join(args.outdir, f"ckpt_{done:06d}.npz")
            save_checkpoint_3d(path, g, state, done)
            print(f">>> checkpoint saved: {path}")


def _frames_3d_mesh(args, g, dec, state, done: int) -> None:
    """The mesh's 3-D frame loop on resident shards: each card makes its
    own initial block (or takes its part of a resumed state), the blocks
    are widened once and advanced a frame at a time; the line comes from
    per-card reductions (mass summed in float64), and the whole grid is
    gathered to the host only for a VTK frame or a checkpoint."""
    from .io_utils import save_checkpoint_3d, write_vtk

    blocks = dec.start(dec.init_shards(args.ic) if state is None else dec.scatter_state(state))
    del state
    target = done + args.steps
    while done < target:
        k = min(args.frame_every, target - done)
        blocks = dec.advance(blocks, k, istep0=done)
        done += k
        print(_export_line(done, *dec.line(blocks)))
        vtk = not args.no_frames
        ckpt = bool(args.checkpoint_every) and done % args.checkpoint_every == 0
        if vtk or ckpt:
            whole = dec.finish(blocks, device="cpu")
            if vtk:
                write_vtk(os.path.join(args.outdir, f"step-{done:05d}"),
                          {"VOF": whole.F.numpy()})
            if ckpt:
                path = os.path.join(args.outdir, f"ckpt_{done:06d}.npz")
                save_checkpoint_3d(path, g, whole, done)
                print(f">>> checkpoint saved: {path}")
            del whole


def run_optimize(args) -> int:
    from . import diff
    from .io_utils import save_contour_png

    cfg = diff.diff_config(n=args.nx, adjoint=args.adjoint)
    if args.paint:
        from .paint import paint_interactively

        print(">>> paint the target shape (LMB drag; close window when done)")
        try:
            Ftarget = torch.as_tensor(paint_interactively(cfg.grid), device=args.device)
        except RuntimeError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    elif args.target_npy:
        Ftarget = torch.as_tensor(np.load(args.target_npy).astype(np.float32),
                                  device=args.device)
        if tuple(Ftarget.shape) != cfg.grid.shape:
            print(f"error: target shape {tuple(Ftarget.shape)} != grid {cfg.grid.shape}",
                  file=sys.stderr)
            return 2
    else:
        Ftarget = diff.diff_target(cfg, args.optimize or 1, device=args.device)
    os.makedirs(args.outdir, exist_ok=True)
    print(f">>> Differentiable optimization: {args.nx}x{args.nx}, "
          f"{args.opt_steps} steps/epoch, {args.epochs} epochs, lr={args.lr}, "
          f"adjoint={args.adjoint}")

    from .io_utils import save_grad_png, save_side_by_side_png

    def cb(epoch, loss, F0, grad):
        print(f">>> >>> Optimization cycle {epoch}: loss = {loss:.4f}")
        if not args.no_frames and epoch % 10 == 0:
            save_contour_png(os.path.join(args.outdir, f"opt-{epoch:04d}-f0.png"),
                             F0, cfg.grid.Lx, cfg.grid.Ly)
            # current-vs-target side-by-side (diff_vof.py:448-454) and the
            # gradient field (test/diff_fct.py:370-375); one extra forward
            # rollout per 10 epochs for the end state
            with torch.no_grad():
                F_end = diff.rollout(cfg, F0, args.opt_steps, remat=False).F
            save_side_by_side_png(
                os.path.join(args.outdir, f"opt-{epoch:04d}-vs-target.png"),
                F_end, Ftarget)
            save_grad_png(os.path.join(args.outdir, f"opt-{epoch:04d}-grad.png"), grad)
        if not args.no_frames and args.view_every:
            # mid-epoch evolution frames of this epoch's forward
            # (diff_vof.py:524-554): a separate rollout without autograd
            for step, F in diff.rollout_frames(cfg, F0, args.opt_steps,
                                               args.view_every):
                save_side_by_side_png(
                    os.path.join(
                        args.outdir,
                        f"opt-{epoch:04d}-step{step:05d}-vs-target.png"),
                    F, Ftarget)

    opts = diff.DiffOptions(n_steps=args.opt_steps, lr=args.lr)
    F0, losses = diff.optimize_f0(cfg, Ftarget, opts=opts,
                                  n_epochs=args.epochs, callback=cb)
    np.save(os.path.join(args.outdir, "F0_optimized.npy"), F0.cpu().numpy())
    print(f">>> final loss {losses[-1]:.4f} (from {losses[0]:.4f}); "
          f"F0 saved to {args.outdir}/F0_optimized.npy")
    return 0


def run_optimize_advection(args) -> int:
    """test/diff_fct.py equivalent: optimize F0 under a fixed velocity."""
    from . import diff
    from . import models
    from .io_utils import save_contour_png

    maker = models.ADVECTION_CASES[args.optimize_case]
    kw = {"n": args.nx} if args.nx != 200 else {}
    case, _, u, v, Ftarget = maker(device=args.device, **kw)
    n_steps = args.opt_steps if args.opt_steps != 999 else 200
    os.makedirs(args.outdir, exist_ok=True)
    print(f">>> Advection F0 optimization ({args.optimize_case}): "
          f"{case.grid.nx}^2, {n_steps} steps/epoch, {args.epochs} epochs, "
          f"lr={args.lr}")
    F0, losses = diff.optimize_advection_f0(
        case, u, v, Ftarget, n_steps=n_steps, n_epochs=args.epochs, lr=args.lr)
    for i, l in enumerate(losses):
        if i % max(1, len(losses) // 10) == 0 or i == len(losses) - 1:
            print(f">>> >>> Current loss: {l:.4f}")
    np.save(os.path.join(args.outdir, "F0_optimized.npy"), F0.cpu().numpy())
    if not args.no_frames:
        save_contour_png(os.path.join(args.outdir, "F0_optimized.png"),
                         F0, case.grid.Lx, case.grid.Ly)
    print(f">>> final loss {losses[-1]:.4f} (from {losses[0]:.4f})")
    return 0


def run_advection(args) -> int:
    from . import models
    from .io_utils import save_contour_png

    maker = models.ADVECTION_CASES[args.case]
    case, F, u, v, target = maker(device=args.device)
    n_steps = args.steps or case.n_steps
    os.makedirs(args.outdir, exist_ok=True)
    print(f">>> VOF scheme case {args.case}: grid {case.grid.nx} x {case.grid.ny}, "
          f"dt = {case.dt:4.2e}, {n_steps} steps")
    t0 = time.time()
    chunk = max(1, args.frame_every)
    done = 0
    while done < n_steps:
        n = min(chunk, n_steps - done)
        F = models.simulate_advection(case, F, u, v, n, istep0=done)
        done += n
        Fh = F.cpu().numpy()
        print(f">>> step {done}: mass={Fh[1:-1,1:-1].sum():.3f} "
              f"range=[{Fh.min():.3f},{Fh.max():.3f}]")
        if not args.no_frames:
            save_contour_png(
                os.path.join(args.outdir, f"{args.case}-{done:06d}.png"),
                Fh, case.grid.Lx, case.grid.Ly)
    print(f">>> done in {time.time() - t0:.1f}s")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.csf and not args.three_d:
        # validated once, before any mode dispatch
        print("error: --csf applies to --three-d runs only (2-D always "
              "applies CSF, like the reference)", file=sys.stderr)
        return 2
    if args.plan_mesh:
        # pure shape math: no device touched, so it runs anywhere
        from .config import Numerics, SimConfig
        from .grid import Grid2D, Grid3D
        from .parallel import format_plans, plan_mesh_2d, plan_mesh_3d

        if args.three_d:
            g = Grid3D(args.nx, args.nx, args.nx)  # run_3d is cubic too
            plans = plan_mesh_3d(g, args.plan_mesh, n_jacobi=args.jacobi)
        else:
            cfg = SimConfig(grid=Grid2D(args.nx, args.ny or args.nx),
                            num=Numerics(n_jacobi=args.jacobi))
            plans = plan_mesh_2d(cfg, args.plan_mesh)
        print(format_plans(plans))
        return 0
    err = _device_error(args)
    if err:
        print(f"error: {err}", file=sys.stderr)
        return 2
    if args.case:
        return run_advection(args)
    if args.optimize_case:
        return run_optimize_advection(args)
    if args.optimize or args.target_npy:
        return run_optimize(args)
    if args.three_d:
        return run_3d(args)

    from .config import Numerics, SimConfig
    from .grid import Grid2D
    from .io_utils import load_checkpoint, save_checkpoint, save_contour_png, save_frame_png
    from .metrics import banner, compute_metrics, format_frame
    from .solver import simulate, simulate_cfl
    from .state import init_state
    from .viz import MODES, arrow_field, interp_velocity, render_frame

    ny = args.ny or args.nx
    cfg = SimConfig(
        grid=Grid2D(args.nx, ny),
        num=Numerics(dt=args.dt, n_jacobi=args.jacobi,
                     backend=args.backend,
                     pressure_solver=args.pressure_solver,
                     sor_tol=args.sor_tol,
                     sor_tol_rel=args.sor_tol_rel),
    )

    istep = 0
    if args.resume:
        # the file's dtype is kept: a tpuvof f64 checkpoint resumes in f64
        state, istep, _ = load_checkpoint(args.resume, device=args.device)
        if tuple(state.F.shape) != cfg.grid.shape:
            print(f"error: checkpoint grid {tuple(state.F.shape)} != requested "
                  f"{cfg.grid.shape}", file=sys.stderr)
            return 2
        print(f">>> resumed from {args.resume} at step {istep}")
    else:
        state = init_state(cfg, ic=args.ic, device=args.device)

    if args.mesh:
        return run_distributed(args, cfg, state, istep)

    if args.live:
        from .live import live_loop

        print(banner(cfg))
        state, istep = live_loop(cfg, state, args.steps,
                                 steps_per_frame=args.frame_every,
                                 view=args.view, istep0=istep)
        print(f">>> live session ended at step {istep}")
        return 0

    os.makedirs(args.outdir, exist_ok=True)
    print(banner(cfg))
    print(">>> Compiling the step program...")

    vis_idx = MODES.index(args.view)
    # seed from the resumed step so a --resume run continues the frame
    # numbering instead of overwriting the pre-resume frames
    frame_idx = -(-istep // args.frame_every)  # ceil: a non-frame-aligned
    # prior run wrote a final partial-chunk frame at floor+1 (clobbered
    # by a floor seed; frame-aligned runs are unchanged)
    target_step = istep + args.steps
    profile_cm = None
    if args.profile_dir:
        from .utils import trace
        profile_cm = trace(args.profile_dir)
        profile_cm.__enter__()
    t0 = time.time()
    while istep < target_step:
        n = min(args.frame_every, target_step - istep)
        # istep0 keeps the reference's continuous odd-first parity across
        # frame chunks (steps istep+1 .. istep+n)
        if args.no_cfl_warn:
            state = simulate(cfg, state, n, istep0=istep)
        else:
            # the reference prints per-cell Courant warnings from inside
            # its momentum kernel mid-run (2dvof.py:274-280); the tracker
            # keeps the running argmax on the device and the warning,
            # naming the exact step and face, prints at this host sync
            # (the state trajectory is simulate's, bit for bit)
            state, cfl = simulate_cfl(cfg, state, n, istep0=istep)
            if cfl["violations"]:
                print(f">>> {cfl['axis'].upper()} velocity courant "
                      f"number > 1: {cfl['violations']} cell-step "
                      f"violation(s) since step {cfl['first_step']}; "
                      f"{cfl['axis']}[{cfl['i']},{cfl['j']}] peaked at "
                      f"CFL={cfl['cfl']:.3f} on step {cfl['step']}",
                      file=sys.stderr)
        istep += n

        mode = MODES[vis_idx % len(MODES)]
        m = compute_metrics(cfg, state)
        print(format_frame(istep, cfg.num.dt, m, mode))
        if not bool(m.finite):
            # before any frame is rendered: a NaN has no colour index
            print(">>> aborting: non-finite fields", file=sys.stderr)
            return 1

        if not args.no_frames:
            count = frame_idx
            frame_idx += 1
            with span("tv.render"):
                if mode == "vectors":
                    rgb = render_frame(cfg, state, "vof")
                    arrows = arrow_field(interp_velocity(cfg, state), arrow_spacing=4)
                    save_frame_png(os.path.join(args.outdir, f"{count:06d}-{mode}.png"),
                                   rgb, arrows)
                else:
                    rgb = render_frame(cfg, state, mode)
                    save_frame_png(os.path.join(args.outdir, f"{count:06d}-{mode}.png"),
                                   rgb)
            if args.save_fig:
                save_contour_png(os.path.join(args.outdir, f"{count:06d}-f.png"),
                                 state.F, cfg.grid.Lx, cfg.grid.Ly)
        if args.cycle_views:
            vis_idx += 1
        if args.checkpoint_every and istep % args.checkpoint_every == 0:
            path = os.path.join(args.outdir, f"ckpt_{istep:06d}.npz")
            save_checkpoint(path, cfg, state, istep)
            print(f">>> checkpoint saved: {path}")

    if args.gif and not args.no_frames:
        import glob

        from .io_utils import frames_to_gif
        pat = "*" if args.cycle_views else MODES[vis_idx % len(MODES)]
        frames = glob.glob(os.path.join(args.outdir, f"*-{pat}.png"))
        frames = [f for f in frames if "-f.png" not in f] or glob.glob(
            os.path.join(args.outdir, "*.png"))
        if frames:
            gif = frames_to_gif(frames, os.path.join(args.outdir, "movie.gif"))
            print(f">>> assembled {len(frames)} frames into {gif}")
    wall = time.time() - t0
    if profile_cm is not None:
        profile_cm.__exit__(None, None, None)
        print(f">>> profiler trace written to {args.profile_dir}")
    cups = cfg.grid.nx * cfg.grid.ny * args.steps / wall
    print(f">>> {args.steps} steps in {wall:.2f}s "
          f"({cups:.3e} cell-updates/s incl. frame I/O)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
