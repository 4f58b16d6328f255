#!/usr/bin/env python3
"""On-card smoke run of the tpuvof_torch port (PyTorch + hand-written CUDA).

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: the card's name and power limit; TF32 off.
  2. build: the kernels of tpuvof_torch/csrc, compiled from this checkout
     (one nvcc per source, in parallel); the bulk-copy instructions in the
     fullstep_dma kernels' SASS, counted with cuobjdump, loads (global to
     shared) and stores (shared to global) apart: every kernel has bulk
     loads, and no bulk stores (its outputs leave by thread stores, which
     beat bulk stores on the H100).
  3. kernel vs plain: the whole-step kernel's split of the Jacobi sweeps
     into stage groups (n_jacobi 0 to 20): the sweeps sum to n_jacobi in
     the fewest groups of at most 4, of near-equal depth, the deeper first;
     every kernel against its plain PyTorch version on a
     perturbed, developed 512^2 dam-break state, in f64 and f32: the phase
     kernels; fullstep and fullstep_dma (both parities), fullstep_win (an
     interior and a corner tile), fullstep_strips (NaN in the margins),
     predict_win and fct_sweep_win (x and y) on an interior and an edge
     tile of the hybrid tiled engine and on a 29 x 45 block at the high
     corner; every sweep under FCT_FORWARD, FCT_DIFF and FCT_SCHEME_TEST. Then the whole-step engines
     against each other in f64: mono == tiled == strips; and fullstep_dma ==
     fullstep bit for bit, f64 and f32, both parities: at n = 29 to 32
     (E1 = n + 2 of every residue modulo 4, so that its row copies start
     and end at every offset from a 16-byte boundary, and the last cells
     of a field go by thread loads where E0*E1 is not a multiple of 4) at
     n_jacobi 1, 4, 5, 10 and 11 (one stage group, the split's edges, three
     groups); at 512^2, 1024^2 and 2048^2 at n_jacobi 10 (a CTA walks
     several tiles a group beyond 512^2, its boxes reused); each launch
     shape printed. The outputs land in a private allocator pool filled
     with NaN by the same allocations first, which is checked.
  4. golden: the 64^2 dam break in f64 through the phase kernels ('cuda')
     and through the whole-step kernel ('cuda_mono'), against
     tests/golden_dambreak_64_1000.npz at 300 and 1000 steps.
  5. paths, each run with the launch counts set to 0 just before it and
     read just after: the main path, 512^2 f32 x 1000 steps through
     'cuda_mono' (1000 fullstep launches and no other); 100 steps each of
     'cuda_tiled' and 'cuda_strips'; the phase path 'cuda' (1000 / 1000 /
     2000); the hybrid, pressure_solver='auto' (mg)
     over 100 steps on 'cuda'; a few hybrid steps tile by tile (predict_win,
     fct_sweep_win). Finiteness, 0 <= F <= 1, mass; the 64^2 f32 drift.
  6. project against its plain version at n_jacobi 1, 3, 4, 5 and 11 (one
     stage group, the split's edges, three groups), f64 and f32, on phase
     3's state; then timing: the 512^2 x 1000 run on the mono and phase
     paths and 200 steps of the plain-torch path (host clock), each path's step on the device alone (a replayed CUDA
     graph), and each kernel's time per launch beside its plain version's
     and its bound; the whole-step kernel's launch shape on each of its
     blocks (threads and shared bytes a CTA, CTAs an SM, CTAs launched),
     project's at 514^2, predict's and each sweep axis's at 514^2 and on
     the hybrid's 136^2 block, and the Jacobi groups at the main path's
     n_jacobi.
  7. 3-D kernel vs plain: the four 3-D kernels against their plain versions
     on a perturbed, developed dam-break state at the main path's 200^3,
     f64 and f32:
     predict3d_rhs (csf off and on), correct3d, fct3d_sweep (x, y, z, with
     and without mirror_out), jacobi3d (10 iterations, and 7: launches of
     unequal depth), and each on an i-slab (gi_base != 0); and the csf
     predict3d_rhs on the dam break's noise-free initial state (F exactly 0
     or 1: degenerate normals and zero differences almost everywhere), on
     the grid and the i-slab.
  8. 3-D golden: 32^3 in f64 through 'cuda' against
     tests/golden_dambreak3d_32_300.npz at steps 100 and 300 (resumed with
     istep0); the f32 drift at 300.
  9. 3-D paths, counts set to 0 before and read after each: the 3-D main
     path, simulate_3d at 200^3 f32 x 1000 steps on 'cuda' (1000 / 3000 /
     1000 / 3000 launches of predict3d_rhs / jacobi3d / correct3d /
     fct3d_sweep and no other: jacobi3d_plan(10) is three launches, of 4, 3
     and 3 iterations); csf=True, 100 steps at 200^3 (two
     predict3d_rhs launches a step: the curvature pre-pass); the hybrid,
     pressure_solver='auto' (mg) at 64^3 x 20. Finiteness, 0 <= F <= 1, mass.
 10. 3-D timing: the main path's host-clock ms/step (best of 3), its
     device-alone step (a CUDA graph of a step triple), the csf route's
     (csf=True, 100 steps) and the plain-torch path's, and each 3-D kernel
     beside its plain version and its bound; the csf predict3d_rhs call and
     its curvature pre-pass kappa3d_kernel alone (torch.profiler's device
     time); each sweep's launch shape.
 11. engine blocks vs plain: the four 3-D kernels against their plain
     versions on the blocks the 200^3 engines of phase 13 give them, of a
     perturbed, developed state, f64 and f32. In pencil mode (njl, gj_base)
     on the 2x2 engine's (130, 130, 202) blocks: the shard at gi_base =
     gj_base = 86 (its high x and y walls mid-block) and the y-edge shard at
     gj_base = -14 (its low y wall mid-block). In slab mode on the (4,)
     engine's (80, 202, 202) blocks: the x-edge shards at gi_base = -14 and
     136, each with an x wall mid-block. The csf predict3d_rhs also on the
     noise-free initial state's blocks of the pencil shards (0, 0) and (0,
     1) (a low and a high y wall mid-block, the water's faces in both) and
     of the slab shard at gi_base = -14.
 12. distributed golden: the 32^3 dam break in f64 through Decomp3D on a
     virtual 2x2 pencil mesh and a (2,) slab mesh, all shards on cuda:0,
     against tests/golden_dambreak3d_32_300.npz at steps 100 and 300
     (resumed with istep0), and against the serial 'cuda' run of phase 8.
 13. distributed paths, counts set to 0 before and read after each: this
     slice's main path, Decomp3D at 200^3 f32 x 1000 steps on a virtual 2x2
     pencil mesh (4x the serial path's launches and no other), and the same
     on a (4,) slab mesh. Finiteness and 0 <= F <= 1 on the whole extended
     blocks, mass; F equal to phase 9's serial result bit for bit (every
     owned cell sees the same operations on the same values), u, v, w, p
     within 1e-6 of it; host-clock ms/step (best of 3), device-alone ms/step
     (a CUDA graph of a step triple), idle share, the halo copies' and the F
     wall-plane fixes' device ms per step, and each kernel's time in pencil
     mode beside its plain version and its bound. Where the machine has four
     cards, the 2x2 pencil run again with its shards on cuda:0-cuda:3, its F
     equal bit for bit to the virtual mesh's (with one card the phase says
     the check did not run).
 14. the DMA path (scripts/torch_mono_dma_ab.py's loop), counts set to 0
     before and read after: 512^2 f32 x 1000 steps as (odd, even) pairs of
     fullstep_dma from init_state with the BCs applied (1000 fullstep_dma
     launches and no other), F, u, v, p equal to phase 5's 'cuda_mono' result
     bit for bit; 1024^2 and 2048^2 x 100 steps, each equal bit for bit to
     the same loop on fullstep. At each size: host-clock ms/step (best of 3,
     alternating with the mono loop), device-alone ms/step of both (a CUDA
     graph of a step pair), idle share, and the kernel's us per launch
     beside its plain version's and its bound, with fullstep's from the
     same call; both launch shapes, on lines of their own; in f64 at 512^2
     and 2048^2 the two kernels' us per launch on the device alone.
 15. the differentiable path (tpuvof_torch.diff, models.advection), plain
     torch on the card as tpuvof's runs plain XLA ops: counts set to 0
     before and read after, and no kernel of csrc/ launched. loss and
     dL/dF0 on the card in f64 against the same call on the CPU (unrolled
     and self-adjoint Jacobi at 24^2 x 20, the converged mg and rbsor at
     16^2 x 3). The reference's workload at its width, its depth cut:
     diff_config(80) (gy = -1000, FCT_DIFF, self-adjoint Jacobi, 10
     sweeps) in f32, 2 epochs of optimize_f0 over 100 steps (the reference
     takes 999) with remat from F0 = 0 toward the circle:
     each loss, max|g| and the gate's share, s/epoch after the first, the
     host ms a step and the device's idle share (torch.profiler), the peak
     memory of one loss_and_grad with and without remat. max|g| under
     'unrolled' and 'selfadjoint' at 10 and 100 steps from F0 = 0
     (finite, < 50, and one gradient: no cotangent reaches the solve
     there), and at 10 and 50 from the dam break beside the CPU's f32
     unrolled gradient;
     the converged mg projection (sor_tol_rel 1e-3) over 20 steps from
     both starts (finite, < 50 from F0 = 0), its V-cycles a solve; the
     single vortex at its defaults (500^2, 1000 steps, f32): mass, bounds,
     host ms a step and idle share; one advection_loss_and_grad over 20
     steps at 500^2.

 16. the app layer on the card: tpuvof_torch.cli.main in-process, counts set
     to 0 before and read after each run. The main path through the CLI,
     -ic 1 --nx 512 --steps 1000 --frame-every 100 --backend cuda_mono -s
     --cycle-views --checkpoint-every 500 --gif: exactly 1000 fullstep
     launches and no other, ckpt_001000.npz equal bit for bit to phase 5's
     'cuda_mono' result, ten frames in all five view modes (the vectors
     frames with arrows), ten -f.png figures, two checkpoints, a ten-frame
     movie.gif; again under --no-cfl-warn, the same state. --resume of
     ckpt_000500 for 500 steps: the same state, frames numbered from 5.
     `python -m tpuvof_torch -ic 2 --nx 512 --steps 200 --frame-every 100`
     as a subprocess on the device default; --backend cuda_strips and
     cuda_tiled for 100 steps, with and without --no-cfl-warn, each equal
     bit for bit to simulate on its route. --three-d --nx 200 --steps 100:
     phase 9's launches for 100 steps, its state equal to one simulate_3d
     call, the VTK payload of step-00100.vtk equal to F as float32, a
     --resume of 0 steps, and --mesh over every card (1 on one card, 2,2
     on four): F equal to the serial run. --optimize 1 --nx 80 --epochs 2
     --opt-steps 200, --optimize-case translation, --case single_vortex:
     no kernel launch, their files (--opt-steps 50). Times: the CLI's cell-updates/s, host
     ms/step of the CLI without frames with and without the CFL tracker
     beside simulate's, the device's busy ms a step of simulate and
     simulate_cfl (torch.profiler), the ms of a frame (render_frame + save_frame_png,
     plain and with arrows), of save_contour_png, and of one 200^3 VTK
     write.
 17. the distributed solver ladder, on virtual meshes on cuda:0, counts set
     to 0 before and read after each run, and the residual-driven solves'
     loop tests counted (ops.poisson.keep_iterating: one an SOR iteration
     or V-cycle, one more a solve, each after a host read of the global
     residual). a. Decomp3D(backend='torch') in f64 at 32^3 on (2, 2), (4,)
     and (8,) (shards 4 planes thick, thinner than the wide-halo cone)
     over 100 steps: no kernel launch, within 1e-12 of the serial 'torch'
     run, within 1e-9 of the golden's step 100. b. the distributed hybrid,
     rbsor and mg (sor_tol 1e-8, sor_max_iter 2000), on (2, 2) and (2,) over
     2 steps in f64 at 32^3 against the serial 'cuda' hybrid: F, u, v, w
     within 1e-12, p within 1e-7, the same iterations and V-cycles, k x the
     serial launches on k shards. c. the slice at full width: 200^3 f32 on
     the 2x2 pencil mesh with sor_tol_rel 1e-2, 'auto' (mg) over 10 steps
     and rbsor over 2, beside the serial hybrid: 4 x its launches of
     predict3d_rhs, correct3d and fct3d_sweep and no jacobi3d; finite, 0 <=
     F <= 1, mass; host ms/step, V-cycles or iterations a step, residual
     reads a step, the device's idle share (torch.profiler) of both, and
     the distance from the serial result: F and p equal bit for bit (the
     shards' coefficients are the serial solver's on their blocks). The
     CLI with --three-d --mesh
     2,2 --pressure-solver mg --sor-tol-rel 1e-2 over the same 10 steps on
     that virtual mesh (it stands in for the CLI's lookup of the cards):
     its checkpoint equal bit for bit to the Decomp3D run, its VTK written.
 18. the 2-D decomposition (tpuvof_torch.parallel.Decomp), on virtual
     meshes on cuda:0, counts set to 0 before and read after each run. The
     four kernels it launches against their plain versions, f64 and f32, on
     the blocks the 512^2 2x2 engines give them (two shards each):
     fullstep_win on the (302, 302) extended blocks, fullstep_strips on the
     (306, 306) padded blocks with NaN in the margins, predict_win and
     fct_sweep_win (x and y) on the (264, 264) PHASE_HALO-widened blocks;
     each one's us a launch there beside its plain version's and its bound.
     a. The 64^2 dam break in f64 x 300 against the golden's step 300
     (1e-8): the torch engine on (2, 2), (2, 4) and (8, 1) (8-row shards,
     thinner than any kernel engine's halo; no launch, within 1e-12 of the
     serial 'torch' run), the full-block, tiled and strips engines on
     (2, 2) (4 launches a step and no other; F, u, v, p equal to the serial
     'cuda_mono' run bit for bit). b. The hybrid, rbsor and mg (sor_tol
     1e-8, mg's crossover at 64 cells), f64, on (2, 2) at 16^2 over 2 steps
     and (1, 8) at 64^2 over 1: equal to the serial 'cuda' hybrid bit for bit, the
     same iterations and V-cycles, a predict_win and two fct_sweep_win a
     shard a step. c. The slice's main path, 512^2 f32 x 1000 on 2x2
     through the full-block, tiled and strips engines beside serial
     'cuda_mono': exact launches, F equal to phase 5's result bit for bit,
     finite, 0 <= F <= 1, mass; host ms/step (best of 3), the device alone (a
     CUDA graph of a step pair), idle share, the halo copies' device
     ms/step; with four cards, the full-block run on cuda:0-cuda:3 too. d.
     2048^2 f32 x 100 through the full-block engine (out of L2), the same
     readings. e. The production hybrid at 512^2 f32, sor_tol_rel 1e-2, mg
     ('auto') x 20 and rbsor x 5 beside the serial hybrid: launches, host
     ms/step, V-cycles or iterations a step, idle shares; mg's F and p equal
     to the serial hybrid's bit for bit, rbsor's and mg's. f. The torch
     engine's ms/step at 512^2 x 20, and Decomp3D(backend='torch') at 200^3
     x 2 on 2x2. g. The CLI: --mesh 2,2 at 512^2 x 200 with frames on the
     virtual mesh (standing in for the CLI's lookup of the cards), 800
     fullstep_win launches, its checkpoint equal to Decomp.simulate bit
     for bit; --plan-mesh 4 and --plan-mesh 8 --three-d; the engine-class
     speeds measured in (c), (f) and phase 13 beside plan.py's constants.

It prints one JSON line of per-kernel results and, last, the JSON status
line. With no CUDA device it exits non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_MAIN = 512  # the size bench.py has always timed
STEPS_MAIN = 1000
STEPS_PLAIN = 200  # phase 6: the plain-torch path's timed runs (host-bound, ~7 ms a step)
# phase 3: fullstep_dma == fullstep on grids whose E1 = n + 2 has every
# residue modulo 4, at each Jacobi split, and on the DMA path's grids
DMA_RESIDUE_SIZES = (29, 30, 31, 32)
DMA_N_JACOBI = (1, 4, 5, 10, 11)
DMA_BIG_SIZES = (512, 1024, 2048)
# phase 14: (n, steps); 2048^2 f32 fields (16.8 MB each) work out of the 50 MB L2
DMA_SIZES = ((N_MAIN, STEPS_MAIN), (1024, 100), (2048, 100))
DMA_F64_SIZES = (N_MAIN, 2048)  # phase 14's f64 times
STEPS_HYBRID = 100
TILE = 128  # the tiled engines' tile in phases 3 and 5
RAGGED = (29, 45)  # phase 3: a phase block whose sides are a multiple of no tile
FCT_VARIANTS = ("FCT_FORWARD", "FCT_DIFF", "FCT_SCHEME_TEST")  # phase 3's sweeps
SEED = 0
# |kernel - plain| / max|plain| bars. f64: both sides do the same IEEE
# operations in the same order (the kernels are built with --fmad=false),
# so only rounding may differ. f32: the same, with p looser because the
# Jacobi sweeps carry rounding differences through ten iterations.
TOL_F64 = 1e-12
TOL_F32 = {"p": 1e-4}
TOL_F32_DEFAULT = 1e-5
TOL_ENGINES = 1e-13  # mono == tiled == strips, f64 absolute (tpuvof's bar)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12      # H100 SXM, f32 outside the tensor cores
# Arithmetic operations per cell of each function, counted from its body
# in tpuvof_torch/csrc/step_cell.cuh once per cell (the kernels' own
# recomputation, e.g. four normals per kappa, is not work the function
# needs): normals 46, curvature 5, two momentum updates ~70, mixes 8; rhs 8,
# Jacobi 9 a sweep, correction 14; one FCT sweep ~40; BCs and clamp 2.
OPS_PER_CELL = {"predict": 129, "project": 8 + 9 * 10 + 14, "fct_sweep": 40,
                "fullstep": 129 + 8 + 9 * 10 + 14 + 2 * 40 + 2}
# Fields each function must read once and write once.
FIELDS_MOVED = {"predict": 5, "project": 9, "fct_sweep": 3, "fullstep": 8}
for _name, _of in (("predict_win", "predict"), ("fct_sweep_win", "fct_sweep"),
                   ("fullstep_win", "fullstep"), ("fullstep_strips", "fullstep"),
                   ("fullstep_dma", "fullstep")):
    OPS_PER_CELL[_name] = OPS_PER_CELL[_of]
    FIELDS_MOVED[_name] = FIELDS_MOVED[_of]

# 3-D: the reference's flagship size (3dvof.py:20-22); the kernels are held
# to their plain versions at the same shapes the main path gives them
N3_MAIN = 200
STEPS3_MAIN = 1000
STEPS3_CSF = 100
N3_CHECK = N3_MAIN
N3_JACOBI = 10  # the step's fixed Jacobi iterations (simulate_3d's n_jacobi)
N3_HYBRID = 64
STEPS3_HYBRID = 20
STEPS3_PLAIN = 30
N3_SLAB = (40, 50)  # (gi_base, nloc) of the i-slab case
N3_GOLDEN_MESHES = ((2, 2), (2,))  # phase 12: 2x2 pencils and (2,) slabs at 32^3
# phase 13: the 2x2 pencil mesh (this slice's main path) and (4,) slabs at 200^3
N3_DIST_MESHES = ((2, 2), (4,))
PENCIL_SHARDS = ((1, 1), (1, 0))  # phase 11: gj_base 86 and -14
# phase 11, the noise-free dam break: the water sits at low x and y
DAM_PENCIL_SHARDS = ((0, 0), (0, 1))
PROJECT_N_JACOBI = (1, 3, 4, 5, 11)  # phase 6: one stage group, the split's edges, three
SLAB_SHARDS = ((0, 0), (3, 0))  # phase 11: gi_base -14 and 136 on the (4,) engine
DT3_SWEEP = 4e-4   # the sweeps' check: Courant numbers up to ~0.3, the limiter fires
# Per cell, counted once from the bodies in tpuvof_torch/csrc (the kernels'
# own recomputation of neighbours' u*, v*, w* and normals is not work the
# function needs): predict3d_rhs three momentum updates ~150 with the mixes,
# rhs 10; correct3d ~30; one sweep ~45; jacobi3d 13 an iteration, 10 of
# them. Fields each must read once and write once: predict3d_rhs u, v, w,
# F -> u*, v*, w*, rhs; correct3d u*, v*, w*, p, F -> u, v, w; a sweep F,
# vel -> F; jacobi3d (all iterations) p, rhs -> p.
OPS_PER_CELL.update({"predict3d_rhs": 160, "correct3d": 30, "fct3d_sweep": 45,
                     "jacobi3d": 13 * 10})
# csf: a Youngs normal once a cell ~189 (54 distinct differences, 72 corner
# sums, 24 corner divisions, 21 accumulations, the mean and the
# normalisation), or 30 where the cell's 3x3x3 cube of F holds one value
# (27 compares; the normal is then the signed zeros the arithmetic would
# give), kappa 9, the three sigma face terms ~60. The pre-pass
# kappa3d_kernel reads F and writes kappa. The csf entries' operations are
# counted from each run's F (csf_ops_per_cell).
NORMAL_OPS, NORMAL_UNIFORM_OPS, KAPPA_OPS, SIGMA_OPS = 189, 30, 9, 60
FIELDS_MOVED.update({"kappa3d": 2, "predict3d_rhs csf": 8})
FIELDS_MOVED.update({"predict3d_rhs": 8, "correct3d": 8, "fct3d_sweep": 3, "jacobi3d": 3})


# phase 15: the differentiable path. Card f64 against CPU f64 through the
# same code: reductions may reassociate on the card, nothing else differs
DIFF_TOL_GRAD = 1e-9  # |dgrad| / max|grad|
DIFF_TOL_LOSS = 1e-12
DIFF_N = 80  # the reference's diff grid (diff_vof.py), uncut
# The reference optimises over 999 steps. The path is host-bound (40-70 ms
# a step forward and backward, by the host), so its depth is cut to keep
# the script well inside its time limit: 2 epochs of 100 steps, the probe
# at two horizons from each start.
DIFF_STEPS = 100
DIFF_EPOCHS = 2
DIFF_HORIZONS = (10, 100)
DIFF_HORIZONS_DAM = (10, 50)  # from the dam break, card beside CPU
DIFF_MG_STEPS = 20  # the mg exit test reads the host once a V-cycle
DIFF_IDLE_STEPS = 20  # the profiled window of the idle share
# tpuvof's bound on |g| at the 999-step horizon
# (tests/test_diff_implicit.py::test_diff_mg_grads_bounded_999_steps)
DIFF_GRAD_BOUND = 50.0
# the vortex at its defaults runs at CFL 1, where the test variant's
# flux-only dV compensation loses mass linearly: -1.86e-2 over 1000 steps
# for tpuvof and the port alike (f32, CPU: tests/test_torch_advection.py::
# test_vortex_at_reference_size_matches_tpuvof); bounds as tpuvof's test
VORTEX_STEPS = 1000
VORTEX_MASS_BAR = 2.5e-2
VORTEX_BOUND = 5e-2
ADVECTION_GRAD_STEPS = 20
# phase 16: the app layer through tpuvof_torch.cli, at the main paths' sizes
APP_STEPS = STEPS_MAIN
APP_FRAME_EVERY = 100
APP_STEPS_ROUTES = 100  # 'cuda_strips' and 'cuda_tiled' through the CLI
APP_STEPS3 = 100
APP_REPEATS = 2  # the timed CLI and simulate runs, alternating
# --optimize through the CLI: two epochs at the reference's 80^2; 50 steps
# an epoch, not 999 (two 999-step epochs through the CLI took 121 s on an
# H100 80GB HBM3 at 700 W)
APP_OPT_STEPS = 50
# phase 17: the distributed solver ladder. (a) and (b) in f64 at the 3-D
# golden's 32^3; (b) with tpuvof's hybrid-test solve (sor_tol 1e-8,
# sor_max_iter 2000, 2 steps: two of the three sweep orders); (c) at the
# flagship 200^3 in f32 on the 2x2 pencil mesh, the production upgrade
# (sor_tol_rel 1e-2): mg ('auto') over 10 steps, rbsor over 2 (host-bound:
# ~0.1 and ~0.9 s a step on 2x2)
LADDER_TORCH_MESHES = ((2, 2), (4,), (8,))
LADDER_HYBRID_MESHES = ((2, 2), (2,))
LADDER_SOLVE = dict(sor_tol=1e-8, sor_max_iter=2000)
STEPS3_LADDER_HYBRID = 2
LADDER_TOL_REL = 1e-2
LADDER_RUNS = (("auto", 10), ("rbsor", 2))  # (pressure_solver, steps) of (c)
LADDER_IDLE_STEPS = 1  # the profiled window of (c)'s idle shares
# phase 18: the 2-D decomposition, on virtual meshes on cuda:0. (a) the 64^2
# golden in f64 over 300 steps: the torch engine on three meshes, (8, 1)
# with 8-row shards, thinner than any kernel engine's halo; the kernel
# engines on 2x2. (b) the hybrid at tpuvof's test tolerance, f64, on (2, 2)
# at 16^2 and (1, 8) at 64^2 (16^2 over 8 rows would leave blocks thinner
# than PHASE_HALO + 1), mg's crossover at 64 cells so its fine levels run
# sharded. (c) the slice's main path: 512^2 f32 x 1000 on 2x2, the three
# whole-step engines. (d) 2048^2 x 100, out of L2. (e) the production
# hybrid at 512^2 (sor_tol_rel 1e-2). (f) the torch engine's speed, the
# planner's 'torch' class. (g) the CLI's --mesh 2,2 and --plan-mesh.
DECOMP_TORCH_MESHES = ((2, 2), (2, 4), (8, 1))
# (n, mesh, steps): both sweep orders at 16^2; one step at 64^2, whose
# rbsor runs to its 2000-iteration cap, each iteration a host read
DECOMP_HYBRID_CASES = ((16, (2, 2), 2), (64, (1, 8), 1))
DECOMP_GATHER_VOLUME = 64
N18_BIG = 2048
STEPS18_BIG = 100
DECOMP_RUNS = (("auto", 20), ("rbsor", 5))  # (pressure_solver, steps) of (e)
STEPS18_TORCH = 20
STEPS18_TORCH3 = 2  # Decomp3D(backend='torch') at 200^3 on 2x2, for the 3-D planner
STEPS18_CLI = 200
DECOMP_SHARDS = ((1, 0), (0, 1))  # the kernels vs plain on these shards' blocks


T_START = time.perf_counter()


def progress(phase: str) -> None:
    """One line on the standard error as a phase starts: where a run that
    is stopped from outside had got to."""
    print(f"chip_smoke: phase {phase} starts, {time.perf_counter() - T_START:.1f} s in",
          file=sys.stderr, flush=True)


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


def pad(a, w, value=0.0):
    return torch.nn.functional.pad(a, (w, w, w, w), value=value)


def window(K, cfg, s, W, r0, c0, extent):
    """Blocks of ``extent`` (an int: square; or (rows, columns)) at (r0, c0)
    of the W-zero-padded fields, and their global origin."""
    e0, e1 = (extent, extent) if isinstance(extent, int) else extent
    return [pad(a, W)[r0:r0 + e0, c0:c0 + e1].contiguous() for a in s], \
        (r0 - W, c0 - W)


def kernel_cases(tt, K, cfg, s):
    """(kernel name, outputs of the kernel, outputs of its plain version,
    output names, the region compared) for every kernel on state ``s``."""
    F, u, v, p = s
    n = cfg.grid.nx
    us, vs = K.predict_plain(cfg, u, v, F)
    cases = [
        ("predict", K.predict(cfg, u, v, F), (us, vs), ("u*", "v*"), None),
        ("project", K.project(cfg, F, us, vs, p, u, v),
         K.project_plain(cfg, F, us, vs, p, u, v), ("p", "u", "v"), None),
    ]
    # the sweeps under each FCT variant (the step runs FCT_FORWARD)
    variants = [(name, cfg.replace(num=dataclasses.replace(cfg.num, fct=getattr(tt, name))))
                for name in FCT_VARIANTS]
    for name, c in variants:
        for axis, vel in ((0, u), (1, v)):
            cases.append(("fct_sweep", (K.fct_sweep(c, F, vel, axis),),
                          (K.fct_sweep_plain(c, F, vel, axis),), (f"F({'xy'[axis]}) {name}",),
                          None))
    for even in (False, True):
        cases.append(("fullstep", K.fullstep(cfg, F, u, v, p, even),
                      K.fullstep_plain(cfg, F, u, v, p, even), "Fuvp", None))
        cases.append(("fullstep_dma", K.fullstep_dma(cfg, F, u, v, p, even),
                      K.fullstep_dma_plain(cfg, F, u, v, p, even), "Fuvp", None))
    W = K.STEP_HALO(cfg)
    centre = (slice(W, -W), slice(W, -W))
    for r0, c0 in ((n // 2, n // 4), (0, n - TILE)):  # an interior and a corner tile
        blocks, (oi, oj) = window(K, cfg, s, W, r0, c0, TILE + 2 * W + 2)
        cases.append(("fullstep", K.fullstep_win(cfg, *blocks, oi, oj, True),
                      K.fullstep_win_plain(cfg, *blocks, oi, oj, True), "Fuvp", centre))
    w2 = K.strips_halo(cfg)
    nan_padded = [pad(a, w2, float("nan")) for a in s]
    grid = (slice(w2, w2 + n + 2), slice(w2, w2 + n + 2))
    cases.append(("fullstep", K.fullstep_strips(cfg, *nan_padded, False),
                  K.fullstep_strips_plain(cfg, *nan_padded, False), "Fuvp", grid))
    W = K.PHASE_HALO
    centre = (slice(W, -W), slice(W, -W))
    L = n + 2 + 2 * W  # the padded grid
    e0, e1 = RAGGED
    # an interior and an edge tile of the hybrid tiled engine, and a ragged
    # block at the high corner (its origin past both walls)
    for (r0, c0), extent in (((n // 2, n // 4), TILE + 2 * W + 2),
                             ((n - TILE, 0), TILE + 2 * W + 2), ((L - e0, L - e1), RAGGED)):
        (ub, vb, Fb), (oi, oj) = window(K, cfg, (u, v, F), W, r0, c0, extent)
        cases.append(("predict_win", K.predict_win(cfg, ub, vb, Fb, oi, oj),
                      K.predict_win_plain(cfg, ub, vb, Fb, oi, oj), ("u*", "v*"), centre))
        for name, c in variants:
            for axis, vel in ((0, ub), (1, vb)):
                cases.append(("fct_sweep_win", (K.fct_sweep_win(c, Fb, vel, axis, oi, oj),),
                              (K.fct_sweep_win_plain(c, Fb, vel, axis, oi, oj),),
                              (f"F({'xy'[axis]}) {name}",), centre))
    return cases


def bound_of(name: str, cells: int, ops_per_cell: float | None = None) -> dict:
    """The least time the card could take for function ``name`` on
    ``cells`` f32 cells: the larger of its compulsory bytes over the memory
    rate and its operations (``ops_per_cell``, else OPS_PER_CELL's) over
    the f32 rate."""
    ops = OPS_PER_CELL[name] if ops_per_cell is None else ops_per_cell
    bytes_ms = 1e3 * FIELDS_MOVED[name] * cells * 4 / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops * cells / F32_OPS_PER_S
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def profiled_ms(fn, n: int, kernel: str) -> float | None:
    """Mean device ms of the launches of kernels whose name holds
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
    return total / count / 1e3 if count and total > 0 else None


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
    host work sits between the launches. The whole-step kernel's
    cooperative launch is captured like any other."""
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


def run_path(tt, K, label, cfg, s0, steps, want_launches, mass_bar=1e-3):
    """Drive ``steps`` of ``cfg`` from ``s0`` with the counts set to 0 just
    before and read just after; check the counts and the physics."""
    mass0 = tt.compute_metrics(cfg, s0).mass.item()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    s_end = tt.simulate(cfg, s0, steps)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: n for k, n in K.LAUNCHES.items() if n}
    print(f"{label} launches: {launches} ({secs:.2f} s)")
    check(launches == want_launches, f"{label} launch counts {launches} != {want_launches}")
    m = tt.compute_metrics(cfg, s_end)
    drift = abs(m.mass.item() - mass0) / mass0
    Fmin, Fmax = s_end.F.min().item(), s_end.F.max().item()
    n = cfg.grid.nx
    print(f"{label} {n}^2 {str(s0.F.dtype)[6:]} x{steps}: finite={bool(m.finite)} "
          f"F in [{Fmin:.3e}, {Fmax:.3e}] mass drift {drift:.3e} "
          f"max|u| {m.max_u.item():.3e} max|v| {m.max_v.item():.3e} "
          f"CFL ({m.cfl_u.item():.3e}, {m.cfl_v.item():.3e})")
    check(bool(m.finite), f"{label}: non-finite fields")
    check(0.0 <= Fmin and Fmax <= 1.0, f"{label}: F outside [0, 1]: [{Fmin}, {Fmax}]")
    check(drift <= mass_bar, f"{label}: mass drift {drift:.3e} > {mass_bar:.0e}")
    return launches, s_end


def bulk_copy_sass(build) -> dict:
    """{kernel function: its bulk-copy SASS instructions (UBLK*, UTMA*)} of
    the fullstep_dma kernels of the built library (cuobjdump): UBLKCP.S.G
    copies global to shared memory, UBLKCP.G.S shared to global."""
    import re

    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    dump = subprocess.run([cuobjdump, "--dump-sass", build.load_library()._name],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts = {}
    for block in dump.split("Function : ")[1:]:
        name = block.split()[0]
        if "fullstep_dma" in name:
            counts[name] = re.findall(r"\b(?:UBLK|UTMA)[A-Z0-9_.]*", block)
    return counts


def poisoned_outputs(call, like: torch.Tensor, label: str):
    """The outputs of ``call()``, fullstep_dma on fields like ``like``,
    made in a private allocator pool that was filled with NaN first by the
    same allocations (four fields, then the scratch), so a cell the kernel
    never stored shows as NaN. Fails unless every output lies in poisoned
    memory."""
    from tpuvof_torch.kernels import step_kernels as K

    pool = torch.cuda.MemPool()
    with torch.cuda.use_mem_pool(pool):
        blocks = [torch.full_like(like, float("nan")) for _ in range(4)]
        blocks.append(torch.full((K.scratch_cells("fullstep_dma", like.shape, like.dtype),),
                                 float("nan"), dtype=like.dtype, device=like.device))
        poisoned = [(t.data_ptr(), t.data_ptr() + t.nbytes) for t in blocks]
        del blocks
        got = call()
        torch.cuda.synchronize()
    landed = all(any(lo <= g.data_ptr() and g.data_ptr() + g.nbytes <= hi
                     for lo, hi in poisoned) for g in got)
    check(landed, f"{label}: an output does not lie in the NaN-poisoned blocks")
    out = tuple(g.clone() for g in got)
    del got
    return out


def step_pairs(kernel, cfg, s, steps: int):
    """``steps`` steps of a whole-step kernel from fields ``s`` as (odd,
    even) parity pairs, simulate's order from istep0 = 0."""
    for _ in range(steps // 2):
        s = kernel(cfg, *s, False)
        s = kernel(cfg, *s, True)
    return s


def run_dma_path(tt, S, K, tag, n: int, steps: int, want=None):
    """Phase 14 at n^2 f32: ``steps`` of fullstep_dma from init_state with
    the BCs applied, counts set to 0 before and read after; the fields
    equal bit for bit to ``want`` (default: the same loop on fullstep);
    then host-clock and device-alone times of both loops, the kernel per
    launch beside fullstep's, its plain version's and its bound, and at
    DMA_F64_SIZES both kernels per launch in f64; both launch shapes are
    printed, not returned."""
    from tpuvof_torch.kernels import build

    lib = build.load_library()
    cfg = tt.dam_break_2d(n, num=tt.Numerics(backend="cuda_mono"))
    s0 = tuple(S._with_bc(tt.init_state(cfg)))
    mass0 = tt.compute_metrics(cfg, tt.State(*s0)).mass.item()
    label = f"DMA path {n}^2 f32 x{steps}"
    torch.cuda.synchronize()
    K.reset_launch_counts()
    s_dma = step_pairs(K.fullstep_dma, cfg, s0, steps)
    torch.cuda.synchronize()
    launches = {k: c for k, c in K.LAUNCHES.items() if c}
    print(f"{label} launches: {launches}")
    check(launches == {"fullstep_dma": steps}, f"{label}: launch counts {launches}")
    if want is None:
        want = step_pairs(K.fullstep, cfg, s0, steps)
    diff = max((a - b).abs().max().item() for a, b in zip(s_dma, want))
    same = all(torch.equal(a, b) for a, b in zip(s_dma, want))
    m = tt.compute_metrics(cfg, tt.State(*s_dma))
    drift = abs(m.mass.item() - mass0) / mass0
    Fmin, Fmax = s_dma[0].min().item(), s_dma[0].max().item()
    print(f"{label}: F, u, v, p equal to the mono loop's bit for bit: {same} (max|d| "
          f"{diff:.3e}); finite={bool(m.finite)} F in [{Fmin:.3e}, {Fmax:.3e}] mass "
          f"drift {drift:.3e}")
    check(same, f"{label}: fullstep_dma differs from fullstep, max|d| {diff:.3e}")
    check(bool(m.finite), f"{label}: non-finite fields")
    check(0.0 <= Fmin and Fmax <= 1.0, f"{label}: F outside [0, 1]: [{Fmin}, {Fmax}]")
    check(drift <= 1e-3, f"{label}: mass drift {drift:.3e} > 1e-3")

    kernels = {"dma": K.fullstep_dma, "mono": K.fullstep}
    runs = {name: [] for name in kernels}

    def run(kernel):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_pairs(kernel, cfg, s0, steps)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for kernel in kernels.values():  # warm-up
        run(kernel)
    for r in range(3):  # best of 3, alternating which loop goes first
        for name in ("dma", "mono") if r % 2 == 0 else ("mono", "dma"):
            runs[name].append(run(kernels[name]))
    out = {}
    for name in ("mono", "dma", "dma", "mono"):  # device alone, in turns
        dev = device_ms(lambda k=kernels[name]: step_pairs(k, cfg, s_dma, 2), 10) / 2
        out.setdefault(name, []).append(dev)
    res = {"n": n, "steps": steps, "launches": launches.get("fullstep_dma", 0),
           "equal_to_fullstep": same,
           "ms": device_ms(lambda: K.fullstep_dma(cfg, *s_dma, False), 20),
           "mono_ms": device_ms(lambda: K.fullstep(cfg, *s_dma, False), 20),
           "plain_ms": device_ms(lambda: K.fullstep_dma_plain(cfg, *s_dma, False), 3),
           "host_ms": host_ms(lambda: K.fullstep_dma(cfg, *s_dma, False), 100),
           "plain_host_ms": host_ms(lambda: K.fullstep_dma_plain(cfg, *s_dma, False), 5),
           **bound_of("fullstep_dma", (n + 2) ** 2)}
    for dtype in (torch.float32, torch.float64):
        print(f"{tag} launch fullstep_dma ({n + 2}, {n + 2}) {str(dtype)[6:]}: threads, "
              f"shared bytes, CTAs an SM, CTAs, tile rows {dma_shape(lib, n + 2, dtype)} "
              f"(fullstep "
              f"{fullstep_shapes(lib, (('', n + 2, n + 2, dtype),))['']})")
    if n in DMA_F64_SIZES:
        s64 = [a.double() for a in s_dma]
        res["f64_ms"] = device_ms(lambda: K.fullstep_dma(cfg, *s64, False), 20)
        res["f64_mono_ms"] = device_ms(lambda: K.fullstep(cfg, *s64, False), 20)
        print(f"{tag} fullstep_dma ({n + 2}, {n + 2}) f64: kernel {1e3 * res['f64_ms']:.2f} "
              f"us/launch on the device (fullstep {1e3 * res['f64_mono_ms']:.2f}; dma/mono "
              f"{res['f64_ms'] / res['f64_mono_ms']:.4f})")
    for name in ("mono", "dma"):
        step_ms = 1e3 * min(runs[name]) / steps
        dev = min(out[name])
        res[f"{name}_step_ms"], res[f"{name}_device_step_ms"] = step_ms, dev
        print(f"{tag} {name} loop {n}^2 x{steps} f32: best {min(runs[name]):.4f} s of "
              f"{[round(t, 4) for t in runs[name]]}, {n * n * steps / min(runs[name]):.4e} "
              f"cell-updates/s, {step_ms:.4f} ms/step; device alone "
              f"{[round(d, 5) for d in out[name]]} ms/step, idle "
              f"{100 * (1 - dev / step_ms):.1f}% of the host-clock step")
    print(f"{tag} fullstep_dma ({n + 2}, {n + 2}) f32: kernel {1e3 * res['ms']:.2f} us/launch "
          f"on the device (fullstep {1e3 * res['mono_ms']:.2f}; dma/mono "
          f"{res['ms'] / res['mono_ms']:.4f}; {1e3 * res['host_ms']:.2f} us per call from "
          f"Python); plain {1e3 * res['plain_ms']:.2f} us/call on the device "
          f"({1e3 * res['plain_host_ms']:.2f} us from Python); bound "
          f"{1e3 * res['bound_ms']:.2f} us ({res['bound_by']})")
    return res


def perturbed_state_3d(tt, n: int, steps: int):
    """The n^3 dam break advanced ``steps`` through the kernels in f64,
    plus seeded uniform perturbations (F 1e-3, clipped to [0, 1]; u, v, w
    0.5; p 1), each velocity's low ghost plane along its own axis zeroed
    (the state invariant), BCs applied."""
    from tpuvof_torch.ops import apply_bc_3d

    g = tt.Grid3D(n, n, n)
    s = tt.simulate_3d(g, tt.init_state_3d(g, 1, "cuda", torch.float64), steps)
    rng = np.random.default_rng(SEED)

    def noise(a, amp):
        return a + torch.as_tensor(rng.uniform(-amp, amp, a.shape), device="cuda")

    F = noise(s.F, 1e-3).clamp(0.0, 1.0)
    u, v, w = (noise(a, 0.5) for a in (s.u, s.v, s.w))
    p = noise(s.p, 1.0)
    u[0] = 0.0
    v[:, 0] = 0.0
    w[:, :, 0] = 0.0
    u, v, w, F, p = apply_bc_3d(u, v, w, F, p)
    return g, tt.State3D(F=F, u=u, v=v, w=w, p=p)


def kernel_cases_3d(K3, g, fl, blocks, dt):
    """(kernel name, kernel outputs, plain outputs, output names) for every
    3-D kernel on each (tag, state, block origin, csf only) of ``blocks``;
    on a csf-only block, the csf predict3d_rhs alone."""
    cases = []
    for tag, (F, u, v, w, p), org, csf_only in blocks:
        for csf in (True,) if csf_only else (False, True):
            cases.append((f"predict3d_rhs{' csf' if csf else ''}{tag}",
                          K3.predict3d_rhs(g, fl, dt, u, v, w, F, csf, **org),
                          K3.predict3d_rhs_plain(g, fl, dt, u, v, w, F, csf, **org),
                          ("u*", "v*", "w*", "rhs")))
        if csf_only:
            continue
        us, vs, ws, rhs = K3.predict3d_rhs_plain(g, fl, dt, u, v, w, F, False, **org)
        cases.append((f"correct3d{tag}", K3.correct3d(g, fl, dt, us, vs, ws, p, F, **org),
                      K3.correct3d_plain(g, fl, dt, us, vs, ws, p, F, **org), "uvw"))
        for axis, vel in enumerate((u, v, w)):
            for mirror in (False, True):
                cases.append((f"fct3d_sweep {'xyz'[axis]}{' mirror' if mirror else ''}{tag}",
                              (K3.fct3d_sweep(g, DT3_SWEEP, F, vel, axis, mirror, **org),),
                              (K3.fct3d_sweep_plain(g, DT3_SWEEP, F, vel, axis, mirror,
                                                    **org),), ("F",)))
        for n_iter in (N3_JACOBI, 7):
            cases.append((f"jacobi3d n_iter={n_iter}{tag}",
                          (K3.jacobi3d(g, n_iter, p, rhs, **org),),
                          (K3.jacobi3d_plain(g, n_iter, p, rhs, **org),), ("p",)))
    return cases


def check_kernels_3d(K3, g, fl, blocks_of, dt, label):
    """Every 3-D kernel against its plain version on the blocks
    ``blocks_of(dtype)`` gives, f64 and f32; returns the worst errors by
    kernel name (the csf predict3d_rhs cases also as "predict3d_rhs
    csf")."""
    results = {}
    for dtype in (torch.float64, torch.float32):
        key = "f64" if dtype == torch.float64 else "f32"
        for name_tag, got, want, outs in kernel_cases_3d(K3, g, fl, blocks_of(dtype), dt):
            torch.cuda.synchronize()
            name = name_tag.split()[0]
            names = [name] + ["predict3d_rhs csf"] * name_tag.startswith("predict3d_rhs csf")
            for out_name, g_, w_ in zip(outs, got, want):
                rel, diff = rel_err(g_, w_)
                tol = TOL_F64 if key == "f64" else TOL_F32.get(out_name, TOL_F32_DEFAULT)
                for n in names:
                    r = results.setdefault(n, {"rel_f64": 0.0, "rel_f32": 0.0, "abs_f32": 0.0})
                    r[f"rel_{key}"] = max(r[f"rel_{key}"], rel)
                    if key == "f32":
                        r["abs_f32"] = max(r["abs_f32"], diff)
                print(f"kernel vs plain {key} {label} {name_tag:40s} {out_name:4s} "
                      f"rel {rel:.3e} (bar {tol:.0e}) abs {diff:.3e}")
                check(rel <= tol, f"{name_tag} {out_name} {key}: rel {rel:.3e} > {tol:.0e}")
    return results


def state_slab(s, gi_base: int, nloc: int):
    """The i-slab of every field whose local plane l is global plane
    gi_base + l, l = 0..nloc+1."""
    return type(s)(*(a[gi_base:gi_base + nloc + 2].contiguous() for a in s))


def run_path_3d(tt, counters, label, g, s0, steps, want_launches, **kw):
    """Drive ``steps`` of simulate_3d from ``s0`` with every count set to 0
    just before and read just after; check the counts and the physics."""
    def mass(s):
        return s.F[1:-1, 1:-1, 1:-1].double().sum().item()

    mass0 = mass(s0)
    torch.cuda.synchronize()
    for c in counters:
        c.reset_launch_counts()
    t0 = time.perf_counter()
    s_end = tt.simulate_3d(g, s0, steps, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: n for c in counters for k, n in c.LAUNCHES.items() if n}
    print(f"{label} launches: {launches} ({secs:.2f} s)")
    check(launches == want_launches, f"{label} launch counts {launches} != {want_launches}")
    finite = all(bool(torch.isfinite(a).all()) for a in s_end)
    drift = abs(mass(s_end) - mass0) / mass0
    Fmin, Fmax = s_end.F.min().item(), s_end.F.max().item()
    print(f"{label} {g.nx}^3 {str(s0.F.dtype)[6:]} x{steps}: finite={finite} "
          f"F in [{Fmin:.3e}, {Fmax:.3e}] mass drift {drift:.3e} "
          f"max|u| {s_end.u.abs().max().item():.3e} max|v| {s_end.v.abs().max().item():.3e} "
          f"max|w| {s_end.w.abs().max().item():.3e}")
    check(finite, f"{label}: non-finite fields")
    check(0.0 <= Fmin and Fmax <= 1.0, f"{label}: F outside [0, 1]: [{Fmin}, {Fmax}]")
    check(drift <= 1e-3, f"{label}: mass drift {drift:.3e} > 1e-3")
    return launches, s_end


def time_kernels_3d(K3, g, fl, dt, s, org, tag):
    """Each 3-D kernel's device time per call on block ``s`` with origin
    ``org``, beside its plain version's and its bound; the three sweeps as
    their mean (the paths run them equally often)."""
    F, u, v, w, p = s
    us, vs, ws, rhs = K3.predict3d_rhs_plain(g, fl, dt, u, v, w, F, **org)
    jacobi_plan = K3.jacobi3d_plan(N3_JACOBI)
    timed = {
        "predict3d_rhs": (lambda: K3.predict3d_rhs(g, fl, dt, u, v, w, F, **org),
                          lambda: K3.predict3d_rhs_plain(g, fl, dt, u, v, w, F, **org)),
        "correct3d": (lambda: K3.correct3d(g, fl, dt, us, vs, ws, p, F, **org),
                      lambda: K3.correct3d_plain(g, fl, dt, us, vs, ws, p, F, **org)),
        "jacobi3d": (lambda: K3.jacobi3d(g, N3_JACOBI, p, rhs, **org),
                     lambda: K3.jacobi3d_plain(g, N3_JACOBI, p, rhs, **org)),
    }
    for axis, vel in enumerate((u, v, w)):
        timed[f"fct3d_sweep_{'xyz'[axis]}"] = (
            lambda axis=axis, vel=vel: K3.fct3d_sweep(g, dt, F, vel, axis, **org),
            lambda axis=axis, vel=vel: K3.fct3d_sweep_plain(g, dt, F, vel, axis, **org))
    cells = F.numel()
    times = {}
    for name, (kern, plain) in timed.items():
        t = times[name] = {"ms": device_ms(kern, 20), "plain_ms": device_ms(plain, 3),
                           "host_ms": host_ms(kern, 50)}
        t.update(bound_of(name[:-2] if name.startswith("fct3d_sweep_") else name, cells))
        per = (f" ({N3_JACOBI} iterations in {len(jacobi_plan)} launches)"
               if name == "jacobi3d" else "")
        mode = f" {org}" if org else ""
        print(f"{tag} {name:15s} {tuple(F.shape)}{mode} f32: kernel {1e3 * t['ms']:.2f} "
              f"us/call{per} on the device ({1e3 * t['host_ms']:.2f} us per call from "
              f"Python); plain {1e3 * t['plain_ms']:.2f} us/call on the device; bound "
              f"{1e3 * t['bound_ms']:.2f} us ({t['bound_by']})")
    times["jacobi3d"]["ms_per_launch"] = times["jacobi3d"]["ms"] / len(jacobi_plan)
    for depth in sorted(set(jacobi_plan), reverse=True):
        geo = K3.jacobi3d_geometry(F.shape, depth, F.dtype, "njl" in org)
        print(f"{tag} jacobi3d launch of {depth} levels on {tuple(F.shape)}: {geo['threads']} "
              f"threads a CTA, each {geo['run']} k positions, a {geo['rows']} x {geo['cols']} "
              f"region owning {100 * geo['owned_share']:.1f}%; {geo['resident']} CTAs an SM, "
              f"grid {geo['grid']}, {geo['chunk']} planes a chunk; computed / owned "
              f"cell-levels {geo['computed_over_owned']:.3f}")
    xyz = [times.pop(f"fct3d_sweep_{a}") for a in "xyz"]
    times["fct3d_sweep"] = {k: sum(t[k] for t in xyz) / 3 if isinstance(xyz[0][k], float)
                            else xyz[0][k] for k in xyz[0]}
    return times


def csf_ops_per_cell(F) -> tuple[float, float]:
    """(operations a cell of kappa3d_kernel's function, of the csf
    predict3d_rhs) on field F: a Youngs normal costs NORMAL_UNIFORM_OPS at a
    cell whose 3x3x3 cube of F holds one value and NORMAL_OPS elsewhere
    (the share counted on the cells inside F's outer ring)."""
    n0, n1, n2 = F.shape
    c = F[1:-1, 1:-1, 1:-1]
    same = torch.ones_like(c, dtype=torch.bool)
    for a in range(3):
        for b in range(3):
            for d in range(3):
                same &= F[a:n0 - 2 + a, b:n1 - 2 + b, d:n2 - 2 + d] == c
    share = same.float().mean().item()
    normal = share * NORMAL_UNIFORM_OPS + (1 - share) * NORMAL_OPS
    kappa = normal + KAPPA_OPS
    return kappa, OPS_PER_CELL["predict3d_rhs"] + kappa + SIGMA_OPS


def time_csf_3d(K3, g, fl, dt, s, org, tag):
    """The csf predict3d_rhs call's device time per call on block ``s``
    with origin ``org`` (its two launches) beside its plain version's and
    its bound, and its curvature pre-pass kappa3d_kernel's own device time
    (torch.profiler; None where it shows none) beside its bound."""
    F, u, v, w, _ = s
    cells = F.numel()
    kappa_ops, csf_ops = csf_ops_per_cell(F)

    def kern():
        return K3.predict3d_rhs(g, fl, dt, u, v, w, F, True, **org)

    t = {"ms": device_ms(kern, 20),
         "plain_ms": device_ms(lambda: K3.predict3d_rhs_plain(g, fl, dt, u, v, w, F, True,
                                                                **org), 3),
         "host_ms": host_ms(kern, 50), **bound_of("predict3d_rhs csf", cells, csf_ops),
         "kappa3d_kernel": {"ms": profiled_ms(kern, 20, "kappa3d_kernel"),
                            **bound_of("kappa3d", cells, kappa_ops)}}
    kap = t["kappa3d_kernel"]
    mode = f" {org}" if org else ""
    kap_us = "not measured" if kap["ms"] is None else f"{1e3 * kap['ms']:.2f} us"
    print(f"{tag} predict3d_rhs csf {tuple(F.shape)}{mode} f32: {1e3 * t['ms']:.2f} us/call "
          f"(2 launches) on the device ({1e3 * t['host_ms']:.2f} us per call from Python); "
          f"plain {1e3 * t['plain_ms']:.2f} us/call; bound {1e3 * t['bound_ms']:.2f} us "
          f"({t['bound_by']}); kappa3d_kernel alone {kap_us} (torch.profiler), bound "
          f"{1e3 * kap['bound_ms']:.2f} us ({kap['bound_by']}; {kappa_ops:.1f} operations a "
          f"cell on this F)")
    return t


def run_dist_path(tt, counters, label, dec, s0, steps, want_launches, serial_end, tag):
    """Drive ``steps`` of Decomp3D ``dec`` from ``s0`` through its public
    stages (what ``simulate`` calls, so the extended blocks can be read),
    with every count set to 0 just before the steps and read just after;
    check the counts, the physics on the whole extended blocks and the
    gathered state against the serial run; then time it."""
    def mass(s):
        return s.F[1:-1, 1:-1, 1:-1].double().sum().item()

    mass0 = mass(s0)
    blocks0 = dec.widen(dec.scatter_state(s0))
    torch.cuda.synchronize()
    for c in counters:
        c.reset_launch_counts()
    t0 = time.perf_counter()
    blocks = dec.advance(blocks0, steps)
    torch.cuda.synchronize()
    secs = [time.perf_counter() - t0]
    launches = {k: n for c in counters for k, n in c.LAUNCHES.items() if n}
    print(f"{label} launches: {launches} ({secs[0]:.2f} s)")
    check(launches == want_launches, f"{label} launch counts {launches} != {want_launches}")
    finite = all(bool(torch.isfinite(a).all()) for b in blocks for a in b)
    Fmin = min(b.F.min().item() for b in blocks)
    Fmax = max(b.F.max().item() for b in blocks)
    s_end = dec.gather_state(dec.narrow(blocks))
    drift = abs(mass(s_end) - mass0) / mass0
    dF = (s_end.F - serial_end.F).abs().max().item()
    rel_uvwp = {name: rel_err(getattr(s_end, name), getattr(serial_end, name))[0]
                for name in "uvwp"}
    print(f"{label} {dec.g.nx}^3 {str(s0.F.dtype)[6:]} x{steps}, blocks "
          f"{tuple(blocks[0].F.shape)}: extended blocks finite={finite}, F in "
          f"[{Fmin:.3e}, {Fmax:.3e}]; mass drift {drift:.3e}; vs the serial 'cuda' run "
          f"max|dF| {dF:.3e} (bar 0), rel " +
          ", ".join(f"{n} {r:.3e}" for n, r in rel_uvwp.items()) + " (bar 1e-6)")
    check(finite, f"{label}: non-finite values in the extended blocks")
    check(0.0 <= Fmin and Fmax <= 1.0, f"{label}: F outside [0, 1]: [{Fmin}, {Fmax}]")
    check(drift <= 1e-3, f"{label}: mass drift {drift:.3e} > 1e-3")
    check(dF == 0.0, f"{label}: F differs from the serial run's, max|dF| {dF:.3e}")
    check(max(rel_uvwp.values()) <= 1e-6, f"{label}: u, v, w, p vs serial {rel_uvwp}")
    for _ in range(2):  # best of 3 on the host clock
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec.advance(blocks0, steps)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    step_ms = 1e3 * min(secs) / steps

    def triple():
        for ph in (1, 2, 0):
            dec.step(blocks, ph)

    dev_ms = device_ms(triple, 2) / 3
    halo_ms = device_ms(lambda: dec._refresh(blocks, dec.W, dec.Wy), 10)

    def wall_fixes():  # idempotent on a stepped block
        for k, b in enumerate(blocks):
            dec._restore_wall_planes(k, b.F)

    wall_ms = device_ms(wall_fixes, 10)
    cells = dec.g.nx * dec.g.ny * dec.g.nz
    print(f"{tag} {label} {dec.g.nx}^3 x{steps} f32: best {min(secs):.4f} s of "
          f"{[round(t, 4) for t in secs]}, {cells * steps / min(secs):.4e} cell-updates/s, "
          f"{step_ms:.4f} ms/step; device alone {dev_ms:.4f} ms/step, idle "
          f"{100 * (1 - dev_ms / step_ms):.1f}% of the host-clock step; halo copies "
          f"{halo_ms:.4f} ms/step on the device ({100 * halo_ms / dev_ms:.1f}%); F "
          f"wall-plane fixes {wall_ms:.4f} ms/step ({100 * wall_ms / dev_ms:.1f}%)")
    k = dec.coords.index(PENCIL_SHARDS[0]) if dec.pencil else 0
    return {"launches": launches, "block": blocks[k], "origin": dec.origin(k),
            "step_ms": step_ms, "end": s_end}


def fullstep_levels(lib, n_jacobi: int) -> list:
    """The Jacobi sweeps of each of the whole-step kernel's stage groups
    at n_jacobi, as the library splits them."""
    out = (ctypes.c_int * 8)()
    n_groups = lib.tv_fullstep_levels(n_jacobi, out, 8)
    check(0 <= n_groups <= 8, f"tv_fullstep_levels({n_jacobi}) gave {n_groups} groups")
    return list(out[:n_groups])


def fullstep_shapes(lib, blocks) -> dict:
    """{label: [threads a CTA, shared bytes a CTA, CTAs an SM, CTAs
    launched, tile rows]} of the whole-step kernel on each (label, E0, E1,
    dtype)."""
    out = {}
    for label, e0, e1, dtype in blocks:
        shape = (ctypes.c_int * 5)()
        fn = lib.tv_fullstep_shape_f64 if dtype == torch.float64 else lib.tv_fullstep_shape_f32
        check(fn(e0, e1, shape) == 0, f"tv_fullstep_shape {label} failed")
        out[label] = list(shape)
    return out


def dma_shape(lib, e: int, dtype) -> list:
    """[threads a CTA, shared bytes a CTA, CTAs an SM, CTAs launched, tile
    rows] of fullstep_dma on an e x e grid."""
    shape = (ctypes.c_int * 5)()
    fn = lib.tv_fullstep_dma_shape_f64 if dtype == torch.float64 else \
        lib.tv_fullstep_dma_shape_f32
    check(fn(e, e, shape) == 0, "tv_fullstep_dma_shape failed")
    return list(shape)


def phase_shapes(lib, blocks) -> dict:
    """{"kernel dtype (E0, E1)": [threads a CTA, shared bytes a CTA, CTAs an
    SM, CTAs launched, tile rows, tile columns]} of predict and of each
    sweep axis on each (name suffix, E0, E1) of ``blocks``, f32 and f64."""
    out = {}
    for suffix, e0, e1 in blocks:
        for dt in ("f32", "f64"):
            shape = (ctypes.c_int * 6)()
            check(getattr(lib, f"tv_predict_shape_{dt}")(e0, e1, shape) == 0,
                  "tv_predict_shape failed")
            out[f"predict{suffix} {dt} ({e0}, {e1})"] = list(shape)
            for axis in (0, 1):
                check(getattr(lib, f"tv_fct_sweep_shape_{dt}")(e0, e1, axis, shape) == 0,
                      "tv_fct_sweep_shape failed")
                out[f"fct_sweep{suffix} {'xy'[axis]} {dt} ({e0}, {e1})"] = list(shape)
    return out


def sweep_shapes(lib) -> dict:
    """{axis dtype mode: [threads a CTA, shared bytes a CTA, CTAs an SM]}
    of the three sweeps' kernels."""
    out = {}
    for axis in range(3):
        for dt, fn in (("f32", lib.tv_fct3d_shape_f32), ("f64", lib.tv_fct3d_shape_f64)):
            for pencil in (0, 1):
                shape = (ctypes.c_int * 3)()
                check(fn(axis, pencil, shape) == 0, "tv_fct3d_shape failed")
                out[f"{'xyz'[axis]} {dt}{' pencil' if pencil else ''}"] = list(shape)
    return out


def idle_share(fn) -> tuple[float, float | None]:
    """(host-clock ms of one call of ``fn`` behind synchronize fences, the
    device's idle share over it: 1 - the kernels' summed device time from
    torch.profiler / that time; None where the profiler shows none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy_ms = sum(getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0.0))
                  for ev in prof.key_averages()) / 1e3
    return wall_ms, (1.0 - busy_ms / wall_ms if busy_ms > 0 else None)


def run_diff_phase(tt, counters, tag) -> None:
    """Phase 15: the differentiable path on the card (see the module's
    docstring)."""
    from tpuvof_torch import diff
    from tpuvof_torch.models.advection import simulate_advection, single_vortex
    from tpuvof_torch.ops import mg as mg_mod

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    for c in counters:
        c.reset_launch_counts()

    # card f64 against CPU f64, the same seeded F0
    rng = np.random.default_rng(SEED)
    cases = [("unrolled 24^2 x20", diff.diff_config(24, adjoint="unrolled"), 20),
             ("selfadjoint 24^2 x20", diff.diff_config(24), 20)]
    cases += [(f"{s} 16^2 x3", diff.diff_config(16, pressure_solver=s, sor_tol=1e-11,
                                                sor_max_iter=3000), 3) for s in ("mg", "rbsor")]
    for label, cfg, steps in cases:
        F0 = rng.uniform(0.2, 0.8, cfg.grid.shape)
        T = diff.diff_target(cfg, 2, device="cpu").to(torch.float64)
        (lc, gc), (lh, gh) = (diff.loss_and_grad(cfg, torch.as_tensor(F0, device=d),
                                                 T.to(d), steps) for d in ("cuda", "cpu"))
        loss_rel = abs(lc.item() - lh.item()) / abs(lh.item())
        grad_rel = (gc.cpu() - gh).abs().max().item() / gh.abs().max().item()
        print(f"diff card f64 vs CPU f64 {label}: loss {lc.item():.15e} rel {loss_rel:.3e} "
              f"(bar {DIFF_TOL_LOSS:.0e}); grad rel {grad_rel:.3e} (bar {DIFF_TOL_GRAD:.0e}), "
              f"max|g| {gh.abs().max().item():.4e}")
        check(loss_rel <= DIFF_TOL_LOSS, f"diff {label}: loss rel {loss_rel:.3e}")
        check(grad_rel <= DIFF_TOL_GRAD, f"diff {label}: grad rel {grad_rel:.3e}")

    # the reference's workload, f32, uncut: 3 epochs of 999 steps
    cfg = diff.diff_config(DIFF_N)
    target = diff.diff_target(cfg, 2)
    zeros = torch.zeros_like(target)
    opts = diff.DiffOptions(n_steps=DIFF_STEPS, remat=True)
    stamps, epochs = [], []
    base = {}  # bytes allocated when the peak was reset: earlier phases' tensors

    def record(epoch, loss, F0, grad):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        g_int = grad[1:-1, 1:-1]
        epochs.append({"loss": loss, "max_g": grad.abs().max().item(),
                       "gate_share": (g_int.abs() < opts.grad_gate).double().mean().item(),
                       "finite": bool(torch.isfinite(grad).all()),
                       "F0_range": (F0.min().item(), F0.max().item())})
        if epoch == DIFF_EPOCHS - 2:  # the last epoch's peak: one loss_and_grad's
            torch.cuda.reset_peak_memory_stats()
            base[True] = torch.cuda.memory_allocated()
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    diff.optimize_f0(cfg, target, opts=opts, n_epochs=DIFF_EPOCHS, callback=record)
    peak = {True: torch.cuda.max_memory_allocated() - base[True]}
    secs = [b - a for a, b in zip(stamps[::2], stamps[1::2])]
    for k, (e, sec) in enumerate(zip(epochs, secs)):
        print(f"diff {DIFF_N}^2 f32 x{DIFF_STEPS} epoch {k}: loss {e['loss']:.6e} max|g| "
              f"{e['max_g']:.4e} gate |g| < {opts.grad_gate} lets {e['gate_share']:.4f} of the "
              f"interior through; F0 in [{e['F0_range'][0]:.4f}, {e['F0_range'][1]:.4f}]; "
              f"{sec:.3f} s {tag}")
        check(np.isfinite(e["loss"]) and e["finite"], f"diff epoch {k}: non-finite")
        check(0.0 <= e["F0_range"][0] and e["F0_range"][1] <= 1.0,
              f"diff epoch {k}: F0 outside [0, 1]: {e['F0_range']}")
    print(f"diff {DIFF_N}^2 f32 x{DIFF_STEPS}: {np.mean(secs[1:]):.3f} s/epoch (epochs 1-"
          f"{DIFF_EPOCHS - 1}; host clock behind synchronize fences) {tag}")
    wall, idle = idle_share(lambda: diff.loss_and_grad(cfg, zeros, target, DIFF_IDLE_STEPS))
    print(f"diff {DIFF_N}^2 f32 loss_and_grad x{DIFF_IDLE_STEPS}: {wall / DIFF_IDLE_STEPS:.3f} "
          f"ms/step host, device idle "
          f"{'not measured' if idle is None else f'{100 * idle:.1f}%'} {tag}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base[False] = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    _, grad = diff.loss_and_grad(cfg, zeros, target, DIFF_STEPS, remat=False)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    peak[False] = torch.cuda.max_memory_allocated() - base[False]
    check(bool(torch.isfinite(grad).all()), "diff remat=False: non-finite grad")
    for remat, b in peak.items():
        print(f"diff {DIFF_N}^2 f32 x{DIFF_STEPS} one loss_and_grad remat={remat}: peak "
              f"{b / 2**20:.1f} MiB (max_memory_allocated above the {base[remat] / 2**20:.1f} "
              f"MiB held before it{', the last epoch' if remat else f'; {sec:.3f} s'}) {tag}")

    # max|g| under 'unrolled' and 'selfadjoint' over the horizon (remat off:
    # the same gradient, bit for bit, in less time). From F0 = 0, F stays 0,
    # every flux F u dt and its derivative in u vanish, and no cotangent
    # reaches the velocity or the pressure solve: both adjoints must give one
    # gradient. From the dam break the solve's adjoint acts; there the card
    # is held beside the CPU's f32 unrolled gradient (recorded, not gated).
    dam = torch.as_tensor(tt.initial_volume_fraction(cfg.grid, 1), device="cuda")
    blowup = {"zeros": {}, "dam_break": {}}
    for start, F0, horizons in (("zeros", zeros, DIFF_HORIZONS),
                                ("dam_break", dam, DIFF_HORIZONS_DAM)):
        for h in horizons:
            row, grads = {}, {}
            for adjoint in ("unrolled", "selfadjoint"):
                _, grads[adjoint] = diff.loss_and_grad(
                    diff.diff_config(DIFF_N, adjoint=adjoint), F0, target, h, remat=False)
                row[adjoint] = grads[adjoint].abs().max().item()
            if start == "zeros":
                same = torch.equal(grads["unrolled"], grads["selfadjoint"])
                print(f"diff blow-up probe {DIFF_N}^2 f32 x{h} from F0 = 0: max|g| unrolled "
                      f"{row['unrolled']:.4e}, selfadjoint {row['selfadjoint']:.4e} (bar "
                      f"{DIFF_GRAD_BOUND}); equal bit for bit {same}")
                check(np.isfinite(row["selfadjoint"]) and row["selfadjoint"] < DIFF_GRAD_BOUND,
                      f"diff selfadjoint x{h}: max|g| {row['selfadjoint']}")
                check(same, f"diff x{h} from F0 = 0: the adjoints' gradients differ")
            else:
                _, g_cpu = diff.loss_and_grad(diff.diff_config(DIFF_N, adjoint="unrolled"),
                                              F0.cpu(), target.cpu(), h, remat=False)
                row["unrolled_cpu"] = g_cpu.abs().max().item()
                row["card_vs_cpu"] = ((grads["unrolled"].cpu() - g_cpu).abs().max().item()
                                      / max(row["unrolled_cpu"], 1e-30))
                print(f"diff blow-up probe {DIFF_N}^2 f32 x{h} from the dam break: max|g| "
                      f"unrolled {row['unrolled']:.4e} (CPU {row['unrolled_cpu']:.4e}, "
                      f"|card - CPU| / max|CPU| {row['card_vs_cpu']:.3e}), selfadjoint "
                      f"{row['selfadjoint']:.4e}")
            blowup[start][h] = row
    for start, rows in blowup.items():
        (h0, r0), (h1, r1) = next(iter(rows.items())), list(rows.items())[-1]
        u0, u1 = r0["unrolled"], r1["unrolled"]
        if np.isfinite(u1) and u0 > 0:
            print(f"diff unrolled growth from {start}, {h0} -> {h1} steps: x{u1 / u0:.4e}, "
                  f"x{(u1 / u0) ** (1.0 / (h1 - h0)):.6f} a step")

    # the converged mg projection; its V-cycles counted through the exit test
    cfg_mg = diff.diff_config(DIFF_N, pressure_solver="mg", sor_tol=0.0, sor_tol_rel=1e-3,
                              sor_max_iter=50)
    keep = mg_mod.keep_iterating
    for start, F0 in (("zeros", zeros), ("dam_break", dam)):
        calls = [0, 0]  # exit tests, solves

        def counting(it, *a):
            calls[0] += 1
            calls[1] += it == 0
            return keep(it, *a)

        mg_mod.keep_iterating = counting
        try:
            # the forward alone gives the V-cycles a forward solve takes
            for _ in diff.rollout_frames(cfg_mg, F0, DIFF_MG_STEPS, DIFF_MG_STEPS):
                pass
            cycles_fwd = (calls[0] - calls[1]) / calls[1]
            calls[:] = [0, 0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, grad = diff.loss_and_grad(cfg_mg, F0, target, DIFF_MG_STEPS)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        finally:
            mg_mod.keep_iterating = keep
        max_g = grad.abs().max().item()
        print(f"diff mg {DIFF_N}^2 f32 x{DIFF_MG_STEPS} (sor_tol_rel 1e-3) from {start}: loss "
              f"{loss.item():.6e} max|g| {max_g:.4e}; {sec:.3f} s; {cycles_fwd:.2f} V-cycles a "
              f"forward solve; {calls[1]} solves, {calls[0] - calls[1]} V-cycles in "
              f"loss_and_grad (forward, recompute, adjoint) {tag}")
        check(bool(torch.isfinite(loss)) and bool(torch.isfinite(grad).all()),
              f"diff mg from {start}: non-finite")
        if start == "zeros":
            check(max_g < DIFF_GRAD_BOUND, f"diff mg: max|g| {max_g}")

    # the single vortex at the reference's own size
    case, F0, u, v, Ftarget = single_vortex()
    mass0 = F0[1:-1, 1:-1].double().sum().item()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    F = simulate_advection(case, F0, u, v, VORTEX_STEPS)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / VORTEX_STEPS
    drift = (F[1:-1, 1:-1].double().sum().item() - mass0) / mass0
    Fmin, Fmax = F.min().item(), F.max().item()
    print(f"advection single_vortex {case.grid.nx}^2 f32 x{VORTEX_STEPS}: mass drift "
          f"{drift:.4e} (bar {VORTEX_MASS_BAR:.1e}), F in [{Fmin:.4f}, {Fmax:.4f}] (bar "
          f"{VORTEX_BOUND}), {ms:.4f} ms/step host {tag}")
    check(bool(torch.isfinite(F).all()), "vortex: non-finite F")
    check(abs(drift) <= VORTEX_MASS_BAR, f"vortex: mass drift {drift:.3e}")
    check(Fmin > -VORTEX_BOUND and Fmax < 1 + VORTEX_BOUND, f"vortex: F in [{Fmin}, {Fmax}]")
    wall, idle = idle_share(lambda: simulate_advection(case, F0, u, v, DIFF_IDLE_STEPS))
    print(f"advection single_vortex {case.grid.nx}^2 f32 x{DIFF_IDLE_STEPS}: "
          f"{wall / DIFF_IDLE_STEPS:.4f} ms/step host, device idle "
          f"{'not measured' if idle is None else f'{100 * idle:.1f}%'} {tag}")
    loss, grad = diff.advection_loss_and_grad(case, F0, u, v, Ftarget, ADVECTION_GRAD_STEPS)
    print(f"advection_loss_and_grad {case.grid.nx}^2 f32 x{ADVECTION_GRAD_STEPS}: loss "
          f"{loss.item():.6e} max|g| {grad.abs().max().item():.4e}")
    check(bool(torch.isfinite(loss)) and bool(torch.isfinite(grad).all()),
          "advection_loss_and_grad: non-finite")

    torch.cuda.synchronize()
    launches = {k: n for c in counters for k, n in c.LAUNCHES.items() if n}
    print(f"diff path launches of csrc/ kernels: {launches}")
    check(not launches, f"the differentiable path launched kernels: {launches}")
    print(f"phase 15 (differentiable path): {time.perf_counter() - t_phase:.1f} s {tag}")


def cli_run(cli, counters, label, argv):
    """``cli.main(argv)`` with every count set to 0 just before and read
    just after; fails unless it returns 0. Returns (launches, its standard
    output, seconds); the output's first and last lines are echoed."""
    torch.cuda.synchronize()
    for c in counters:
        c.reset_launch_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: n for c in counters for k, n in c.LAUNCHES.items() if n}
    lines = out.getvalue().splitlines()
    for line in lines[:1] + lines[-2:]:
        print(f"  {label} | {line}")
    print(f"{label}: rc {rc}, launches {launches} ({secs:.2f} s)")
    check(rc == 0, f"{label}: the CLI returned {rc}")
    return launches, out.getvalue(), secs


def cli_rate(text: str) -> tuple[float, float]:
    """(wall seconds, cell-updates/s) of the CLI's closing line."""
    import re

    m = re.search(r">>> \d+ steps in ([0-9.]+)s \(([0-9.e+-]+) cell-updates/s", text)
    check(m is not None, "the CLI printed no closing rate line")
    return float(m.group(1)), float(m.group(2))


def same_state(got, want, label: str) -> None:
    diff = max((a.double() - b.double()).abs().max().item() for a, b in zip(got, want))
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    print(f"{label}: bit for bit {same}, max|d| {diff:.3e}")
    check(same, f"{label}: max|d| {diff:.3e}")


@contextlib.contextmanager
def loop_tests():
    """Count the calls of the residual-driven solves' exit test
    (ops.poisson.keep_iterating): one for each SOR iteration or V-cycle and
    one more for each solve, each after one host read of the global
    residual; in every module that runs such a loop."""
    from tpuvof_torch.ops import mg, poisson
    from tpuvof_torch.parallel import mg as pmg

    count = [0]
    real = poisson.keep_iterating

    def counted(*a):
        count[0] += 1
        return real(*a)

    mods = (poisson, mg, pmg)
    for m in mods:
        m.keep_iterating = counted
    try:
        yield count
    finally:
        for m in mods:
            m.keep_iterating = real


def counted_run(counters, fn):
    """(fn's result, launches, loop tests, seconds), every count set to 0
    just before ``fn`` and read just after."""
    torch.cuda.synchronize()
    for c in counters:
        c.reset_launch_counts()
    with loop_tests() as calls:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    return out, {k: n for c in counters for k, n in c.LAUNCHES.items() if n}, calls[0], secs


def virtual_mesh(tt, shape, dev):
    names = ("mx", "my")[:len(shape)]
    return tt.make_mesh(int(np.prod(shape)), names, [dev] * int(np.prod(shape)))


def run_ladder_phase(tt, counters, golden3, tag) -> None:
    """Phase 17: the distributed solver ladder (see the module's
    docstring)."""
    from tpuvof_torch import cli, io_utils

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    f64 = torch.float64
    I = (slice(1, -1),) * 3

    # ---- a. Decomp3D(backend='torch') vs the serial plain path and the golden ----
    n, ck = int(golden3["n"]), int(golden3["checkpoint"])
    g = tt.Grid3D(n, n, n)
    s0 = tt.init_state_3d(g, 1, dev, f64)
    serial, launches, _, secs = counted_run(
        counters, lambda: tt.simulate_3d(g, s0, ck, backend="torch"))
    print(f"ladder a: serial 'torch' {n}^3 f64 x{ck}: launches {launches} ({secs:.2f} s)")
    check(launches == {}, f"serial 'torch' launched {launches}")
    for shape in LADDER_TORCH_MESHES:
        dec = tt.Decomp3D(g, virtual_mesh(tt, shape, dev), backend="torch")
        got, launches, _, secs = counted_run(counters, lambda: dec.simulate(s0, ck))
        rel = max(rel_err(a, b)[0] for a, b in zip(got, serial))
        gold = max(np.abs(getattr(got, k).cpu().numpy() - golden3[f"{k}100"]).max()
                   for k in "Fu")
        print(f"ladder a: Decomp3D(backend='torch') {shape} (nx/px {dec.nxl}) {n}^3 f64 "
              f"x{ck}: launches {launches}, vs serial 'torch' rel {rel:.3e} (bar 1e-12), vs "
              f"the golden's F100/u100 {gold:.3e} (bar 1e-9) ({secs:.2f} s)")
        check(launches == {}, f"Decomp3D(backend='torch') {shape} launched {launches}")
        check(rel <= 1e-12, f"Decomp3D(backend='torch') {shape} vs serial {rel:.3e}")
        check(gold <= 1e-9, f"Decomp3D(backend='torch') {shape} vs the golden {gold:.3e}")

    # ---- b. the hybrid vs the serial hybrid, f64 ----
    steps = STEPS3_LADDER_HYBRID
    for solver in ("rbsor", "mg"):
        want, l_ser, c_ser, secs = counted_run(counters, lambda: tt.simulate_3d(
            g, s0, steps, pressure_solver=solver, **LADDER_SOLVE))
        print(f"ladder b: serial hybrid {solver} {n}^3 f64 x{steps}: launches {l_ser}, "
              f"{c_ser - steps} iterations ({secs:.2f} s)")
        for shape in LADDER_HYBRID_MESHES:
            dec = tt.Decomp3D(g, virtual_mesh(tt, shape, dev), pressure_solver=solver,
                              **LADDER_SOLVE)
            got, launches, calls, secs = counted_run(counters, lambda: dec.simulate(s0, steps))
            errs = {k: (getattr(got, k)[I] - getattr(want, k)[I]).abs().max().item()
                    for k in "Fuvwp"}
            k = len(dec.coords)
            print(f"ladder b: Decomp3D hybrid {solver} {shape} (W {dec.W}) {n}^3 f64 x{steps}:"
                  f" launches {launches}, {calls - steps} iterations (serial "
                  f"{c_ser - steps}), max|d| vs the serial hybrid " +
                  ", ".join(f"{q} {e:.3e}" for q, e in errs.items()) +
                  f" (bars 1e-12, p 1e-7) ({secs:.2f} s; {time.perf_counter() - t_phase:.1f} s "
                  "into the phase)")
            check(launches == {q: k * v for q, v in l_ser.items()},
                  f"hybrid {solver} {shape} launches {launches} != {k} x {l_ser}")
            check(calls == c_ser, f"hybrid {solver} {shape}: {calls} loop tests != {c_ser}")
            check(max(errs[q] for q in "Fuvw") <= 1e-12 and errs["p"] <= 1e-7,
                  f"hybrid {solver} {shape} vs serial {errs}")

    # ---- c. the slice at full width: 200^3 f32, 2x2 pencils ----
    g3 = tt.Grid3D(N3_MAIN, N3_MAIN, N3_MAIN)
    s3 = tt.init_state_3d(g3, 1, dev)
    mesh = virtual_mesh(tt, (2, 2), dev)

    def mass(s):
        return s.F[I].double().sum().item()

    ends = {}
    for solver, steps in LADDER_RUNS:
        kw = dict(pressure_solver=solver, sor_tol_rel=LADDER_TOL_REL)
        want, l_ser, c_ser, secs_ser = counted_run(
            counters, lambda: tt.simulate_3d(g3, s3, steps, **kw))
        dec = tt.Decomp3D(g3, mesh, **kw)
        blocks0 = dec.widen(dec.scatter_state(s3))
        blocks, launches, calls, secs = counted_run(counters,
                                                    lambda: dec.advance(blocks0, steps))
        got = ends[solver] = dec.gather_state(dec.narrow(blocks))
        finite = all(bool(torch.isfinite(a).all()) for b in blocks for a in b)
        Fmin = min(b.F.min().item() for b in blocks)
        Fmax = max(b.F.max().item() for b in blocks)
        drift = abs(mass(got) - mass(s3)) / mass(s3)
        dF = (got.F - want.F).abs().max().item()
        rel_p = rel_err(got.p, want.p)[0]
        check(launches == {q: 4 * v for q, v in l_ser.items()} and "jacobi3d" not in launches,
              f"hybrid {solver} 2x2 launches {launches} != 4 x {l_ser}")
        check(finite, f"hybrid {solver} 2x2: non-finite values in the blocks")
        check(0.0 <= Fmin and Fmax <= 1.0, f"hybrid {solver} 2x2: F in [{Fmin}, {Fmax}]")
        check(drift <= 1e-3, f"hybrid {solver} 2x2: mass drift {drift:.3e}")
        wall_d, idle_d = idle_share(lambda: dec.advance(blocks0, LADDER_IDLE_STEPS))
        wall_s, idle_s = idle_share(lambda: tt.simulate_3d(g3, s3, LADDER_IDLE_STEPS, **kw))

        def pct(x):
            return "not measured" if x is None else f"{100 * x:.1f}%"

        unit = "V-cycles" if dec.pressure_solver == "mg" else "iterations"
        print(f"{tag} ladder c: hybrid {solver} -> {dec.pressure_solver}, sor_tol_rel "
              f"{LADDER_TOL_REL}, {N3_MAIN}^3 f32 x{steps} on the 2x2 pencil mesh: launches "
              f"{launches} (4 x the serial {l_ser}); {1e3 * secs / steps:.2f} ms/step on the "
              f"host clock (serial hybrid {1e3 * secs_ser / steps:.2f}); {unit} a step "
              f"{(calls - steps) / steps:.2f} (serial {(c_ser - steps) / steps:.2f}); global "
              f"residual reads a step {calls / steps:.2f} and one tolerance read; idle share "
              f"{pct(idle_d)} over {LADDER_IDLE_STEPS} steps ({wall_d:.1f} ms; serial "
              f"{pct(idle_s)}, {wall_s:.1f} ms); finite, F in [{Fmin:.3e}, {Fmax:.3e}], mass "
              f"drift {drift:.3e}; vs the serial hybrid max|dF| {dF:.3e}, rel p {rel_p:.3e} "
              f"({time.perf_counter() - t_phase:.1f} s into the phase)")
        check(dF == 0 and rel_p == 0, f"hybrid {solver} 2x2 vs the serial hybrid: "
              f"max|dF| {dF:.3e}, rel p {rel_p:.3e} (want bit for bit)")

    # the CLI with the production upgrade on the 2x2 mesh: its device lookup
    # gives the cards cuda:0 onwards, so the virtual mesh stands in for it
    solver, steps = LADDER_RUNS[0]
    work = tempfile.TemporaryDirectory()
    argv = ["--three-d", "--nx", str(N3_MAIN), "--steps", str(steps), "--frame-every",
            str(steps), "--checkpoint-every", str(steps), "--mesh", "2,2",
            "--pressure-solver", "mg", "--sor-tol-rel", str(LADDER_TOL_REL),
            "--outdir", work.name]
    real_mesh = cli._mesh_3d
    cli._mesh_3d = lambda args: (mesh, None)
    try:
        launches, _, _ = cli_run(cli, counters, "ladder c: CLI --three-d --mesh 2,2 "
                                 f"--pressure-solver mg --sor-tol-rel {LADDER_TOL_REL}", argv)
    finally:
        cli._mesh_3d = real_mesh
    end, _, _ = io_utils.load_checkpoint_3d(
        os.path.join(work.name, f"ckpt_{steps:06d}.npz"), dev)
    check(os.path.getsize(os.path.join(work.name, f"step-{steps:05d}.vtk")) > N3_MAIN ** 3,
          "the CLI wrote no VTK")
    same_state(end, ends[solver], f"ladder c: the CLI's checkpoint == Decomp3D({solver}, "
               f"sor_tol_rel={LADDER_TOL_REL}) x{steps}")
    work.cleanup()
    print(f"phase 17 (the distributed solver ladder): {time.perf_counter() - t_phase:.1f} s "
          f"{tag}")


def run_app_phase(tt, counters, s_mono_main, per_step3, tag) -> None:
    """Phase 16: the app layer on the card (see the module's docstring)."""
    import re

    from PIL import Image

    from tpuvof_torch import cli, io_utils, viz
    from tpuvof_torch.solver import TILE_ROWS

    dev = s_mono_main.F.device
    t_phase = time.perf_counter()
    work = tempfile.TemporaryDirectory()
    root = work.name
    n = str(N_MAIN)

    # ---- a. the main path through the CLI ----
    main_argv = ["-ic", "1", "--nx", n, "--steps", str(APP_STEPS), "--frame-every",
                 str(APP_FRAME_EVERY), "--backend", "cuda_mono", "-s", "--cycle-views",
                 "--checkpoint-every", "500", "--gif"]
    cli_runs = {}
    for variant, extra in (("cfl", []), ("no-cfl-warn", ["--no-cfl-warn"])):
        d = os.path.join(root, f"a-{variant}")
        launches, text, secs = cli_run(cli, counters, f"CLI main path ({variant})",
                                       main_argv + extra + ["--outdir", d])
        check(launches == {"fullstep": APP_STEPS},
              f"CLI main path ({variant}) launches {launches}")
        end, istep, echo = io_utils.load_checkpoint(os.path.join(d, "ckpt_001000.npz"),
                                                    dev)
        check(istep == APP_STEPS and echo["num"]["backend"] == "cuda_mono",
              f"ckpt_001000: istep {istep}, backend {echo['num']['backend']}")
        same_state(end, s_mono_main, f"CLI main path ({variant}) ckpt_001000 == simulate "
                                     "'cuda_mono' x1000 (phase 5)")
        cli_runs[variant] = (d, text, secs)
    d_a, text_a, _ = cli_runs["cfl"]
    files = sorted(os.listdir(d_a))
    frames = [f for f in files if re.fullmatch(r"\d{6}-(vof|u|v|vnorm|vectors)\.png", f)]
    modes = {f[7:-4] for f in frames}
    figs = [f for f in files if re.fullmatch(r"\d{6}-f\.png", f)]
    ckpts = [f for f in files if f.startswith("ckpt_")]
    with Image.open(os.path.join(d_a, "movie.gif")) as gif:
        n_gif = gif.n_frames
    print(f"CLI main path files: {len(frames)} frames in modes {sorted(modes)}, "
          f"{len(figs)} -f.png, checkpoints {ckpts}, movie.gif of {n_gif} frames")
    check(len(frames) == 10 and modes == set(viz.MODES), f"frames {frames}")
    check(len(figs) == 10 and ckpts == ["ckpt_000500.npz", "ckpt_001000.npz"],
          f"figures {figs}, checkpoints {ckpts}")
    check(n_gif == 10, f"movie.gif has {n_gif} frames")
    for f in frames:
        img = np.asarray(Image.open(os.path.join(d_a, f)))
        ink = int((img[..., :3].max(-1) < 8).sum())  # Blues' darkest is (8, 48, 107)
        check(img.shape == (2 * N_MAIN, 2 * N_MAIN, 4), f"{f}: shape {img.shape}")
        check((ink > 0) == f.endswith("vectors.png"), f"{f}: {ink} black arrow pixels")
    frame_lines = [ln for ln in text_a.splitlines() if ln.startswith(">>> Number of steps:")]
    check(len(frame_lines) == 10 and not any("NON-FINITE" in ln or "nan" in ln
                                             for ln in frame_lines),
          f"frame lines: {frame_lines}")

    # ---- b. resume at step 500 ----
    d_b = os.path.join(root, "b")
    launches, _, _ = cli_run(cli, counters, "CLI resume", [
        "--resume", os.path.join(d_a, "ckpt_000500.npz"), "--nx", n, "--steps", "500",
        "--frame-every", str(APP_FRAME_EVERY), "--backend", "cuda_mono",
        "--checkpoint-every", "500", "--outdir", d_b])
    check(launches == {"fullstep": 500}, f"CLI resume launches {launches}")
    end, _, _ = io_utils.load_checkpoint(os.path.join(d_b, "ckpt_001000.npz"), dev)
    same_state(end, s_mono_main, "CLI resume 500 + 500 == simulate x1000")
    got = sorted(f for f in os.listdir(d_b) if f.endswith(".png"))
    want = [f"{k:06d}-vof.png" for k in range(5, 10)]
    print(f"CLI resume frames: {got}")
    check(got == want, f"resumed frames {got} != {want}")

    # ---- c. the default route as users start it; strips and tiled ----
    d_c = os.path.join(root, "c")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "tpuvof_torch", "-ic", "2", "--nx", n,
                          "--steps", "200", "--frame-every", "100", "--outdir", d_c],
                         cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                         text=True, timeout=600)
    lines = res.stdout.splitlines()
    for line in lines[:1] + lines[-3:]:
        print(f"  python -m tpuvof_torch (default route) | {line}")
    print(f"python -m tpuvof_torch -ic 2 --nx {n} --steps 200: rc {res.returncode} "
          f"({time.perf_counter() - t0:.2f} s with the process's start)")
    check(res.returncode == 0, f"python -m tpuvof_torch: rc {res.returncode}: "
                               f"{res.stderr[-2000:]}")
    frame_lines = [ln for ln in lines if ln.startswith(">>> Number of steps:")]
    check(len(frame_lines) == 2 and not any("NON-FINITE" in ln or "nan" in ln
                                            for ln in frame_lines),
          f"python -m tpuvof_torch frame lines: {frame_lines}")
    s0 = tt.init_state(tt.dam_break_2d(N_MAIN), device=dev)
    for backend, kernel, per_step in (("cuda_strips", "fullstep_strips", 1),
                                      ("cuda_tiled", "fullstep_win", N_MAIN // TILE_ROWS)):
        cfg_b = tt.dam_break_2d(N_MAIN, num=tt.Numerics(backend=backend))
        want = tt.simulate(cfg_b, s0, APP_STEPS_ROUTES)
        for variant, extra in (("cfl", []), ("no-cfl-warn", ["--no-cfl-warn"])):
            d = os.path.join(root, f"c-{backend}-{variant}")
            label = f"CLI {backend} ({variant})"
            launches, _, _ = cli_run(cli, counters, label, [
                "-ic", "1", "--nx", n, "--steps", str(APP_STEPS_ROUTES), "--frame-every",
                str(APP_FRAME_EVERY), "--backend", backend, "--no-frames",
                "--checkpoint-every", str(APP_STEPS_ROUTES), "--outdir", d] + extra)
            check(launches == {kernel: per_step * APP_STEPS_ROUTES},
                  f"{label} launches {launches}")
            end, _, _ = io_utils.load_checkpoint(
                os.path.join(d, f"ckpt_{APP_STEPS_ROUTES:06d}.npz"), dev)
            same_state(end, want, f"{label} == simulate '{backend}' x{APP_STEPS_ROUTES}")

    # ---- d. 3-D ----
    g3 = tt.Grid3D(N3_MAIN, N3_MAIN, N3_MAIN)
    want3 = tt.simulate_3d(g3, tt.init_state_3d(g3, device=dev), APP_STEPS3)
    d_d = os.path.join(root, "d")
    argv3 = ["--three-d", "--nx", str(N3_MAIN), "--steps", str(APP_STEPS3), "--frame-every",
             "50", "--checkpoint-every", str(APP_STEPS3)]
    launches, _, _ = cli_run(cli, counters, "CLI 3-D", argv3 + ["--outdir", d_d])
    check(launches == {k: v * APP_STEPS3 for k, v in per_step3.items()},
          f"CLI 3-D launches {launches}")
    ck3 = os.path.join(d_d, f"ckpt_{APP_STEPS3:06d}.npz")
    end3, istep3, _ = io_utils.load_checkpoint_3d(ck3, dev)
    check(istep3 == APP_STEPS3, f"3-D checkpoint istep {istep3}")
    same_state(end3, want3, f"CLI 3-D (chunks of 50) == one simulate_3d x{APP_STEPS3}")
    with open(os.path.join(d_d, f"step-{APP_STEPS3:05d}.vtk"), "rb") as f:
        data = f.read()
    payload = data.split(b"LOOKUP_TABLE default\n", 1)[1][:-1]
    e = N3_MAIN + 2
    vtk = np.frombuffer(payload, ">f4").reshape(e, e, e).transpose(2, 1, 0)
    same = np.array_equal(vtk, end3.F.float().cpu().numpy())
    print(f"CLI 3-D step-{APP_STEPS3:05d}.vtk payload == F as float32: bit for bit {same}")
    check(same, "the VTK payload differs from F")
    launches, text, _ = cli_run(cli, counters, "CLI 3-D resume of 0 steps", [
        "--three-d", "--nx", str(N3_MAIN), "--steps", "0", "--resume", ck3,
        "--outdir", os.path.join(root, "d-resume")])
    check(launches == {} and f"resumed from {ck3} at step {APP_STEPS3}" in text,
          f"3-D resume of 0 steps: launches {launches}")
    again, _, _ = io_utils.load_checkpoint_3d(ck3, dev)
    same_state(again, end3, "3-D checkpoint reloaded")
    cards = torch.cuda.device_count()
    mesh = "2,2" if cards == 4 else str(cards)
    d_m = os.path.join(root, "d-mesh")
    launches, _, _ = cli_run(cli, counters, f"CLI 3-D --mesh {mesh}",
                             argv3 + ["--mesh", mesh, "--no-frames", "--outdir", d_m])
    check(launches == {k: cards * v * APP_STEPS3 for k, v in per_step3.items()},
          f"CLI 3-D --mesh {mesh} launches {launches}")
    endm, _, _ = io_utils.load_checkpoint_3d(os.path.join(d_m, f"ckpt_{APP_STEPS3:06d}.npz"),
                                         dev)
    same_state((endm.F,), (want3.F,), f"CLI 3-D --mesh {mesh} F == the serial run's")

    # ---- e. the optimiser and the advection cases: no kernel ----
    for label, argv, want_files in (
            ("CLI --optimize 1", ["--optimize", "1", "--nx", str(DIFF_N), "--epochs", "2",
                                  "--opt-steps", str(APP_OPT_STEPS)],
             {"F0_optimized.npy", "opt-0000-f0.png", "opt-0000-vs-target.png",
              "opt-0000-grad.png"}),
            ("CLI --optimize-case translation", ["--optimize-case", "translation",
                                                 "--epochs", "2"],
             {"F0_optimized.npy", "F0_optimized.png"}),
            ("CLI --case single_vortex", ["--case", "single_vortex", "--steps", "100"],
             {"single_vortex-000100.png"})):
        d = os.path.join(root, label.split()[-1])
        launches, text, _ = cli_run(cli, counters, label, argv + ["--outdir", d])
        check(launches == {}, f"{label}: kernel launches {launches}")
        got = set(os.listdir(d))
        check(got == want_files, f"{label}: files {sorted(got)}")

    # ---- f. times ----
    wall, cups = cli_rate(text_a)
    print(f"{tag} CLI main path {N_MAIN}^2 x{APP_STEPS} cuda_mono with frames (-s, "
          f"--cycle-views, 2 checkpoints, --gif): {wall:.2f} s, {cups:.4e} cell-updates/s "
          "incl. frame I/O (the CLI's line)")
    cfg_mono = tt.dam_break_2d(N_MAIN, num=tt.Numerics(backend="cuda_mono"))
    runs = {"CLI (CFL tracker)": [], "CLI --no-cfl-warn": [], "simulate": []}

    def timed_cli(extra):
        _, text, _ = cli_run(cli, counters, "CLI timing", main_argv[:8] + [
            "--backend", "cuda_mono", "--no-frames", "--outdir",
            os.path.join(root, "timing")] + extra)
        return cli_rate(text)[0]

    def timed_simulate():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tt.simulate(cfg_mono, s0, APP_STEPS)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    legs = [("CLI (CFL tracker)", lambda: timed_cli([])),
            ("CLI --no-cfl-warn", lambda: timed_cli(["--no-cfl-warn"])),
            ("simulate", timed_simulate)]
    for r in range(APP_REPEATS):
        for name, fn in legs if r % 2 == 0 else legs[::-1]:
            runs[name].append(fn())
    for name, secs in runs.items():
        best = min(secs)
        print(f"{tag} host ms/step {N_MAIN}^2 x{APP_STEPS} cuda_mono, {name}: "
              f"{1e3 * best / APP_STEPS:.4f} (best of {[round(t, 4) for t in secs]} s)")
    # where the CFL tracker's cost lies: the device's busy time a step
    # beside the host's, with and without it
    for name, fn in (("simulate", lambda: tt.simulate(cfg_mono, s0, APP_FRAME_EVERY)),
                     ("simulate_cfl", lambda: tt.simulate_cfl(cfg_mono, s0, APP_FRAME_EVERY))):
        wall_ms, idle = idle_share(fn)
        busy = "not measured" if idle is None else \
            f"{wall_ms * (1 - idle) / APP_FRAME_EVERY:.4f} ms/step, idle {100 * idle:.1f}%"
        print(f"{tag} {name} {N_MAIN}^2 x{APP_FRAME_EVERY} cuda_mono: "
              f"{wall_ms / APP_FRAME_EVERY:.4f} ms/step host; device busy {busy}")
    state = s_mono_main
    cfg = cfg_mono
    frame_ms = {}

    def frame(mode):
        path = os.path.join(root, "frame.png")
        if mode == "vectors":
            arrows = viz.arrow_field(viz.interp_velocity(cfg, state), arrow_spacing=4)
            io_utils.save_frame_png(path, viz.render_frame(cfg, state, "vof"), arrows)
        else:
            io_utils.save_frame_png(path, viz.render_frame(cfg, state, mode))

    for label, fn, reps in (
            (f"render_frame + save_frame_png (vof) at {N_MAIN}^2", lambda: frame("vof"), 5),
            (f"render_frame + save_frame_png (vectors, arrows) at {N_MAIN}^2",
             lambda: frame("vectors"), 2),
            (f"save_contour_png (-s) at {N_MAIN}^2", lambda: io_utils.save_contour_png(
                os.path.join(root, "f.png"), state.F, cfg.grid.Lx, cfg.grid.Ly), 5),
            (f"write_vtk of F at {N3_MAIN}^3", lambda: io_utils.write_vtk(
                os.path.join(root, "v"), {"VOF": want3.F}), 3)):
        fn()
        secs = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            secs.append(time.perf_counter() - t0)
        frame_ms[label] = 1e3 * min(secs)
        print(f"{tag} {label}: {frame_ms[label]:.2f} ms (best of "
              f"{[round(1e3 * t, 2) for t in secs]})")
    work.cleanup()
    print(f"phase 16 (the app layer): {time.perf_counter() - t_phase:.1f} s {tag}")


def shard_kernel_cases(tt, K, s):
    """(kernel name, kernel outputs, plain outputs, output names, region)
    of each 2-D kernel the decomposition launches, on the blocks the 512^2
    2x2 engines give it for the state ``s``: fullstep_win on the full-block
    engine's extended blocks, fullstep_strips on the strips engine's padded
    blocks (NaN in the margins no refresh writes), predict_win and
    fct_sweep_win on the hybrid's PHASE_HALO-widened blocks; each on the
    shards DECOMP_SHARDS (each with two walls in its block), compared on
    the centre the engine keeps."""
    mesh = virtual_mesh(tt, (2, 2), s.F.device)
    cfg = tt.dam_break_2d(N_MAIN, num=tt.Numerics(backend="cuda_mono"))
    full = tt.Decomp(cfg, mesh)
    strips = tt.Decomp(cfg.replace(num=tt.Numerics(backend="cuda_strips")), mesh)
    hybrid = tt.Decomp(cfg.replace(num=tt.Numerics(backend="cuda", pressure_solver="mg")), mesh)
    shards = full.scatter_state(s)
    ext = full.widen(shards)
    pad = strips.widen(shards)
    off = strips.W2 - strips.W
    strips._refresh(pad, strips.W, strips.W, off)
    for b in pad:
        for a in b:
            for sl in ((slice(0, off),), (slice(-off, None),), (slice(None), slice(0, off)),
                       (slice(None), slice(-off, None))):
                a[sl] = float("nan")
    F, u, v, _ = (list(f) for f in zip(*shards))
    Fh, uh, vh = (hybrid._extend(a, K.PHASE_HALO) for a in (F, u, v))
    cases = []
    for xy in DECOMP_SHARDS:
        k = full.coords.index(xy)
        W, W2, H = full.W, strips.W2, K.PHASE_HALO
        oi, oj = full.origin(k, W)
        cases.append(("fullstep_win", K.fullstep_win(cfg, *ext[k], oi, oj, True),
                      K.fullstep_win_plain(cfg, *ext[k], oi, oj, True), "Fuvp",
                      (slice(W, -W), slice(W, -W))))
        oi, oj = full.origin(k, 0)
        kw = dict(oi0=oi, oj0=oj)
        cases.append(("fullstep_strips",
                      K.fullstep_strips(cfg, *pad[k], False, extents=(full.nxl, full.nyl), **kw),
                      K.fullstep_strips_plain(cfg, *pad[k], False, **kw), "Fuvp",
                      (slice(W2, -W2), slice(W2, -W2))))
        oi, oj = full.origin(k, H)
        ctr = (slice(H, -H), slice(H, -H))
        cases.append(("predict_win", K.predict_win(cfg, uh[k], vh[k], Fh[k], oi, oj),
                      K.predict_win_plain(cfg, uh[k], vh[k], Fh[k], oi, oj), ("u*", "v*"), ctr))
        for axis, vel in ((0, uh[k]), (1, vh[k])):
            cases.append(("fct_sweep_win", (K.fct_sweep_win(cfg, Fh[k], vel, axis, oi, oj),),
                          (K.fct_sweep_win_plain(cfg, Fh[k], vel, axis, oi, oj),),
                          (f"F({'xy'[axis]})",), ctr))
    return cases, (ext[0], pad[0], (uh[0], vh[0], Fh[0]), full, strips)


def time_shard_kernels(tt, K, blocks, tag) -> dict:
    """Each kernel's device us a launch on the shard blocks of
    shard_kernel_cases (f32), beside its plain version's and its bound."""
    ext, pad, (uh, vh, Fh), full, strips = blocks
    cfg = full.cfg
    W, H = full.W, K.PHASE_HALO
    oi, oj = full.origin(0, W)
    pi, pj = full.origin(0, 0)
    hi, hj = full.origin(0, H)
    ext_kw = dict(extents=(full.nxl, full.nyl), oi0=pi, oj0=pj)
    timed = {
        "fullstep_win": (lambda: K.fullstep_win(cfg, *ext, oi, oj, False),
                         lambda: K.fullstep_win_plain(cfg, *ext, oi, oj, False), ext[0].shape),
        "fullstep_strips": (lambda: K.fullstep_strips(cfg, *pad, False, **ext_kw),
                            lambda: K.fullstep_strips_plain(cfg, *pad, False, oi0=pi, oj0=pj),
                            pad[0].shape),
        "predict_win": (lambda: K.predict_win(cfg, uh, vh, Fh, hi, hj),
                        lambda: K.predict_win_plain(cfg, uh, vh, Fh, hi, hj), Fh.shape),
        "fct_sweep_win_x": (lambda: K.fct_sweep_win(cfg, Fh, uh, 0, hi, hj),
                            lambda: K.fct_sweep_win_plain(cfg, Fh, uh, 0, hi, hj), Fh.shape),
        "fct_sweep_win_y": (lambda: K.fct_sweep_win(cfg, Fh, vh, 1, hi, hj),
                            lambda: K.fct_sweep_win_plain(cfg, Fh, vh, 1, hi, hj), Fh.shape),
    }
    times = {}
    for name, (kern, plain, shape) in timed.items():
        t = times[name] = {"block": list(shape), "ms": device_ms(kern, 20),
                           "plain_ms": device_ms(plain, 5), "host_ms": host_ms(kern, 100)}
        t.update(bound_of(name.removesuffix("_x").removesuffix("_y"), shape[0] * shape[1]))
        print(f"{tag} decomp {name:15s} {tuple(shape)} f32 (shard (0, 0) of 512^2 on 2x2): "
              f"kernel {1e3 * t['ms']:.2f} us/launch on the device ({1e3 * t['host_ms']:.2f} us "
              f"per call from Python); plain {1e3 * t['plain_ms']:.2f} us/call; bound "
              f"{1e3 * t['bound_ms']:.2f} us ({t['bound_by']})")
    x, y = times.pop("fct_sweep_win_x"), times.pop("fct_sweep_win_y")
    times["fct_sweep_win"] = {k: (x[k] + y[k]) / 2 if isinstance(x[k], float) else x[k]
                              for k in x}
    return times


def run_decomp_path(tt, K, label, dec, s0, steps, want_launches, serial_end, tag,
                    bit_for_bit="Fuvp"):
    """Drive ``steps`` of Decomp ``dec`` from ``s0`` through its public
    stages, every count set to 0 just before the steps and read just after;
    check the counts, the physics and the fields named in ``bit_for_bit``
    against the serial run (equal bit for bit); then time it: host-clock
    ms/step (best of 3), the device alone (a CUDA graph of a step pair),
    the idle share and the halo copies' device ms a step."""
    cfg = dec.cfg
    mass0 = tt.compute_metrics(cfg, s0).mass.item()
    blocks0 = dec.widen(dec.scatter_state(s0))
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    blocks = dec.advance(blocks0, steps)
    torch.cuda.synchronize()
    secs = [time.perf_counter() - t0]
    launches = {k: c for k, c in K.LAUNCHES.items() if c}
    print(f"{label} launches: {launches} ({secs[0]:.2f} s)")
    check(launches == want_launches, f"{label} launch counts {launches} != {want_launches}")
    s_end = dec.gather_state(dec.narrow(blocks))
    m = tt.compute_metrics(cfg, s_end)
    drift = abs(m.mass.item() - mass0) / mass0
    Fmin, Fmax = s_end.F.min().item(), s_end.F.max().item()
    diffs = {n: (a.double() - b.double()).abs().max().item()
             for n, a, b in zip("Fuvp", s_end, serial_end)}
    n = cfg.grid.nx
    print(f"{label} {n}^2 {str(s0.F.dtype)[6:]} x{steps} on {dec.px}x{dec.py} ({dec.engine}): "
          f"finite={bool(m.finite)} F in [{Fmin:.3e}, {Fmax:.3e}] mass drift {drift:.3e}; vs "
          "the serial run max|d| " + ", ".join(f"{q} {d:.3e}" for q, d in diffs.items()) +
          f" (bar 0 for {bit_for_bit})")
    check(bool(m.finite), f"{label}: non-finite fields")
    check(0.0 <= Fmin and Fmax <= 1.0, f"{label}: F outside [0, 1]: [{Fmin}, {Fmax}]")
    check(drift <= 1e-3, f"{label}: mass drift {drift:.3e} > 1e-3")
    check(all(torch.equal(a, b) for q, a, b in zip("Fuvp", s_end, serial_end)
              if q in bit_for_bit), f"{label}: {bit_for_bit} differ from the serial run {diffs}")
    for _ in range(2):  # best of 3 on the host clock
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec.advance(blocks0, steps)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    step_ms = 1e3 * min(secs) / steps
    dev_ms = device_ms(lambda: dec.advance(blocks, 2), 2) / 2
    off = dec.W2 - dec.W if dec.engine == "strips" else 0
    halo_ms = device_ms(lambda: dec._refresh(blocks, dec.W, dec.W, off), 10)
    print(f"{tag} {label} {n}^2 x{steps} f32 on {dec.px}x{dec.py} ({dec.engine}): best "
          f"{min(secs):.4f} s of {[round(t, 4) for t in secs]}, {n * n * steps / min(secs):.4e} "
          f"cell-updates/s, {step_ms:.4f} ms/step; device alone {dev_ms:.4f} ms/step, idle "
          f"{100 * (1 - dev_ms / step_ms):.1f}% of the host-clock step; halo copies "
          f"{halo_ms:.4f} ms/step on the device ({100 * halo_ms / dev_ms:.1f}%)")
    return {"launches": launches, "end": s_end, "step_ms": step_ms, "dev_ms": dev_ms,
            "halo_ms": halo_ms, "cups": n * n * steps / min(secs)}


def serial_times(tt, label, cfg, s0, steps, tag) -> dict:
    """Host-clock ms/step (best of 3 after a warm-up) and the device alone
    (a CUDA graph of a step pair) of serial ``simulate`` on ``cfg``."""
    secs = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s_end = tt.simulate(cfg, s0, steps)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    step_ms = 1e3 * min(secs[1:]) / steps
    dev_ms = device_ms(lambda: tt.step_pair(cfg, s_end, lean=True), 10) / 2
    n = cfg.grid.nx
    print(f"{tag} {label} {n}^2 x{steps} f32 serial: best {min(secs[1:]):.4f} s of "
          f"{[round(t, 4) for t in secs[1:]]}, {n * n * steps / min(secs[1:]):.4e} "
          f"cell-updates/s, {step_ms:.4f} ms/step; device alone {dev_ms:.4f} ms/step, idle "
          f"{100 * (1 - dev_ms / step_ms):.1f}%")
    return {"end": s_end, "step_ms": step_ms, "dev_ms": dev_ms}


def multi_card_check(label, make_dec, s0, steps, want) -> None:
    """Where the machine has four cards: the same run with its shards on
    cuda:0-cuda:3, its F equal bit for bit to the virtual mesh's (``want``):
    the cross-device ordering of the halo copies. With fewer cards it says
    that the check did not run."""
    n = torch.cuda.device_count()
    if n < 4:
        print(f"{label} on cuda:0-cuda:3: not run, the machine has {n} card(s); the virtual "
              "mesh's check above ran")
        return
    dec = make_dec([torch.device("cuda", i) for i in range(4)])
    got = dec.simulate(s0, steps)
    torch.cuda.synchronize()
    dF = (got.F - want.F).abs().max().item()
    same = torch.equal(got.F, want.F)
    print(f"{label} on cuda:0-cuda:3: F equal to the virtual mesh's bit for bit {same} "
          f"(max|dF| {dF:.3e})")
    check(same, f"{label} on four cards: max|dF| {dF:.3e} against the virtual mesh")


def run_decomp_phase(tt, counters, golden, s64, s_mono_main, dist3, tag,
                     dev=torch.device("cuda")) -> dict:
    """Phase 18: the 2-D decomposition (see the module's docstring), on
    ``dev``. Returns the kernel results and times the kernels line needs."""
    from tpuvof_torch import cli, io_utils
    from tpuvof_torch.kernels import step_kernels as K
    from tpuvof_torch.parallel import mg as pmg
    from tpuvof_torch.parallel import plan

    t_phase = time.perf_counter()
    f64 = torch.float64
    mesh = virtual_mesh(tt, (2, 2), dev)
    out = {"results": {}, "launches": {}}

    # ---- the kernels against their plain versions on the engines' blocks ----
    for dtype in (f64, torch.float32):
        key = "f64" if dtype == f64 else "f32"
        s = tt.State(*(a.to(dtype).contiguous() for a in s64))
        cases, blocks = shard_kernel_cases(tt, K, s)
        for name, got, want, outs, region in cases:
            torch.cuda.synchronize()
            for out_name, g_, w_ in zip(outs, got, want):
                rel, diff = rel_err(g_[region], w_[region])
                tol = TOL_F64 if key == "f64" else TOL_F32.get(out_name, TOL_F32_DEFAULT)
                r = out["results"].setdefault(name, {"rel_f64": 0.0, "rel_f32": 0.0,
                                                     "abs_f32": 0.0})
                r[f"rel_{key}"] = max(r[f"rel_{key}"], rel)
                if key == "f32":
                    r["abs_f32"] = max(r["abs_f32"], diff)
                print(f"kernel vs plain {key} decomp {name:15s} {tuple(g_.shape)} "
                      f"{out_name:5s} rel {rel:.3e} (bar {tol:.0e}) abs {diff:.3e}")
                check(rel <= tol, f"decomp {name} {out_name} {key}: rel {rel:.3e} > {tol:.0e}")
    out["times"] = time_shard_kernels(tt, K, blocks, tag)
    del blocks

    # ---- a. the 64^2 golden in f64 ----
    n_g, ck = int(golden["n"]), int(golden["checkpoint"])
    cfg_t = tt.dam_break_2d(n_g, num=tt.Numerics(backend="torch"))
    s0 = tt.init_state(cfg_t, 1, dev, f64)
    serial_t, launches, _, secs = counted_run(counters, lambda: tt.simulate(cfg_t, s0, ck))
    check(launches == {}, f"serial 'torch' launched {launches}")
    cfg_m = tt.dam_break_2d(n_g, num=tt.Numerics(backend="cuda_mono"))
    serial_m, launches, _, _ = counted_run(counters, lambda: tt.simulate(cfg_m, s0, ck))
    check(launches == {"fullstep": ck}, f"serial mono launches {launches}")

    def golden_err(s):
        return max(np.abs(getattr(s, k).cpu().numpy() - golden[f"{k}{ck}"]).max() for k in "Fu")

    # the torch engine against the serial 'torch' run (bar 1e-12 of each
    # field's scale, as phase 17 (a)); the kernel engines against the
    # serial 'cuda_mono' run, bit for bit: the same kernel, with an origin
    cases = [(f"torch {shape}", cfg_t, shape, "torch", serial_t, {})
             for shape in DECOMP_TORCH_MESHES]
    cases += [(f"{b} (2, 2)", cfg_m.replace(num=tt.Numerics(backend=b)), (2, 2), "cuda_mono",
               serial_m, {name: 4 * ck})
              for b, name in (("cuda_mono", "fullstep_win"), ("cuda_tiled", "fullstep_win"),
                              ("cuda_strips", "fullstep_strips"))]
    for label, cfg, shape, serial_name, serial, want_launches in cases:
        dec = tt.Decomp(cfg, virtual_mesh(tt, shape, dev))
        got, launches, _, secs = counted_run(counters, lambda: dec.simulate(s0, ck))
        diffs = {q: (a - b).abs().max().item() for q, a, b in zip("Fuvp", got, serial)}
        rel = max(rel_err(a, b)[0] for a, b in zip(got, serial))
        gold = golden_err(got)
        bar = "0" if serial_name == "cuda_mono" else "rel 1e-12"
        print(f"decomp a: {label} {dec.engine} engine (blocks {dec.nxl}x{dec.nyl}) {n_g}^2 f64 "
              f"x{ck}: launches {launches}; vs the serial '{serial_name}' run max|d| " +
              ", ".join(f"{q} {d:.3e}" for q, d in diffs.items()) +
              f", rel {rel:.3e} (bar {bar}); vs the golden's F{ck}/u{ck} {gold:.3e} (bar 1e-8) "
              f"({secs:.2f} s)")
        check(launches == want_launches, f"decomp a {label}: launches {launches}")
        if serial_name == "cuda_mono":
            check(all(torch.equal(a, b) for a, b in zip(got, serial)),
                  f"decomp a {label} vs serial {diffs}")
        else:
            check(rel <= 1e-12, f"decomp a {label} vs serial rel {rel:.3e}")
        check(gold <= 1e-8, f"decomp a {label} vs the golden {gold:.3e}")
    print(f"decomp a: {time.perf_counter() - t_phase:.1f} s into the phase")

    # ---- b. the hybrid in f64 at tpuvof's test tolerance ----
    real_gather = pmg.GATHER_VOLUME
    pmg.GATHER_VOLUME = DECOMP_GATHER_VOLUME
    try:
        for n, shape, steps in DECOMP_HYBRID_CASES:
            for solver in ("rbsor", "mg"):
                cfg = tt.dam_break_2d(n, num=tt.Numerics(backend="cuda", pressure_solver=solver,
                                                         **LADDER_SOLVE))
                sh = tt.init_state(cfg, 1, dev, f64)
                want, l_ser, c_ser, _ = counted_run(counters,
                                                    lambda: tt.simulate(cfg, sh, steps))
                dec = tt.Decomp(cfg, virtual_mesh(tt, shape, dev))
                got, launches, calls, secs = counted_run(counters,
                                                         lambda: dec.simulate(sh, steps))
                diffs = {q: (a - b).abs().max().item() for q, a, b in zip("Fuvp", got, want)}
                k = dec.px * dec.py
                print(f"decomp b: hybrid {solver} {shape} {n}^2 f64 x{steps}: launches "
                      f"{launches} (serial {l_ser}), {calls - steps} iterations (serial "
                      f"{c_ser - steps}), vs the serial hybrid max|d| " +
                      ", ".join(f"{q} {d:.3e}" for q, d in diffs.items()) +
                      f" (bar 0) ({secs:.2f} s)")
                check(launches == {"predict_win": k * steps, "fct_sweep_win": 2 * k * steps},
                      f"decomp b {solver} {shape}: launches {launches}")
                check(calls == c_ser, f"decomp b {solver} {shape}: {calls} != {c_ser} loop tests")
                check(all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"decomp b {solver} {shape} vs serial {diffs}")
    finally:
        pmg.GATHER_VOLUME = real_gather
    print(f"decomp b: {time.perf_counter() - t_phase:.1f} s into the phase")

    # ---- c. the slice's main path: 512^2 f32 x 1000 on 2x2 ----
    cfg_mono = tt.dam_break_2d(N_MAIN, num=tt.Numerics(backend="cuda_mono"))
    s32 = tt.init_state(cfg_mono, 1, dev)
    serial_c = serial_times(tt, "decomp c: 'cuda_mono'", cfg_mono, s32, STEPS_MAIN, tag)
    check(all(torch.equal(a, b) for a, b in zip(serial_c["end"], s_mono_main)),
          "decomp c: the serial mono run differs from phase 5's")
    engines = {}
    for e, backend, name in (("full", "cuda_mono", "fullstep_win"),
                             ("tiled", "cuda_tiled", "fullstep_win"),
                             ("strips", "cuda_strips", "fullstep_strips")):
        dec = tt.Decomp(cfg_mono.replace(num=tt.Numerics(backend=backend)), mesh)
        # a launch a shard; the tiled engine's a tile (solver.TILE_ROWS rows)
        per_step = 4 if dec.tile is None else 4 * (dec.nxl // dec.tile[0]) * (dec.nyl //
                                                                             dec.tile[1])
        engines[e] = run_decomp_path(tt, K, f"decomp c: {e}", dec, s32, STEPS_MAIN,
                                     {name: per_step * STEPS_MAIN}, s_mono_main, tag,
                                     bit_for_bit="F")
        print(f"decomp c: {time.perf_counter() - t_phase:.1f} s into the phase")
    out["launches"]["fullstep_win"] = engines["full"]["launches"].get("fullstep_win", 0)
    out["launches"]["fullstep_win tiled"] = engines["tiled"]["launches"].get("fullstep_win", 0)
    out["launches"]["fullstep_strips"] = engines["strips"]["launches"].get("fullstep_strips", 0)
    multi_card_check("decomp c: full 2x2 512^2 x1000",
                     lambda devs: tt.Decomp(cfg_mono, tt.make_mesh(4, ("mx", "my"), devs)),
                     s32, STEPS_MAIN, engines["full"]["end"])

    # ---- d. 2048^2 x 100, out of L2 ----
    cfg_big = tt.dam_break_2d(N18_BIG, num=tt.Numerics(backend="cuda_mono"))
    s_big = tt.init_state(cfg_big, 1, dev)
    serial_d = serial_times(tt, "decomp d: 'cuda_mono'", cfg_big, s_big, STEPS18_BIG, tag)
    run_decomp_path(tt, K, "decomp d: full", tt.Decomp(cfg_big, mesh), s_big, STEPS18_BIG,
                    {"fullstep_win": 4 * STEPS18_BIG}, serial_d["end"], tag, bit_for_bit="F")
    del s_big, serial_d
    print(f"decomp d: {time.perf_counter() - t_phase:.1f} s into the phase")

    # ---- e. the production hybrid at 512^2 ----
    I = (slice(1, -1), slice(1, -1))
    for solver, steps in DECOMP_RUNS:
        cfg = tt.dam_break_2d(N_MAIN, num=tt.Numerics(backend="cuda", pressure_solver=solver,
                                                      sor_tol_rel=LADDER_TOL_REL))
        want, l_ser, c_ser, secs_ser = counted_run(counters, lambda: tt.simulate(cfg, s32, steps))
        dec = tt.Decomp(cfg, mesh)
        got, launches, calls, secs = counted_run(counters, lambda: dec.simulate(s32, steps))
        check(launches == {"predict_win": 4 * steps, "fct_sweep_win": 8 * steps},
              f"decomp e {solver}: launches {launches}")
        if solver == "auto":
            out["launches"]["predict_win"] = launches.get("predict_win", 0)
            out["launches"]["fct_sweep_win"] = launches.get("fct_sweep_win", 0)
        m = tt.compute_metrics(cfg, got)
        mass0 = tt.compute_metrics(cfg, s32).mass.item()
        drift = abs(m.mass.item() - mass0) / mass0
        Fmin, Fmax = got.F.min().item(), got.F.max().item()
        dF = (got.F - want.F).abs().max().item()
        rel_p = rel_err(got.p[I], want.p[I])[0]
        blocks0 = dec.widen(dec.scatter_state(s32))
        wall_d, idle_d = idle_share(lambda: dec.advance(blocks0, 1))
        wall_s, idle_s = idle_share(lambda: tt.simulate(cfg, s32, 1))

        def pct(x):
            return "not measured" if x is None else f"{100 * x:.1f}%"

        unit = "V-cycles" if dec.cfg.num.pressure_solver == "mg" else "iterations"
        print(f"{tag} decomp e: hybrid {solver} -> {dec.cfg.num.pressure_solver}, sor_tol_rel "
              f"{LADDER_TOL_REL}, {N_MAIN}^2 f32 x{steps} on 2x2: launches {launches}; "
              f"{1e3 * secs / steps:.2f} ms/step on the host clock (serial hybrid "
              f"{1e3 * secs_ser / steps:.2f}); {unit} a step {(calls - steps) / steps:.2f} "
              f"(serial {(c_ser - steps) / steps:.2f}); idle share {pct(idle_d)} over one step "
              f"({wall_d:.1f} ms; serial {pct(idle_s)}, {wall_s:.1f} ms); finite="
              f"{bool(m.finite)}, F in [{Fmin:.3e}, {Fmax:.3e}], mass drift {drift:.3e}; vs "
              f"the serial hybrid max|dF| {dF:.3e}, rel p {rel_p:.3e}")
        check(bool(m.finite) and 0.0 <= Fmin and Fmax <= 1.0 and drift <= 1e-3,
              f"decomp e {solver}: physics")
        check(dF == 0 and torch.equal(got.p, want.p),
              f"decomp e {solver} vs serial: max|dF| {dF:.3e}, rel p {rel_p:.3e} (want bit "
              "for bit)")
    print(f"decomp e: {time.perf_counter() - t_phase:.1f} s into the phase")

    # ---- f. the torch engine's speed ----
    dec_t = tt.Decomp(cfg_mono.replace(num=tt.Numerics(backend="torch")), mesh)
    got, launches, _, _ = counted_run(counters, lambda: dec_t.simulate(s32, 2))
    check(launches == {}, f"decomp f: the torch engine launched {launches}")
    secs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec_t.simulate(s32, STEPS18_TORCH)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    torch_cups = N_MAIN * N_MAIN * STEPS18_TORCH / min(secs)
    print(f"{tag} decomp f: torch engine {N_MAIN}^2 f32 x{STEPS18_TORCH} on 2x2: "
          f"{1e3 * min(secs) / STEPS18_TORCH:.2f} ms/step (best of {[round(t, 3) for t in secs]}"
          f" s), {torch_cups:.4e} cell-updates/s")
    g3 = tt.Grid3D(N3_MAIN, N3_MAIN, N3_MAIN)
    s3 = tt.init_state_3d(g3, 1, dev)
    dec3 = tt.Decomp3D(g3, mesh, backend="torch")
    dec3.simulate(s3, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec3.simulate(s3, STEPS18_TORCH3)
    torch.cuda.synchronize()
    secs3 = time.perf_counter() - t0
    torch3_cups = N3_MAIN ** 3 * STEPS18_TORCH3 / secs3
    print(f"{tag} decomp f: Decomp3D(backend='torch') {N3_MAIN}^3 f32 x{STEPS18_TORCH3} on 2x2: "
          f"{1e3 * secs3 / STEPS18_TORCH3:.2f} ms/step, {torch3_cups:.4e} cell-updates/s")
    del s3, dec3

    # ---- g. the CLI ----
    work = tempfile.TemporaryDirectory()
    argv = ["--mesh", "2,2", "--nx", str(N_MAIN), "--steps", str(STEPS18_CLI), "--frame-every",
            str(STEPS18_CLI // 2), "-s", "--checkpoint-every", str(STEPS18_CLI), "--outdir",
            work.name]
    real_mesh = cli._mesh_2d
    cli._mesh_2d = lambda args: (mesh, None)
    try:
        launches, _, _ = cli_run(cli, counters, "decomp g: CLI --mesh 2,2", argv)
    finally:
        cli._mesh_2d = real_mesh
    check(launches == {"fullstep_win": 4 * STEPS18_CLI}, f"decomp g: CLI launches {launches}")
    frames = sorted(f for f in os.listdir(work.name) if f.endswith(".png"))
    check(frames == ["000000-f.png", "000000-vof.png", "000001-f.png", "000001-vof.png"],
          f"decomp g: the CLI's frames {frames}")
    end, _, _ = io_utils.load_checkpoint(os.path.join(work.name, f"ckpt_{STEPS18_CLI:06d}.npz"),
                                         dev)
    want = tt.Decomp(tt.dam_break_2d(N_MAIN), mesh).simulate(s32, STEPS18_CLI)
    same_state(end, want, f"decomp g: the CLI's checkpoint == Decomp('cuda').simulate x"
               f"{STEPS18_CLI}")
    work.cleanup()
    for argv in (["--plan-mesh", "4", "--nx", str(N_MAIN)],
                 ["--plan-mesh", "8", "--three-d", "--nx", str(N3_MAIN)]):
        launches, text, _ = cli_run(cli, counters, f"decomp g: CLI {' '.join(argv)}", argv)
        check(launches == {} and text.splitlines()[0].split()[:2] == ["mesh", "engine"],
              f"decomp g: {argv} printed no plan table")
        for line in text.splitlines():
            print(f"  plan | {line}")
    # the engine-class speeds beside the planner's constants: swept cells a
    # second of each class (cell-updates/s times its work factor) over the
    # reference class's
    full_cups = engines["full"]["cups"]
    wf_full = (N_MAIN // 2 + 2 * K.STEP_HALO(cfg_mono) + 2) ** 2 / (N_MAIN // 2) ** 2
    measured_2d = {"cuda-full": 1.0, "torch": torch_cups / (full_cups * wf_full)}
    swept3 = {}
    for shape, name in (((4,), "cuda-slab"), ((2, 2), "cuda-pencil")):
        px, py = (shape + (1,))[:2]
        adm = tt.admission_3d(g3, px, py)
        wf = (adm["nloc"] + 2) * (adm["nyE"] + 2) * (g3.nz + 2) / (
            (g3.nx // px) * (g3.ny // py) * g3.nz)
        swept3[name] = N3_MAIN ** 3 / (1e-3 * dist3[shape]["step_ms"]) * wf
    measured_3d = {"cuda-slab": 1.0, "cuda-pencil": swept3["cuda-pencil"] / swept3["cuda-slab"],
                   "torch": torch3_cups / swept3["cuda-slab"]}
    for label, got, const in (("2-D", measured_2d, plan.SPEED_2D),
                              ("3-D", measured_3d, plan.SPEED_3D)):
        print(f"{tag} decomp g: {label} engine-class speeds measured " +
              ", ".join(f"{k} {v:.4f}" for k, v in got.items()) + "; plan.py's constants " +
              ", ".join(f"{k} {v}" for k, v in const.items()))
    out["speeds"] = {"2d": measured_2d, "3d": measured_3d}
    print(f"phase 18 (the 2-D decomposition): {time.perf_counter() - t_phase:.1f} s {tag}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA card")
    import tpuvof_torch as tt
    from tpuvof_torch import solver as S
    from tpuvof_torch.kernels import build
    from tpuvof_torch.kernels import step_kernels as K

    progress("1")
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

    progress("2")
    # ---- 2. build ----
    build.load_library()
    print(f"build: {build.build_seconds():.1f} s")
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())
    bulk = bulk_copy_sass(build)
    bulk_counts = {}
    for name, ins in bulk.items():
        loads = sum(i.startswith("UBLKCP.S.G") for i in ins)
        stores = sum(i.startswith("UBLKCP.G.S") for i in ins)
        bulk_counts[name] = {"loads": loads, "stores": stores, "all": len(ins)}
        print(f"bulk-copy SASS in {name}: {loads} loads, {stores} stores, {len(ins)} in all "
              f"({', '.join(sorted(set(ins)))})")
    # every kernel moves its tiles' inputs by bulk loads and stores its
    # outputs with the threads
    check(bool(bulk) and all(c["loads"] > 0 and c["stores"] == 0
                             for c in bulk_counts.values()),
          f"a fullstep_dma kernel lacks bulk loads or has bulk stores: {bulk_counts}")

    progress("3")
    # ---- 3. kernel vs plain on the card ----
    lib = build.load_library()
    for n_jacobi in range(0, 21):
        depths = fullstep_levels(lib, n_jacobi)
        check(sum(depths) == n_jacobi and len(depths) == -(-n_jacobi // 4)
              and all(1 <= d <= 4 for d in depths)
              and depths == sorted(depths, reverse=True)
              and (not depths or depths[0] - depths[-1] <= 1),
              f"fullstep's Jacobi groups at n_jacobi={n_jacobi}: {depths}")
    print("fullstep's Jacobi groups, n_jacobi 0..20: sums, fewest groups of <= 4, "
          "near-equal, deeper first")
    cfg64 = tt.dam_break_2d(N_MAIN, num=tt.Numerics(backend="cuda"))
    s64 = perturbed_state(tt, N_MAIN, 50)
    results = {}
    for dtype in (torch.float64, torch.float32):
        s = tt.State(*(a.to(dtype).contiguous() for a in s64))
        for name, got, want, outs, region in kernel_cases(tt, K, cfg64, s):
            torch.cuda.synchronize()
            for out_name, g_, w_ in zip(outs, got, want):
                if region is not None:
                    g_, w_ = g_[region], w_[region]
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
                print(f"kernel vs plain {key} {name:13s} {out_name:20s} "
                      f"rel {rel:.3e} (bar {tol:.0e}) abs {diff:.3e}")
                check(rel <= tol, f"{name} {out_name} {key}: rel {rel:.3e} > {tol:.0e}")
    cfg_mono64 = tt.dam_break_2d(N_MAIN, num=tt.Numerics(backend="cuda_mono"))
    for even in (False, True):
        mono = S._step_cuda_mono(cfg_mono64, s64, even)
        for label, other in (("tiled", S._step_cuda_tiled(cfg_mono64, s64, even, tile=TILE)),
                             ("strips", S._step_cuda_strips(cfg_mono64, s64, even))):
            diff = max((a - b).abs().max().item() for a, b in zip(other, mono))
            print(f"engines f64 mono == {label} (even={even}): max abs {diff:.3e} "
                  f"(bar {TOL_ENGINES:.0e})")
            check(diff <= TOL_ENGINES, f"mono vs {label}: {diff:.3e}")
    # fullstep_dma == fullstep bit for bit, its outputs on NaN-poisoned
    # memory, with each launch's shape
    dma_cases = [(n_b, DMA_N_JACOBI) for n_b in DMA_RESIDUE_SIZES]
    dma_cases += [(n_b, (10,)) for n_b in DMA_BIG_SIZES]
    n_same = 0
    for n_b, n_jacobis in dma_cases:
        s_b = s64 if n_b == N_MAIN else perturbed_state(tt, n_b, 50 if n_b < 1024 else 10)
        base = tt.dam_break_2d(n_b, num=tt.Numerics(backend="cuda_mono"))
        for dtype in (torch.float64, torch.float32):
            st = [a.to(dtype).contiguous() for a in s_b]
            dt = str(dtype)[6:]
            print(f"fullstep_dma launch at {n_b}^2 {dt}: threads, shared bytes, CTAs an SM, "
                  f"CTAs, tile rows {dma_shape(lib, n_b + 2, dtype)} "
                  f"(fullstep "
                  f"{fullstep_shapes(lib, (('', n_b + 2, n_b + 2, dtype),))['']})")
            for nj in n_jacobis:
                cfg_b = base.replace(num=dataclasses.replace(base.num, n_jacobi=nj))
                for even in (False, True):
                    want = K.fullstep(cfg_b, *st, even)
                    label = (f"fullstep_dma == fullstep {n_b}^2 {dt} n_jacobi={nj} "
                             f"(even={even}")
                    got = poisoned_outputs(lambda: K.fullstep_dma(cfg_b, *st, even), st[0],
                                           label)
                    diff = max((a - b).abs().max().item() for a, b in zip(got, want))
                    same = all(torch.equal(a, b) for a, b in zip(got, want))
                    n_same += same
                    if n_b in DMA_BIG_SIZES or not same:
                        print(f"{label}, {(n_b + 2) ** 2} cells, outputs on NaN-poisoned "
                              f"memory): bit for bit {same}, max|d| {diff:.3e}")
                    check(same, f"fullstep_dma vs fullstep {n_b}^2 {dtype} n_jacobi={nj} "
                                f"even={even}: max|d| {diff:.3e}")
    print(f"fullstep_dma == fullstep bit for bit in all {n_same} cases (n {DMA_RESIDUE_SIZES} "
          f"at n_jacobi {DMA_N_JACOBI}, n {DMA_BIG_SIZES} at 10; f64, f32; both parities)")

    progress("4")
    # ---- 4. the slice in f64 against the golden, phase and mono routes ----
    golden = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "tests", "golden_dambreak_64_1000.npz"))
    n_g = int(golden["n"])
    for backend in ("cuda", "cuda_mono"):
        cfg_g = tt.dam_break_2d(n_g, num=tt.Numerics(backend=backend))
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
            print(f"golden f64 {n_g}^2 {backend} {key}: {err:.3e} (bar {bar:.0e})")
            check(err <= bar, f"golden {backend} {key} {err:.3e} > {bar:.0e}")

    progress("5")
    # ---- 5. the paths ----
    cfg_mono = tt.dam_break_2d(N_MAIN, num=tt.Numerics(backend="cuda_mono"))
    cfg = tt.dam_break_2d(N_MAIN, num=tt.Numerics(backend="cuda"))
    s0 = tt.init_state(cfg)
    path_launches = {}
    launches, s_mono_main = run_path(tt, K, "main path (cuda_mono)", cfg_mono, s0,
                                     STEPS_MAIN, {"fullstep": STEPS_MAIN})
    path_launches.update(launches)
    for backend, name, per_step in (("cuda_tiled", "fullstep_win", N_MAIN // S.TILE_ROWS),
                                    ("cuda_strips", "fullstep_strips", 1)):
        launches, _ = run_path(tt, K, f"{backend} path", cfg_mono.replace(
            num=tt.Numerics(backend=backend)), s0, STEPS_HYBRID,
            {name: STEPS_HYBRID * per_step})
        path_launches.update(launches)
    launches, _ = run_path(tt, K, "phase path (cuda)", cfg, s0, STEPS_MAIN,
                           {"predict": STEPS_MAIN, "project": STEPS_MAIN,
                            "fct_sweep": 2 * STEPS_MAIN})
    path_launches.update(launches)
    # the hybrid, in the bounded-cost relative-tolerance mode (tpuvof's
    # production setting of the upgraded solvers)
    cfg_hyb = tt.dam_break_2d(N_MAIN, num=tt.Numerics(
        backend="cuda", pressure_solver="auto", sor_tol_rel=1e-2))
    check(S.resolve_auto(cfg_hyb).num.pressure_solver == "mg", "auto did not pick mg")
    _, s_hyb = run_path(tt, K, "hybrid path (cuda, auto -> mg)", cfg_hyb, s0, STEPS_HYBRID,
                        {"predict": STEPS_HYBRID, "fct_sweep": 2 * STEPS_HYBRID})
    cfg_mg = S.resolve_auto(cfg_hyb)
    K.reset_launch_counts()
    tiled = whole = s_hyb
    for k in range(3):
        tiled = S._step_cuda_hybrid_tiled(cfg_mg, tiled, k % 2 == 1, tile=TILE, lean=True)
        whole = S._step_cuda(cfg_mg, whole, k % 2 == 1, lean=True)
    torch.cuda.synchronize()
    launches = {k: n for k, n in K.LAUNCHES.items() if n}
    n_tiles = (N_MAIN // TILE) ** 2
    print(f"hybrid tiled x3 (tile {TILE}) launches: {launches}")
    check({k: launches.get(k) for k in ("predict_win", "fct_sweep_win")}
          == {"predict_win": 3 * n_tiles, "fct_sweep_win": 6 * n_tiles},
          f"hybrid tiled launch counts {launches}")
    path_launches.update({k: launches[k] for k in ("predict_win", "fct_sweep_win")})
    diff = max(rel_err(a, b)[0] for a, b in zip(tiled, whole))
    print(f"hybrid tiled vs whole-field hybrid f32 x3: max rel {diff:.3e} (bar 1e-5)")
    check(diff <= 1e-5, f"hybrid tiled vs whole {diff:.3e}")
    cfg_g = tt.dam_break_2d(n_g, num=tt.Numerics(backend="cuda_mono"))
    s = tt.simulate(cfg_g, tt.init_state(cfg_g), int(golden["n_steps"]))
    err32 = np.abs(s.F.double().cpu().numpy() - golden["F"]).max()
    print(f"golden f32 {n_g}^2 cuda_mono x{int(golden['n_steps'])} F drift {err32:.3e} "
          f"(bar 5e-3)")
    check(err32 <= 5e-3, f"f32 golden drift {err32:.3e} > 5e-3")

    progress("6")
    # ---- 6. project at the edges of its stage groups, then timing ----
    for dtype in (torch.float64, torch.float32):
        key = "f64" if dtype == torch.float64 else "f32"
        F, u, v, p = (a.to(dtype).contiguous() for a in s64)
        us, vs = K.predict_plain(cfg64, u, v, F)
        for n_jacobi in PROJECT_N_JACOBI:
            c = cfg64.replace(num=dataclasses.replace(cfg64.num, n_jacobi=n_jacobi))
            got = K.project(c, F, us, vs, p, u, v)
            want = K.project_plain(c, F, us, vs, p, u, v)
            torch.cuda.synchronize()
            r = results["project"]
            for out_name, g_, w_ in zip("puv", got, want):
                rel, diff = rel_err(g_, w_)
                tol = TOL_F64 if key == "f64" else TOL_F32.get(out_name, TOL_F32_DEFAULT)
                r[f"rel_{key}"] = max(r[f"rel_{key}"], rel)
                if key == "f32":
                    r["abs_f32"] = max(r["abs_f32"], diff)
                print(f"kernel vs plain {key} project n_jacobi={n_jacobi:<2d} {out_name} "
                      f"rel {rel:.3e} (bar {tol:.0e}) abs {diff:.3e}")
                check(rel <= tol, f"project n_jacobi={n_jacobi} {out_name} {key}: rel "
                                  f"{rel:.3e} > {tol:.0e}")
    paths = {"mono": cfg_mono, "kernel": cfg,
             "plain": cfg.replace(num=tt.Numerics(backend="torch"))}
    runs = {path: [] for path in paths}

    steps_of = {path: STEPS_PLAIN if path == "plain" else STEPS_MAIN for path in paths}

    def run(path):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tt.simulate(paths[path], s0, steps_of[path])
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for path in paths:  # warm-up
        run(path)
    order = list(paths)
    for r in range(3):  # alternate which path goes first
        for path in order if r % 2 == 0 else order[::-1]:
            runs[path].append(run(path))
    s32 = tt.State(*(a.to(torch.float32).contiguous() for a in s64))
    for path, c in paths.items():
        best = min(runs[path])
        cells = N_MAIN * N_MAIN * steps_of[path]
        step_ms = 1e3 * best / steps_of[path]
        # the device's own time per step: a CUDA graph of one step pair
        dev_ms = device_ms(lambda: tt.step_pair(c, s32, lean=True), 10) / 2
        print(f"{tag} {path} path {N_MAIN}^2 x{steps_of[path]} f32: best {best:.4f} s "
              f"of {[round(t, 4) for t in runs[path]]}, {cells / best:.4e} "
              f"cell-updates/s, {step_ms:.4f} ms/step; device alone {dev_ms:.4f} "
              f"ms/step, idle {100 * (1 - dev_ms / step_ms):.1f}% of the host-clock step")

    F, u, v, p = s32
    us, vs = K.predict_plain(cfg64, u, v, F)
    (ub, vb, Fb), (oi, oj) = window(K, cfg64, (u, v, F), K.PHASE_HALO, N_MAIN // 2,
                                    N_MAIN // 4, TILE + 2 * K.PHASE_HALO + 2)
    # the whole-step kernel's blocks on its tiled and strips routes
    W = K.STEP_HALO(cfg64)
    wb = [pad(a, W)[N_MAIN // 2:N_MAIN // 2 + S.TILE_ROWS + 2 * W + 2].contiguous()
          for a in s32]
    strips = [pad(a, K.strips_halo(cfg64)) for a in s32]
    timed = {
        "predict": (lambda: K.predict(cfg64, u, v, F),
                    lambda: K.predict_plain(cfg64, u, v, F), F.shape),
        "project": (lambda: K.project(cfg64, F, us, vs, p, u, v),
                    lambda: K.project_plain(cfg64, F, us, vs, p, u, v), F.shape),
        "fct_sweep_x": (lambda: K.fct_sweep(cfg64, F, u, 0),
                        lambda: K.fct_sweep_plain(cfg64, F, u, 0), F.shape),
        "fct_sweep_y": (lambda: K.fct_sweep(cfg64, F, v, 1),
                        lambda: K.fct_sweep_plain(cfg64, F, v, 1), F.shape),
        "fullstep": (lambda: K.fullstep(cfg64, F, u, v, p, False),
                     lambda: K.fullstep_plain(cfg64, F, u, v, p, False), F.shape),
        "predict_win": (lambda: K.predict_win(cfg64, ub, vb, Fb, oi, oj),
                        lambda: K.predict_win_plain(cfg64, ub, vb, Fb, oi, oj), Fb.shape),
        "fct_sweep_win_x": (lambda: K.fct_sweep_win(cfg64, Fb, ub, 0, oi, oj),
                            lambda: K.fct_sweep_win_plain(cfg64, Fb, ub, 0, oi, oj),
                            Fb.shape),
        "fct_sweep_win_y": (lambda: K.fct_sweep_win(cfg64, Fb, vb, 1, oi, oj),
                            lambda: K.fct_sweep_win_plain(cfg64, Fb, vb, 1, oi, oj),
                            Fb.shape),
        "fullstep_win": (lambda: K.fullstep_win(cfg64, *wb, N_MAIN // 2 - W, -W, False),
                         lambda: K.fullstep_win_plain(cfg64, *wb, N_MAIN // 2 - W, -W, False),
                         wb[0].shape),
        "fullstep_strips": (lambda: K.fullstep_strips(cfg64, *strips, False),
                            lambda: K.fullstep_strips_plain(cfg64, *strips, False),
                            strips[0].shape),
    }
    times = {}
    for name, (kern, plain, shape) in timed.items():
        t = times[name] = {"ms": device_ms(kern, 20), "plain_ms": device_ms(plain, 20),
                           "host_ms": host_ms(kern, 200), "plain_host_ms": host_ms(plain, 20)}
        t.update(bound_of(name.removesuffix("_x").removesuffix("_y"), shape[0] * shape[1]))
        print(f"{tag} {name:15s} {tuple(shape)} f32: kernel {1e3 * t['ms']:.2f} us/launch "
              f"on the device ({1e3 * t['host_ms']:.2f} us per call from Python); plain "
              f"{1e3 * t['plain_ms']:.2f} us/call on the device "
              f"({1e3 * t['plain_host_ms']:.2f} us from Python); bound "
              f"{1e3 * t['bound_ms']:.2f} us ({t['bound_by']})")
    shapes2d = fullstep_shapes(lib, (
        ("fullstep f32", *F.shape, torch.float32), ("fullstep f64", *F.shape, torch.float64),
        ("fullstep_win f32", *wb[0].shape, torch.float32),
        ("fullstep_strips f32", *strips[0].shape, torch.float32)))
    project_shapes = {}
    for label, fn in (("project f32", lib.tv_project_shape_f32),
                      ("project f64", lib.tv_project_shape_f64)):
        shape = (ctypes.c_int * 5)()
        check(fn(*F.shape, shape) == 0, f"tv_project_shape {label} failed")
        project_shapes[label] = list(shape)
    for label, (threads, smem, per_sm, ctas, rows) in {**shapes2d, **project_shapes}.items():
        print(f"{tag} launch {label}: {threads} threads and {smem} shared bytes a CTA, "
              f"{per_sm} CTAs an SM, {ctas} CTAs of {rows} x 32 tiles")
    # the phase kernels on the phase route's grid and the hybrid's blocks
    shapes_phase = phase_shapes(lib, (("", *F.shape), ("_win", *Fb.shape)))
    for label, (threads, smem, per_sm, ctas, rows, cols) in shapes_phase.items():
        print(f"{tag} launch {label}: {threads} threads and {smem} shared bytes a CTA, "
              f"{per_sm} CTAs an SM, {ctas} CTAs of {rows} x {cols} tiles")
    n_jacobi = cfg_mono.num.n_jacobi
    print(f"fullstep at the main path's n_jacobi {n_jacobi}: Jacobi groups "
          f"{fullstep_levels(lib, n_jacobi)}")
    # the paths run both sweeps equally often: one entry, their mean
    for name in ("fct_sweep", "fct_sweep_win"):
        x, y = times.pop(f"{name}_x"), times.pop(f"{name}_y")
        times[name] = {k: (x[k] + y[k]) / 2 if isinstance(x[k], float) else x[k] for k in x}

    progress("7")
    # ---- 7. 3-D kernel vs plain on the card ----
    from tpuvof_torch import solver3d as S3
    from tpuvof_torch.kernels import step3d_kernels as K3

    fl = tt.Fluid()
    dt3 = 4e-6
    g_chk, s3_64 = perturbed_state_3d(tt, N3_CHECK, 50)
    s3_init64 = S3._with_bc(tt.init_state_3d(g_chk, 1, "cuda", torch.float64))
    gi0, nloc = N3_SLAB

    def whole_and_slab(dtype):
        out = []
        for state, tag, csf_only in ((s3_64, "", False), (s3_init64, " dam-break init", True)):
            s = tt.State3D(*(a.to(dtype).contiguous() for a in state))
            out += [(tag, s, {}, csf_only),
                    (f"{tag} slab@{gi0}", state_slab(s, gi0, nloc), {"gi_base": gi0}, csf_only)]
        return out

    results3 = check_kernels_3d(K3, g_chk, fl, whole_and_slab, dt3, f"{N3_CHECK}^3")
    del s3_64

    progress("8")
    # ---- 8. the 3-D golden, f64 through 'cuda'; the f32 drift ----
    golden3 = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "tests", "golden_dambreak3d_32_300.npz"))
    n3g, ck3, n3s = int(golden3["n"]), int(golden3["checkpoint"]), int(golden3["n_steps"])
    g3g = tt.Grid3D(n3g, n3g, n3g)
    s100 = tt.simulate_3d(g3g, tt.init_state_3d(g3g, 1, "cuda", torch.float64), ck3)
    s300 = tt.simulate_3d(g3g, s100, n3s - ck3, istep0=ck3)
    for key, got, want in (("F100", s100.F, golden3["F100"]), ("u100", s100.u, golden3["u100"]),
                           (f"F{n3s}", s300.F, golden3["F"]), (f"u{n3s}", s300.u, golden3["u"])):
        err = np.abs(got.cpu().numpy() - want).max()
        print(f"golden f64 {n3g}^3 cuda {key}: {err:.3e} (bar 1e-9)")
        check(err <= 1e-9, f"3-D golden {key} {err:.3e} > 1e-9")
    s = tt.simulate_3d(g3g, tt.init_state_3d(g3g), n3s)
    err32 = np.abs(s.F.double().cpu().numpy() - golden3["F"]).max()
    print(f"golden f32 {n3g}^3 cuda x{n3s} F drift {err32:.3e} (bar 5e-3)")
    check(err32 <= 5e-3, f"3-D f32 golden drift {err32:.3e} > 5e-3")

    progress("9")
    # ---- 9. the 3-D paths ----
    counters = (K, K3)
    g3 = tt.Grid3D(N3_MAIN, N3_MAIN, N3_MAIN)
    s3 = tt.init_state_3d(g3)
    per_step = {"predict3d_rhs": 1, "jacobi3d": len(K3.jacobi3d_plan(N3_JACOBI)),
                "correct3d": 1, "fct3d_sweep": 3}
    launches, s3_serial = run_path_3d(tt, counters, "3-D main path (cuda)", g3, s3,
                                      STEPS3_MAIN,
                                      {k: n * STEPS3_MAIN for k, n in per_step.items()})
    path_launches.update(launches)
    # csf: predict3d_rhs launches the curvature pre-pass and the predictor
    csf_launches, _ = run_path_3d(tt, counters, "3-D csf path (cuda, csf=True)", g3, s3,
                                  STEPS3_CSF,
                                  {k: n * STEPS3_CSF * (2 if k == "predict3d_rhs" else 1)
                                   for k, n in per_step.items()}, csf=True)
    g3h = tt.Grid3D(N3_HYBRID, N3_HYBRID, N3_HYBRID)
    check(S3._resolve_auto_3d(g3h) == "mg", "3-D auto did not pick mg")
    run_path_3d(tt, counters, "3-D hybrid path (cuda, auto -> mg)", g3h, tt.init_state_3d(g3h),
                STEPS3_HYBRID, {"predict3d_rhs": STEPS3_HYBRID, "correct3d": STEPS3_HYBRID,
                                "fct3d_sweep": 3 * STEPS3_HYBRID},
                pressure_solver="auto", sor_tol_rel=1e-2)

    progress("10")
    # ---- 10. 3-D timing ----
    def run3(backend, steps, csf=False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tt.simulate_3d(g3, s3, steps, backend=backend, csf=csf)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run3("cuda", STEPS3_MAIN)  # warm-up
    runs3 = [run3("cuda", STEPS3_MAIN) for _ in range(3)]
    run3("cuda", STEPS3_CSF, True)
    runs3_csf = [run3("cuda", STEPS3_CSF, True) for _ in range(3)]
    run3("torch", 3)
    plain3 = [run3("torch", STEPS3_PLAIN) for _ in range(2)]
    s3dev = S3._with_bc(s3)
    for label, runs, steps, csf in (("cuda", runs3, STEPS3_MAIN, False),
                                    ("cuda csf", runs3_csf, STEPS3_CSF, True),
                                    ("torch", plain3, STEPS3_PLAIN, False)):
        best = min(runs)
        step_ms = 1e3 * best / steps
        lean = S3._step_3d_torch if label == "torch" else S3._step_3d_cuda_lean
        nm3 = S3.numerics_3d(g3, dt=dt3, n_jacobi=10, backend="torch" if label == "torch"
                             else "cuda")

        def triple(lean=lean, csf=csf, nm3=nm3):
            for ph in (1, 2, 0):
                lean(g3, fl, nm3, csf, s3dev, ph)

        dev_ms = device_ms(triple, 1 if label == "torch" else 5) / 3
        print(f"{tag} 3-D {label} path {N3_MAIN}^3 x{steps} f32: best {best:.4f} s of "
              f"{[round(t, 4) for t in runs]}, {N3_MAIN ** 3 * steps / best:.4e} "
              f"cell-updates/s, {step_ms:.4f} ms/step; device alone {dev_ms:.4f} ms/step, "
              f"idle {100 * (1 - dev_ms / step_ms):.1f}% of the host-clock step")

    times.update(time_kernels_3d(K3, g3, fl, dt3, s3dev, {}, tag))
    csf_times = time_csf_3d(K3, g3, fl, dt3, s3dev, {}, tag)
    shapes3d = sweep_shapes(lib)
    for label, (threads, smem, per_sm) in shapes3d.items():
        print(f"{tag} launch fct3d_sweep {label}: {threads} threads and {smem} shared bytes "
              f"a CTA, {per_sm} CTAs an SM")

    progress("11")
    # ---- 11. the four 3-D kernels on the 200^3 engines' blocks vs plain ----
    from tpuvof_torch.parallel import Decomp3D, make_mesh

    cuda0 = torch.device("cuda", 0)
    g_chk, s3_64 = perturbed_state_3d(tt, N3_CHECK, 50)
    dec_pencil = Decomp3D(g_chk, make_mesh(devices=[cuda0] * 4), dt=dt3)
    dec_slab = Decomp3D(g_chk, make_mesh(4, ("mx",), [cuda0] * 4), dt=dt3)

    def engine_blocks(dec, shards, dam_shards, want_shape):
        """The blocks of ``shards`` of the perturbed state (every kernel)
        and of ``dam_shards`` of the noise-free initial state (the csf
        predict3d_rhs alone)."""
        def blocks_of(dtype):
            out = []
            for state, xys, tag, csf_only in ((s3_64, shards, "", False),
                                              (s3_init64, dam_shards, " dam-break init", True)):
                blocks = dec.widen(dec.scatter_state(tt.State3D(*(a.to(dtype) for a in state))))
                for xy in xys:
                    k = dec.coords.index(xy)
                    org = dec.origin(k)
                    check(tuple(blocks[k].F.shape) == want_shape,
                          f"the engine's block {tuple(blocks[k].F.shape)} != {want_shape}")
                    where = ",".join(str(org[key]) for key in ("gi_base", "gj_base")
                                     if key in org)
                    kind = "pencil" if dec.pencil else "slab"
                    out.append((f"{tag} {kind}{xy}@({where})", blocks[k], org, csf_only))
            return out
        return blocks_of

    results_pencil = check_kernels_3d(
        K3, g_chk, fl, engine_blocks(dec_pencil, PENCIL_SHARDS, DAM_PENCIL_SHARDS,
                                     (130, 130, 202)), dt3, "pencil")
    # the slab instantiation on the (4,) engine's edge shards: the same
    # kernels as phase 7's slab case, with an x wall mid-block
    for name, r in check_kernels_3d(
            K3, g_chk, fl, engine_blocks(dec_slab, SLAB_SHARDS, SLAB_SHARDS[:1],
                                         (80, 202, 202)), dt3, "slab engine").items():
        for key, val in r.items():
            results3[name][key] = max(results3[name][key], val)
    del s3_64, s3_init64, dec_pencil, dec_slab

    progress("12")
    # ---- 12. the 32^3 golden through Decomp3D, f64 ----
    for shape in N3_GOLDEN_MESHES:
        names = ("mx", "my")[:len(shape)]
        dec = Decomp3D(g3g, make_mesh(int(np.prod(shape)), names, [cuda0] * 4))
        d100 = dec.simulate(tt.init_state_3d(g3g, 1, "cuda", torch.float64), ck3)
        d300 = dec.simulate(d100, n3s - ck3, istep0=ck3)
        kind = "pencils" if dec.pencil else "slabs"
        for key, got, want, serial in (
                ("F100", d100.F, golden3["F100"], s100.F),
                ("u100", d100.u, golden3["u100"], s100.u),
                (f"F{n3s}", d300.F, golden3["F"], s300.F),
                (f"u{n3s}", d300.u, golden3["u"], s300.u)):
            err = np.abs(got.cpu().numpy() - want).max()
            rel, _ = rel_err(got, serial)
            print(f"golden f64 {n3g}^3 Decomp3D {shape} {kind} {key}: {err:.3e} (bar 1e-9); "
                  f"vs serial 'cuda' rel {rel:.3e} (bar {TOL_F64:.0e})")
            check(err <= 1e-9, f"Decomp3D {shape} golden {key} {err:.3e} > 1e-9")
            check(rel <= TOL_F64, f"Decomp3D {shape} vs serial {key} {rel:.3e}")

    progress("13")
    # ---- 13. the distributed paths at 200^3 ----
    dist = {}
    for shape in N3_DIST_MESHES:
        names = ("mx", "my")[:len(shape)]
        dec = Decomp3D(g3, make_mesh(int(np.prod(shape)), names, [cuda0] * 4))
        label = f"3-D distributed path ({'x'.join(map(str, shape))} "
        label += f"{'pencils' if dec.pencil else 'slabs'}, cuda)"
        dist[shape] = run_dist_path(tt, counters, label, dec, s3, STEPS3_MAIN,
                                    {k: 4 * n * STEPS3_MAIN for k, n in per_step.items()},
                                    s3_serial, tag)
    multi_card_check("3-D distributed path (2x2 pencils) 200^3 x1000",
                     lambda devs: Decomp3D(g3, make_mesh(4, ("mx", "my"), devs)), s3,
                     STEPS3_MAIN, dist[(2, 2)]["end"])
    pencil_path = dist[N3_DIST_MESHES[0]]
    pencil_times = time_kernels_3d(K3, g3, fl, dt3, pencil_path["block"],
                                   pencil_path["origin"], tag)
    pencil_csf_times = time_csf_3d(K3, g3, fl, dt3, pencil_path["block"],
                                   pencil_path["origin"], tag)
    results.update(results3)

    progress("14")
    # ---- 14. the DMA path: fullstep_dma's step-pair loop ----
    dma = {}
    for n, steps in DMA_SIZES:
        dma[n] = run_dma_path(tt, S, K, tag, n, steps,
                              want=tuple(s_mono_main) if n == N_MAIN else None)
    path_launches["fullstep_dma"] = dma[N_MAIN]["launches"]
    times["fullstep_dma"] = {k: dma[N_MAIN][k] for k in (
        "ms", "plain_ms", "host_ms", "plain_host_ms", "bound_ms", "bound_by")}

    progress("15")
    # ---- 15. the differentiable path ----
    run_diff_phase(tt, counters, tag)

    progress("16")
    # ---- 16. the app layer through the CLI ----
    run_app_phase(tt, counters, s_mono_main, per_step, tag)

    progress("17")
    # ---- 17. the distributed solver ladder ----
    run_ladder_phase(tt, counters, golden3, tag)

    progress("18")
    # ---- 18. the 2-D decomposition ----
    decomp = run_decomp_phase(tt, counters, golden, s64, s_mono_main, dist, tag)

    site = "tpuvof/pallas_kernels/step_kernels.py"
    sources = {"predict": ("tpuvof_torch/csrc/predict.cu", f"{site}:444"),
               "project": ("tpuvof_torch/csrc/project.cu", f"{site}:237"),
               "fct_sweep": ("tpuvof_torch/csrc/fct_sweep.cu", f"{site}:330"),
               "predict_win": ("tpuvof_torch/csrc/predict.cu", f"{site}:506"),
               "fct_sweep_win": ("tpuvof_torch/csrc/fct_sweep.cu", f"{site}:539"),
               "fullstep": ("tpuvof_torch/csrc/fullstep.cu",
                            f"{site}:669, {site}:1119, {site}:1089"),
               "fullstep_dma": ("tpuvof_torch/csrc/fullstep_dma.cu", f"{site}:793"),
               "predict3d_rhs": ("tpuvof_torch/csrc/predict3d.cu",
                                 "tpuvof/pallas_kernels/step3d.py:520"),
               "correct3d": ("tpuvof_torch/csrc/correct3d.cu",
                             "tpuvof/pallas_kernels/step3d.py:672"),
               "fct3d_sweep": ("tpuvof_torch/csrc/fct3d.cu",
                               "tpuvof/pallas_kernels/step3d.py:908, "
                               "tpuvof/pallas_kernels/step3d.py:929"),
               "jacobi3d": ("tpuvof_torch/csrc/jacobi3d.cu",
                            "tpuvof/pallas_kernels/jacobi3d.py:456, "
                            "tpuvof/pallas_kernels/jacobi3d.py:418")}
    kernels = []
    for name, (src, rep) in sources.items():
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "launches": path_launches[name], "max_abs_err": r["abs_f32"],
                        "max_rel_err_f32": r["rel_f32"], "max_rel_err_f64": r["rel_f64"],
                        "library_ms": None, **times[name]})
    # fullstep.cu on its tiled and strips routes (tpuvof's :1119 and :1089)
    fullstep = next(k for k in kernels if k["name"] == "fullstep")
    fullstep["variants"] = {name: {"launches": path_launches[name], **times[name]}
                            for name in ("fullstep_win", "fullstep_strips")}
    # the decomposition's launches (phase 18 (c), (e)) and each kernel on the
    # blocks the 512^2 2x2 engines give it
    decomp_of = dict(fullstep["variants"])
    decomp_of.update({k["name"]: k for k in kernels if k["name"] in ("predict_win",
                                                                       "fct_sweep_win")})
    for name, k in decomp_of.items():
        r = decomp["results"][name]
        k["decomp"] = {"launches": decomp["launches"][name], "max_abs_err": r["abs_f32"],
                       "max_rel_err_f32": r["rel_f32"], "max_rel_err_f64": r["rel_f64"],
                       **decomp["times"][name]}
    fullstep["variants"]["fullstep_win"]["decomp"]["launches_tiled"] = \
        decomp["launches"]["fullstep_win tiled"]
    # threads, shared bytes, CTAs an SM, CTAs, tile rows
    fullstep["launch_shape"] = shapes2d
    for k in kernels:
        if k["name"] in ("predict", "fct_sweep", "predict_win", "fct_sweep_win"):
            k["launch_shape"] = {label: sh for label, sh in shapes_phase.items()
                                 if label.split()[0] == k["name"]}
    next(k for k in kernels if k["name"] == "fct3d_sweep")["launch_shape"] = shapes3d
    # fullstep_dma at every size of phase 14; its bulk-copy instructions
    fullstep_dma = next(k for k in kernels if k["name"] == "fullstep_dma")
    fullstep_dma["sizes"] = {str(n + 2): r for n, r in dma.items()}
    fullstep_dma["bulk_copy_sass"] = bulk_counts
    # the 3-D kernels in pencil mode, on the 2x2 engine's block (phases 11, 13)
    for k in kernels:
        if k["name"] in results_pencil:
            r = results_pencil[k["name"]]
            k["variants"] = {"pencil": {
                "block": list(pencil_path["block"].F.shape),
                "launches": pencil_path["launches"][k["name"]], "max_abs_err": r["abs_f32"],
                "max_rel_err_f32": r["rel_f32"], "max_rel_err_f64": r["rel_f64"],
                **pencil_times[k["name"]]}}
    # the csf route's predict3d_rhs (phases 9, 10, 11, 13): the call's two
    # launches and its curvature pre-pass alone, serial and on the pencil block
    predict3d = next(k for k in kernels if k["name"] == "predict3d_rhs")
    r = results["predict3d_rhs csf"]
    rp = results_pencil["predict3d_rhs csf"]
    predict3d["variants"]["csf"] = {
        "launches": csf_launches["predict3d_rhs"], "max_abs_err": r["abs_f32"],
        "max_rel_err_f32": r["rel_f32"], "max_rel_err_f64": r["rel_f64"], **csf_times,
        "pencil": {"block": list(pencil_path["block"].F.shape), "max_abs_err": rp["abs_f32"],
                   "max_rel_err_f32": rp["rel_f32"], "max_rel_err_f64": rp["rel_f64"],
                   **pencil_csf_times}}
    progress("end")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
