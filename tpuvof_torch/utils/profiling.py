"""Tracing (counterpart of tpuvof/utils/profiling.py).

``trace`` wraps a block in a ``torch.profiler`` trace (CPU activity, and
CUDA activity when a card is in use) written as a Chrome trace into
``logdir`` (chrome://tracing, Perfetto).

``span`` marks one of the program's own spans. Every span of the package
goes through it, and all carry the prefix ``tv.``:

  ====================  ==================================================
  span                  where
  ====================  ==================================================
  tv.simulate           the body of solver.simulate, simulate_cfl,
                        solver3d.simulate_3d and the advance of Decomp
                        and Decomp3D (one per call)
  tv.halo               a decomposition's halo refresh of its blocks, one
                        per step of a wide-halo engine (and in 3-D one per
                        ghost exchange of its BCs)
  tv.shard_line         Decomp3D.line, the frame's per-shard reductions
  tv.bc                 the plain-torch BC passes outside the kernels
  tv.cfl                simulate_cfl's Courant tracker, one per step
  tv.wrap.<kernel>      a CUDA wrapper from its CUDA branch to its return
  tv.launch.<kernel>    the foreign call into the kernel library alone
  tv.metrics            metrics.compute_metrics
  tv.host_read          a program read that waits on the device
  tv.render             the CLI frame's picture and its PNG
  ====================  ==================================================

A span records only while a profiler records (``--profile-dir``, or any
caller's ``torch.profiler``); it then lands in the profiler's trace as a
``cpu_op`` event on the profiler's clock, nested in the span around it.
With no profiler recording it allocates and records nothing.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "span", "recording"]

_OFF = contextlib.nullcontext()

#: Whether a profiler records: the one check behind every span. A path
#: that runs on every kernel launch tests it before entering a span, so
#: that with no profiler it pays neither the span's call nor a ``with``.
recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context manager recording ``name`` as a span of the running
    profiler; a shared no-op when none records."""
    if recording():
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; its Chrome trace lands in
    ``logdir/trace_<pid>_<ns>.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
