"""Tracing and step timing (counterpart of tpuvof/utils/profiling.py).

``trace`` wraps a block in a ``torch.profiler`` trace (CPU activity, and
CUDA activity when a card is in use) written as a Chrome trace into
``logdir`` (chrome://tracing, Perfetto); ``time_steps`` measures the
steady-state wall clock of a simulate call with the warm-up (the kernels'
first build and launch) excluded and ``torch.cuda.synchronize`` as the
fence.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "time_steps"]


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


def _fence(state):
    """Wait until the device has finished the work queued on the state."""
    if state.F.is_cuda:
        torch.cuda.synchronize(state.F.device)


def time_steps(simulate, cfg, state, n_steps: int, repeats: int = 3):
    """Returns (best_seconds, cell_updates_per_sec, final_state)."""
    state = simulate(cfg, state, n_steps)  # warm-up: builds and first launches
    _fence(state)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        state = simulate(cfg, state, n_steps)
        _fence(state)
        best = min(best, time.perf_counter() - t0)
    cells = cfg.grid.nx * cfg.grid.ny
    return best, cells * n_steps / best, state
