"""Device (H100): the share of the traced sub-window of whole frames in which
no kernel, copy or fill ran on the card: 1 - the union of its busy
intervals over the sub-window's wall time, from torch.profiler's CUDA
activity."""
from __future__ import annotations


def read(run):
    tr = run.trace
    if tr is None or tr.window[1] <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
