"""Device (H100): the device time of the copies between two cards (peer
to peer memcpy events of torch.profiler's CUDA activity) in the traced
sub-window, over its steps, in milliseconds a step. None without such a
copy."""
from __future__ import annotations


def _peer(name: str) -> bool:
    return "PtoP" in name or "Peer" in name


def read(run):
    tr = run.trace
    if tr is None or tr.steps <= 0:
        return None
    copies = [dur for cat, name, _, dur in tr.device if cat == "gpu_memcpy" and _peer(name)]
    if not copies:
        return None
    return 1e-3 * sum(copies) / tr.steps
