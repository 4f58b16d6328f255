"""Device (H100): the mean idle share of a mesh's cards over the traced
sub-window: 100 x (1 - the summed durations of the device's events
(kernels, copies, fills), clipped to the sub-window, over the number of
cards times its wall time). The union of busy intervals (device_idle_pct)
counts a moment busy when any card is; this counts each card's time. None
for a route without a mesh."""
from __future__ import annotations


def read(run):
    tr = run.trace
    cards = getattr(run.route, "cards", None)
    if tr is None or not cards or tr.window[1] <= 0 or not tr.device:
        return None
    w0, w1 = tr.window[0], tr.window[0] + tr.window[1]
    busy = sum(max(0.0, min(ts + dur, w1) - max(ts, w0)) for _, _, ts, dur in tr.device)
    return 100.0 * (1.0 - busy / (cards * tr.window[1]))
