"""L4 app: the host-clock span from the fence after the solver call to the
end of the frame's host work (metrics line, picture, read-back), mean over
the measured window's frames."""
from __future__ import annotations


def read(run):
    if not run.spans:
        return None
    return 1e3 * sum(s.t2 - s.t1 for s in run.spans) / len(run.spans)
