"""L3 driver: the bytes the distributed 3-D engine's halo refreshes and
ghost exchanges copied, over the steps it took, over the process (the
program's counter ``tpuvof_torch.parallel.dist3d.HALO``, read after the
run). None where the program has no such counter or took no step."""
from __future__ import annotations


def read(run):
    from tpuvof_torch.parallel import dist3d

    counts = getattr(dist3d, "HALO", None)
    if counts is None or not counts.get("steps"):
        return None
    return counts["bytes"] / counts["steps"]
