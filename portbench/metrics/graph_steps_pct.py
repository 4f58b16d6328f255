"""L3 driver: the share of ``simulate``'s 'cuda_mono' steps on the card
that were replayed from a CUDA graph, over the process (the program's
counter ``tpuvof_torch.solver.MONO_GRAPH``, read after the run): 100 x
graph steps / (graph steps + steps launched one by one). Nothing where
the program has no such counter or ran no such step."""
from __future__ import annotations


def read(run):
    from tpuvof_torch import solver

    counts = getattr(solver, "MONO_GRAPH", None)
    if counts is None:
        return None
    total = counts["graph_steps"] + counts["eager_steps"]
    return 100.0 * counts["graph_steps"] / total if total else None
