"""``tpuvof_torch.solver.simulate_cfl``: the 2-D step with the Courant
tracker, as ``python -m tpuvof_torch`` runs it by default. The frame's
report (largest Courant number, its step and face, the count of faces
above 0.25) is judged beside the state."""
from __future__ import annotations

import math

import torch

from portbench.harness import compare_states
from portbench.reference.flow2d import Flow2D
from portbench.routes.simulate import port_config

FIELDS = ("F", "u", "v", "p")

__all__ = ["Route"]


class Route:
    dims = 2
    tracks_cfl = True

    def __init__(self, config: dict, traffic: dict, device):
        from tpuvof_torch.solver import simulate_cfl

        self._simulate_cfl = simulate_cfl
        self.cfg = port_config(config, traffic)
        self.shape = self.cfg.grid.shape
        self.cells = config["nx"] * config["ny"]
        self.n_jacobi = config["n_jacobi"]
        self.dtype = config["dtype"]

    def advance(self, state, n: int, istep0: int):
        from tpuvof_torch.state import State

        return self._simulate_cfl(self.cfg, State(*state), n, istep0=istep0)

    @staticmethod
    def reference(config: dict) -> Flow2D:
        return Flow2D(config)

    @staticmethod
    def judge(ref: Flow2D, sample, dtype=torch.float64):
        """State numbers, and ``cfl_gap``: the worst of the report's Courant
        number against the reference's largest, and of the reference's own
        number at the reported step and face against its largest, both
        relative to the largest; infinite where the count of faces above
        the limit, or the step of the first, differs."""
        rep = sample.report
        probe = (rep["step"], rep["axis"], rep["i"], rep["j"])
        inp = tuple(a.to(dtype) for a in sample.inp)
        out, r = ref.advance(inp, sample.steps, sample.istep0, track_cfl=True, probe=probe)
        nums = compare_states(sample.out, out, FIELDS)
        best = abs(r["cfl"]) or 1.0
        at = r["at_probe"]
        gap = max(abs(rep["cfl"] - r["cfl"]), math.inf if at is None else r["cfl"] - at) / best
        if rep["violations"] != r["violations"] or rep["first_step"] != r["first_step"]:
            gap = math.inf
        nums["cfl_gap"] = gap
        return out, nums
