"""``tpuvof_torch.solver.simulate``: the 2-D step on the traffic's backend
(``cuda_mono``: one whole-step kernel launch a step), with no CFL tracker,
as ``python -m tpuvof_torch --no-cfl-warn`` runs it."""
from __future__ import annotations

import torch

from portbench.harness import compare_states
from portbench.reference.flow2d import Flow2D

FIELDS = ("F", "u", "v", "p")

__all__ = ["Route", "port_config"]


def port_config(config: dict, traffic: dict):
    """The port's SimConfig for a configuration dict and a traffic mix."""
    from tpuvof_torch import Fluid, Grid2D, Numerics, SimConfig

    return SimConfig(grid=Grid2D(config["nx"], config["ny"], config["Lx"], config["Ly"]),
                     fluid=Fluid(**config["fluid"]),
                     num=Numerics(dt=config["dt"], n_jacobi=config["n_jacobi"],
                                  backend=traffic["backend"]))


class Route:
    dims = 2

    def __init__(self, config: dict, traffic: dict, device):
        from tpuvof_torch.solver import simulate

        self._simulate = simulate
        self.cfg = port_config(config, traffic)
        self.shape = self.cfg.grid.shape
        self.cells = config["nx"] * config["ny"]
        self.n_jacobi = config["n_jacobi"]
        self.dtype = config["dtype"]

    def advance(self, state, n: int, istep0: int):
        from tpuvof_torch.state import State

        return self._simulate(self.cfg, State(*state), n, istep0=istep0), None

    @staticmethod
    def reference(config: dict) -> Flow2D:
        return Flow2D(config)

    @staticmethod
    def judge(ref: Flow2D, sample, dtype=torch.float64):
        """The reference's state after the frame, and the state numbers."""
        inp = tuple(a.to(dtype) for a in sample.inp)
        out = ref.advance(inp, sample.steps, sample.istep0)
        return out, compare_states(sample.out, out, FIELDS)
