"""``tpuvof_torch.solver3d.simulate_3d``: the 3-D step on the traffic's
backend (``cuda``: predict3d_rhs, jacobi3d, correct3d and three fct3d
sweeps a step), as ``python -m tpuvof_torch --three-d`` runs it."""
from __future__ import annotations

import torch

from portbench.harness import compare_states
from portbench.reference.flow3d import Flow3D

FIELDS = ("F", "u", "v", "w", "p")

__all__ = ["Route"]


class Route:
    dims = 3

    def __init__(self, config: dict, traffic: dict, device):
        from tpuvof_torch import Fluid, Grid3D
        from tpuvof_torch.solver3d import simulate_3d

        self._simulate_3d = simulate_3d
        self.grid = Grid3D(config["nx"], config["ny"], config["nz"],
                           config["Lx"], config["Ly"], config["Lz"])
        self.fluid = Fluid(**config["fluid"])
        self.dt = config["dt"]
        self.backend = traffic["backend"]
        self.csf = bool(config["csf"])
        self.shape = self.grid.shape
        self.cells = config["nx"] * config["ny"] * config["nz"]
        self.n_jacobi = config["n_jacobi"]
        self.dtype = config["dtype"]

    def advance(self, state, n: int, istep0: int):
        from tpuvof_torch.state import State3D

        out = self._simulate_3d(self.grid, State3D(*state), n, self.dt, self.n_jacobi,
                                fl=self.fluid, backend=self.backend, istep0=istep0,
                                csf=self.csf)
        return out, None

    @staticmethod
    def reference(config: dict) -> Flow3D:
        return Flow3D(config)

    @staticmethod
    def judge(ref: Flow3D, sample, dtype=torch.float64):
        inp = tuple(a.to(dtype) for a in sample.inp)
        out = ref.advance(inp, sample.steps, sample.istep0)
        return out, compare_states(sample.out, out, FIELDS)
