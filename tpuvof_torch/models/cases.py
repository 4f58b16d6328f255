"""Forward two-phase cases (counterpart of tpuvof/models/cases.py)."""
from __future__ import annotations

import torch

from ..config import SimConfig, dam_break_2d
from ..state import State, init_state

__all__ = ["dam_break", "rising_bubble", "liquid_drop", "FORWARD_CASES"]


def dam_break(n: int = 200, *, device, dtype: torch.dtype, **kw) -> tuple[SimConfig, State]:
    """Liquid column x in [0, Lx/3], y in [0, Ly/2] collapsing under gravity."""
    cfg = dam_break_2d(n, **kw)
    return cfg, init_state(cfg, 1, device, dtype)


def rising_bubble(n: int = 200, *, device, dtype: torch.dtype, **kw) -> tuple[SimConfig, State]:
    """Gas circle of radius Lx/12 released near the bottom."""
    cfg = dam_break_2d(n, **kw)
    return cfg, init_state(cfg, 2, device, dtype)


def liquid_drop(n: int = 200, *, device, dtype: torch.dtype, **kw) -> tuple[SimConfig, State]:
    """Liquid circle falling onto a pool filling y < 0.37*Ly."""
    cfg = dam_break_2d(n, **kw)
    return cfg, init_state(cfg, 3, device, dtype)


FORWARD_CASES = {"dam_break": dam_break, "rising_bubble": rising_bubble,
                 "liquid_drop": liquid_drop}
