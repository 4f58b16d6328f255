"""Material property mixing (counterpart of tpuvof/ops/materials.py:15-20).

Pointwise over the full grid including ghosts: F is clamped to [0, 1]
and density/viscosity are linear mixes of the two phases' properties.
"""
from __future__ import annotations

from ..config import Fluid
from .common import clamp01

__all__ = ["mix_properties"]


def mix_properties(fl: Fluid, F):
    """Return (rho, nu) from the volume fraction."""
    Fc = clamp01(F)
    rho = fl.rho_g * (1.0 - Fc) + fl.rho_l * Fc
    nu = fl.nu_l * Fc + fl.nu_g * (1.0 - Fc)
    return rho, nu
