"""Canonical cases: the forward two-phase cases and the pure-advection
scheme-verification cases."""
from .advection import (
    ADVECTION_CASES,
    AdvectionCase,
    checkerboard,
    simulate_advection,
    single_vortex,
    translation,
    zalesak_disk,
)
from .cases import FORWARD_CASES, dam_break, liquid_drop, rising_bubble

__all__ = [
    "FORWARD_CASES",
    "dam_break",
    "liquid_drop",
    "rising_bubble",
    "AdvectionCase",
    "single_vortex",
    "zalesak_disk",
    "translation",
    "checkerboard",
    "simulate_advection",
    "ADVECTION_CASES",
]
