"""Canonical cases of the forward solver."""
from .cases import FORWARD_CASES, dam_break, liquid_drop, rising_bubble

__all__ = ["FORWARD_CASES", "dam_break", "liquid_drop", "rising_bubble"]
