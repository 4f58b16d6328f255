"""The check's control: the plain reference put in the program's place, in
a lower precision than the configuration states (bfloat16 for its
float32). The benchmark's own runs never use it; ``readings.py`` and the
tests do, to show that the check fails it."""
from __future__ import annotations

import torch

__all__ = ["StandIn"]


class StandIn:
    """A route whose solver call is the reference's, computed in ``dtype``
    from the state cast to it, its result cast back. Everything else
    (shapes, the port's config for the frame work, the judge) is the
    wrapped route's."""

    def __init__(self, route, config: dict, dtype=torch.bfloat16):
        self.route = route
        self.ref = route.reference(config)
        self.dtype = dtype
        self.track_cfl = getattr(route, "tracks_cfl", False)

    def __getattr__(self, name):
        return getattr(self.route, name)

    def frame_output(self, kind: str, state):
        """The frame's line as the reference computes it in ``dtype`` (the
        metrics line, the read-back line); None for a frame kind the
        reference does not compute, whose program's frame work then runs."""
        low = tuple(a.to(self.dtype) for a in state)
        if kind == "metrics_line":
            from portbench.frames.metrics_line import LINE

            return LINE.format(**self.ref.metrics(low, self.dtype))
        if kind == "readback3d":
            from portbench.frames.readback3d import LINE

            return LINE.format(**self.ref.readback(low[0], self.dtype))
        return None

    def advance(self, state, n: int, istep0: int):
        back = state[0].dtype
        low = tuple(a.to(self.dtype) for a in state)
        if self.track_cfl:
            out, rep = self.ref.advance(low, n, istep0, track_cfl=True)
            rep = {k: v for k, v in rep.items() if k != "at_probe"}
            return tuple(a.to(back) for a in out), rep
        return tuple(a.to(back) for a in self.ref.advance(low, n, istep0)), None
