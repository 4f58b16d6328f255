"""The mesh's 3-D frame line, as ``python -m tpuvof_torch --three-d --mesh``
prints it: the liquid mass (summed in float64 on each card) and F's range
from the program's per-shard reductions (``Decomp3D.line``), with no
whole-grid read-back, written to the run's log. Judged against the mass
and range of the frame's own output that the kept frame reduced in
float64 (``portbench.shards``). A state without resident blocks (the
control's, judged on its boxes alone) has no line."""
from __future__ import annotations

import re

from portbench.frames.metrics_line import units_off
from portbench.frames.readback3d import LINE

__all__ = ["Frame"]

_LINE = re.compile(r"mass=(\S+) range=\[(\S+),(\S+)\]")


class Frame:
    name = "shard_lines"
    numbers = ("line_units",)

    def __init__(self, route, traffic: dict, outdir):
        self.route = route
        self.log = open(outdir / f"{self.name}.log", "w")

    def run(self, state, istep: int, index: int) -> str:
        mass, lo, hi = self.route.line(state)
        line = f">>> Exporting step-{istep:05d} result... " + LINE.format(mass=mass, min=lo,
                                                                          max=hi)
        self.log.write(line + "\n")
        return line

    def close(self):
        self.log.close()

    def judge(self, ref, ref_state, sample, line: str) -> dict:
        """``line_units``: the printed mass, minimum and maximum's worst
        distance from the kept output's float64 values, in units of the
        last printed digit."""
        m = _LINE.search(line)
        want = sample.out[0].line
        if m is None or want is None:
            return {"line_units": float("inf")}
        return {"line_units": max(units_off(m.group(1), want["mass"]),
                                  units_off(m.group(2), want["min"]),
                                  units_off(m.group(3), want["max"]))}
