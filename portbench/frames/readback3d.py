"""The 3-D frame's read-back, as ``python -m tpuvof_torch --three-d`` does
it at each frame: the whole F to the host, the liquid mass over the
interior and F's range, and the export line written to the run's log (the
VTK file that follows it in the CLI is left out: see the configuration's
``reduced``). Judged against the reference's mass and range of the
frame's own F, which the state's numbers judge against the reference's
run."""
from __future__ import annotations

import re

from portbench.frames.metrics_line import units_off

__all__ = ["Frame", "LINE"]

#: The numbers of the line as the CLI prints them.
LINE = "mass={mass:.1f} range=[{min:.3f},{max:.3f}]"
_LINE = re.compile(r"mass=(\S+) range=\[(\S+),(\S+)\]")


class Frame:
    name = "readback3d"
    numbers = ("line_units",)

    def __init__(self, route, traffic: dict, outdir):
        self.log = open(outdir / f"{self.name}.log", "w")

    def run(self, state, istep: int, index: int) -> str:
        F = state[0].cpu().numpy()
        line = (f">>> Exporting step-{istep:05d} result... "
                + LINE.format(mass=F[1:-1, 1:-1, 1:-1].sum(), min=F.min(), max=F.max()))
        self.log.write(line + "\n")
        return line

    def close(self):
        self.log.close()

    def judge(self, ref, ref_state, sample, line: str) -> dict:
        """``line_units``: the printed mass, minimum and maximum's worst
        distance from the reference's values, in units of the last printed
        digit."""
        m = _LINE.search(line)
        if m is None:
            return {"line_units": float("inf")}
        want = ref.readback(sample.out[0])
        return {"line_units": max(units_off(m.group(1), want["mass"]),
                                  units_off(m.group(2), want["min"]),
                                  units_off(m.group(3), want["max"]))}
