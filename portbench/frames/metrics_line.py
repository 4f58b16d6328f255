"""The 2-D frame's metrics line, as ``python -m tpuvof_torch`` prints it:
``compute_metrics`` and ``format_frame`` (one host read of the metrics),
the finiteness guard the CLI stops on, and the line written to the run's
log. Judged against the reference's metrics of the frame's own output
state, which the state's numbers judge against the reference's run."""
from __future__ import annotations

import math
import re

__all__ = ["Frame", "parse_line", "units_off", "LINE"]

#: The numbers of the line as format_frame prints them.
LINE = ("mass={mass:.4f} max|u|={max_u:.3e} max|v|={max_v:.3e} "
        "CFL=({cfl_u:.3f},{cfl_v:.3f}) div={max_div:.3e}")

_LINE = re.compile(r"mass=(\S+) max\|u\|=(\S+) max\|v\|=(\S+) CFL=\((\S+),(\S+)\) div=([^\s\[]+)")
_FIELDS = ("mass", "max_u", "max_v", "cfl_u", "cfl_v", "max_div")


def parse_line(line: str) -> dict:
    """The printed numbers of a metrics line, as their strings."""
    m = _LINE.search(line)
    if m is None:
        raise ValueError(f"not a metrics line: {line!r}")
    return dict(zip(_FIELDS, m.groups()))


def units_off(printed: str, value: float) -> float:
    """How many units of the printed string's last digit ``value`` lies from
    it: a correct print of a value lies within half a unit."""
    try:
        x = float(printed)
    except ValueError:
        return math.inf
    if not math.isfinite(x) or not math.isfinite(value):
        return math.inf
    if "e" in printed:
        mant, exp = printed.split("e")
        decimals = len(mant.split(".")[1]) if "." in mant else 0
        unit = 10.0 ** (int(exp) - decimals)
    else:
        decimals = len(printed.split(".")[1]) if "." in printed else 0
        unit = 10.0 ** (-decimals)
    return abs(x - value) / unit


class Frame:
    name = "metrics_line"
    numbers = ("line_mass_rel", "line_units")

    def __init__(self, route, traffic: dict, outdir):
        from tpuvof_torch.metrics import compute_metrics, format_frame

        self._compute, self._format = compute_metrics, format_frame
        self.cfg = route.cfg
        self.log = open(outdir / f"{self.name}.log", "w")

    def run(self, state, istep: int, index: int) -> str:
        from tpuvof_torch.state import State

        m = self._compute(self.cfg, State(*state))
        line = self._format(istep, self.cfg.num.dt, m, "vof")
        self.log.write(line + "\n")
        if not bool(m.finite):
            raise FloatingPointError(f"non-finite fields at step {istep}")
        return line

    def close(self):
        self.log.close()

    def judge(self, ref, ref_state, sample, line: str) -> dict:
        """``line_mass_rel``: the printed mass against the reference's
        float64 mass of the frame's state, relative; ``line_units``: the
        other printed numbers' worst distance from the reference's values
        of that state, in units of their last printed digit."""
        got = parse_line(line)
        want = ref.metrics(sample.out)
        try:
            mass = abs(float(got["mass"]) - want["mass"]) / abs(want["mass"])
        except (ValueError, ZeroDivisionError):
            mass = math.inf
        units = max(units_off(got[k], want[k]) for k in _FIELDS[1:])
        return {"line_mass_rel": mass, "line_units": units}
