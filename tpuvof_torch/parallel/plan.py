"""Mesh planning: rank the (px, py) decompositions of a grid over a number
of devices (counterpart of tpuvof/parallel/plan.py).

Each divisor pair gets the engine that Decomp or Decomp3D would really run
there with a 'cuda*' backend, decided by the engines' own admission rules
(``dist.admission_2d``, ``dist3d.admission_3d``), or 'torch' where only
the plain engine runs; and a relative score

  score = engine_class_speed / work_factor

  work_factor         cells the engine sweeps a step over the cells the
                      shard owns: the extended block (nxl+2W+2)(nyl+2W+2)
                      in 2-D, (nloc+2)(nyE+2)(nz+2) in 3-D, 1 for 'torch'
  engine_class_speed  swept cells a second of the class, relative to the
                      full-block engine (2-D) or the slab engine (3-D),
                      measured on the card (the constants below)

Scores rank configurations; they predict no absolute rate. tpuvof pads its
swept extents to the TPU's (8, 128) tiles and models its B-chunked Jacobi;
neither applies to the port. Pure shape arithmetic: no device is needed
(CLI: ``python -m tpuvof_torch --plan-mesh N [--three-d]``).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..config import SimConfig
from ..grid import Grid3D
from ..kernels.step_kernels import STEP_HALO
from .dist import admission_2d
from .dist3d import admission_3d

__all__ = ["MeshPlan", "plan_mesh_2d", "plan_mesh_3d", "format_plans"]

# Swept cells a second of each engine class relative to the full-block
# engine (2-D) or the x-slab engine (3-D): a class's cell-updates/s on the
# host clock times its work factor, over the reference class's. Measured
# on one NVIDIA H100 80GB HBM3 at 700.00 W by chip_smoke.py, whose phase 18
# (g) prints each beside these constants: 2-D at 512^2 f32 on a virtual
# 2x2 mesh (phase 18 (c): the full-block engine, 1000 steps; (f): the torch
# engine, 20 steps); 3-D at 200^3 f32 (phase 13: the (4,) slabs and the
# 2x2 pencils, 1000 steps; phase 18 (f): the torch engine on 2x2, 2 steps).
# One card hosts every shard there, so these rank engines; they are not
# rates of a multi-card run.
SPEED_2D = {"cuda-full": 1.0, "torch": 0.0215}
SPEED_3D = {"cuda-slab": 1.0, "cuda-pencil": 1.028, "torch": 0.0197}
#: Bytes of a field's cell in the halo payload (f32).
CELL_BYTES = 4


@dataclass(frozen=True)
class MeshPlan:
    """One ranked decomposition candidate."""

    px: int
    py: int
    engine: str          # 'cuda-full' | 'cuda-slab' | 'cuda-pencil' | 'torch'
    work_factor: float   # swept/owned cells per device (>= 1)
    score: float         # engine_class_speed / work_factor (relative)
    halo_mb_step: float  # the wide-halo refresh's copies a step, MB (all fields)
    detail: str          # engine geometry, or why a kernel engine does not run

    @property
    def mesh_shape(self) -> tuple[int, int]:
        return (self.px, self.py)


def _divisor_pairs(n: int):
    for px in range(1, n + 1):
        if n % px == 0:
            yield px, n // px


def _plan(px, py, engine, swept, owned, speed, halo_cells, fields, detail) -> MeshPlan:
    wf = swept / owned
    return MeshPlan(px, py, engine, round(wf, 3), round(speed / wf, 4),
                    round(halo_cells * fields * CELL_BYTES / 2**20, 3), detail)


def plan_mesh_2d(cfg: SimConfig, n_devices: int) -> list[MeshPlan]:
    """Ranked (px, py) meshes for Decomp: the full-block engine where each
    (W+1)-band halo comes from one neighbour (what 'cuda' and 'cuda_mono'
    run), else the torch engine. The halo payload is the (W+1) bands on
    each split side over the extended block's other extent, 4 fields."""
    g = cfg.grid
    W = STEP_HALO(cfg)
    plans = []
    for px, py in _divisor_pairs(n_devices):
        if g.nx % px or g.ny % py:
            continue
        adm = admission_2d(g, px, py, W)
        nxl, nyl = adm["nxl"], adm["nyl"]
        halo = 0
        if px > 1:
            halo += 2 * (W + 1) * (adm["nyE"] + 2)
        if py > 1:
            halo += 2 * (W + 1) * (adm["nxE"] + 2)
        if adm["ok"]:
            plans.append(_plan(px, py, "cuda-full", (adm["nxE"] + 2) * (adm["nyE"] + 2),
                               nxl * nyl, SPEED_2D["cuda-full"], halo, 4,
                               f"W={W} resident block"))
        else:
            plans.append(_plan(px, py, "torch", nxl * nyl, nxl * nyl, SPEED_2D["torch"], halo,
                               4, adm["why"]))
    plans.sort(key=lambda p: -p.score)
    return plans


def plan_mesh_3d(g: Grid3D, n_devices: int, n_jacobi: int = 10) -> list[MeshPlan]:
    """Ranked (px, py) meshes for Decomp3D: x slabs (py = 1) and (x, y)
    pencils where the wide-halo engine admits the shape (admission_3d),
    else the torch engine. The halo payload is the (W+1) planes on each x
    side and the (Wy+1) rows on each y side, 5 fields."""
    plans = []
    for px, py in _divisor_pairs(n_devices):
        if g.nx % px or g.ny % py:
            continue
        adm = admission_3d(g, px, py, n_jacobi)
        owned = (g.nx // px) * (g.ny // py) * g.nz
        halo = 0
        if px > 1:
            halo += 2 * (adm["W"] + 1) * (adm["nyE"] + 2) * (g.nz + 2)
        if py > 1:
            halo += 2 * (adm["Wy"] + 1) * (adm["nloc"] + 2) * (g.nz + 2)
        if adm["ok"]:
            engine = "cuda-pencil" if adm["pencil"] else "cuda-slab"
            swept = (adm["nloc"] + 2) * (adm["nyE"] + 2) * (g.nz + 2)
            detail = f"W={adm['W']}" + (f" Wy={adm['Wy']}" if adm["pencil"] else "")
            plans.append(_plan(px, py, engine, swept, owned, SPEED_3D[engine], halo, 5, detail))
        else:
            plans.append(_plan(px, py, "torch", owned, owned, SPEED_3D["torch"], halo, 5,
                               adm["why"]))
    plans.sort(key=lambda p: -p.score)
    return plans


def format_plans(plans: list[MeshPlan]) -> str:
    """Human-readable ranking table (CLI --plan-mesh)."""
    if not plans:
        return "no mesh shape divides this grid at that device count"
    lines = [f"{'mesh':>8}  {'engine':<14} {'work x':>7} {'score':>7} "
             f"{'halo MB/step':>12}  detail"]
    for p in plans:
        lines.append(f"{p.px:>3}x{p.py:<4}  {p.engine:<14} "
                     f"{p.work_factor:>7} {p.score:>7} "
                     f"{p.halo_mb_step:>12}  {p.detail}")
    return "\n".join(lines)
