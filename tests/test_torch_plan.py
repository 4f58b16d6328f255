"""The port's mesh planner, tpuvof_torch.parallel.plan (tests/test_plan.py's
analogs): pure shape arithmetic, whose verdicts are the engines' own
admission rules (admission_2d, admission_3d), so a plan names the engine
Decomp or Decomp3D really builds at that shape. The rankings follow the
engine-class speeds measured on the card, not tpuvof's TPU ones, and may
differ from tpuvof's."""
import numpy as np
import pytest
import torch

import tpuvof_torch as tt
from tpuvof_torch.cli import main
from tpuvof_torch.parallel import (Decomp, Decomp3D, Mesh, admission_2d, admission_3d,
                                   format_plans, plan_mesh_2d, plan_mesh_3d)
from tpuvof_torch.parallel import plan as P

CPU = torch.device("cpu")


def _mesh(px, py):
    devices = np.empty(px * py, dtype=object)
    devices[:] = [CPU] * (px * py)
    return Mesh(devices.reshape(px, py), ("mx", "my"))


def _ranked(plans):
    return all(plans[i].score >= plans[i + 1].score for i in range(len(plans) - 1))


def _engine_3d(g, px, py, n_jacobi=10):
    """The engine Decomp3D(backend='cuda') builds at (px, py), or 'torch'
    where it raises for the wide-halo engine's cone."""
    try:
        dec = Decomp3D(g, _mesh(px, py) if py > 1 else tt.make_mesh(px, ("mx",), [CPU] * px),
                       n_jacobi=n_jacobi)
    except ValueError as e:
        assert "backend='torch'" in str(e)
        return "torch"
    return "cuda-pencil" if dec.pencil else "cuda-slab"


def test_plan_3d_flagship_8_chips():
    """200^3 on 8 chips: every shape admits the wide-halo engine (the
    port's slabs have no even-width rule, unlike tpuvof's); each plan
    names the engine Decomp3D builds, ranked by score."""
    g = tt.Grid3D(200, 200, 200)
    plans = plan_mesh_3d(g, 8)
    assert [(p.px, p.py) for p in plans] and _ranked(plans)
    for p in plans:
        assert p.engine == _engine_3d(g, p.px, p.py), (p.px, p.py)
    slab = next(p for p in plans if (p.px, p.py) == (8, 1))
    assert slab.engine == "cuda-slab" and slab.detail == "W=14"


def test_plan_3d_slab_when_it_fits():
    plans = {(p.px, p.py): p for p in plan_mesh_3d(tt.Grid3D(64, 64, 64), 2)}
    assert plans[(2, 1)].engine == "cuda-slab"
    assert plans[(1, 2)].engine == "cuda-pencil"


def test_plan_3d_agrees_with_decomp3d_admission():
    """The planner's verdict is the constructor's: an admitted shape
    builds the engine with the admission's geometry; a rejected one
    raises, and the plan names the torch engine and the reason."""
    g = tt.Grid3D(32, 32, 32)
    adm = admission_3d(g, 2, 2, n_jacobi=2)
    assert adm["ok"] and adm["pencil"]
    dec = Decomp3D(g, _mesh(2, 2), n_jacobi=2)
    assert dec.pencil and (dec.W, dec.Wy, dec.nloc, dec.nyE) == (
        adm["W"], adm["Wy"], adm["nloc"], adm["nyE"])
    bad = admission_3d(g, 2, 4)  # ny/py = 8 < Wy + 1 = 15
    assert not bad["ok"] and "ny/py" in bad["why"]
    with pytest.raises(ValueError, match="ny/py"):
        Decomp3D(g, _mesh(2, 4))
    plan = next(p for p in plan_mesh_3d(g, 8) if (p.px, p.py) == (2, 4))
    assert plan.engine == "torch" and plan.detail == bad["why"]


def test_admission_table_512_cube():
    """512^3: tpuvof's VMEM rejects 2x4 and admits 2x8 and 4x4; the port
    has no VMEM cap and admits all three, with the cone's geometry; the
    planner ranks them as pencil engines and scores the halo work."""
    g = tt.Grid3D(512, 512, 512)
    geometry = {(2, 8): (14, 14, 284, 92), (2, 4): (14, 14, 284, 156),
                (4, 4): (14, 14, 156, 156)}
    for (px, py), geo in geometry.items():
        a = admission_3d(g, px, py)
        assert a["ok"] and a["pencil"]
        assert (a["W"], a["Wy"], a["nloc"], a["nyE"]) == geo
    v16 = {(p.px, p.py): p for p in plan_mesh_3d(g, 16)}
    assert v16[(2, 8)].engine == v16[(4, 4)].engine == "cuda-pencil"
    # the squarer 4x4 blocks sweep fewer halo cells per owned cell
    assert v16[(4, 4)].work_factor < v16[(2, 8)].work_factor
    assert v16[(4, 4)].score > v16[(2, 8)].score
    assert {(p.px, p.py): p.engine for p in plan_mesh_3d(g, 8)}[(2, 4)] == "cuda-pencil"


def test_plan_2d_within_reach_uses_full_block():
    """512^2 on 4: the full-block engine everywhere, the squarest first;
    Decomp with 'cuda_mono' builds it at each plan's shape."""
    cfg = tt.dam_break_2d(512, num=tt.Numerics(backend="cuda_mono"))
    plans = plan_mesh_2d(cfg, 4)
    assert plans[0].mesh_shape == (2, 2) and _ranked(plans)
    for p in plans:
        assert p.engine == "cuda-full"
        assert Decomp(cfg, _mesh(p.px, p.py)).engine == "full"
    W = 22
    assert plans[0].work_factor == round((256 + 2 * W + 2) ** 2 / 256**2, 3)
    halo = 2 * 2 * (W + 1) * (256 + 2 * W + 2) * 4 * P.CELL_BYTES / 2**20
    assert plans[0].halo_mb_step == round(halo, 3)


def test_plan_2d_large_and_thin_shards():
    """The port has no VMEM envelope: 8192^2 on 4 chips still plans the
    full-block engine (tpuvof streams there). Where a shard is thinner
    than the W+1 halo the planner names the torch engine and the reason,
    and Decomp on a 'cuda*' backend raises there."""
    big = plan_mesh_2d(tt.dam_break_2d(8192), 4)
    assert big[0].engine == "cuda-full"
    cfg = tt.dam_break_2d(64, num=tt.Numerics(backend="cuda_mono"))
    plans = {(p.px, p.py): p for p in plan_mesh_2d(cfg, 8)}
    for (px, py), p in plans.items():
        adm = admission_2d(cfg.grid, px, py, 22)
        assert p.engine == ("cuda-full" if adm["ok"] else "torch")
        if not adm["ok"]:
            assert p.detail == adm["why"]
            with pytest.raises(ValueError, match="backend='torch'"):
                Decomp(cfg, _mesh(px, py))
    assert plans[(8, 1)].engine == "torch" and plans[(8, 1)].work_factor == 1.0


def test_plan_formatting_and_no_fit(capsys):
    assert "mesh" in format_plans(plan_mesh_3d(tt.Grid3D(64, 64, 64), 2))
    assert "no mesh shape" in format_plans(plan_mesh_2d(tt.dam_break_2d(64), 7))
    # the CLI prints the same table, needing no device
    assert main(["--plan-mesh", "4", "--nx", "512"]) == 0
    assert capsys.readouterr().out == format_plans(plan_mesh_2d(tt.dam_break_2d(512), 4)) + "\n"
