"""The port's 2-D slice end to end against tpuvof and the golden.

- Against tpuvof.simulate in f64 at 32^2 x 20 steps within 1e-12 of each
  field's scale. tpuvof.simulate runs under ``jax.disable_jit()`` there:
  compiled, XLA contracts a*b+c into FMAs, and the dam break amplifies that
  rounding difference to 5.3e-9 (u, v) after 20 steps -- tpuvof's own gap
  between its jitted and eager runs. The jitted run is held at 1e-7.
- Against tests/golden_dambreak_64_1000.npz with the bars of
  tests/test_golden.py: f64 F/u within 1e-8 at step 300 and 1e-5 at 1000;
  f32 F within 5e-3 at 1000.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import tpuvof as tv

import tpuvof_torch as tt
from tpuvof_torch.convert import config_from_tpuvof, state_from_numpy, state_to_numpy
from tpuvof_torch.models import FORWARD_CASES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden_dambreak_64_1000.npz")


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def _cfg(n, backend):
    return tt.dam_break_2d(n, num=tt.Numerics(backend=backend))


@pytest.fixture(scope="module")
def tpuvof_32_20():
    """tpuvof's 32^2 dam break: the f64 initial state and its state after
    20 steps, eager and jitted."""
    cfg = tv.dam_break_2d(32)
    s0 = tv.State(*(jnp.asarray(a, jnp.float64) for a in tv.init_state(cfg, ic=1)))
    with jax.disable_jit():
        eager = tv.simulate(cfg, s0, 20)
    jitted = tv.simulate(cfg, s0, 20)
    return cfg, [np.asarray(a) for a in s0], eager, jitted


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_slice_matches_tpuvof_simulate_f64(tpuvof_32_20, backend):
    cfg, s0, eager, jitted = tpuvof_32_20
    pc = _cfg(32, backend)
    assert pc == config_from_tpuvof(
        cfg.replace(num=dataclasses.replace(cfg.num, backend={"cuda": "pallas",
                                                               "torch": "xla"}[backend])))
    out = state_to_numpy(tt.simulate(pc, state_from_numpy(*s0, "cpu", torch.float64), 20))
    for name, got, e, j in zip("Fuvp", out, eager, jitted):
        assert _rel(got, e) <= 1e-12, name
        assert _rel(got, j) <= 1e-7, name


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def golden_run_f64(golden):
    """The 64^2 dam break on backend='cuda' (CPU tensors: the plain
    versions), 300 steps, then on to 1000 in a second chunk."""
    cfg = _cfg(int(golden["n"]), "cuda")
    s300 = tt.simulate(cfg, tt.init_state(cfg, 1, "cpu", torch.float64),
                       int(golden["checkpoint"]))
    s1000 = tt.simulate(cfg, s300, int(golden["n_steps"]) - int(golden["checkpoint"]),
                        istep0=int(golden["checkpoint"]))
    return s300, s1000


def test_golden_300_steps_f64(golden, golden_run_f64):
    s300, _ = golden_run_f64
    assert np.max(np.abs(s300.F.numpy() - golden["F300"])) <= 1e-8
    assert np.max(np.abs(s300.u.numpy() - golden["u300"])) <= 1e-8


def test_golden_1000_steps_f64(golden, golden_run_f64):
    _, s1000 = golden_run_f64
    assert np.max(np.abs(s1000.F.numpy() - golden["F"])) <= 1e-5
    assert np.max(np.abs(s1000.u.numpy() - golden["u"])) <= 1e-5


def test_golden_1000_steps_f32_drift(golden):
    cfg = _cfg(int(golden["n"]), "cuda")
    s = tt.simulate(cfg, tt.init_state(cfg, 1, "cpu", torch.float32), int(golden["n_steps"]))
    assert s.F.dtype == torch.float32
    assert np.max(np.abs(s.F.double().numpy() - golden["F"])) <= 5e-3


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_chunked_with_istep0_matches_continuous(backend):
    cfg = _cfg(32, backend)
    s0 = tt.init_state(cfg, 1, "cpu", torch.float64)
    whole = tt.simulate(cfg, s0, 13)
    part = tt.simulate(cfg, tt.simulate(cfg, s0, 7), 6, istep0=7)
    for a, b in zip(whole, part):
        assert torch.equal(a, b)
    # restarting the parity each chunk is a different trajectory
    wrong = tt.simulate(cfg, tt.simulate(cfg, s0, 7), 6)
    assert not torch.equal(whole.F, wrong.F)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_lean_step_equals_full_step(backend):
    cfg = _cfg(32, backend)
    s = tt.simulate(cfg, tt.init_state(cfg, 1, "cpu", torch.float64), 9)
    before = [a.clone() for a in s]
    for even in (False, True):
        lean = tt.step(cfg, s, even, lean=True)
        full = tt.step(cfg, s, even, lean=False)
        for a, b in zip(lean, full):
            assert torch.equal(a, b)
    pair = tt.step_pair(cfg, s, lean=True)
    seq = tt.step(cfg, tt.step(cfg, s, False, lean=True), True, lean=True)
    for a, b in zip(pair, seq):
        assert torch.equal(a, b)
    for a, b in zip(s, before):  # the entry state is not modified
        assert torch.equal(a, b)


def test_convert_round_trips():
    rng = np.random.default_rng(5)
    arrays = [rng.standard_normal((10, 10)) for _ in range(4)]
    s = state_from_numpy(*arrays, "cpu", torch.float64)
    assert all(a.dtype == torch.float64 and a.is_contiguous() for a in s)
    for a, b in zip(state_to_numpy(s), arrays):
        np.testing.assert_array_equal(a, b)
    s32 = state_from_numpy(*arrays, "cpu", torch.float32)
    for a, b in zip(state_to_numpy(s32), arrays):
        np.testing.assert_array_equal(a, b.astype(np.float32))

    jcfg = tv.SimConfig(grid=tv.Grid2D(40, 40, 0.2, 0.2),
                        fluid=tv.Fluid(rho_l=900.0, sigma=0.01),
                        num=tv.Numerics(dt=2e-6, n_jacobi=7, fct=tv.FCT_DIFF))
    pc = config_from_tpuvof(jcfg)
    assert pc == tt.SimConfig(grid=tt.Grid2D(40, 40, 0.2, 0.2),
                              fluid=tt.Fluid(rho_l=900.0, sigma=0.01),
                              num=tt.Numerics(dt=2e-6, n_jacobi=7, fct=tt.FCT_DIFF,
                                              backend="torch"))
    for tpu_name, port_name in (("xla", "torch"), ("pallas", "cuda"),
                                ("pallas_mono", "cuda_mono"), ("pallas_tiled", "cuda_tiled"),
                                ("pallas_strips", "cuda_strips")):
        num = dataclasses.replace(jcfg.num, backend=tpu_name)
        assert config_from_tpuvof(jcfg.replace(num=num)).num.backend == port_name
    # the ladder's settings are carried
    num = dataclasses.replace(jcfg.num, pressure_solver="mg", sor_omega=1.5, sor_tol=1e-5,
                              sor_max_iter=77, sor_tol_rel=1e-2)
    got = config_from_tpuvof(jcfg.replace(num=num)).num
    assert (got.pressure_solver, got.sor_omega, got.sor_tol, got.sor_max_iter,
            got.sor_tol_rel) == ("mg", 1.5, 1e-5, 77, 1e-2)
    # the pressure adjoint and the mirror between sweeps are carried
    num = dataclasses.replace(jcfg.num, pressure_adjoint="selfadjoint", bc_between_sweeps=True)
    got = config_from_tpuvof(jcfg.replace(num=num)).num
    assert (got.pressure_adjoint, got.bc_between_sweeps) == ("selfadjoint", True)
    with pytest.raises(NotImplementedError, match="unknown tpuvof backend"):
        config_from_tpuvof(jcfg.replace(num=dataclasses.replace(jcfg.num,
                                                                backend="pallas_dma")))
    with pytest.raises(TypeError):
        config_from_tpuvof({"grid": None})


@pytest.mark.parametrize("num", [tt.Numerics(backend="pallas_mono"),
                                 tt.Numerics(backend="cuda_mono", bc_between_sweeps=True),
                                 tt.Numerics(bc_between_sweeps=True)])
def test_unported_settings_raise(num):
    cfg = tt.dam_break_2d(16, num=num)
    s = tt.init_state(cfg, 1, "cpu", torch.float64)
    with pytest.raises(NotImplementedError):
        tt.simulate(cfg, s, 1)
    with pytest.raises(NotImplementedError):
        tt.step(cfg, s, False)


def test_metrics_match_tpuvof(tpuvof_32_20):
    from tpuvof.metrics import compute_metrics

    cfg, _, eager, _ = tpuvof_32_20
    want = compute_metrics(cfg, eager)
    got = tt.compute_metrics(config_from_tpuvof(cfg),
                             state_from_numpy(*map(np.asarray, eager), "cpu", torch.float64))
    for name, g_, w_ in zip(got._fields, got, want):
        if name == "finite":
            assert bool(g_) and bool(w_)
        else:
            assert abs(float(g_) - float(w_)) <= 1e-12 * max(abs(float(w_)), 1e-300), name


@pytest.mark.parametrize("case,ic", [("dam_break", 1), ("rising_bubble", 2), ("liquid_drop", 3)])
def test_cases(case, ic):
    cfg, s = FORWARD_CASES[case](24, device="cpu", dtype=torch.float64)
    assert cfg == tt.dam_break_2d(24)
    np.testing.assert_array_equal(s.F.numpy(),
                                  tt.initial_volume_fraction(cfg.grid, ic).astype(np.float64))
    out = tt.simulate(cfg, s, 4)
    m = tt.compute_metrics(cfg, out)
    assert bool(m.finite) and 0.0 <= float(out.F.min()) and float(out.F.max()) <= 1.0


def test_import_pulls_in_no_jax():
    code = ("import sys, tpuvof_torch, tpuvof_torch.convert, tpuvof_torch.kernels, "
            "tpuvof_torch.kernels.build, tpuvof_torch.models, tpuvof_torch.metrics, "
            "tpuvof_torch.solver, tpuvof_torch.ops.mg, tpuvof_torch.ops.window, "
            "tpuvof_torch.diff, tpuvof_torch.models.advection, "
            "tpuvof_torch.parallel, tpuvof_torch.parallel.dist3d, "
            "tpuvof_torch.parallel.dist, tpuvof_torch.parallel.halo, "
            "tpuvof_torch.parallel.plan; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tpuvof')); print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
