"""tpuvof_torch.models.advection, the pure-advection scheme cases, against
the loop-based spec (tests/reference_numpy.py) and against tpuvof's
models/advection.py, and the routes that take bc_between_sweeps.

The analogs of tests/test_scheme.py hold the port to the spec at the same
sizes and bars. Port against tpuvof: the cases' fields bit for bit (both
build them in numpy f32), and simulate_advection in f64 within 1e-12 of
tpuvof run eagerly, on the same numpy inputs.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import tpuvof as tv
import tpuvof.models as JM
from tpuvof.models.advection import simulate_advection as j_simulate_advection

import tpuvof_torch as tt
import tpuvof_torch.models as M
from tpuvof_torch.convert import config_from_tpuvof, state_from_numpy, state_to_numpy
from tpuvof_torch.models.advection import simulate_advection

from test_scheme import spec_advect

TOL = 1e-12
MAKERS = ("single_vortex", "zalesak_disk", "translation", "checkerboard")


def _f64(*tensors):
    return tuple(t.to(torch.float64) for t in tensors)


@pytest.mark.parametrize("maker", [M.single_vortex, M.zalesak_disk, M.translation])
def test_advection_matches_spec(maker):
    case, F0, u, v, _ = maker(n=20, tmax=40, device="cpu")
    n_steps = 9  # odd: a last step without its pair
    got = simulate_advection(case, *_f64(F0, u, v), n_steps)
    want = spec_advect(case.grid.nx, case.grid.ny, case.grid.Lx, case.grid.Ly,
                       F0.numpy(), u.numpy(), v.numpy(), n_steps, case.dt,
                       case.fct.denom_eps)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12)


def test_vortex_mass_conservation_and_bounds():
    """The closed Kothe-Rider flow holds the total of F to the scheme's
    truncation (~CFL; 64^2 at tmax 2000 is CFL ~0.06), and F stays near
    [0, 1] with no clamping, in f32 as the cases come."""
    case, F0, u, v, _ = M.single_vortex(n=64, tmax=2000, device="cpu")
    m0 = F0[1:-1, 1:-1].sum().item()
    F = simulate_advection(case, F0, u, v, 100)
    assert F.dtype == torch.float32
    m1 = F[1:-1, 1:-1].sum().item()
    assert abs(m1 - m0) / m0 < 1e-3
    assert F.min().item() > -5e-2 and F.max().item() < 1 + 5e-2
    assert torch.isfinite(F).all()


def test_translation_moves_interface():
    """At CFL 1 the gas circle moves one cell a step and keeps its mass
    while away from the walls."""
    case, F0, u, v, _ = M.translation(n=48, tmax=60, device="cpu")
    n_steps = 10
    F = simulate_advection(case, F0, u, v, n_steps)

    def gas_centroid_x(f):
        gas = 1.0 - f.numpy()[1:-1, 1:-1]
        xs = np.arange(gas.shape[0])[:, None]
        return (gas * xs).sum() / gas.sum(), gas.sum()

    c0, m0 = gas_centroid_x(F0)
    c1, m1 = gas_centroid_x(F)
    assert abs((c1 - c0) - n_steps) < 0.5
    assert abs(m1 - m0) / m0 < 1e-3


def test_checkerboard_stays_bounded():
    case, F0, u, v, _ = M.checkerboard(n=44, tmax=600, device="cpu")  # CFL ~0.15
    F = simulate_advection(case, F0, u, v, 30)
    assert torch.isfinite(F).all()
    assert F.min().item() > -5e-2 and F.max().item() < 1 + 5e-2


@pytest.mark.parametrize("name", MAKERS)
def test_cases_match_tpuvof(name):
    """Same grid, step and duration; F0, u, v and the target bit for bit,
    f32; and the case's numerics are tpuvof's, converted."""
    kw = dict(n=26, tmax=50)
    jcase, *jfields = getattr(JM, name)(**kw)
    case, *fields = M.ADVECTION_CASES[name](device="cpu", **kw)
    assert dataclasses.asdict(case.grid) == dataclasses.asdict(jcase.grid)
    assert (case.dt, case.n_steps) == (jcase.dt, jcase.n_steps)
    assert case.numerics() == config_from_tpuvof(
        tv.SimConfig(grid=jcase.grid, num=jcase.numerics())).num
    for got, want in zip(fields, jfields):
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", MAKERS)
def test_simulate_advection_matches_tpuvof(name):
    """f64, 9 steps continuous and as chunks of 5 and 4 (the second with
    odd istep0 = 5), against tpuvof's continuous run, eager."""
    case, F0, u, v, _ = M.ADVECTION_CASES[name](n=24, tmax=60, device="cpu")
    jcase = getattr(JM, name)(n=24, tmax=60)[0]
    F0, u, v = _f64(F0, u, v)
    with jax.disable_jit():
        want = np.asarray(j_simulate_advection(jcase, *(jnp.asarray(a.numpy())
                                                        for a in (F0, u, v)), 9))
    got = simulate_advection(case, F0, u, v, 9)
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= TOL * scale
    chunked = simulate_advection(case, simulate_advection(case, F0, u, v, 5), u, v, 4,
                                 istep0=5)
    assert np.abs(chunked.numpy() - want).max() <= TOL * scale
    assert np.abs(got.numpy() - F0.numpy()).max() > 1e-3  # the flow moved F


def test_step_with_bc_between_sweeps_matches_tpuvof():
    """The forward solver runs bc_between_sweeps on backend='torch', as
    tpuvof's plain path does: three steps, f64, eager. (Behind walls the
    sweeps read F's ghosts only through wall faces of zero velocity, so
    here the mirror leaves the result as it was; the advection cases,
    whose wall faces move, are where it acts.)"""
    jcfg = tv.dam_break_2d(24, num=tv.Numerics(bc_between_sweeps=True))
    s0 = tv.init_state(jcfg, ic=1)
    s0 = tv.State(*(jnp.asarray(a, jnp.float64) for a in s0))
    with jax.disable_jit():
        want = tv.simulate(jcfg, s0, 3)
    pc = config_from_tpuvof(jcfg)
    assert pc.num.backend == "torch" and pc.num.bc_between_sweeps
    got = tt.simulate(pc, state_from_numpy(*map(np.asarray, s0), "cpu", torch.float64), 3)
    for g_, w_ in zip(state_to_numpy(got), want):
        w_ = np.asarray(w_)
        assert np.abs(g_ - w_).max() <= TOL * max(np.abs(w_).max(), 1.0)


@pytest.mark.parametrize("backend", ["cuda", "cuda_mono", "cuda_tiled", "cuda_strips"])
def test_bc_between_sweeps_raises_on_cuda_routes(backend):
    """tpuvof's Pallas routes sweep with no mirror in between, ignoring the
    flag; the port's kernel routes refuse it instead."""
    cfg = tt.dam_break_2d(16, num=tt.Numerics(backend=backend, bc_between_sweeps=True))
    s = tt.init_state(cfg, 1, "cpu", torch.float64)
    with pytest.raises(NotImplementedError, match="Pallas routes ignore it"):
        tt.step(cfg, s, False)
    with pytest.raises(NotImplementedError, match="Pallas routes ignore it"):
        tt.simulate(cfg, s, 1)


@pytest.mark.slow  # 19 s alone, 780 s beside five other workers
def test_vortex_at_reference_size_matches_tpuvof():
    """The single vortex at its defaults (500^2, 1000 steps, f32, CFL 1),
    chip_smoke.py phase 15's run: the port's mass drift and bounds equal
    tpuvof's (jitted) within f32 noise, and both sit inside the phase's
    bars (the test variant's flux-only dV compensation loses mass at this
    CFL; tpuvof's own test notes the loss grows with CFL)."""
    case, F0, u, v, _ = M.single_vortex(device="cpu")
    jcase, jF0, ju, jv, _ = JM.single_vortex()
    F = simulate_advection(case, F0, u, v, 1000)
    jF = np.asarray(j_simulate_advection(jcase, jF0, ju, jv, 1000))
    m0 = F0[1:-1, 1:-1].double().sum().item()
    drift = (F[1:-1, 1:-1].double().sum().item() - m0) / m0
    jdrift = (jF[1:-1, 1:-1].astype(np.float64).sum() - m0) / m0
    assert abs(drift - jdrift) < 1e-5, (drift, jdrift)
    assert abs(drift) < 2.5e-2
    assert abs(F.min().item() - jF.min()) < 1e-3 and abs(F.max().item() - jF.max()) < 1e-3
    assert F.min().item() > -5e-2 and F.max().item() < 1 + 5e-2
