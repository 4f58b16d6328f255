"""The phase kernels' plain versions and wrappers (tpuvof_torch.kernels).

On the CPU the plain versions are held against tpuvof's Pallas kernels,
run in interpret mode as tests/test_pallas.py runs them, at 32^2 in f64,
within 1e-12 of the field's scale: both sides do the same operations per
element; the sweeps also under the two FCT variants the forward step does
not run. The wrappers must route CPU tensors to the plain versions and
count no launch. The ``cuda``-marked tests hold the CUDA kernels against
the plain versions on a card, the phase kernels also on grids and blocks
that no tile divides; they need no jax, so on a machine without jax they
run with ``pytest tests/test_torch_kernels.py --noconftest -m cuda``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import tpuvof_torch as tt
from tpuvof_torch.kernels import step_kernels as K

N = 32
TOL = 1e-12


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def _t(a):
    return torch.as_tensor(np.array(a, np.float64))


@pytest.fixture(scope="module")
def ref():
    """tpuvof (the reference), its Pallas phase kernels, and a developed,
    perturbed, BC-consistent 32^2 dam-break state as numpy f64."""
    import jax.numpy as jnp

    import tpuvof as tv
    from tpuvof import pallas_kernels as pk
    from tpuvof.ops import apply_bc
    from tpuvof_torch.convert import config_from_tpuvof

    cfg = tv.dam_break_2d(N)
    s0 = tv.State(*(jnp.asarray(a, jnp.float64) for a in tv.init_state(cfg, ic=1)))
    s = tv.simulate(cfg, s0, 40)
    rng = np.random.default_rng(10)
    F, u, v, p = (np.asarray(a) + rng.uniform(-1e-3, 1e-3, a.shape) for a in s)
    u, v, F, p = (np.asarray(a) for a in apply_bc(*map(jnp.asarray, (u, v, F, p))))
    return cfg, config_from_tpuvof(cfg), pk, (F, u, v, p)


def test_predict_plain_matches_pallas_predict(ref):
    cfg, pc, pk, (F, u, v, p) = ref
    want = pk.pallas_predict(cfg, u, v, F, interpret=True)
    got = K.predict_plain(pc, _t(u), _t(v), _t(F))
    for g_, w_ in zip(got, want):
        assert _rel(g_, w_) <= TOL


def test_project_plain_matches_pallas_project(ref):
    cfg, pc, pk, (F, u, v, p) = ref
    us, vs = (np.asarray(a) for a in pk.pallas_predict(cfg, u, v, F, interpret=True))
    want = pk.project_pressure_and_correct(cfg, F, us, vs, p, u, v, interpret=True)
    got = K.project_plain(pc, *map(_t, (F, us, vs, p, u, v)))
    for name, g_, w_ in zip("puv", got, want):
        assert _rel(g_, w_) <= TOL, name
    # the returned p keeps the entry p's ghost ring; u, v keep the entry
    # values off the corrected ranges (the wall faces and ghosts)
    np.testing.assert_array_equal(got[0].numpy()[[0, -1], :], p[[0, -1], :])
    np.testing.assert_array_equal(got[1].numpy()[1, :], u[1, :])
    np.testing.assert_array_equal(got[2].numpy()[:, 1], v[:, 1])


@pytest.fixture(scope="module")
def ref_star(ref):
    """tpuvof's u*, v* of the ref state (pallas_predict, interpret mode)."""
    cfg, _, pk, (F, u, v, _) = ref
    return tuple(np.asarray(a) for a in pk.pallas_predict(cfg, u, v, F, interpret=True))


@pytest.mark.parametrize("n_jacobi", [1, 2, 3, 4, 5, 8, 11])
def test_project_plain_matches_pallas_project_at_each_group_split(ref, ref_star, n_jacobi):
    """project_plain against tpuvof's kernel at the sweep counts on either
    side of the CUDA kernel's stage-group split (at most 4 sweeps a group:
    1-4 in one group, 5 and 8 in two, 11 in three)."""
    from tpuvof_torch.convert import config_from_tpuvof

    cfg, _, pk, (F, u, v, p) = ref
    cfg = cfg.replace(num=dataclasses.replace(cfg.num, n_jacobi=n_jacobi))
    us, vs = ref_star
    want = pk.project_pressure_and_correct(cfg, F, us, vs, p, u, v, interpret=True)
    got = K.project_plain(config_from_tpuvof(cfg), *map(_t, (F, us, vs, p, u, v)))
    for name, g_, w_ in zip("puv", got, want):
        assert _rel(g_, w_) <= TOL, name
    np.testing.assert_array_equal(got[0].numpy()[[0, -1], :], p[[0, -1], :])
    assert _rel(got[0][1:-1, 1:-1], p[1:-1, 1:-1]) > 1e-6  # the sweeps moved p


@pytest.mark.parametrize("axis", [0, 1])
def test_fct_sweep_plain_matches_pallas_sweep(ref, axis):
    cfg, pc, pk, (F, u, v, p) = ref
    if axis == 0:
        want = pk.pallas_fct_sweep_x(cfg, F, u, interpret=True)
    else:
        want = pk.pallas_fct_sweep_y(cfg, F, v, interpret=True)
    got = K.fct_sweep_plain(pc, _t(F), _t(u if axis == 0 else v), axis)
    assert _rel(got, want) <= TOL
    np.testing.assert_array_equal(got.numpy()[0], F[0])  # ghosts kept


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("variant", ["FCT_DIFF", "FCT_SCHEME_TEST"])
def test_fct_sweep_plain_matches_pallas_sweep_variants(ref, variant, axis):
    """fct_sweep_plain against tpuvof's sweep kernels under the two FCT
    variants that the forward step does not run: no clamps, dV/dv on the
    flux only, and a limiter guard (FCT_DIFF) or denominator epsilon
    (FCT_SCHEME_TEST)."""
    import tpuvof.config as tc
    from tpuvof_torch.convert import config_from_tpuvof

    cfg, _, pk, (F, u, v, p) = ref
    cfg = cfg.replace(num=dataclasses.replace(cfg.num, fct=getattr(tc, variant)))
    pc = config_from_tpuvof(cfg)
    assert pc.num.fct == getattr(tt, variant)
    if axis == 0:
        want = pk.pallas_fct_sweep_x(cfg, F, u, interpret=True)
    else:
        want = pk.pallas_fct_sweep_y(cfg, F, v, interpret=True)
    got = K.fct_sweep_plain(pc, _t(F), _t(u if axis == 0 else v), axis)
    assert _rel(got, want) <= TOL
    forward = K.fct_sweep_plain(config_from_tpuvof(ref[0]), _t(F), _t(u if axis == 0 else v),
                                axis)
    assert _rel(got, forward) > 1e-9  # the variant changes the sweep


def test_wrappers_route_cpu_tensors_to_plain_and_count_nothing(ref):
    _, pc, _, arrays = ref
    F, u, v, p = map(_t, arrays)
    K.reset_launch_counts()
    us, vs = K.predict(pc, u, v, F)
    for g_, w_ in zip((us, vs), K.predict_plain(pc, u, v, F)):
        assert torch.equal(g_, w_)
    for g_, w_ in zip(K.project(pc, F, us, vs, p, u, v),
                      K.project_plain(pc, F, us, vs, p, u, v)):
        assert torch.equal(g_, w_)
    for axis, vel in ((0, u), (1, v)):
        assert torch.equal(K.fct_sweep(pc, F, vel, axis), K.fct_sweep_plain(pc, F, vel, axis))
    assert all(n == 0 for n in K.LAUNCHES.values())
    with pytest.raises(ValueError):
        K.fct_sweep(pc, F, u, 2)


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Each CUDA kernel against its plain version on the card, f64 and
    f32, on a perturbed developed 64^2 state (bars as chip_smoke.py's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from tpuvof_torch.ops import apply_bc

    n = 64
    plain = tt.dam_break_2d(n)
    s = tt.simulate(plain, tt.init_state(plain, 1, "cuda", torch.float64), 30)
    rng = np.random.default_rng(11)
    F, u, v, p = (a + torch.as_tensor(rng.uniform(-1e-3, 1e-3, a.shape), device="cuda")
                  for a in s)
    u, v, F, p = apply_bc(u, v, F, p)
    cfg = tt.dam_break_2d(n, num=tt.Numerics(backend="cuda"))
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
        Fd, ud, vd, pd = (a.to(dtype).contiguous() for a in (F, u, v, p))
        K.reset_launch_counts()
        us, vs = K.predict_plain(cfg, ud, vd, Fd)
        pairs = [
            (K.predict(cfg, ud, vd, Fd), (us, vs)),
            (K.project(cfg, Fd, us, vs, pd, ud, vd),
             K.project_plain(cfg, Fd, us, vs, pd, ud, vd)),
            ((K.fct_sweep(cfg, Fd, ud, 0), K.fct_sweep(cfg, Fd, vd, 1)),
             (K.fct_sweep_plain(cfg, Fd, ud, 0), K.fct_sweep_plain(cfg, Fd, vd, 1))),
        ]
        torch.cuda.synchronize()
        assert {k: n for k, n in K.LAUNCHES.items() if n} == {
            "predict": 1, "project": 1, "fct_sweep": 2}
        for got, want in pairs:
            for g_, w_ in zip(got, want):
                assert g_.is_cuda and g_.dtype == dtype
                assert _rel(g_.cpu(), w_.cpu()) <= tol
    with pytest.raises(ValueError):
        K.fct_sweep(cfg, F.T, u, 0)  # not contiguous
    with pytest.raises(ValueError):
        K.predict(cfg, u[:-1], v, F)  # wrong shape


@pytest.mark.cuda
def test_project_matches_plain_on_card_at_each_group_split():
    """The one-launch project kernel against its plain version on the card
    at n_jacobi 0 to 12 (every split of its stage groups: one group up to
    4, then the first, middle and last groups), f64 (1e-12) and f32 (p
    1e-4, u and v 1e-5), at 64^2 (one tile row per CTA) and 257^2 (a ragged
    last tile); p keeps the entry ghost ring bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from tpuvof_torch.ops import apply_bc

    for n in (64, 257):
        plain = tt.dam_break_2d(n)
        s = tt.simulate(plain, tt.init_state(plain, 1, "cuda", torch.float64), 30)
        rng = np.random.default_rng(n)
        F, u, v, p = (a + torch.as_tensor(rng.uniform(-1e-3, 1e-3, a.shape), device="cuda")
                      for a in s)
        u, v, F, p = apply_bc(u, v, F, p)
        base = tt.dam_break_2d(n, num=tt.Numerics(backend="cuda"))
        for dtype, tols in ((torch.float64, (1e-12,) * 3), (torch.float32, (1e-4, 1e-5, 1e-5))):
            Fd, ud, vd, pd = (a.to(dtype).contiguous() for a in (F, u, v, p))
            us, vs = K.predict_plain(base, ud, vd, Fd)
            for n_jacobi in range(13):
                cfg = base.replace(num=dataclasses.replace(base.num, n_jacobi=n_jacobi))
                K.reset_launch_counts()
                got = K.project(cfg, Fd, us, vs, pd, ud, vd)
                torch.cuda.synchronize()
                assert K.LAUNCHES["project"] == 1
                want = K.project_plain(cfg, Fd, us, vs, pd, ud, vd)
                for name, g_, w_, tol in zip("puv", got, want, tols):
                    assert _rel(g_.cpu(), w_.cpu()) <= tol, (n, dtype, n_jacobi, name)
                assert torch.equal(got[0][[0, -1]], pd[[0, -1]])
                assert torch.equal(got[0][:, [0, -1]], pd[:, [0, -1]])


@pytest.mark.cuda
def test_phase_kernels_match_plain_on_card_at_edge_shapes():
    """predict, fct_sweep, predict_win and fct_sweep_win against their plain
    versions on the card at the shapes where their tiles are ragged: the
    whole 63^2 and 200^2 grids (65^2 arrays: no tile height or width
    divides them), and, on the 200^2 state padded by PHASE_HALO, a 136^2
    window and a 29 x 45 block at each corner (origins past both walls);
    f64 within 1e-12 and f32 within 1e-4 of the field's scale, windows on
    the block minus PHASE_HALO; the sweeps under FCT_FORWARD, FCT_DIFF and
    FCT_SCHEME_TEST. Each call is one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from tpuvof_torch.ops import apply_bc

    W = K.PHASE_HALO
    for n in (63, 200):
        plain = tt.dam_break_2d(n)
        s = tt.simulate(plain, tt.init_state(plain, 1, "cuda", torch.float64), 20)
        rng = np.random.default_rng(n + 1)
        F, u, v, p = (a + torch.as_tensor(rng.uniform(-1e-3, 1e-3, a.shape), device="cuda")
                      for a in s)
        u, v, F, p = apply_bc(u, v, F, p)
        base = tt.dam_break_2d(n, num=tt.Numerics(backend="cuda"))
        blocks = [((F, u, v), (0, 0), (slice(None), slice(None)))]
        if n == 200:
            padded = [torch.nn.functional.pad(a, (W,) * 4) for a in (F, u, v)]
            L = n + 2 + 2 * W
            for e0, e1 in ((136, 136), (29, 45)):
                for r0 in (0, L - e0):
                    for c0 in (0, L - e1):
                        blocks.append(([a[r0:r0 + e0, c0:c0 + e1].contiguous() for a in padded],
                                       (r0 - W, c0 - W), (slice(W, -W), slice(W, -W))))
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
            for (Fb, ub, vb), (oi, oj), keep in blocks:
                Fb, ub, vb = (a.to(dtype).contiguous() for a in (Fb, ub, vb))
                whole = (oi, oj) == (0, 0)
                K.reset_launch_counts()
                got = (K.predict(base, ub, vb, Fb) if whole
                       else K.predict_win(base, ub, vb, Fb, oi, oj))
                want = K.predict_win_plain(base, ub, vb, Fb, oi, oj)
                pairs = list(zip(got, want))
                for name in ("FCT_FORWARD", "FCT_DIFF", "FCT_SCHEME_TEST"):
                    cfg = base.replace(num=dataclasses.replace(base.num,
                                                               fct=getattr(tt, name)))
                    for axis, vel in ((0, ub), (1, vb)):
                        g_ = (K.fct_sweep(cfg, Fb, vel, axis) if whole
                              else K.fct_sweep_win(cfg, Fb, vel, axis, oi, oj))
                        pairs.append((g_, K.fct_sweep_win_plain(cfg, Fb, vel, axis, oi, oj)))
                torch.cuda.synchronize()
                want_counts = ({"predict": 1, "fct_sweep": 6} if whole
                               else {"predict_win": 1, "fct_sweep_win": 6})
                assert {k: c for k, c in K.LAUNCHES.items() if c} == want_counts
                for k, (g_, w_) in enumerate(pairs):
                    assert g_.is_cuda and g_.dtype == dtype
                    assert _rel(g_[keep].cpu(), w_[keep].cpu()) <= tol, (
                        n, tuple(Fb.shape), (oi, oj), dtype, k)
