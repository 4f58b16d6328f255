"""The whole-step kernel's routes and the windowed phase kernels
(tpuvof_torch.kernels: fullstep, fullstep_win, fullstep_strips,
predict_win, fct_sweep_win; tpuvof_torch.solver: 'cuda_mono',
'cuda_tiled', 'cuda_strips').

On the CPU the plain versions are held against tpuvof's Pallas kernels in
interpret mode, in f64, within 1e-12 of the field's scale: both sides do
the same operations per cell. A windowed kernel is exact only on its
block's centre, at least its halo from the edges (beyond, tpuvof's rolls
wrap and the port's shifts read zeros), so windows are compared there.
The port's engines are held against each other at tpuvof's own bar
between its engines (atol 1e-13, tests/test_pallas.py), and the public
routes against tpuvof's eager simulate. Sizes: 32^2 grids; the windows run
n_jacobi = 4, so a whole-step window is 8 + 2*16 + 2 = 42 cells wide. The
windowed phase kernels are also held on a 29 x 37 block, a multiple of no
tile of their kernels, and the windowed sweep under every FCT variant.
The fullstep wrapper is also held to pallas_fullstep at every n_jacobi
from 0 to 20, which the kernel splits into different groups of Jacobi
sweeps. The ``cuda``-marked tests hold the CUDA kernels against the plain
versions on a card, the whole-step kernel also on grids that fill no
32 x 32 tile and at every n_jacobi from 1 to 12.
"""
import dataclasses

import numpy as np
import pytest
import torch

import tpuvof_torch as tt
from tpuvof_torch.convert import config_from_tpuvof, state_from_numpy, state_to_numpy
from tpuvof_torch.kernels import step_kernels as K
from tpuvof_torch.solver import _step_cuda_mono, _step_cuda_strips, _step_cuda_tiled

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
    """tpuvof, its Pallas step kernels, and a developed, perturbed,
    BC-consistent 32^2 dam-break state as numpy f64."""
    import jax.numpy as jnp

    import tpuvof as tv
    from tpuvof.ops import apply_bc
    from tpuvof.pallas_kernels import step_kernels as pk

    cfg = tv.dam_break_2d(N)
    s0 = tv.State(*(jnp.asarray(a, jnp.float64) for a in tv.init_state(cfg, ic=1)))
    s = tv.simulate(cfg, s0, 40)
    rng = np.random.default_rng(20)
    F, u, v, p = (np.asarray(a) + rng.uniform(-1e-3, 1e-3, a.shape) for a in s)
    u, v, F, p = (np.asarray(a) for a in apply_bc(*map(jnp.asarray, (u, v, F, p))))
    return tv, pk, cfg, (F, u, v, p)


def _window(arrays, W, r0, c0, extent):
    """Blocks of ``extent`` starting at (r0, c0) of the W-zero-padded arrays
    (the tiled engines' slicing); the block's origin is (r0 - W, c0 - W)."""
    return [np.pad(a, W)[r0:r0 + extent, c0:c0 + extent] for a in arrays]


@pytest.mark.parametrize("even", [False, True])
def test_fullstep_plain_matches_pallas_fullstep(ref, even):
    tv, pk, cfg, (F, u, v, p) = ref
    want = pk.pallas_fullstep(cfg, F, u, v, p, even, interpret=True)
    got = K.fullstep_plain(config_from_tpuvof(cfg), *map(_t, (F, u, v, p)), even)
    for name, g_, w_ in zip("Fuvp", got, want):
        assert _rel(g_, w_) <= TOL, name


@pytest.mark.parametrize("where", ["corner", "interior"])
def test_fullstep_win_plain_matches_pallas_fullstep_win(ref, where):
    tv, pk, cfg, arrays = ref
    cfg = cfg.replace(num=dataclasses.replace(cfg.num, n_jacobi=4))
    pc = config_from_tpuvof(cfg)
    W = K.STEP_HALO(pc)
    r0, c0 = (0, 0) if where == "corner" else (8, 16)
    blocks = _window(arrays, W, r0, c0, 8 + 2 * W + 2)
    want = pk.pallas_fullstep_win(cfg, *blocks, r0 - W, c0 - W, where == "corner",
                                  interpret=True)
    got = K.fullstep_win_plain(pc, *map(_t, blocks), r0 - W, c0 - W, where == "corner")
    for name, g_, w_ in zip("Fuvp", got, want):
        assert _rel(g_.numpy()[W:-W, W:-W], np.asarray(w_)[W:-W, W:-W]) <= TOL, name


@pytest.mark.parametrize("where", ["corner", "interior"])
def test_phase_win_plain_matches_pallas(ref, where):
    """predict_win and fct_sweep_win (x and y) against their Pallas
    counterparts on a 16-cell PHASE_HALO window."""
    tv, pk, cfg, (F, u, v, p) = ref
    pc = config_from_tpuvof(cfg)
    W = K.PHASE_HALO
    r0, c0 = (0, 0) if where == "corner" else (8, 16)
    ub, vb, Fb = _window((u, v, F), W, r0, c0, 8 + 2 * W + 2)
    oi, oj = r0 - W, c0 - W
    want = pk.pallas_predict_win(cfg, ub, vb, Fb, oi, oj, interpret=True)
    got = K.predict_win_plain(pc, _t(ub), _t(vb), _t(Fb), oi, oj)
    for g_, w_ in zip(got, want):
        assert _rel(g_.numpy()[W:-W, W:-W], np.asarray(w_)[W:-W, W:-W]) <= TOL
    for axis, vel in ((0, ub), (1, vb)):
        want = pk.pallas_fct_sweep_win(cfg, Fb, vel, axis, oi, oj, interpret=True)
        got = K.fct_sweep_win_plain(pc, _t(Fb), _t(vel), axis, oi, oj)
        assert _rel(got.numpy()[W:-W, W:-W], np.asarray(want)[W:-W, W:-W]) <= TOL, axis


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("variant", ["FCT_DIFF", "FCT_SCHEME_TEST"])
def test_sweep_win_plain_matches_pallas_variants(ref, variant, axis):
    """fct_sweep_win_plain against pallas_fct_sweep_win under the FCT
    variants that the forward step does not run, on a corner window whose
    origin lies past both walls."""
    import tpuvof.config as tc

    tv, pk, cfg, (F, u, v, p) = ref
    cfg = cfg.replace(num=dataclasses.replace(cfg.num, fct=getattr(tc, variant)))
    pc = config_from_tpuvof(cfg)
    W = K.PHASE_HALO
    Fb, vel = _window((F, u if axis == 0 else v), W, 0, 0, 8 + 2 * W + 2)
    want = pk.pallas_fct_sweep_win(cfg, Fb, vel, axis, -W, -W, interpret=True)
    got = K.fct_sweep_win_plain(pc, _t(Fb), _t(vel), axis, -W, -W)
    assert _rel(got.numpy()[W:-W, W:-W], np.asarray(want)[W:-W, W:-W]) <= TOL


@pytest.mark.parametrize("corner", ["low", "high"])
def test_phase_win_plain_matches_pallas_on_a_ragged_block(ref, corner):
    """predict_win and fct_sweep_win (x and y) against Pallas on a 29 x 37
    block, a multiple of no tile height (8, 16, 24 rows; 26 rows of the x
    sweep) and of no tile width (32 columns; 26 of the y sweep), at the
    low or the high corner of the padded grid (its origin past both
    walls)."""
    tv, pk, cfg, (F, u, v, p) = ref
    pc = config_from_tpuvof(cfg)
    W = K.PHASE_HALO
    e0, e1 = 29, 37
    n = F.shape[0] + 2 * W
    r0, c0 = (0, 0) if corner == "low" else (n - e0, n - e1)
    ub, vb, Fb = (np.pad(a, W)[r0:r0 + e0, c0:c0 + e1] for a in (u, v, F))
    oi, oj = r0 - W, c0 - W
    want = pk.pallas_predict_win(cfg, ub, vb, Fb, oi, oj, interpret=True)
    got = K.predict_win_plain(pc, _t(ub), _t(vb), _t(Fb), oi, oj)
    for g_, w_ in zip(got, want):
        assert _rel(g_.numpy()[W:-W, W:-W], np.asarray(w_)[W:-W, W:-W]) <= TOL
    for axis, vel in ((0, ub), (1, vb)):
        want = pk.pallas_fct_sweep_win(cfg, Fb, vel, axis, oi, oj, interpret=True)
        got = K.fct_sweep_win_plain(pc, _t(Fb), _t(vel), axis, oi, oj)
        assert _rel(got.numpy()[W:-W, W:-W], np.asarray(want)[W:-W, W:-W]) <= TOL, axis


def test_windowed_plain_at_origin_equal_the_ops(ref):
    """At oi = oj = 0 on the whole grid the windowed bodies are the
    whole-grid ops bit for bit."""
    _, _, cfg, arrays = ref
    pc = config_from_tpuvof(cfg)
    F, u, v, p = map(_t, arrays)
    for g_, w_ in zip(K.predict_win_plain(pc, u, v, F, 0, 0), K.predict_plain(pc, u, v, F)):
        assert torch.equal(g_, w_)
    for axis, vel in ((0, u), (1, v)):
        assert torch.equal(K.fct_sweep_win_plain(pc, F, vel, axis, 0, 0),
                           K.fct_sweep_plain(pc, F, vel, axis))
    plain = pc.replace(num=dataclasses.replace(pc.num, backend="torch"))
    for even in (False, True):
        lean = tt.step(plain, tt.State(F, u, v, p), even, lean=True)
        for g_, w_ in zip(K.fullstep_plain(pc, F, u, v, p, even), lean):
            assert torch.equal(g_, w_)


@pytest.fixture(scope="module")
def port_state(ref):
    _, _, cfg, arrays = ref
    return config_from_tpuvof(cfg), state_from_numpy(*arrays, "cpu", torch.float64)


@pytest.mark.parametrize("tile", [8, 16, (16, 32), 32])
def test_tiled_equals_mono(port_state, tile):
    pc, s = port_state
    for even in (False, True):
        want = _step_cuda_mono(pc, s, even)
        got = _step_cuda_tiled(pc, s, even, tile=tile)
        for name, g_, w_ in zip("Fuvp", got, want):
            assert torch.max(torch.abs(g_ - w_)).item() <= 1e-13, (name, tile, even)


def test_strips_equals_mono_with_nan_margins(port_state):
    """The strips engine's margins are never rewritten between steps, so
    they may hold anything: filled with NaN, the step is still mono's."""
    pc, s = port_state
    w2 = K.strips_halo(pc)
    assert w2 % 8 == 0 and w2 >= K.STEP_HALO(pc)
    for even in (False, True):
        padded = []
        for a in s:
            b = torch.full((N + 2 + 2 * w2,) * 2, float("nan"), dtype=a.dtype)
            b[w2:w2 + N + 2, w2:w2 + N + 2] = a
            padded.append(b)
        out = K.fullstep_strips(pc, *padded, even)
        want = _step_cuda_mono(pc, s, even)
        for name, o, w_ in zip("Fuvp", out, want):
            g_ = o[w2:w2 + N + 2, w2:w2 + N + 2]
            assert torch.max(torch.abs(g_ - w_)).item() <= 1e-13, (name, even)
        got = _step_cuda_strips(pc, s, even)
        for g_, w_ in zip(got, want):
            assert torch.max(torch.abs(g_ - w_)).item() <= 1e-13


def test_mono_equals_torch_lean_step(port_state):
    pc, s = port_state
    plain = pc.replace(num=dataclasses.replace(pc.num, backend="torch"))
    mono = pc.replace(num=dataclasses.replace(pc.num, backend="cuda_mono"))
    for even in (False, True):
        want = tt.step(plain, s, even, lean=True)
        for name, g_, w_ in zip("Fuvp", tt.step(mono, s, even, lean=True), want):
            assert torch.max(torch.abs(g_ - w_)).item() <= 1e-13, name


@pytest.fixture(scope="module")
def tpuvof_32_21():
    """tpuvof's eager 32^2 dam break over 21 steps (an odd count: the
    remainder step), from its f64 initial state."""
    import jax
    import jax.numpy as jnp

    import tpuvof as tv

    cfg = tv.dam_break_2d(N)
    s0 = tv.State(*(jnp.asarray(a, jnp.float64) for a in tv.init_state(cfg, ic=1)))
    with jax.disable_jit():
        want = tv.simulate(cfg, s0, 21)
    return cfg, [np.asarray(a) for a in s0], [np.asarray(a) for a in want]


@pytest.mark.parametrize("backend", ["cuda_mono", "cuda_tiled", "cuda_strips"])
def test_simulate_matches_tpuvof(tpuvof_32_21, backend):
    cfg, s0, want = tpuvof_32_21
    tpu_name = {"cuda_mono": "pallas_mono", "cuda_tiled": "pallas_tiled",
                "cuda_strips": "pallas_strips"}[backend]
    pc = config_from_tpuvof(cfg.replace(num=dataclasses.replace(cfg.num, backend=tpu_name)))
    assert pc.num.backend == backend
    out = state_to_numpy(tt.simulate(pc, state_from_numpy(*s0, "cpu", torch.float64), 21))
    for name, g_, w_ in zip("Fuvp", out, want):
        assert _rel(g_, w_) <= TOL, name


def test_wrappers_route_cpu_tensors_to_plain_and_count_nothing(port_state):
    pc, s = port_state
    F, u, v, p = s
    K.reset_launch_counts()
    for g_, w_ in zip(K.fullstep(pc, F, u, v, p, True), K.fullstep_plain(pc, F, u, v, p, True)):
        assert torch.equal(g_, w_)
    blocks = [a[:20, 4:30] for a in (F, u, v, p)]
    for g_, w_ in zip(K.fullstep_win(pc, *blocks, 3, -2, False),
                      K.fullstep_win_plain(pc, *blocks, 3, -2, False)):
        assert torch.equal(g_, w_)
    for g_, w_ in zip(K.predict_win(pc, *blocks[1:3], blocks[0], 3, -2),
                      K.predict_win_plain(pc, *blocks[1:3], blocks[0], 3, -2)):
        assert torch.equal(g_, w_)
    assert torch.equal(K.fct_sweep_win(pc, blocks[0], blocks[2], 1, 3, -2),
                       K.fct_sweep_win_plain(pc, blocks[0], blocks[2], 1, 3, -2))
    assert all(n == 0 for n in K.LAUNCHES.values())
    with pytest.raises(ValueError):
        K.fct_sweep_win(pc, F, u, 2, 0, 0)


def test_routes_and_halos():
    from tpuvof_torch.solver import effective_backend

    def eff(backend, solver="jacobi", n=32):
        return effective_backend(tt.dam_break_2d(n, num=tt.Numerics(
            backend=backend, pressure_solver=solver)))

    assert tt.Numerics().backend == "cuda"
    for b in ("torch", "cuda", "cuda_mono", "cuda_tiled", "cuda_strips"):
        assert eff(b) == b
        assert eff(b, "mg") == ("torch" if b == "torch" else "cuda")
    assert eff("cuda_mono", n=4096) == "cuda_mono"  # no VMEM model: mono at every size
    cfg = tt.dam_break_2d(32)
    assert K.STEP_HALO(cfg) == 22 and K.strips_halo(cfg) == 24 and K.PHASE_HALO == 3
    with pytest.raises(ValueError):
        _step_cuda_tiled(cfg, tt.init_state(cfg, 1, "cpu", torch.float64), False, tile=12)


@pytest.mark.cuda
def test_step_kernels_match_plain_on_card():
    """fullstep (whole grid, window, strips with NaN margins), predict_win
    and fct_sweep_win against their plain versions on the card, f64
    within 1e-12 and f32 within 1e-4, on a perturbed developed 64^2
    state; mono == tiled == strips within 1e-13 in f64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from tpuvof_torch.ops import apply_bc

    n = 64
    plain = tt.dam_break_2d(n, num=tt.Numerics(backend="torch"))
    s = tt.simulate(plain, tt.init_state(plain, 1, "cuda", torch.float64), 30)
    rng = np.random.default_rng(21)
    F, u, v, p = (a + torch.as_tensor(rng.uniform(-1e-3, 1e-3, a.shape), device="cuda")
                  for a in s)
    u, v, F, p = apply_bc(u, v, F, p)
    cfg = tt.dam_break_2d(n, num=tt.Numerics(backend="cuda_mono"))
    W = K.STEP_HALO(cfg)
    w2 = K.strips_halo(cfg)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
        st = [a.to(dtype).contiguous() for a in (F, u, v, p)]
        for even in (False, True):
            for g_, w_ in zip(K.fullstep(cfg, *st, even), K.fullstep_plain(cfg, *st, even)):
                assert _rel(g_.cpu(), w_.cpu()) <= tol
            blocks = [torch.nn.functional.pad(a, (W,) * 4)[8:8 + 16 + 2 * W + 2,
                                                          0:16 + 2 * W + 2].contiguous()
                      for a in st]
            got = K.fullstep_win(cfg, *blocks, 8 - W, -W, even)
            want = K.fullstep_win_plain(cfg, *blocks, 8 - W, -W, even)
            for g_, w_ in zip(got, want):
                assert _rel(g_[W:-W, W:-W].cpu(), w_[W:-W, W:-W].cpu()) <= tol
            padded = [torch.nn.functional.pad(a, (w2,) * 4, value=float("nan")) for a in st]
            got = K.fullstep_strips(cfg, *padded, even)
            want = K.fullstep_plain(cfg, *st, even)
            for g_, w_ in zip(got, want):
                assert _rel(g_[w2:w2 + n + 2, w2:w2 + n + 2].cpu(), w_.cpu()) <= tol
        Wp = K.PHASE_HALO
        blocks = [torch.nn.functional.pad(a, (Wp,) * 4)[0:22, 40:62].contiguous()
                  for a in st]
        oi, oj = -Wp, 40 - Wp
        for g_, w_ in zip(K.predict_win(cfg, blocks[1], blocks[2], blocks[0], oi, oj),
                          K.predict_win_plain(cfg, blocks[1], blocks[2], blocks[0], oi, oj)):
            assert _rel(g_[Wp:-Wp, Wp:-Wp].cpu(), w_[Wp:-Wp, Wp:-Wp].cpu()) <= tol
        for axis in (0, 1):
            g_ = K.fct_sweep_win(cfg, blocks[0], blocks[1 + axis], axis, oi, oj)
            w_ = K.fct_sweep_win_plain(cfg, blocks[0], blocks[1 + axis], axis, oi, oj)
            assert _rel(g_[Wp:-Wp, Wp:-Wp].cpu(), w_[Wp:-Wp, Wp:-Wp].cpu()) <= tol
    s64 = tt.State(F, u, v, p)
    mono = _step_cuda_mono(cfg, s64, True)
    for other in (_step_cuda_tiled(cfg, s64, True, tile=16), _step_cuda_strips(cfg, s64, True)):
        for g_, w_ in zip(other, mono):
            assert torch.max(torch.abs(g_ - w_)).item() <= 1e-13


@pytest.mark.parametrize("n_jacobi", range(0, 21))
def test_fullstep_matches_pallas_fullstep_at_every_jacobi_count(ref, n_jacobi):
    """The fullstep wrapper on CPU tensors (its plain version, which the
    kernel is held to on the card) against tpuvof's pallas_fullstep at
    every n_jacobi the kernel splits into different Jacobi groups (0 to
    20: none to five groups of depths 1 to 4), the parity alternating;
    no launch is counted."""
    tv, pk, cfg, (F, u, v, p) = ref
    cfg = cfg.replace(num=dataclasses.replace(cfg.num, n_jacobi=n_jacobi))
    even = n_jacobi % 2 == 0
    want = pk.pallas_fullstep(cfg, F, u, v, p, even, interpret=True)
    K.reset_launch_counts()
    got = K.fullstep(config_from_tpuvof(cfg), *map(_t, (F, u, v, p)), even)
    assert not any(K.LAUNCHES.values())
    for name, g_, w_ in zip("Fuvp", got, want):
        assert _rel(g_, w_) <= TOL, name


@pytest.mark.cuda
def test_fullstep_edge_shapes_match_plain_on_card():
    """fullstep, fullstep_win and fullstep_strips against their plain
    versions on grids whose ghost-included extents fill no 32 x 32 tile
    (63^2 and 67^2: 65 and 69 cells a side) and lie one past a tile
    boundary (127^2: 129), at every n_jacobi from 1 to 12 (the Jacobi
    groups' depths 1 to 4 and 1 to 3 groups), both parities, f64 within
    1e-12 and f32 within 1e-4 of the field's scale. The library's split
    of the Jacobi sweeps (n_jacobi 0 to 20) sums to n_jacobi in the
    fewest groups of at most 4 sweeps, of near-equal depth, the deeper
    first."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import ctypes

    from tpuvof_torch.kernels.build import load_library
    from tpuvof_torch.ops import apply_bc

    lib = load_library()
    for n_jacobi in range(0, 21):
        out = (ctypes.c_int * 8)()
        depths = list(out[:lib.tv_fullstep_levels(n_jacobi, out, 8)])
        assert sum(depths) == n_jacobi and len(depths) == -(-n_jacobi // 4), depths
        assert all(1 <= d <= 4 for d in depths), depths
        assert depths == sorted(depths, reverse=True), depths
        assert not depths or depths[0] - depths[-1] <= 1, depths
    rng = np.random.default_rng(22)
    for n in (63, 67, 127):
        plain = tt.dam_break_2d(n, num=tt.Numerics(backend="torch"))
        s = tt.simulate(plain, tt.init_state(plain, 1, "cuda", torch.float64), 10)
        F, u, v, p = (a + torch.as_tensor(rng.uniform(-1e-3, 1e-3, a.shape), device="cuda")
                      for a in s)
        u, v, F, p = apply_bc(u, v, F, p)
        for n_jacobi in range(1, 13):
            cfg = tt.dam_break_2d(n, num=tt.Numerics(backend="cuda_mono", n_jacobi=n_jacobi))
            W = K.STEP_HALO(cfg)
            w2 = K.strips_halo(cfg)
            for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
                st = [a.to(dtype).contiguous() for a in (F, u, v, p)]
                tag = (n, n_jacobi, str(dtype))
                for even in (False, True):
                    want = K.fullstep_plain(cfg, *st, even)
                    for name, g_, w_ in zip("Fuvp", K.fullstep(cfg, *st, even), want):
                        assert _rel(g_.cpu(), w_.cpu()) <= tol, (*tag, even, name)
                    r0 = n // 3  # a window of 40 rows, all columns
                    blocks = [torch.nn.functional.pad(a, (W,) * 4)[r0:r0 + 40 + 2 * W]
                              .contiguous() for a in st]
                    got = K.fullstep_win(cfg, *blocks, r0 - W, -W, even)
                    want_w = K.fullstep_win_plain(cfg, *blocks, r0 - W, -W, even)
                    for name, g_, w_ in zip("Fuvp", got, want_w):
                        assert _rel(g_[W:-W, W:-W].cpu(), w_[W:-W, W:-W].cpu()) <= tol, (
                            *tag, even, "win", name)
                    padded = [torch.nn.functional.pad(a, (w2,) * 4, value=float("nan"))
                              for a in st]
                    for name, g_, w_ in zip("Fuvp", K.fullstep_strips(cfg, *padded, even), want):
                        assert _rel(g_[w2:-w2, w2:-w2].cpu(), w_.cpu()) <= tol, (
                            *tag, even, "strips", name)
