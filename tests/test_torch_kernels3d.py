"""The 3-D kernels' plain versions and wrappers
(tpuvof_torch.kernels.step3d_kernels).

On the CPU each plain version is held against tpuvof's Pallas kernel, run
in interpret mode as tests/test_3d.py runs it, in f64 on random
BC-consistent states (tests/test_3d.py's recipe) at 8^3 and 14^3 (slab
chunks of 2 planes: 4 and 7 chunks), within 1e-12 of the field's scale:
both sides do the same operations per element. The Pallas side takes the
fields jk-padded to its (8, 128) tiling (solver3d._pad_jk) and is compared
on the unpadded region. An i-slab (gi_base != 0) is compared beyond the
stencil's reach of its lower edge, where both sides are exact; its upper
edge is the grid's wall. The wrappers must route CPU tensors to the plain
versions and count no launch, and jacobi3d's launch plan must split every
iteration count. The ``cuda``-marked tests hold the CUDA kernels against
the plain versions on a card, the tiled ones also on shapes that fill no
tile and slabs with a wall mid-block; they need no jax, so on a machine
without jax they run with
``pytest tests/test_torch_kernels3d.py --noconftest -m cuda``.
"""
import numpy as np
import pytest
import torch

import tpuvof_torch as tt
from tpuvof_torch.kernels import step3d_kernels as K3

TOL = 1e-12
DT = 4e-6
DT_SWEEP = 2e-3  # with unit velocities: Courant numbers up to ~0.3, the limiter fires


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: a 34^3 field is past
    torch's parallel grain, and under the gate's worker processes its
    threads would oversubscribe the cores (a 300-step golden then took
    35x its time alone)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def _t(a):
    return torch.as_tensor(np.array(a, np.float64))


def _random_state(n, seed, vel_scale):
    """F, u, v, w, p as numpy f64: tests/test_3d.py's random BC-consistent
    state (each velocity's low ghost plane along its own axis zero, then
    the BCs), with velocities of the given scale."""
    import jax.numpy as jnp

    from tpuvof.ops import apply_bc_3d

    rng = np.random.default_rng(seed)
    shape = (n + 2,) * 3
    F = np.clip(rng.normal(0.5, 0.4, shape), 0, 1)
    u, v, w = (rng.normal(0, vel_scale, shape) for _ in range(3))
    p = rng.normal(0, 10.0, shape)
    u[0] = 0.0
    v[:, 0] = 0.0
    w[:, :, 0] = 0.0
    u, v, w, F, p = apply_bc_3d(*map(jnp.asarray, (u, v, w, F, p)))
    return tuple(np.asarray(a) for a in (F, u, v, w, p))


@pytest.fixture(scope="module", params=[8, 14])
def ref(request):
    """tpuvof's grid and Pallas kernels, the port's grid, a jk-pad
    function, and random states: moderate velocities for predict and
    correct, unit ones for the sweeps."""
    import jax.numpy as jnp

    from tpuvof.config import Fluid
    from tpuvof.grid import Grid3D
    from tpuvof.pallas_kernels import jacobi3d as pj
    from tpuvof.pallas_kernels import step3d as ps
    from tpuvof.solver3d import _pad_jk
    from tpuvof_torch.convert import fluid_from_tpuvof, grid3d_from_tpuvof

    n = request.param
    g = Grid3D(n, n, n)
    p1, p2 = _pad_jk(g)

    def pad(a):
        return jnp.pad(jnp.asarray(a), ((0, 0), (0, p1), (0, p2)))

    return dict(n=n, g=g, fl=Fluid(), pg=grid3d_from_tpuvof(g),
                pfl=fluid_from_tpuvof(Fluid()), ps=ps, pj=pj, pad=pad,
                cut=lambda a: np.asarray(a)[:, :n + 2, :n + 2],
                state=_random_state(n, 30 + n, 0.5), fast=_random_state(n, 40 + n, 1.0))


@pytest.mark.parametrize("csf", [False, True])
def test_predict3d_plain_matches_pallas(ref, csf):
    F, u, v, w, _ = ref["state"]
    pad, cut = ref["pad"], ref["cut"]
    want = ref["ps"].pallas_predict3d_rhs(ref["g"], ref["fl"], DT, pad(u), pad(v), pad(w),
                                          pad(F), interpret=True, csf=csf)
    got = K3.predict3d_rhs_plain(ref["pg"], ref["pfl"], DT, *map(_t, (u, v, w, F)), csf=csf)
    for name, g_, w_ in zip(("u*", "v*", "w*", "rhs"), got, want):
        assert _rel(g_, cut(w_)) <= TOL, name


def test_correct3d_plain_matches_pallas(ref):
    F, u, v, w, p = ref["state"]
    pad, cut = ref["pad"], ref["cut"]
    us, vs, ws, _ = (a.numpy() for a in K3.predict3d_rhs_plain(
        ref["pg"], ref["pfl"], DT, *map(_t, (u, v, w, F))))
    want = ref["ps"].pallas_correct3d(ref["g"], ref["fl"], DT, pad(us), pad(vs), pad(ws),
                                      pad(p), pad(F), interpret=True)
    got = K3.correct3d_plain(ref["pg"], ref["pfl"], DT, *map(_t, (us, vs, ws, p, F)))
    for name, g_, w_ in zip("uvw", got, want):
        assert _rel(g_, cut(w_)) <= TOL, name


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("mirror_out", [False, True])
def test_fct3d_sweep_plain_matches_pallas(ref, axis, mirror_out):
    F, u, v, w, _ = ref["fast"]
    vel = (u, v, w)[axis]
    want = ref["ps"].pallas_fct3d_sweep(ref["g"], DT_SWEEP, ref["pad"](F), ref["pad"](vel),
                                        axis, interpret=True, mirror_out=mirror_out)
    got = K3.fct3d_sweep_plain(ref["pg"], DT_SWEEP, _t(F), _t(vel), axis, mirror_out)
    assert _rel(got, ref["cut"](want)) <= TOL
    assert _rel(got[1:-1, 1:-1, 1:-1], F[1:-1, 1:-1, 1:-1]) > 1e-3  # F moved
    if not mirror_out:  # the stale ghosts pass through
        np.testing.assert_array_equal(got.numpy()[0], F[0])
        np.testing.assert_array_equal(got.numpy()[:, 0], F[:, 0])


@pytest.mark.parametrize("pallas_fn", ["pallas_jacobi_3d", "streamed_jacobi_3d"])
def test_jacobi3d_plain_matches_pallas(ref, pallas_fn):
    F, u, v, w, p = ref["state"]
    _, _, _, rhs = K3.predict3d_rhs_plain(ref["pg"], ref["pfl"], DT, *map(_t, (u, v, w, F)))
    want = getattr(ref["pj"], pallas_fn)(ref["g"], 10, ref["pad"](p), ref["pad"](rhs.numpy()),
                                         interpret=True)
    got = K3.jacobi3d_plain(ref["pg"], 10, _t(p), rhs)
    assert _rel(got, ref["cut"](want)) <= TOL
    ghost = np.ones(got.shape, bool)
    ghost[1:-1, 1:-1, 1:-1] = False
    assert np.all(got.numpy()[ghost] == 0.0)  # zeroed ghost ring


def test_islab_plain_matches_pallas():
    """Every plain version on an i-slab (tpuvof's nloc/gi_base origin):
    local planes 0..11 of a 16^3 grid at global i 6..17, so the slab's
    upper edge is the wall. Compared from local plane 4 up (3 planes of
    stencil reach below; the Jacobi runs 2 iterations, 2 planes)."""
    import jax.numpy as jnp

    from tpuvof.config import Fluid
    from tpuvof.grid import Grid3D
    from tpuvof.pallas_kernels import jacobi3d as pj
    from tpuvof.pallas_kernels import step3d as ps
    from tpuvof.solver3d import _pad_jk
    from tpuvof_torch.convert import grid3d_from_tpuvof

    n, gi_base, nloc = 16, 6, 10
    g, fl = Grid3D(n, n, n), Fluid()
    pg, pfl = grid3d_from_tpuvof(g), tt.Fluid()
    p1, p2 = _pad_jk(g)
    sl = slice(gi_base, gi_base + nloc + 2)
    F, u, v, w, p = (a[sl] for a in _random_state(n, 7, 0.5))

    def pad(a):
        return jnp.pad(jnp.asarray(np.asarray(a)), ((0, 0), (0, p1), (0, p2)))

    def cut(a):
        return np.asarray(a)[4:, :n + 2, :n + 2]

    kw = dict(interpret=True, nloc=nloc, gi_base=gi_base)
    want = ps.pallas_predict3d_rhs(g, fl, DT, pad(u), pad(v), pad(w), pad(F), csf=True, **kw)
    got = K3.predict3d_rhs_plain(pg, pfl, DT, *map(_t, (u, v, w, F)), csf=True,
                                 gi_base=gi_base)
    for name, g_, w_ in zip(("u*", "v*", "w*", "rhs"), got, want):
        assert _rel(g_[4:], cut(w_)) <= TOL, name
    us, vs, ws, rhs = got
    want = ps.pallas_correct3d(g, fl, DT, pad(us), pad(vs), pad(ws), pad(p), pad(F), **kw)
    for name, g_, w_ in zip("uvw", K3.correct3d_plain(pg, pfl, DT, us, vs, ws, _t(p), _t(F),
                                                      gi_base=gi_base), want):
        assert _rel(g_[4:], cut(w_)) <= TOL, name
    want = ps.pallas_fct3d_sweep(g, DT_SWEEP, pad(F), pad(u), 0, mirror_out=True, **kw)
    got = K3.fct3d_sweep_plain(pg, DT_SWEEP, _t(F), _t(u), 0, True, gi_base=gi_base)
    assert _rel(got[4:], cut(want)) <= TOL
    want = pj.pallas_jacobi_3d(g, 2, pad(p), pad(rhs.numpy()), **kw)
    got = K3.jacobi3d_plain(pg, 2, _t(p), rhs, gi_base=gi_base)
    assert _rel(got[4:], cut(want)) <= TOL


def _dam_break_state(n):
    """F, u, v, w, p as numpy f64: tpuvof's n^3 dam break at its start
    (init_state_3d, ic=1), BCs applied. F is exactly 0 or 1 in every cell,
    so most Youngs normals are degenerate (|m| < 1e-10) and most of their
    differences are exact zeros."""
    import jax.numpy as jnp

    import tpuvof as tv
    from tpuvof.ops import apply_bc_3d

    s = tv.init_state_3d(tv.Grid3D(n, n, n), 1)
    fields = (jnp.asarray(a, jnp.float64) for a in (s.u, s.v, s.w, s.F, s.p))
    u, v, w, F, p = apply_bc_3d(*fields)
    return tuple(np.asarray(a) for a in (F, u, v, w, p))


@pytest.mark.parametrize("block", ["grid", "pencil"])
def test_csf_predict3d_plain_matches_pallas_on_dam_break(block):
    """The csf predictor's plain version against tpuvof's Pallas kernel on
    the noise-free 16^3 dam break: on the whole grid, and on the pencil
    block of shard (0, 1) of a 2 x 2 mesh (W = Wy = 6, rows 2..21: the
    water's top face and the high y wall mid-block, the low x wall too),
    compared beyond 4 cells of each block edge, where tpuvof rolls."""
    import jax.numpy as jnp

    from tpuvof.config import Fluid
    from tpuvof.grid import Grid3D
    from tpuvof.pallas_kernels import step3d as ps
    from tpuvof.parallel.dist3d import _pad_planes
    from tpuvof.solver3d import _pad_jk
    from tpuvof_torch.convert import grid3d_from_tpuvof

    n, nl, w_ = 16, 8, 6
    g, fl = Grid3D(n, n, n), Fluid()
    F, u, v, w, _ = _dam_break_state(n)
    assert set(np.unique(F)) == {0.0, 1.0}
    if block == "grid":
        kw, org = {}, {}
        p1, p2 = _pad_jk(g)
        cut = (slice(None), slice(0, n + 2), slice(0, n + 2))
        mid = (slice(None),) * 3
    else:
        nye = nl + 2 * w_
        org = dict(gi_base=-w_, njl=nye, gj_base=nl - w_)
        kw = dict(nloc=nl + 2 * w_, **org)
        F, u, v, w = (np.pad(a, ((w_, w_), (w_, w_), (0, 0)))[:nl + 2 * w_ + 2, nl:nl + nye + 2]
                      for a in (F, u, v, w))
        p1, p2 = _pad_planes(nye, n)
        cut = (slice(4, -4), slice(4, nye + 2 - 4), slice(0, n + 2))
        mid = (slice(4, -4), slice(4, -4))

    def pad(a):
        return jnp.pad(jnp.asarray(a), ((0, 0), (0, p1), (0, p2)))

    want = ps.pallas_predict3d_rhs(g, fl, DT, pad(u), pad(v), pad(w), pad(F), csf=True,
                                   interpret=True, **kw)
    got = K3.predict3d_rhs_plain(grid3d_from_tpuvof(g), tt.Fluid(), DT,
                                 *map(_t, (u, v, w, F)), csf=True, **org)
    for name, g_, w_ref in zip(("u*", "v*", "w*", "rhs"), got, want):
        assert _rel(g_[mid], np.asarray(w_ref)[cut]) <= TOL, name
    # the sigma terms moved u* and v* somewhere (kappa is not zero)
    plain = K3.predict3d_rhs_plain(grid3d_from_tpuvof(g), tt.Fluid(), DT,
                                   *map(_t, (u, v, w, F)), csf=False, **org)
    assert not torch.equal(got[0], plain[0]) and not torch.equal(got[1], plain[1])


def test_wrappers_route_cpu_tensors_to_plain_and_count_nothing():
    g = tt.Grid3D(8, 8, 8)
    fl = tt.Fluid()
    F, u, v, w, p = map(_t, _random_state(8, 5, 0.5))
    K3.reset_launch_counts()
    outs = K3.predict3d_rhs(g, fl, DT, u, v, w, F, csf=True)
    for g_, w_ in zip(outs, K3.predict3d_rhs_plain(g, fl, DT, u, v, w, F, csf=True)):
        assert torch.equal(g_, w_)
    us, vs, ws, rhs = outs
    assert torch.equal(K3.jacobi3d(g, 3, p, rhs), K3.jacobi3d_plain(g, 3, p, rhs))
    for g_, w_ in zip(K3.correct3d(g, fl, DT, us, vs, ws, p, F),
                      K3.correct3d_plain(g, fl, DT, us, vs, ws, p, F)):
        assert torch.equal(g_, w_)
    for axis, vel in enumerate((u, v, w)):
        assert torch.equal(K3.fct3d_sweep(g, DT, F, vel, axis, True),
                           K3.fct3d_sweep_plain(g, DT, F, vel, axis, True))
    assert all(n == 0 for n in K3.LAUNCHES.values())
    with pytest.raises(ValueError):
        K3.fct3d_sweep(g, DT, F, u, 3)
    with pytest.raises(ValueError):
        K3.jacobi3d(g, 0, p, rhs)


@pytest.mark.cuda
def test_kernels3d_match_plain_on_card():
    """Each 3-D CUDA kernel against its plain version on the card, f64
    (1e-12) and f32 (1e-5, p 1e-4), on a random BC-consistent 32^3 state
    and an i-slab of it (bars as chip_smoke.py's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from tpuvof_torch.ops import apply_bc_3d

    n = 32
    g = tt.Grid3D(n, n, n)
    fl = tt.Fluid()
    rng = np.random.default_rng(12)
    shape = g.shape
    F = torch.as_tensor(np.clip(rng.normal(0.5, 0.4, shape), 0, 1), device="cuda")
    u, v, w = (torch.as_tensor(rng.normal(0, 1.0, shape), device="cuda") for _ in range(3))
    p = torch.as_tensor(rng.normal(0, 10.0, shape), device="cuda")
    u[0] = 0.0
    v[:, 0] = 0.0
    w[:, :, 0] = 0.0
    u, v, w, F, p = apply_bc_3d(u, v, w, F, p)
    for dtype, tol, tol_p in ((torch.float64, 1e-12, 1e-12), (torch.float32, 1e-5, 1e-4)):
        for gi_base, sl in ((0, slice(None)), (9, slice(9, 21))):
            Fd, ud, vd, wd, pd = (a[sl].to(dtype).contiguous() for a in (F, u, v, w, p))
            K3.reset_launch_counts()
            pairs = []
            for csf in (False, True):
                pairs.append((K3.predict3d_rhs(g, fl, DT, ud, vd, wd, Fd, csf, gi_base),
                              K3.predict3d_rhs_plain(g, fl, DT, ud, vd, wd, Fd, csf, gi_base)))
            us, vs, ws, rhs = pairs[0][1]
            pairs.append((K3.correct3d(g, fl, DT, us, vs, ws, pd, Fd, gi_base),
                          K3.correct3d_plain(g, fl, DT, us, vs, ws, pd, Fd, gi_base)))
            for axis, vel in enumerate((ud, vd, wd)):
                for mirror in (False, True):
                    pairs.append(((K3.fct3d_sweep(g, DT_SWEEP, Fd, vel, axis, mirror, gi_base),),
                                  (K3.fct3d_sweep_plain(g, DT_SWEEP, Fd, vel, axis, mirror,
                                                        gi_base),)))
            torch.cuda.synchronize()
            assert K3.LAUNCHES == {"predict3d_rhs": 3, "jacobi3d": 0, "correct3d": 1,
                                   "fct3d_sweep": 6}
            for got, want in pairs:
                for g_, w_ in zip(got, want):
                    assert g_.is_cuda and g_.dtype == dtype
                    assert _rel(g_.cpu(), w_.cpu()) <= tol
            got = K3.jacobi3d(g, 10, pd, rhs, gi_base)
            assert _rel(got.cpu(), K3.jacobi3d_plain(g, 10, pd, rhs, gi_base).cpu()) <= tol_p
    with pytest.raises(ValueError):
        K3.fct3d_sweep(g, DT, F[:, :-1], u[:, :-1], 0)  # wrong plane shape
    with pytest.raises(ValueError):
        K3.correct3d(g, fl, DT, u, v, w, p, F.transpose(1, 2))  # not contiguous


@pytest.mark.parametrize("n_iter", range(1, 13))
def test_jacobi3d_plan_splits_every_iteration_count(n_iter):
    """The launch plan of jacobi3d: ceil(n_iter / JACOBI_LEVELS) launches of
    1..JACOBI_LEVELS iterations, near-equal and the deeper first, that sum
    to n_iter (so n_iter that the depth does not divide still works)."""
    plan = K3.jacobi3d_plan(n_iter)
    assert sum(plan) == n_iter
    assert len(plan) == -(-n_iter // K3.JACOBI_LEVELS)
    assert all(1 <= d <= K3.JACOBI_LEVELS for d in plan)
    assert list(plan) == sorted(plan, reverse=True) and plan[0] - plan[-1] <= 1
    assert K3.jacobi3d_plan(10) == (4, 3, 3)  # the step's solve: three launches


@pytest.mark.parametrize("n_iter", [0, -1])
def test_jacobi3d_refuses_fewer_than_one_iteration(n_iter):
    g = tt.Grid3D(8, 8, 8)
    p = torch.zeros(g.shape, dtype=torch.float64)
    with pytest.raises(ValueError, match="n_iter >= 1"):
        K3.jacobi3d_plan(n_iter)
    with pytest.raises(ValueError, match="n_iter >= 1"):
        K3.jacobi3d(g, n_iter, p, p)


def test_3d_wrappers_refuse_wrong_shapes_before_any_launch():
    """A field whose planes are not (n1, nz+2), or with fewer than 3
    planes, is refused on the CPU as on the card."""
    g, fl = tt.Grid3D(8, 8, 8), tt.Fluid()
    ok = torch.zeros(g.shape, dtype=torch.float64)
    for bad in (ok[:, :-1], ok[:, :, :-1], ok[:2], ok[0]):
        with pytest.raises(ValueError, match="a field is"):
            K3.jacobi3d(g, 2, bad.contiguous(), bad.contiguous())
        with pytest.raises(ValueError, match="a field is"):
            K3.predict3d_rhs(g, fl, DT, *(bad.contiguous(),) * 4)


@pytest.mark.parametrize("n_iter", [1, 5, 7, 11])
def test_jacobi3d_on_cpu_runs_plain_and_counts_nothing(n_iter):
    """On CPU tensors the wrapper is the plain version, whatever the launch
    plan would be on the card, and counts no launch."""
    g = tt.Grid3D(9, 7, 6, Ly=0.1 * 7 / 9, Lz=0.1 * 6 / 9)
    rng = np.random.default_rng(n_iter)
    p, rhs = (torch.as_tensor(rng.normal(0, 1, g.shape)) for _ in range(2))
    K3.reset_launch_counts()
    assert torch.equal(K3.jacobi3d(g, n_iter, p, rhs), K3.jacobi3d_plain(g, n_iter, p, rhs))
    assert K3.LAUNCHES["jacobi3d"] == 0


def _card_state(g, seed, device="cuda"):
    """A random BC-consistent state on the card (F, u, v, w, p), f64."""
    from tpuvof_torch.ops import apply_bc_3d

    rng = np.random.default_rng(seed)
    shape = g.shape
    F = torch.as_tensor(np.clip(rng.normal(0.5, 0.4, shape), 0, 1), device=device)
    u, v, w = (torch.as_tensor(rng.normal(0, 1.0, shape), device=device) for _ in range(3))
    p = torch.as_tensor(rng.normal(0, 10.0, shape), device=device)
    u[0] = 0.0
    v[:, 0] = 0.0
    w[:, :, 0] = 0.0
    u, v, w, F, p = apply_bc_3d(u, v, w, F, p)
    return F, u, v, w, p


@pytest.mark.cuda
def test_tiled_kernels3d_edge_shapes_match_plain_on_card():
    """The tiled predict3d_rhs (csf off and on), the multi-level jacobi3d
    (n_iter 1 to 12: depths the launch plan does not divide) and the three
    marching / warp-shuffle sweeps (with and without mirror_out, at a step
    where the limiter fires) against their plain versions, f64 (1e-12) and
    f32 (1e-5, p 1e-4), on a 13 x 17 x 23 grid (n1 = 19 and n2 = 25 fill
    no tile) and on i-slabs of it with the low and the high x wall
    mid-block (zeros beyond the walls, as the slab engine's edge shards
    hold them); the sweeps also on pencil blocks with the low and the high
    y wall mid-block (gj_base -4 and 6, rows past ny + 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    nx, ny, nz = 13, 17, 23
    g = tt.Grid3D(nx, ny, nz, Ly=0.1 * ny / nx, Lz=0.1 * nz / nx)
    fl = tt.Fluid()
    fields = _card_state(g, 21)
    big = [torch.nn.functional.pad(a, (0, 0, 0, 0, 4, 4)) for a in fields]  # 4 planes a side
    blocks = (("grid", fields, 0), ("slab low wall", [a[:12].contiguous() for a in big], -4),
              ("slab high wall", [a[9:].contiguous() for a in big], 5))
    for dtype, tol, tol_p in ((torch.float64, 1e-12, 1e-12), (torch.float32, 1e-5, 1e-4)):
        for tag, block, gi_base in blocks:
            F, u, v, w, p = (a.to(dtype) for a in block)
            K3.reset_launch_counts()
            for csf in (False, True):
                got = K3.predict3d_rhs(g, fl, DT, u, v, w, F, csf, gi_base)
                want = K3.predict3d_rhs_plain(g, fl, DT, u, v, w, F, csf, gi_base)
                for name, g_, w_ in zip(("u*", "v*", "w*", "rhs"), got, want):
                    assert _rel(g_.cpu(), w_.cpu()) <= tol, (tag, dtype, csf, name)
            rhs = want[3]
            for n_iter in range(1, 13):
                got = K3.jacobi3d(g, n_iter, p, rhs, gi_base)
                want_p = K3.jacobi3d_plain(g, n_iter, p, rhs, gi_base)
                assert _rel(got.cpu(), want_p.cpu()) <= tol_p, (tag, dtype, n_iter)
            _check_sweeps_on_card(g, F, (u, v, w), tol, (tag, dtype), gi_base=gi_base)
            torch.cuda.synchronize()
            assert K3.LAUNCHES["predict3d_rhs"] == 3
            assert K3.LAUNCHES["jacobi3d"] == sum(len(K3.jacobi3d_plan(n)) for n in range(1, 13))
            assert K3.LAUNCHES["fct3d_sweep"] == 6
        # pencil blocks: rows 0..13 (gj_base -4) and 10..25 (gj_base 6) of the
        # fields padded by 4 zero rows a side along y
        wide = [torch.nn.functional.pad(a, (0, 0, 4, 4)) for a in fields]
        for r0, njl in ((0, 12), (10, 14)):
            F, u, v, w, _ = (a[:, r0:r0 + njl + 2].contiguous().to(dtype) for a in wide)
            K3.reset_launch_counts()
            _check_sweeps_on_card(g, F, (u, v, w), tol, (f"pencil rows {r0}", dtype),
                                  njl=njl, gj_base=r0 - 4)
            assert K3.LAUNCHES["fct3d_sweep"] == 6


@pytest.mark.cuda
@pytest.mark.parametrize("nz", [150, 151])
def test_jacobi3d_regions_and_pencils_match_plain_on_card(nz):
    """jacobi3d (n_iter 1 to 12) against its plain version, f64 (1e-12) and
    f32 (1e-4), on a 13 x 17 x nz grid whose nz + 2 columns span three of
    the kernel's regions, the last one ragged (at nz 151 by an odd count,
    so that a thread's run of k positions straddles the array's end), on
    i-slabs of it with the low and the high x wall mid-block, and on pencil
    blocks with the low and the high y wall mid-block (gj_base -4 and 6,
    rows past ny + 1); at every depth its launch (jacobi3d_geometry) covers
    the block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    nx, ny = 13, 17
    g = tt.Grid3D(nx, ny, nz, Ly=0.1 * ny / nx, Lz=0.1 * nz / nx)
    *_, p = _card_state(g, 31)
    rhs = torch.as_tensor(np.random.default_rng(32).normal(0, 1e3, g.shape), device="cuda")
    big = [torch.nn.functional.pad(a, (0, 0, 0, 0, 4, 4)) for a in (p, rhs)]
    wide = [torch.nn.functional.pad(a, (0, 0, 4, 4)) for a in (p, rhs)]
    blocks = [("grid", (p, rhs), {}),
              ("slab low wall", [a[:12] for a in big], {"gi_base": -4}),
              ("slab high wall", [a[9:] for a in big], {"gi_base": 5})]
    for r0, njl in ((0, 12), (10, 14)):
        blocks.append((f"pencil rows {r0}", [a[:, r0:r0 + njl + 2] for a in wide],
                       {"njl": njl, "gj_base": r0 - 4}))
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
        for tag, block, org in blocks:
            pb, rb = (a.to(dtype).contiguous() for a in block)
            for depth in range(1, K3.JACOBI_LEVELS + 1):  # the launch covers the block
                geo = K3.jacobi3d_geometry(pb.shape, depth, dtype, "njl" in org)
                (gk, gj, gl), n0, n1, n2 = geo["grid"], *pb.shape
                assert gk * geo["own_cols"] >= n2 and gj * geo["own_rows"] >= n1
                assert gl * geo["chunk"] >= n0 and geo["computed_over_owned"] >= 1
            K3.reset_launch_counts()
            for n_iter in range(1, 13):
                got = K3.jacobi3d(g, n_iter, pb, rb, **org)
                want = K3.jacobi3d_plain(g, n_iter, pb, rb, **org)
                assert _rel(got.cpu(), want.cpu()) <= tol, (tag, dtype, n_iter)
            torch.cuda.synchronize()
            assert K3.LAUNCHES["jacobi3d"] == sum(len(K3.jacobi3d_plan(n)) for n in range(1, 13))


def _check_sweeps_on_card(g, F, vels, tol, tag, **org):
    """The three sweeps with and without mirror_out against their plain
    versions on one block."""
    for axis, vel in enumerate(vels):
        for mirror in (False, True):
            got = K3.fct3d_sweep(g, DT_SWEEP, F, vel, axis, mirror, **org)
            want = K3.fct3d_sweep_plain(g, DT_SWEEP, F, vel, axis, mirror, **org)
            assert _rel(got.cpu(), want.cpu()) <= tol, (*tag, axis, mirror)


@pytest.mark.cuda
def test_csf_predict3d_matches_plain_on_card_on_dam_break():
    """The csf predict3d_rhs (the curvature pre-pass, then the predictor)
    against its plain version on the noise-free 40^3 dam break, f64
    (1e-12) and f32 (1e-5): on the whole grid, an i-slab with the low x
    wall mid-block, and the 2 x 2 pencil engine's blocks of shards (0, 0)
    and (0, 1) (a low and a high y wall mid-block, the water's faces in
    both)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from tpuvof_torch.ops import apply_bc_3d
    from tpuvof_torch.parallel import Decomp3D, make_mesh

    n = 40
    g, fl = tt.Grid3D(n, n, n), tt.Fluid()
    s = tt.init_state_3d(g, 1, "cuda", torch.float64)
    u, v, w, F, p = apply_bc_3d(s.u, s.v, s.w, s.F, s.p)
    assert set(torch.unique(F).tolist()) == {0.0, 1.0}
    state = tt.State3D(F=F, u=u, v=v, w=w, p=p)
    dec = Decomp3D(g, make_mesh(devices=[F.device] * 4))
    pencils = dec.widen(dec.scatter_state(state))
    big = [torch.nn.functional.pad(a, (0, 0, 0, 0, 4, 0)) for a in (F, u, v, w)]
    blocks = [("grid", (F, u, v, w), {}),
              ("slab low x wall", [a[:20].contiguous() for a in big], {"gi_base": -4})]
    for xy in ((0, 0), (0, 1)):
        k = dec.coords.index(xy)
        b = pencils[k]
        blocks.append((f"pencil {xy}", (b.F, b.u, b.v, b.w), dec.origin(k)))
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for tag, fields, org in blocks:
            Fd, ud, vd, wd = (a.to(dtype).contiguous() for a in fields)
            K3.reset_launch_counts()
            got = K3.predict3d_rhs(g, fl, DT, ud, vd, wd, Fd, True, **org)
            torch.cuda.synchronize()
            assert K3.LAUNCHES["predict3d_rhs"] == 2
            want = K3.predict3d_rhs_plain(g, fl, DT, ud, vd, wd, Fd, True, **org)
            for name, g_, w_ in zip(("u*", "v*", "w*", "rhs"), got, want):
                assert _rel(g_.cpu(), w_.cpu()) <= tol, (tag, dtype, name)
