"""The pencil mode (njl, gj_base) of the four 3-D kernels' plain versions
(tpuvof_torch.kernels.step3d_kernels) against tpuvof's Pallas kernels.

On the CPU each plain version runs on an (x, y) pencil of a 24 x 24 x 8
grid cut as the 3 x 3 pencil engine cuts it (n_jacobi = 2: W = Wy = 6,
blocks of (22, 22, 10)): the shard's owned cells and W planes and Wy rows
of neighbour data, zeros beyond the walls, as Decomp3D's entry leaves
them. Two shards: the interior one (1, 1), whose block holds no wall, and
the corner (0, 2), where the x wall and the top y wall sit mid-block. The
Pallas side runs in interpret mode, as tests/test_3d.py runs it, on the
block padded to its (8, 128) tiling as tpuvof/parallel/dist3d.py pads it,
and is compared on the unpadded region beyond 4 cells of each block edge
(where tpuvof's rolls wrap and the port reads zeros). Bar: 1e-12 of the
field's scale, f64 (both sides do the same operations per element).

The ``cuda``-marked tests hold the CUDA kernels in pencil mode against
these plain versions on a card (jacobi3d for 1 to 12 iterations, on shards
with a negative row origin and with rows past ny + 1); they need no jax, so
on a machine without jax they run with
``pytest tests/test_torch_pencil3d.py --noconftest -m cuda``.
"""
import numpy as np
import pytest
import torch

import tpuvof_torch as tt
from tpuvof_torch.kernels import step3d_kernels as K3
from tpuvof_torch.ops import apply_bc_3d as port_bc

TOL = 1e-12
DT = 4e-6
DT_SWEEP = 2e-3  # with unit velocities: Courant numbers up to ~0.5, the limiter fires
N, NZ = 24, 8
NXL = NYL = 8  # a 3 x 3 mesh
W = WY = 2 + 4  # n_jacobi + 4
NLOC, NYE = NXL + 2 * W, NYL + 2 * WY
M = 4  # cells of stencil reach compared away from each block edge
SHARDS = {"interior": (1, 1), "corner": (0, 2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (as the other 3-D
    test files): the gate's worker processes share the cores."""
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


def _random_fields(g_shape, seed, apply_bc):
    """F, u, v, w, p: tests/test_3d.py's random BC-consistent state, unit
    velocities, through the given 3-D BC."""
    rng = np.random.default_rng(seed)
    F = np.clip(rng.normal(0.5, 0.4, g_shape), 0, 1)
    u, v, w = (rng.normal(0, 1.0, g_shape) for _ in range(3))
    p = rng.normal(0, 10.0, g_shape)
    u[0] = 0.0
    v[:, 0] = 0.0
    w[:, :, 0] = 0.0
    return apply_bc(u, v, w, F, p)


def _port_bc(*fields):
    return tuple(a.numpy() for a in port_bc(*map(_t, fields)))


def _pencil(a, xi, yi):
    """Shard (xi, yi)'s extended block of a whole-grid field: zeros beyond
    the walls, local plane l at global i xi*NXL - W + l, row m at global j
    yi*NYL - WY + m."""
    big = np.pad(np.asarray(a), ((W, W), (WY, WY), (0, 0)))
    return big[xi * NXL:xi * NXL + NLOC + 2, yi * NYL:yi * NYL + NYE + 2]


def _origin(xi, yi):
    return dict(gi_base=xi * NXL - W, njl=NYE, gj_base=yi * NYL - WY)


@pytest.fixture(scope="module")
def ref():
    """tpuvof's grid and Pallas kernels, the port's grid, the pad and cut
    functions, and each shard's blocks of one random state."""
    import jax.numpy as jnp

    from tpuvof.config import Fluid
    from tpuvof.grid import Grid3D
    from tpuvof.ops import apply_bc_3d
    from tpuvof.pallas_kernels import jacobi3d as pj
    from tpuvof.pallas_kernels import step3d as ps
    from tpuvof.parallel.dist3d import _pad_planes
    from tpuvof_torch.convert import fluid_from_tpuvof, grid3d_from_tpuvof

    g = Grid3D(N, N, NZ, Lz=0.1 * NZ / N)
    pj_, pk_ = _pad_planes(NYE, NZ)

    def pad(a):
        return jnp.pad(jnp.asarray(np.asarray(a)), ((0, 0), (0, pj_), (0, pk_)))

    def bc(*fields):
        return tuple(np.asarray(a) for a in apply_bc_3d(*map(jnp.asarray, fields)))

    u, v, w, F, p = _random_fields(g.shape, 5, bc)
    blocks = {name: [_pencil(a, *xy) for a in (F, u, v, w, p)] for name, xy in SHARDS.items()}
    return dict(g=g, fl=Fluid(), pg=grid3d_from_tpuvof(g), pfl=fluid_from_tpuvof(Fluid()),
                ps=ps, pj=pj, pad=pad, blocks=blocks,
                cut=lambda a: np.asarray(a)[M:-M, M:NYE + 2 - M, :NZ + 2])


def _mid(a):
    return np.asarray(a)[M:-M, M:-M]


def _kw(shard):
    return dict(interpret=True, nloc=NLOC, **_origin(*SHARDS[shard]))


@pytest.mark.parametrize("shard", list(SHARDS))
@pytest.mark.parametrize("csf", [False, True])
def test_predict3d_pencil_plain_matches_pallas(ref, shard, csf):
    F, u, v, w, _ = ref["blocks"][shard]
    pad = ref["pad"]
    want = ref["ps"].pallas_predict3d_rhs(ref["g"], ref["fl"], DT, pad(u), pad(v), pad(w),
                                          pad(F), csf=csf, **_kw(shard))
    got = K3.predict3d_rhs_plain(ref["pg"], ref["pfl"], DT, *map(_t, (u, v, w, F)), csf,
                                 **_origin(*SHARDS[shard]))
    for name, g_, w_ in zip(("u*", "v*", "w*", "rhs"), got, want):
        assert _rel(_mid(g_), ref["cut"](w_)) <= TOL, name


@pytest.mark.parametrize("shard", list(SHARDS))
def test_correct3d_pencil_plain_matches_pallas(ref, shard):
    F, u, v, w, p = ref["blocks"][shard]
    pad, org = ref["pad"], _origin(*SHARDS[shard])
    us, vs, ws, _ = K3.predict3d_rhs_plain(ref["pg"], ref["pfl"], DT, *map(_t, (u, v, w, F)),
                                           **org)
    want = ref["ps"].pallas_correct3d(ref["g"], ref["fl"], DT, pad(us), pad(vs), pad(ws),
                                      pad(p), pad(F), **_kw(shard))
    got = K3.correct3d_plain(ref["pg"], ref["pfl"], DT, us, vs, ws, _t(p), _t(F), **org)
    for name, g_, w_ in zip("uvw", got, want):
        assert _rel(_mid(g_), ref["cut"](w_)) <= TOL, name


@pytest.mark.parametrize("shard", list(SHARDS))
@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("mirror_out", [False, True])
def test_fct3d_sweep_pencil_plain_matches_pallas(ref, shard, axis, mirror_out):
    F, u, v, w, _ = ref["blocks"][shard]
    vel = (u, v, w)[axis]
    pad = ref["pad"]
    want = ref["ps"].pallas_fct3d_sweep(ref["g"], DT_SWEEP, pad(F), pad(vel), axis,
                                        mirror_out=mirror_out, **_kw(shard))
    got = K3.fct3d_sweep_plain(ref["pg"], DT_SWEEP, _t(F), _t(vel), axis, mirror_out,
                               **_origin(*SHARDS[shard]))
    assert _rel(_mid(got), ref["cut"](want)) <= TOL
    assert _rel(_mid(got), _mid(F)) > 1e-3  # F moved


@pytest.mark.parametrize("shard", list(SHARDS))
def test_jacobi3d_pencil_plain_matches_pallas(ref, shard):
    F, u, v, w, p = ref["blocks"][shard]
    org = _origin(*SHARDS[shard])
    _, _, _, rhs = K3.predict3d_rhs_plain(ref["pg"], ref["pfl"], DT, *map(_t, (u, v, w, F)),
                                          **org)
    want = ref["pj"].pallas_jacobi_3d(ref["g"], 2, ref["pad"](p), ref["pad"](rhs.numpy()),
                                      **_kw(shard))
    got = K3.jacobi3d_plain(ref["pg"], 2, _t(p), rhs, **org)
    assert _rel(_mid(got), ref["cut"](want)) <= TOL
    assert np.all(got.numpy()[:, [0, -1]] == 0.0)  # the block-edge rows are ghosts


def test_pencil_walls_land_mid_block_on_edge_shards_only():
    """The y-wall semantics of pencil mode: on the corner shard the last
    sweep's y mirror, the Jacobi's zeroed wall rows and v*'s zero wall
    face sit at the global walls mid-block; on the interior shard no row
    is treated as a wall (the same sweep without the pencil origin would
    mirror rows 0 and ny+1 of the block)."""
    g, fl = tt.Grid3D(N, N, NZ, Lz=0.1 * NZ / N), tt.Fluid()
    u, v, w, F, p = _random_fields(g.shape, 9, _port_bc)
    for name, (xi, yi) in SHARDS.items():
        org = _origin(xi, yi)
        Fb, ub, vb, wb, pb = (_t(_pencil(a, xi, yi)) for a in (F, u, v, w, p))
        top = N + 1 - org["gj_base"]  # local row of the global wall j = ny+1
        out = K3.fct3d_sweep_plain(g, DT_SWEEP, Fb, vb, 1, True, **org)
        _, vs, _, rhs = K3.predict3d_rhs_plain(g, fl, DT, ub, vb, wb, Fb, **org)
        pj = K3.jacobi3d_plain(g, 2, pb, rhs, **org)
        if name == "corner":
            assert 0 < top < NYE + 1
            assert torch.equal(out[1:-1, top], out[1:-1, top - 1])  # fresh mirror
            assert torch.all(pj[:, top] == 0.0) and torch.all(vs[:, top] == 0.0)
            assert torch.any(pj[W + 1:-W - 1, top - 1, 1:-1] != 0.0)
        else:
            assert not torch.equal(out[1:-1, 0], out[1:-1, 1])  # no mirror at the edge
            assert torch.any(vs[M:-M, 1] != 0.0)


def test_pencil_wrappers_route_cpu_tensors_to_plain_and_check_shapes():
    g, fl = tt.Grid3D(N, N, NZ, Lz=0.1 * NZ / N), tt.Fluid()
    u, v, w, F, p = (_t(_pencil(a, 0, 2)) for a in _random_fields(g.shape, 11, _port_bc))
    org = _origin(0, 2)
    K3.reset_launch_counts()
    got = K3.predict3d_rhs(g, fl, DT, u, v, w, F, True, **org)
    for g_, w_ in zip(got, K3.predict3d_rhs_plain(g, fl, DT, u, v, w, F, True, **org)):
        assert torch.equal(g_, w_)
    us, vs, ws, rhs = got
    assert torch.equal(K3.jacobi3d(g, 2, p, rhs, **org), K3.jacobi3d_plain(g, 2, p, rhs, **org))
    for g_, w_ in zip(K3.correct3d(g, fl, DT, us, vs, ws, p, F, **org),
                      K3.correct3d_plain(g, fl, DT, us, vs, ws, p, F, **org)):
        assert torch.equal(g_, w_)
    for axis, vel in enumerate((u, v, w)):
        assert torch.equal(K3.fct3d_sweep(g, DT, F, vel, axis, True, **org),
                           K3.fct3d_sweep_plain(g, DT, F, vel, axis, True, **org))
    assert all(n == 0 for n in K3.LAUNCHES.values())
    with pytest.raises(ValueError, match="a field is"):  # a pencil block without njl
        K3.fct3d_sweep(g, DT, F, u, 0, gi_base=org["gi_base"])
    with pytest.raises(ValueError, match="njl"):  # a row origin without njl
        K3.jacobi3d(g, 2, p[:, :N + 2].contiguous(), rhs[:, :N + 2].contiguous(),
                    gj_base=3)
    with pytest.raises(ValueError, match="a field is"):  # njl that is not the block's
        K3.correct3d(g, fl, DT, us, vs, ws, p, F, gi_base=0, njl=NYE + 1, gj_base=0)
    for gj_base in (N + 1, -NYE - 1):  # the block lies wholly beyond a wall
        with pytest.raises(ValueError, match="no interior row"):
            K3.predict3d_rhs(g, fl, DT, u, v, w, F, gi_base=0, njl=NYE, gj_base=gj_base)


@pytest.mark.cuda
def test_pencil_kernels_match_plain_on_card():
    """Each 3-D CUDA kernel in pencil mode against its plain version on
    the card, on the interior and the corner shard of a random state, f64
    (1e-12) and f32 (1e-5, p 1e-4), the bars of chip_smoke.py."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    g, fl = tt.Grid3D(N, N, NZ, Lz=0.1 * NZ / N), tt.Fluid()
    fields = _random_fields(g.shape, 13, _port_bc)
    for dtype, tol, tol_p in ((torch.float64, 1e-12, 1e-12), (torch.float32, 1e-5, 1e-4)):
        for xi, yi in SHARDS.values():
            org = _origin(xi, yi)
            u, v, w, F, p = (_t(_pencil(a, xi, yi)).to("cuda", dtype) for a in fields)
            pairs = []
            for csf in (False, True):
                pairs.append((K3.predict3d_rhs(g, fl, DT, u, v, w, F, csf, **org),
                              K3.predict3d_rhs_plain(g, fl, DT, u, v, w, F, csf, **org)))
            us, vs, ws, rhs = pairs[0][1]
            pairs.append((K3.correct3d(g, fl, DT, us, vs, ws, p, F, **org),
                          K3.correct3d_plain(g, fl, DT, us, vs, ws, p, F, **org)))
            for axis, vel in enumerate((u, v, w)):
                for mirror in (False, True):
                    pairs.append(((K3.fct3d_sweep(g, DT_SWEEP, F, vel, axis, mirror, **org),),
                                  (K3.fct3d_sweep_plain(g, DT_SWEEP, F, vel, axis, mirror,
                                                        **org),)))
            torch.cuda.synchronize()
            for got, want in pairs:
                for g_, w_ in zip(got, want):
                    assert _rel(g_.cpu(), w_.cpu()) <= tol
            got = K3.jacobi3d(g, 10, p, rhs, **org)
            assert _rel(got.cpu(), K3.jacobi3d_plain(g, 10, p, rhs, **org).cpu()) <= tol_p


@pytest.mark.cuda
def test_tiled_pencil_kernels_match_plain_on_card():
    """The tiled predict3d_rhs (csf off and on) and the multi-level jacobi3d
    (n_iter 1 to 12) in pencil mode against their plain versions, f64
    (1e-12) and f32 (1e-5, p 1e-4), on the shards whose row origin is
    negative (0, 0) and whose rows run past ny + 1 (2, 2), each with an x
    and a y wall mid-block, and on the interior shard (1, 1). The
    blocks' 22 rows and 10 columns fill no (j, k) tile of either kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    g, fl = tt.Grid3D(N, N, NZ, Lz=0.1 * NZ / N), tt.Fluid()
    fields = _random_fields(g.shape, 17, _port_bc)
    for dtype, tol, tol_p in ((torch.float64, 1e-12, 1e-12), (torch.float32, 1e-5, 1e-4)):
        for xi, yi in ((0, 0), (2, 2), (1, 1)):
            org = _origin(xi, yi)
            u, v, w, F, p = (_t(_pencil(a, xi, yi)).to("cuda", dtype) for a in fields)
            for csf in (False, True):
                got = K3.predict3d_rhs(g, fl, DT, u, v, w, F, csf, **org)
                want = K3.predict3d_rhs_plain(g, fl, DT, u, v, w, F, csf, **org)
                for name, g_, w_ in zip(("u*", "v*", "w*", "rhs"), got, want):
                    assert _rel(g_.cpu(), w_.cpu()) <= tol, ((xi, yi), dtype, csf, name)
            rhs = want[3]
            for n_iter in range(1, 13):
                got = K3.jacobi3d(g, n_iter, p, rhs, **org)
                want_p = K3.jacobi3d_plain(g, n_iter, p, rhs, **org)
                assert _rel(got.cpu(), want_p.cpu()) <= tol_p, ((xi, yi), dtype, n_iter)
