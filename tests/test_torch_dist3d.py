"""The port's distributed 3-D engine (tpuvof_torch.parallel: Decomp3D,
make_mesh, admission_3d) against the port's serial path and tpuvof.

Decomp3D runs on meshes of CPU devices, where the kernel wrappers run
their plain versions: one controller, four shards on one device, as the
engine runs on one card. f64, n_jacobi = 2, 6 steps (every sweep phase
twice), from random BC-consistent states (tests/test_3d.py's recipe,
unit velocities, dt 2e-4 so F moves by tenths). Bars: 1e-12 of each
field's scale against the serial simulate_3d on 'torch' (the plain ops)
and on 'cuda' (the kernels' plain versions), which compute the same
operations per owned cell; one case against tpuvof's serial simulate_3d
(XLA, eager), at that bar too. Meshes: (2,) slabs; (2, 2) pencils; (1, 2)
at the minimum ny/py == Wy + 1 (tpuvof's adversarial shape); (2, 1) with
pencil=True; (2, 2) with csf.
"""
import dataclasses

import numpy as np
import pytest
import torch

import tpuvof_torch as tt
from tpuvof_torch.ops import apply_bc_3d
from tpuvof_torch.parallel import Mesh, admission_3d, factor2d, make_mesh

TOL = 1e-12
DT = 2e-4
NJ = 2
STEPS = 6
G16 = tt.Grid3D(16, 16, 8, Lz=0.05)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (as the other 3-D
    test files): the gate's worker processes share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


def _assert_close(got, want, tol=TOL):
    for name, a, b in zip("Fuvwp", got, want):
        assert _rel(a, b) <= tol, (name, _rel(a, b))


def _random_state(g, seed):
    rng = np.random.default_rng(seed)
    F = np.clip(rng.normal(0.5, 0.4, g.shape), 0, 1)
    u, v, w = (rng.normal(0, 1.0, g.shape) for _ in range(3))
    p = rng.normal(0, 10.0, g.shape)
    u[0] = 0.0
    v[:, 0] = 0.0
    w[:, :, 0] = 0.0
    u, v, w, F, p = apply_bc_3d(*map(torch.as_tensor, (u, v, w, F, p)))
    return tt.State3D(F=F, u=u, v=v, w=w, p=p)


def _mesh(shape):
    n = int(np.prod(shape))
    names = ("mx",) if len(shape) == 1 else ("mx", "my")
    devices = np.empty(n, dtype=object)
    devices[:] = [CPU] * n
    return Mesh(devices.reshape(shape), names)


CASES = {
    "slab (2,)": (G16, (2,), {}),
    "pencil (2, 2)": (G16, (2, 2), {}),
    "pencil (1, 2) minimum": (tt.Grid3D(16, 14, 8, Ly=0.1 * 14 / 16, Lz=0.05), (1, 2), {}),
    "pencil=True (2, 1)": (G16, (2, 1), {"pencil": True}),
    "pencil (2, 2) csf": (tt.Grid3D(20, 20, 8, Lz=0.04), (2, 2), {"csf": True}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_decomp3d_matches_serial(case):
    g, shape, kw = CASES[case]
    s0 = _random_state(g, 3)
    dec = tt.Decomp3D(g, _mesh(shape), dt=DT, n_jacobi=NJ, **kw)
    assert dec.pencil == (case != "slab (2,)")
    if "minimum" in case:
        assert dec.nyl == dec.Wy + 1
    got = dec.simulate(s0, STEPS)
    csf = kw.get("csf", False)
    want = tt.simulate_3d(g, s0, STEPS, dt=DT, n_jacobi=NJ, csf=csf, backend="torch")
    assert _rel(want.F, s0.F) > 0.1  # the flow moved
    _assert_close(got, want)
    _assert_close(got, tt.simulate_3d(g, s0, STEPS, dt=DT, n_jacobi=NJ, csf=csf,
                                      backend="cuda"))


def test_decomp3d_matches_tpuvof_serial_xla():
    """The (2, 2) pencil engine against tpuvof's serial simulate_3d on
    'xla', eager (jitted tpuvof contracts FMAs)."""
    import jax
    import jax.numpy as jnp

    import tpuvof as tv
    from tpuvof.grid import Grid3D

    s0 = _random_state(G16, 4)
    dec = tt.Decomp3D(G16, _mesh((2, 2)), dt=DT, n_jacobi=NJ)
    got = dec.simulate(s0, STEPS)
    with jax.disable_jit():
        want = tv.simulate_3d(Grid3D(**dataclasses.asdict(G16)),
                              tv.State3D(*(jnp.asarray(a.numpy()) for a in s0)), STEPS,
                              dt=DT, n_jacobi=NJ)
    _assert_close(got, [torch.as_tensor(np.array(a)) for a in want])


def test_chunked_with_istep0_matches_continuous():
    s0 = _random_state(G16, 5)
    dec = tt.Decomp3D(G16, _mesh((2, 2)), dt=DT, n_jacobi=NJ)
    whole = dec.simulate(s0, STEPS)
    half = dec.simulate(dec.simulate(s0, STEPS // 2), STEPS - STEPS // 2, istep0=STEPS // 2)
    for a, b in zip(half, whole):
        assert torch.equal(a, b)
    # the resident form: the extended blocks carried across the two calls
    blocks = dec.advance(dec.widen(dec.scatter_state(s0)), STEPS // 2)
    blocks = dec.advance(blocks, STEPS - STEPS // 2, istep0=STEPS // 2)
    for a, b in zip(dec.gather_state(dec.narrow(blocks)), whole):
        assert torch.equal(a, b)


def test_start_from_a_state_that_is_not_bc_consistent():
    """Both the engine and the serial 'cuda' path apply the BCs once at
    entry, so a state whose ghosts are not its mirrors (a painted state)
    takes the same trajectory (tpuvof's test_parallel_3d.py twin)."""
    s = _random_state(G16, 6)
    F = s.F.clone()
    F[0] += 0.01
    F[:, -1] -= 0.02
    u = s.u.clone()
    u[:, 0] += 1e-3
    s0 = s._replace(F=F, u=u)
    dec = tt.Decomp3D(G16, _mesh((2, 2)), dt=DT, n_jacobi=NJ)
    _assert_close(dec.simulate(s0, STEPS),
                  tt.simulate_3d(G16, s0, STEPS, dt=DT, n_jacobi=NJ, backend="cuda"))


def test_extended_blocks_stay_finite_and_bounded():
    """The junk beyond the walls of edge shards is never refreshed but
    stays finite (the kernels select with masks, they do not multiply)."""
    s0 = _random_state(G16, 7)
    dec = tt.Decomp3D(G16, _mesh((2, 2)), dt=DT, n_jacobi=NJ)
    blocks = dec.advance(dec.widen(dec.scatter_state(s0)), STEPS)
    for b in blocks:
        assert tuple(b.F.shape) == (dec.nloc + 2, dec.nyE + 2, G16.nz + 2)
        assert all(bool(torch.isfinite(a).all()) for a in b)
        assert 0.0 <= float(b.F.min()) and float(b.F.max()) <= 1.0


def test_scatter_then_gather_is_the_bc_of_the_state():
    s0 = _random_state(G16, 8)
    F = s0.F.clone()
    F[:, 0] = 0.3  # ghosts the gather must rebuild
    s0 = s0._replace(F=F)
    for shape in ((2,), (2, 2), (1, 2)):
        dec = tt.Decomp3D(G16, _mesh(shape), dt=DT, n_jacobi=NJ)
        shards = dec.scatter_state(s0)
        assert [tuple(s.F.shape) for s in shards] == \
            [(dec.nxl + 2, dec.nyl + 2, G16.nz + 2)] * len(dec.coords)
        u, v, w, F_, p = apply_bc_3d(s0.u, s0.v, s0.w, s0.F, s0.p)
        for a, b in zip(dec.gather_state(shards), (F_, u, v, w, p)):
            assert torch.equal(a, b)


def test_admission_decisions():
    a = admission_3d(tt.Grid3D(200, 200, 200), 2, 2)
    assert (a["ok"], a["pencil"], a["W"], a["nloc"], a["Wy"], a["nyE"]) == \
        (True, True, 14, 128, 14, 128)
    a = admission_3d(tt.Grid3D(200, 200, 200), 4, 1, csf=True)
    assert (a["ok"], a["pencil"], a["W"], a["nloc"], a["Wy"], a["nyE"]) == \
        (True, False, 16, 82, 0, 200)
    # W and Wy are the step's cone, n_jacobi + 4 (+6 with csf), nothing else
    a = admission_3d(G16, 2, 1, NJ, pencil=True)
    assert (a["ok"], a["pencil"], a["W"], a["nloc"], a["Wy"], a["nyE"]) == \
        (True, True, NJ + 4, 8 + 2 * (NJ + 4), NJ + 4, 16 + 2 * (NJ + 4))
    assert admission_3d(G16, 2, 1, NJ, csf=True)["W"] == NJ + 6
    assert not admission_3d(G16, 2, 2, NJ, csf=True)["ok"]  # W + 1 = 9 > nx/px = 8
    assert not admission_3d(G16, 2, 1, 10)["ok"]  # W = 14 > nx/px - 1


@pytest.mark.parametrize("shape,kw,match", [
    ((4,), {}, "nx/px"),                          # slabs of 4 planes, W = 6
    ((2, 4), {}, "ny/py"),                        # pencils of 4 rows, Wy = 6
    ((2, 2), {"csf": True}, "nx/px"),             # csf widens W to 8
])
def test_inadmissible_shapes_raise(shape, kw, match):
    with pytest.raises(ValueError, match=match):
        tt.Decomp3D(G16, _mesh(shape), n_jacobi=NJ, **kw)


def test_unported_engines_and_bad_meshes_raise():
    """The engines that once raised here build now: the plain-torch engine
    and the hybrid (their trajectories: tests/test_torch_dist3d_torch.py
    and test_torch_hybrid_dist3d.py); the bad meshes still raise."""
    dec = tt.Decomp3D(G16, _mesh((2,)), n_jacobi=NJ, backend="torch")
    assert dec.backend == "torch" and not dec.hybrid and dec.W == 0
    for solver, want in (("mg", "mg"), ("rbsor", "rbsor"), ("auto", "mg")):
        dec = tt.Decomp3D(G16, _mesh((2,)), n_jacobi=NJ, pressure_solver=solver)
        assert dec.hybrid and dec.pressure_solver == want and dec.W == 4
    with pytest.raises(ValueError, match="backend='torch' cannot honour"):
        tt.Decomp3D(G16, _mesh((2, 1)), n_jacobi=NJ, backend="torch", pencil=True)
    with pytest.raises(ValueError, match="divisible"):
        tt.Decomp3D(tt.Grid3D(18, 18, 8, Lz=0.1 * 8 / 18), _mesh((4,)), n_jacobi=NJ)
    with pytest.raises(ValueError, match="2-axis"):
        tt.Decomp3D(G16, _mesh((2,)), n_jacobi=NJ, pencil=True)


def test_make_mesh(monkeypatch):
    m = make_mesh(devices=[CPU] * 4)
    assert m.devices.shape == (2, 2) and m.axis_names == ("mx", "my")
    assert all(d == CPU for d in m.devices.flat)
    m = make_mesh(3, ("mx",), devices=["cpu"] * 4)
    assert m.devices.shape == (3,) and m.axis_names == ("mx",)
    assert factor2d(8) == (4, 2) and factor2d(7) == (7, 1)
    with pytest.raises(ValueError):
        make_mesh(5, devices=[CPU] * 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
