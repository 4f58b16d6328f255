"""The port's distributed multigrid (tpuvof_torch.parallel.mg) against the
port's serial mg_solve and tpuvof's serial ops.mg.mg_solve.

The problem is tpuvof's own (tests/test_mg_dist.py::_manufactured: a
zero-mean rhs with structure at several wavelengths, on the unit box),
solved to tol 1e-9 from p = 0 in f64. The blocks sit on the CPU, one
controller, as Decomp3D's shards do. Each layout runs the three regimes
of the gather crossover: GATHER_VOLUME = 10**9 gathers the fine problem at
once (the serial solver, bit for bit), 0 shards every level down to the
coarsest, 256 shards the fine levels and gathers the rest. Bars: atol
1e-11 against both serial solves (tpuvof's), and the same number of
V-cycles as the port's serial solve, counted by the calls of the loop
test (ops.poisson.keep_iterating, one more than the cycles).
"""
import functools

import numpy as np
import pytest
import torch

import tpuvof_torch.ops.mg as omg
import tpuvof_torch.parallel.mg as pmg
from tpuvof_torch.parallel.mg import MGDecomp, mg_solve_dist

ATOL = 1e-11


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (as the other port test
    files): the gate's worker processes share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _manufactured(shape, seed=0):
    """tpuvof's test problem (tests/test_mg_dist.py:40-51)."""
    rng = np.random.default_rng(seed)
    rhs = rng.standard_normal(shape)
    for ax, n in enumerate(shape):
        x = np.arange(n) / n
        wave = np.sin(2 * np.pi * x) + 0.3 * np.cos(6 * np.pi * x)
        rhs += np.expand_dims(wave, tuple(k for k in range(len(shape)) if k != ax))
    rhs -= rhs.mean()
    return rhs


def _split(full, spec: MGDecomp):
    """The row-major blocks of a whole array."""
    lshape = [n // s for n, s in zip(full.shape, spec.shards)]
    return [full[tuple(slice(c * n, (c + 1) * n) for c, n in zip(cs, lshape))].contiguous()
            for cs in spec.coords]


def _join(blocks, spec: MGDecomp, gshape):
    full = torch.empty(gshape, dtype=blocks[0].dtype)
    lshape = blocks[0].shape
    for cs, b in zip(spec.coords, blocks):
        full[tuple(slice(c * n, (c + 1) * n) for c, n in zip(cs, lshape))] = b
    return full


@pytest.fixture
def loop_tests(monkeypatch):
    """The number of loop tests each solve makes, serial or distributed
    (the replicated regime calls the serial solver)."""
    calls = [0]
    real = omg.keep_iterating

    def counted(*a):
        calls[0] += 1
        return real(*a)

    monkeypatch.setattr(omg, "keep_iterating", counted)
    monkeypatch.setattr(pmg, "keep_iterating", counted)
    return calls


@functools.lru_cache(maxsize=None)
def _tpuvof_serial(gshape, tol, tol_rel):
    import jax.numpy as jnp

    from tpuvof.ops.mg import mg_solve

    inv2 = tuple(float(n) ** 2 for n in gshape)
    out = mg_solve(jnp.zeros(tuple(n + 2 for n in gshape), jnp.float64),
                   jnp.asarray(_manufactured(gshape)), inv2, tol, 80, tol_rel=tol_rel)
    return np.asarray(out)[(slice(1, -1),) * len(gshape)]


def _solve(shards, gshape, gv, loop_tests, tol=1e-9, tol_rel=0.0):
    """(distributed, port serial, tpuvof serial) interiors and the loop
    tests of the port's two solves."""
    nd = len(gshape)
    inv2 = tuple(float(n) ** 2 for n in gshape)
    rhs = torch.as_tensor(_manufactured(gshape))
    interior = (slice(1, -1),) * nd
    serial = omg.mg_solve(torch.zeros([n + 2 for n in gshape], dtype=torch.float64), rhs,
                          inv2, tol, 80, tol_rel=tol_rel)[interior]
    n_serial, loop_tests[0] = loop_tests[0], 0
    spec = MGDecomp(tuple(shards) + (1,) * (nd - len(shards)))
    rhss = _split(rhs, spec)
    ps = [torch.zeros([n + 2 for n in r.shape], dtype=torch.float64) for r in rhss]
    outs = mg_solve_dist(spec, ps, rhss, inv2, tol, 80, tol_rel=tol_rel, gather_volume=gv)
    got = _join([o[interior] for o in outs], spec, gshape)
    return got, serial, _tpuvof_serial(gshape, tol, tol_rel), (loop_tests[0], n_serial)


def _check(got, serial, ref, counts):
    np.testing.assert_allclose(got.numpy(), serial.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    assert counts[0] == counts[1] > 2, counts


@pytest.mark.parametrize("gv", [10**9, 0, 256], ids=["gathered", "sharded", "mixed"])
@pytest.mark.parametrize("shards", [(2, 4), (2, 2)], ids=["2x4", "2x2"])
def test_solve_matches_serial_2d(shards, gv, loop_tests):
    got, serial, ref, counts = _solve(shards, (32, 32), gv, loop_tests)
    _check(got, serial, ref, counts)
    if gv == 10**9:  # gathered at once: the serial solver on the same values
        assert torch.equal(got, serial)


@pytest.mark.parametrize("gv", [10**9, 0, 256], ids=["gathered", "sharded", "mixed"])
@pytest.mark.parametrize("shards", [(2, 4), (4, 1)], ids=["2x4", "4x1"])
def test_solve_matches_serial_3d(shards, gv, loop_tests):
    _check(*_solve(shards, (16, 16, 16), gv, loop_tests))


def test_solve_matches_serial_tolrel(loop_tests):
    """sor_tol_rel's scale is the global max, so the relative stop takes
    the serial trip count."""
    _check(*_solve((2, 4), (32, 32), 256, loop_tests, tol=1e-12, tol_rel=1e-3))


def test_one_cell_thick_blocks(loop_tests):
    """16 blocks of one row each: the fine level sharded, the rest
    gathered (the next level no longer divides the mesh)."""
    got, serial, _, counts = _solve((16, 1), (16, 16), 0, loop_tests)
    np.testing.assert_allclose(got.numpy(), serial.numpy(), rtol=0, atol=ATOL)
    assert counts[0] == counts[1]


def test_non_coarsenable_global_grid_raises():
    """The contract is on the global grid: 6 halves to 3 < 4."""
    spec = MGDecomp((2, 1))
    rhss = _split(torch.as_tensor(_manufactured((6, 6))), spec)
    ps = [torch.zeros(5, 8, dtype=torch.float64) for _ in rhss]
    with pytest.raises(ValueError, match="coarsenable"):
        mg_solve_dist(spec, ps, rhss, (36.0, 36.0), 1e-9, 10)


def test_prolong_and_exchange_on_blocks():
    """The sharded prolongation equals the serial one cut into blocks, bit
    for bit (its shard-boundary planes come from the neighbours), and the
    ghost exchange fills every face ghost and the corners."""
    spec = MGDecomp((2, 4))
    e = torch.as_tensor(np.random.default_rng(1).standard_normal((8, 8)))
    got = pmg._prolong_dist(spec, _split(e, spec))
    for a, b in zip(got, _split(omg._prolong(e), spec)):
        assert torch.equal(a, b)
    full = torch.nn.functional.pad(e, (1, 1, 1, 1))
    for blk, (ci, cj) in zip(pmg._padded(spec, _split(e, spec)), spec.coords):
        want = full[ci * 4:ci * 4 + 6, cj * 2:cj * 2 + 4]
        assert torch.equal(blk, want)
    with pytest.raises(ValueError):
        MGDecomp((2, 0))
