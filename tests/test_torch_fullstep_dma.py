"""The bulk-copy whole-step kernel (tpuvof_torch.kernels: fullstep_dma,
fullstep_dma_plain), counterpart of tpuvof's pallas_fullstep_dma.

tpuvof's DMA kernel computes its window-I/O mono kernel's step bit for bit
and only moves the state otherwise (tests/test_pallas.py pins that), so
the port's plain version is fullstep_plain's computation under its own
name. On the CPU it is held against tpuvof's DMA kernel in interpret mode,
in f64, within 1e-12 of the field's scale (both sides do the same
operations per cell), for one step on grids of n = 29 to 32 (E1 = n + 2 of
every residue modulo 4, the residues the kernel's bulk copies of 16-byte
units see in f32) at n_jacobi 1, 4, 5 and 11 (one Jacobi stage group, the
split's edges, three groups), each grid at every n_jacobi and every
n_jacobi on every grid at both parities (the parities alternate over the
pairs: each interpret-mode call compiles a program of its own, ~2 s), and
for 4 chained steps, on developed, perturbed dam-break states. The
``cuda``-marked test holds the kernel to ``fullstep`` bit for bit on a
card, over the whole product of grids, n_jacobi, parities and dtypes.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from tpuvof_torch.convert import config_from_tpuvof
from tpuvof_torch.kernels import step_kernels as K

N = 32
SIZES = (29, 30, 31, 32)  # E1 = n + 2 = 31, 32, 33, 34: every residue modulo 4
N_JACOBI = (1, 4, 5, 11)  # one stage group, the split's edges, three groups
TOL = 1e-12


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def _t(a):
    return torch.as_tensor(np.array(a, np.float64))


@functools.lru_cache(maxsize=None)
def _state(n):
    """tpuvof's DMA kernel, the n^2 dam break's config, and a developed,
    perturbed, BC-consistent state of it as numpy f64 (developed on the
    port's plain path, which costs no compilation)."""
    import tpuvof as tv
    import tpuvof_torch as tt
    from tpuvof.pallas_kernels.step_kernels import pallas_fullstep_dma
    from tpuvof_torch.ops import apply_bc

    cfg = tv.dam_break_2d(n)
    pc = config_from_tpuvof(cfg)
    s = tt.simulate(pc, tt.init_state(pc, 1, "cpu", torch.float64), 40)
    rng = np.random.default_rng(20)
    F, u, v, p = (a + torch.as_tensor(rng.uniform(-1e-3, 1e-3, a.shape)) for a in s)
    u, v, F, p = apply_bc(u, v, F, p)
    return cfg, pallas_fullstep_dma, tuple(a.numpy() for a in (F, u, v, p))


@pytest.fixture(scope="module")
def ref():
    """_state at N, and the port's config."""
    cfg, dma, arrays = _state(N)
    return cfg, dma, config_from_tpuvof(cfg), arrays


# (n, n_jacobi, even): every grid at every n_jacobi, the parity alternating
# so that each grid and each n_jacobi sees both
CASES = [(n, nj, (a + b) % 2 == 1) for a, n in enumerate(SIZES)
         for b, nj in enumerate(N_JACOBI)]


@pytest.mark.parametrize("n, n_jacobi, even", CASES,
                         ids=[f"n{n}-nj{nj}-{'even' if e else 'odd'}" for n, nj, e in CASES])
def test_fullstep_dma_plain_matches_pallas_fullstep_dma(n, n_jacobi, even):
    cfg, dma, arrays = _state(n)
    cfg = cfg.replace(num=dataclasses.replace(cfg.num, n_jacobi=n_jacobi))
    want = dma(cfg, *arrays, even, interpret=True)
    got = K.fullstep_dma_plain(config_from_tpuvof(cfg), *map(_t, arrays), even)
    for name, g_, w_ in zip("Fuvp", got, want):
        assert _rel(g_, w_) <= TOL, name


def test_fullstep_dma_plain_chained_matches_pallas(ref):
    """4 chained steps with alternating parity, as test_pallas.py chains
    tpuvof's DMA kernel against its mono kernel."""
    cfg, dma, pc, arrays = ref
    want = arrays
    got = tuple(map(_t, arrays))
    for step_i in range(4):
        even = step_i % 2 == 1
        want = dma(cfg, *want, even, interpret=True)
        got = K.fullstep_dma_plain(pc, *got, even)
    for name, g_, w_ in zip("Fuvp", got, want):
        assert _rel(g_, w_) <= TOL, name


@pytest.mark.parametrize("even", [False, True])
def test_fullstep_dma_on_cpu_is_fullstep_and_counts_nothing(ref, even):
    _, _, pc, arrays = ref
    F, u, v, p = map(_t, arrays)
    K.reset_launch_counts()
    for g_, w_ in zip(K.fullstep_dma(pc, F, u, v, p, even), K.fullstep(pc, F, u, v, p, even)):
        assert torch.equal(g_, w_)
    assert all(n == 0 for n in K.LAUNCHES.values())
    assert "fullstep_dma" in K.LAUNCHES


def test_fullstep_dma_on_cpu_takes_any_alignment(ref):
    """The alignment the bulk copies need binds CUDA operands only: a CPU
    view that starts off a 16-byte boundary runs the plain version."""
    _, _, pc, arrays = ref
    shape = arrays[0].shape
    views = []
    for a in arrays:
        buf = torch.empty(a.size + 1, dtype=torch.float64)
        buf[1:] = _t(a).reshape(-1)
        views.append(buf[1:].view(shape))
    assert views[0].data_ptr() % 16 != 0
    for g_, w_ in zip(K.fullstep_dma(pc, *views, True), K.fullstep_plain(pc, *views, True)):
        assert torch.equal(g_, w_)


def test_scratch_cells_of_fullstep_is_five_unpadded_blocks():
    """fullstep's scratch is five blocks of E0 * E1 cells in either dtype
    (fullstep_dma's is laid out by its library: the card test checks it)."""
    for shape in ((31, 31), (32, 32), (33, 33), (34, 34), (7, 5)):
        for dtype in (torch.float32, torch.float64):
            assert K.scratch_cells("fullstep", shape, dtype) == 5 * shape[0] * shape[1]


@pytest.mark.cuda
def test_fullstep_dma_matches_fullstep_on_card():
    """On a card: the kernel equals fullstep bit for bit, f64 and f32,
    both parities, n_jacobi 1, 4, 5 and 11, at n = 29 to 32 (E1 of every
    residue modulo 4: rows whose copies start and end off a 16-byte
    boundary, and fields whose last cells go by thread loads), with the
    outputs on memory filled with NaN first so that a cell never stored
    shows, and the scratch the wrapper allocates as the library lays it
    out (five blocks of at least E0 * E1 cells, each starting on a 16-byte
    boundary); f64 within 1e-12 of its plain version; at 2050^2 in f64
    once (many tiles a CTA, the boxes reused); a misaligned view raises
    ValueError."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import tpuvof_torch as tt
    from tpuvof_torch.ops import apply_bc

    def developed(n, steps):
        plain = tt.dam_break_2d(n, num=tt.Numerics(backend="torch"))
        s = tt.simulate(plain, tt.init_state(plain, 1, "cuda", torch.float64), steps)
        rng = np.random.default_rng(21)
        F, u, v, p = (a + torch.as_tensor(rng.uniform(-1e-3, 1e-3, a.shape), device="cuda")
                      for a in s)
        u, v, F, p = apply_bc(u, v, F, p)
        return F, u, v, p

    cases = [(n, dtype, nj) for n in SIZES for dtype in (torch.float64, torch.float32)
             for nj in N_JACOBI] + [(2048, torch.float64, 10)]
    states = {}
    for n, dtype, nj in cases:
        if n not in states:
            states[n] = developed(n, 30 if n < 100 else 5)
        base = tt.dam_break_2d(n, num=tt.Numerics(backend="cuda_mono"))
        cfg = base.replace(num=dataclasses.replace(base.num, n_jacobi=nj))
        st = [a.to(dtype).contiguous() for a in states[n]]
        cells = K.scratch_cells("fullstep_dma", st[0].shape, dtype)
        block = cells // 5
        assert cells == 5 * block and block >= st[0].numel()
        assert block * st[0].element_size() % 16 == 0
        for even in (False, True):
            want = K.fullstep(cfg, *st, even)
            # the outputs go to a private pool that the same allocations
            # (four fields, then the scratch) filled with NaN
            pool = torch.cuda.MemPool()
            with torch.cuda.use_mem_pool(pool):
                poison = [torch.full_like(st[0], float("nan")) for _ in range(4)]
                poison.append(torch.full((cells,), float("nan"), dtype=dtype, device="cuda"))
                spans = [(t.data_ptr(), t.data_ptr() + t.nbytes) for t in poison]
                del poison
                K.reset_launch_counts()
                got = K.fullstep_dma(cfg, *st, even)
                torch.cuda.synchronize()
            assert K.LAUNCHES["fullstep_dma"] == 1
            for g_ in got:
                assert any(lo <= g_.data_ptr() and g_.data_ptr() + g_.nbytes <= hi
                           for lo, hi in spans), "an output missed the poisoned blocks"
            for name, g_, w_ in zip("Fuvp", got, want):
                assert torch.equal(g_, w_), (n, dtype, nj, even, name)
            if dtype == torch.float64 and n < 100:
                for g_, w_ in zip(got, K.fullstep_dma_plain(cfg, *st, even)):
                    assert _rel(g_.cpu(), w_.cpu()) <= TOL
            del got
    st = [a.float().contiguous() for a in states[SIZES[0]]]
    cfg = tt.dam_break_2d(SIZES[0], num=tt.Numerics(backend="cuda_mono"))
    buf = torch.zeros(st[0].numel() + 1, dtype=torch.float32, device="cuda")
    misaligned = buf[1:].view(st[0].shape)
    with pytest.raises(ValueError):
        K.fullstep_dma(cfg, misaligned, *st[1:], True)
