"""The bulk-copy whole-step kernel (tpuvof_torch.kernels: fullstep_dma,
fullstep_dma_plain), counterpart of tpuvof's pallas_fullstep_dma.

tpuvof's DMA kernel computes its window-I/O mono kernel's step bit for bit
and only moves the state otherwise (tests/test_pallas.py pins that), so
the port's plain version is fullstep_plain's computation under its own
name. On the CPU it is held against tpuvof's DMA kernel in interpret mode,
in f64, within 1e-12 of the field's scale (both sides do the same
operations per cell), for one step of either parity and for 4 chained
steps, on the developed, perturbed 32^2 dam-break state of
test_torch_fullstep.py. The ``cuda``-marked test holds the kernel to
``fullstep`` bit for bit and to its plain version on a card.
"""
import numpy as np
import pytest
import torch

from tpuvof_torch.convert import config_from_tpuvof
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
    """tpuvof's DMA kernel, the port's config, and a developed, perturbed,
    BC-consistent 32^2 dam-break state as numpy f64."""
    import jax.numpy as jnp

    import tpuvof as tv
    from tpuvof.ops import apply_bc
    from tpuvof.pallas_kernels.step_kernels import pallas_fullstep_dma

    cfg = tv.dam_break_2d(N)
    s0 = tv.State(*(jnp.asarray(a, jnp.float64) for a in tv.init_state(cfg, ic=1)))
    s = tv.simulate(cfg, s0, 40)
    rng = np.random.default_rng(20)
    F, u, v, p = (np.asarray(a) + rng.uniform(-1e-3, 1e-3, a.shape) for a in s)
    u, v, F, p = (np.asarray(a) for a in apply_bc(*map(jnp.asarray, (u, v, F, p))))
    return cfg, pallas_fullstep_dma, config_from_tpuvof(cfg), (F, u, v, p)


@pytest.mark.parametrize("even", [False, True])
def test_fullstep_dma_plain_matches_pallas_fullstep_dma(ref, even):
    cfg, dma, pc, arrays = ref
    want = dma(cfg, *arrays, even, interpret=True)
    got = K.fullstep_dma_plain(pc, *map(_t, arrays), even)
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


@pytest.mark.cuda
def test_fullstep_dma_matches_fullstep_on_card():
    """On a card: the kernel equals fullstep bit for bit, f64 and f32,
    both parities, at 64^2 and 63^2 (65^2 = 4225 cells, not a multiple of
    4: the ragged tail goes by plain stores), with the outputs on memory
    filled with NaN first so that a chunk never stored shows; f64 within
    1e-12 of its plain version; a misaligned view raises ValueError."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import tpuvof_torch as tt
    from tpuvof_torch.ops import apply_bc

    for n in (64, 63):
        plain = tt.dam_break_2d(n, num=tt.Numerics(backend="torch"))
        s = tt.simulate(plain, tt.init_state(plain, 1, "cuda", torch.float64), 30)
        rng = np.random.default_rng(21)
        F, u, v, p = (a + torch.as_tensor(rng.uniform(-1e-3, 1e-3, a.shape), device="cuda")
                      for a in s)
        u, v, F, p = apply_bc(u, v, F, p)
        cfg = tt.dam_break_2d(n, num=tt.Numerics(backend="cuda_mono"))
        for dtype in (torch.float64, torch.float32):
            st = [a.to(dtype).contiguous() for a in (F, u, v, p)]
            for even in (False, True):
                want = K.fullstep(cfg, *st, even)
                # the outputs go to a private pool that the same allocations
                # (four fields, then the (7,) + shape scratch) filled with NaN
                pool = torch.cuda.MemPool()
                with torch.cuda.use_mem_pool(pool):
                    poison = [torch.full_like(st[0], float("nan")) for _ in range(4)]
                    poison.append(torch.full((7,) + tuple(st[0].shape), float("nan"),
                                             dtype=dtype, device="cuda"))
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
                    assert torch.equal(g_, w_), (n, dtype, even, name)
                if dtype == torch.float64:
                    for g_, w_ in zip(got, K.fullstep_dma_plain(cfg, *st, even)):
                        assert _rel(g_.cpu(), w_.cpu()) <= TOL
                del got
        shape = st[0].shape
        buf = torch.zeros(st[0].numel() + 1, dtype=torch.float32, device="cuda")
        misaligned = buf[1:].view(shape)
        with pytest.raises(ValueError):
            K.fullstep_dma(cfg, misaligned, *st[1:], True)
