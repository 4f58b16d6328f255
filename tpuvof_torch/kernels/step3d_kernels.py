"""The hand-written kernels of the 3-D step: wrappers and plain versions.

Counterpart of tpuvof/pallas_kernels/step3d.py and jacobi3d.py (file:line
of each ``pallas_call`` site):

  =============  ===================  ==============================================
  wrapper        CUDA source          replaces
  =============  ===================  ==============================================
  predict3d_rhs  csrc/predict3d.cu    pallas_predict3d_rhs (step3d.py:520)
  correct3d      csrc/correct3d.cu    pallas_correct3d (step3d.py:672)
  fct3d_sweep    csrc/fct3d.cu        pallas_fct3d_sweep (step3d.py:908, :929)
  jacobi3d       csrc/jacobi3d.cu     pallas_jacobi_3d (jacobi3d.py:456),
                                      streamed_jacobi_3d (jacobi3d.py:418)
  =============  ===================  ==============================================

Fields are (n0, n1, nz+2) tensors whose local plane l holds global
i-index gi_base + l and whose local row m holds global j-index
gj_base + m: the whole grid is gi_base = 0, n0 = nx+2, n1 = ny+2; an
i-slab (tpuvof's nloc, gi_base) has n0 = nloc+2; an (x, y) pencil (tpuvof's
pencil mode, njl and gj_base) also has n1 = njl+2. A block is exact beyond
the stencil's reach of its edges and junk by contract nearer; every mask
is global, so a pencil's y-wall rows sit mid-block on a y-edge shard and
nowhere on an interior one. ``njl=None`` means the whole j range
(n1 = ny+2, gj_base = 0); ``njl`` given is the pencil mode, and it alone
selects the kernels' pencil instantiation, the same way for all four. Of
the four functions only the sweep computes something else on a pencil
(its in-plane sweeps also mask by global i); the others' masks already
take global j, and they take ``njl`` so that every kernel takes one block
origin, which the wrappers check against the block's rows.
tpuvof pads a pencil's planes to its (8, 128) tiling; the port's blocks
are unpadded.

A wrapper given CPU tensors runs the plain PyTorch version beside it and
counts nothing. Given CUDA tensors it checks them, allocates its outputs
and scratch with ``torch.empty``, launches on the current stream without
synchronising, adds the number of kernels it launched to its entry of
``LAUNCHES`` (``jacobi3d`` one per launch of ``jacobi3d_plan(n_iter)``,
each running several iterations; ``predict3d_rhs`` two with csf, the
curvature pre-pass and the predictor; the others one), and raises if a
launch is refused; it never falls back to the plain version. Its spans
(``tv.wrap.<name>``, ``tv.launch.<name>``) and first-launch seconds are
the 2-D wrappers' (step_kernels.py), through the same launch helper.

The plain versions state what the kernels compute, the lean step's
semantics included: the BC fix of the velocities inside predict, the
zeroed planes and positions off the update ranges, the Jacobi's zeroed
ghost ring and the last sweep's fresh mirrors. Reads past an array's edge
are 0 on both sides (ops/fct3d.shift3).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..config import Fluid
from ..grid import Grid3D
from ..ops.fct3d import axis_scales, shift3, sweep3d
from ..ops.materials import mix_properties
from ..ops.normals3d import normalize_normals_3d, young_msum_3d
from ..ops.poisson import ap_inv_3d, poisson_constants_3d
from .build import load_library
from .step_kernels import _checked, _doubles, _launch, _on_cpu

__all__ = [
    "LAUNCHES",
    "reset_launch_counts",
    "predict3d_rhs",
    "correct3d",
    "fct3d_sweep",
    "jacobi3d",
    "jacobi3d_plan",
    "jacobi3d_geometry",
    "JACOBI_LEVELS",
    "predict3d_rhs_plain",
    "correct3d_plain",
    "fct3d_sweep_plain",
    "jacobi3d_plain",
]

#: Kernel launches per wrapper since the last reset (CUDA tensors only).
LAUNCHES = {name: 0 for name in ("predict3d_rhs", "jacobi3d", "correct3d", "fct3d_sweep")}


#: Jacobi iterations one launch of jacobi3d runs at most (1 to the
#: kernel's kLevelsMax, 5, csrc/jacobi3d.cu): 4 took the least time for the
#: step's 10 iterations at 200^3 f32 (scripts/torch_ab3d.py times every
#: depth).
JACOBI_LEVELS = 4


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def jacobi3d_plan(n_iter: int) -> tuple[int, ...]:
    """The Jacobi iterations of each launch of ``jacobi3d``:
    ceil(n_iter / JACOBI_LEVELS) launches of near-equal depth, the deeper
    ones first (10 -> (4, 3, 3), 7 -> (4, 3), 12 -> (4, 4, 4))."""
    n_iter = int(n_iter)
    if n_iter < 1:
        raise ValueError(f"jacobi3d needs n_iter >= 1, not {n_iter}")
    n_launch = -(-n_iter // JACOBI_LEVELS)
    depth, deeper = divmod(n_iter, n_launch)
    return tuple(depth + 1 if i < deeper else depth for i in range(n_launch))


def jacobi3d_geometry(shape, nlev: int, dtype=torch.float32, pencil: bool = False) -> dict:
    """How ``jacobi3d`` launches at ``nlev`` levels a launch on the current
    card for a block of ``shape`` (n0, n1, nz+2), from the kernel library
    (a CUDA card only): its CTA (``threads``, shared bytes ``smem``, CTAs
    ``resident`` an SM), each thread's ``run`` of k positions, the region
    (``rows`` x ``cols``) and its owned part (``own_rows`` x ``own_cols``,
    ``owned_share`` of it), the ``grid`` of CTAs (along k, j, l), the planes
    a ``chunk``, and ``computed_over_owned``: the cell-levels its threads
    compute, every region position at every step of every chunk and its
    halo, over the block's."""
    lib = load_library()
    suffix = "_f32" if dtype == torch.float32 else "_f64"
    shape_out = (ctypes.c_int * 8)()
    grid_out = (ctypes.c_int * 4)()
    ratio = ctypes.c_double()
    n0, n1, n2 = (int(n) for n in shape)
    for rc in (getattr(lib, "tv_jacobi3d_shape" + suffix)(int(pencil), nlev, shape_out),
               getattr(lib, "tv_jacobi3d_grid" + suffix)(n0, n1, n2, int(pencil), nlev,
                                                         grid_out, ctypes.byref(ratio))):
        if rc != 0:
            raise RuntimeError(f"jacobi3d_geometry({tuple(shape)}, {nlev}): "
                               f"{lib.tv_error_string(rc).decode()}")
    threads, smem, resident, run, rows, cols, own_cols, own_rows = shape_out
    return {"threads": threads, "smem": smem, "resident": resident, "run": run,
            "rows": rows, "cols": cols, "own_rows": own_rows, "own_cols": own_cols,
            "owned_share": own_rows * own_cols / (rows * cols),
            "grid": tuple(grid_out[:3]), "chunk": grid_out[3],
            "computed_over_owned": ratio.value}


@functools.lru_cache(maxsize=32)
def _levels_array(plan: tuple[int, ...]):
    return (ctypes.c_int * len(plan))(*plan)


# ----------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------
def _iota(shape, axis, device, start=0):
    view = [1, 1, 1]
    view[axis] = shape[axis]
    return (torch.arange(shape[axis], device=device) + start).reshape(view)


def bc_fix_uvw(g: Grid3D, u, v, w, gi, gj_base: int = 0):
    """u, v, w as set_BC (y, then x, then z faces) would leave them, from
    their interior values (tpuvof's _bc_fix_uvw); ``gi`` is the global
    i-index of each plane, ``gj_base`` the global j-index of row 0."""
    j = _iota(u.shape, 1, u.device, gj_base)
    k = _iota(u.shape, 2, u.device)
    jm, km, im = g.ny + 1, g.nz + 1, g.nx + 1
    zero = torch.zeros((), dtype=u.dtype, device=u.device)

    def ymirror(x):
        x = torch.where(j == 0, shift3(x, 0, 1, 0), x)
        return torch.where(j == jm, shift3(x, 0, -1, 0), x)

    def zmirror(x):
        x = torch.where(k == 0, shift3(x, 0, 0, 1), x)
        return torch.where(k == km, shift3(x, 0, 0, -1), x)

    def imirror(x):
        x = torch.where(gi == 0, shift3(x, 1, 0, 0), x)
        return torch.where(gi == im, shift3(x, -1, 0, 0), x)

    u = zmirror(torch.where((gi == 1) | (gi == im), zero, ymirror(u)))
    v = zmirror(imirror(torch.where((j == 1) | (j == jm), zero, v)))
    w = torch.where((k == 1) | (k == km), zero, imirror(ymirror(w)))
    return u, v, w


def _curvature_block(g: Grid3D, F, m_int):
    """kappa of the csf predictor on a block (tpuvof's fused normals and
    curvature, _predict_block): zero off the global interior."""
    zero = torch.zeros((), dtype=F.dtype, device=F.device)
    shifted = {}

    def f(di, dj, dk):
        if (di, dj, dk) not in shifted:
            shifted[di, dj, dk] = shift3(F, di, dj, dk)
        return shifted[di, dj, dk]

    ms = [torch.where(m_int, m, zero) for m in young_msum_3d(f, g.dx, g.dy, g.dz)]
    mx, my, mz = (torch.where(m_int, m, zero) for m in normalize_normals_3d(*ms))
    kappa = -(
        (shift3(mx, 1, 0, 0) - shift3(mx, -1, 0, 0)) / (2.0 * g.dx)
        + (shift3(my, 0, 1, 0) - shift3(my, 0, -1, 0)) / (2.0 * g.dy)
        + (shift3(mz, 0, 0, 1) - shift3(mz, 0, 0, -1)) / (2.0 * g.dz)
    )
    return torch.where(m_int, kappa, zero)


def predict3d_rhs_plain(g: Grid3D, fl: Fluid, dt, u, v, w, F, csf: bool = False,
                        gi_base: int = 0, njl: int | None = None, gj_base: int = 0):
    """(u*, v*, w*, rhs) of the lean step (tpuvof's _predict_kernel): the
    BC fix, rho/nu, the upwind predictor (with csf, normals, curvature and
    the sigma terms), the projection rhs; zero off the update ranges and
    on the first and last planes."""
    dev = F.device
    shape = F.shape
    dxi, dyi, dzi = g.dxi, g.dyi, g.dzi
    gi = _iota(shape, 0, dev, gi_base)
    j = _iota(shape, 1, dev, gj_base)
    k = _iota(shape, 2, dev)
    j_int = (j >= 1) & (j <= g.ny)
    k_int = (k >= 1) & (k <= g.nz)
    i_int = (gi >= 1) & (gi <= g.nx)
    zero = torch.zeros((), dtype=F.dtype, device=dev)

    u, v, w = bc_fix_uvw(g, u, v, w, gi, gj_base)
    rho, nu = mix_properties(fl, F)
    if csf:
        kappa = _curvature_block(g, F, i_int & j_int & k_int)

    def U(di=0, dj=0, dk=0):
        return shift3(u, di, dj, dk)

    def V(di=0, dj=0, dk=0):
        return shift3(v, di, dj, dk)

    def W(di=0, dj=0, dk=0):
        return shift3(w, di, dj, dk)

    # ---- u* ----
    v_here = 0.25 * (V(-1, 0, 0) + V(-1, 1, 0) + V(0, 0, 0) + V(0, 1, 0))
    w_here = 0.25 * (W(-1, 0, 0) + W(-1, 0, 1) + W(0, 0, 0) + W(0, 0, 1))
    dudx = torch.where(u > 0, (u - U(-1, 0, 0)) * dxi, (U(1, 0, 0) - u) * dxi)
    dudy = torch.where(v_here > 0, (u - U(0, -1, 0)) * dyi, (U(0, 1, 0) - u) * dyi)
    dudz = torch.where(w_here > 0, (u - U(0, 0, -1)) * dzi, (U(0, 0, 1) - u) * dzi)
    acc_u = (
        nu * (U(-1, 0, 0) - 2 * u + U(1, 0, 0)) * dxi**2
        + nu * (U(0, -1, 0) - 2 * u + U(0, 1, 0)) * dyi**2
        + nu * (U(0, 0, -1) - 2 * u + U(0, 0, 1)) * dzi**2
        - u * dudx - v_here * dudy - w_here * dudz
        + fl.gx
    )
    if csf:
        kap = (kappa + shift3(kappa, -1, 0, 0)) * 0.5
        fx = -fl.sigma * (F - shift3(F, -1, 0, 0)) * kap / g.dx
        acc_u = acc_u + fx * 2 / (rho + shift3(rho, -1, 0, 0))
    us = torch.where((gi >= 2) & (gi <= g.nx) & j_int & k_int, u + dt * acc_u, zero)

    # ---- v* ----
    u_here = 0.25 * (U(0, -1, 0) + U(0, 0, 0) + U(1, -1, 0) + U(1, 0, 0))
    w_here = 0.25 * (W(0, -1, 1) + W(0, -1, 0) + W(0, 0, 0) + W(0, 0, 1))
    dvdx = torch.where(u_here > 0, (v - V(-1, 0, 0)) * dxi, (V(1, 0, 0) - v) * dxi)
    dvdy = torch.where(v > 0, (v - V(0, -1, 0)) * dyi, (V(0, 1, 0) - v) * dyi)
    dvdz = torch.where(w_here > 0, (v - V(0, 0, -1)) * dzi, (V(0, 0, 1) - v) * dzi)
    acc_v = (
        nu * (V(-1, 0, 0) - 2 * v + V(1, 0, 0)) * dxi**2
        + nu * (V(0, -1, 0) - 2 * v + V(0, 1, 0)) * dyi**2
        + nu * (V(0, 0, -1) - 2 * v + V(0, 0, 1)) * dzi**2
        - u_here * dvdx - v * dvdy - w_here * dvdz
        + fl.gy
    )
    if csf:
        kap = (kappa + shift3(kappa, 0, -1, 0)) * 0.5
        fy = -fl.sigma * (F - shift3(F, 0, -1, 0)) * kap / g.dy
        acc_v = acc_v + fy * 2 / (rho + shift3(rho, 0, -1, 0))
    vs = torch.where(i_int & (j >= 2) & (j <= g.ny) & k_int, v + dt * acc_v, zero)

    # ---- w* ----
    u_here = 0.25 * (U(1, 0, -1) + U(0, 0, -1) + U(1, 0, 0) + U(0, 0, 0))
    v_here = 0.25 * (V(0, 1, -1) + V(0, 0, -1) + V(0, 0, 0) + V(0, 1, 0))
    dwdx = torch.where(u_here > 0, (w - W(-1, 0, 0)) * dxi, (W(1, 0, 0) - w) * dxi)
    dwdy = torch.where(v_here > 0, (w - W(0, -1, 0)) * dyi, (W(0, 1, 0) - w) * dyi)
    dwdz = torch.where(w > 0, (w - W(0, 0, -1)) * dzi, (W(0, 0, 1) - w) * dzi)
    acc_w = (
        nu * (W(-1, 0, 0) - 2 * w + W(1, 0, 0)) * dxi**2
        + nu * (W(0, -1, 0) - 2 * w + W(0, 1, 0)) * dyi**2
        + nu * (W(0, 0, -1) - 2 * w + W(0, 0, 1)) * dzi**2
        - u_here * dwdx - v_here * dwdy - w * dwdz
        + fl.gz
    )
    if csf:
        kap = (kappa + shift3(kappa, 0, 0, -1)) * 0.5
        fz = -fl.sigma * (F - shift3(F, 0, 0, -1)) * kap / g.dz
        acc_w = acc_w + fz * 2 / (rho + shift3(rho, 0, 0, -1))
    ws = torch.where(i_int & j_int & (k >= 2) & (k <= g.nz), w + dt * acc_w, zero)

    # ---- projection rhs: u* at i+1 etc., exactly zero past the ranges ----
    rhs = rho / dt * (
        (shift3(us, 1, 0, 0) - us) * dxi
        + (shift3(vs, 0, 1, 0) - vs) * dyi
        + (shift3(ws, 0, 0, 1) - ws) * dzi
    )
    rhs = torch.where(i_int & j_int & k_int, rhs, zero)
    outs = (us, vs, ws, rhs)
    for a in outs:
        a[0] = 0.0
        a[-1] = 0.0
    return outs


def correct3d_plain(g: Grid3D, fl: Fluid, dt, u_star, v_star, w_star, p, F,
                    gi_base: int = 0, njl: int | None = None, gj_base: int = 0):
    """(u, v, w) = u* - dt/rho_face * grad p on the update ranges, zero
    everywhere else (tpuvof's _correct_kernel)."""
    dev = F.device
    shape = F.shape
    gi = _iota(shape, 0, dev, gi_base)
    j = _iota(shape, 1, dev, gj_base)
    k = _iota(shape, 2, dev)
    i_int = (gi >= 1) & (gi <= g.nx)
    j_int = (j >= 1) & (j <= g.ny)
    k_int = (k >= 1) & (k <= g.nz)
    zero = torch.zeros((), dtype=F.dtype, device=dev)
    rho, _ = mix_properties(fl, F)
    u = u_star - dt / ((rho + shift3(rho, -1, 0, 0)) * 0.5) * (
        p - shift3(p, -1, 0, 0)) * g.dxi
    v = v_star - dt / ((rho + shift3(rho, 0, -1, 0)) * 0.5) * (
        p - shift3(p, 0, -1, 0)) * g.dyi
    w = w_star - dt / ((rho + shift3(rho, 0, 0, -1)) * 0.5) * (
        p - shift3(p, 0, 0, -1)) * g.dzi
    outs = (torch.where((gi >= 2) & (gi <= g.nx) & j_int & k_int, u, zero),
            torch.where(i_int & (j >= 2) & (j <= g.ny) & k_int, v, zero),
            torch.where(i_int & j_int & (k >= 2) & (k <= g.nz), w, zero))
    for a in outs:
        a[0] = 0.0
        a[-1] = 0.0
    return outs


def mirror_jk(g: Grid3D, x, gj_base: int = 0):
    """F's ghost mirrors in set_BC's y-then-z order (tpuvof's _mirror_jk);
    returns a new tensor. The y mirrors are written at the global walls
    only (row m holds global j gj_base + m), mid-block on a pencil's y-edge
    shard; a source row off the array reads 0. tpuvof also bounds them to
    rows <= njl+1 to keep its pad rows zero: the port's blocks end there."""
    x = x.clone()
    n1 = x.shape[1]
    for wall, src in ((0, 1), (g.ny + 1, g.ny)):
        m, ms = wall - gj_base, src - gj_base
        if 0 <= m < n1:
            x[:, m, :] = x[:, ms, :] if 0 <= ms < n1 else 0.0
    x[:, :, 0] = x[:, :, 1]
    x[:, :, g.nz + 1] = x[:, :, g.nz]
    return x


def fct3d_sweep_plain(g: Grid3D, dt, F, vel, axis: int, mirror_out: bool = False,
                      gi_base: int = 0, njl: int | None = None, gj_base: int = 0):
    """F after one sweep along ``axis`` (0, 1, 2 = x, y, z; vel = u, v, w).
    The first and last planes carry the input's (stale) ghosts through, or
    with ``mirror_out`` (the step's last sweep) the output is given fresh
    j/k mirrors and those planes copy their neighbours (tpuvof's
    _mirror_jk and _ghost_planes_out). A pencil (``njl`` given) is swept
    by the two-axis-masked body (ops/fct3d.sweep_masked_2axis)."""
    out = sweep3d(g, dt, F, vel, axis, gi_base, None if njl is None else gj_base)
    if mirror_out:
        out = mirror_jk(g, out, gj_base)
        out[0] = out[1]
        out[-1] = out[-2]
    return out


def _ghost_mask(g: Grid3D, shape, device, gi_base: int, gj_base: int):
    """The block's edge planes and rows and every position at or beyond a
    global wall (tpuvof's ghost ring, with a pencil's block-edge rows)."""
    gi = _iota(shape, 0, device, gi_base)
    l = _iota(shape, 0, device)
    gj = _iota(shape, 1, device, gj_base)
    m = _iota(shape, 1, device)
    k = _iota(shape, 2, device)
    return ((l == 0) | (l == shape[0] - 1) | (gi <= 0) | (gi >= g.nx + 1)
            | (m == 0) | (m == shape[1] - 1) | (gj <= 0) | (gj >= g.ny + 1)
            | (k == 0) | (k >= g.nz + 1))


def jacobi3d_plain(g: Grid3D, n_iter: int, p, rhs, gi_base: int = 0,
                   njl: int | None = None, gj_base: int = 0):
    """``n_iter`` exact Jacobi iterations with the ghost ring held at zero
    (tpuvof's pallas_jacobi_3d and streamed_jacobi_3d); returns a new p
    whose ghost ring is zero."""
    dev, dtype = p.device, p.dtype
    ghost = _ghost_mask(g, p.shape, dev, gi_base, gj_base)
    (cx, cy, cz), classes = poisson_constants_3d(g)
    gi = _iota(p.shape, 0, dev, gi_base)
    j = _iota(p.shape, 1, dev, gj_base)
    k = _iota(p.shape, 2, dev)
    ap_inv = ap_inv_3d(classes, (gi == 1) | (gi == g.nx), (j == 1) | (j == g.ny),
                       (k == 1) | (k == g.nz), dtype, dev)

    def c(x):
        return torch.full((), x, dtype=dtype, device=dev)

    cx, cy, cz = c(cx), c(cy), c(cz)
    zero = c(0.0)
    p = torch.where(ghost, zero, p)
    for _ in range(n_iter):
        val = (rhs
               - cx * shift3(p, 1, 0, 0) - cx * shift3(p, -1, 0, 0)
               - cy * shift3(p, 0, 1, 0) - cy * shift3(p, 0, -1, 0)
               - cz * shift3(p, 0, 0, 1) - cz * shift3(p, 0, 0, -1)) * ap_inv
        p = torch.where(ghost, zero, val)
    return p


# ----------------------------------------------------------------------
# kernel constants: computed in double exactly as the JAX package folds
# them, cast to the kernel's type in C. The order is the C side's.
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=32)
def _predict3d_constants(g: Grid3D, fl: Fluid, dt: float):
    return _doubles([fl.rho_l, fl.rho_g, fl.nu_l, fl.nu_g, dt, g.dxi, g.dyi, g.dzi,
                     g.dxi**2, g.dyi**2, g.dzi**2, fl.gx, fl.gy, fl.gz, -fl.sigma,
                     g.dx, g.dy, g.dz, 4.0 * g.dx, 4.0 * g.dy, 4.0 * g.dz,
                     2.0 * g.dx, 2.0 * g.dy, 2.0 * g.dz])


@functools.lru_cache(maxsize=32)
def _correct3d_constants(g: Grid3D, fl: Fluid, dt: float):
    return _doubles([fl.rho_l, fl.rho_g, dt, g.dxi, g.dyi, g.dzi])


@functools.lru_cache(maxsize=32)
def _sweep3d_constants(g: Grid3D, dt: float, axis: int):
    vol, dv_area, flux_scale, q_scale, final_div = axis_scales(g, axis)
    return _doubles([dt, vol, dt * dv_area, flux_scale, q_scale, final_div])


@functools.lru_cache(maxsize=32)
def _jacobi3d_constants(g: Grid3D):
    (cx, cy, cz), classes = poisson_constants_3d(g)
    return _doubles([cx, cy, cz] + [classes[e >> 2, (e >> 1) & 1, e & 1] for e in range(8)])


# ----------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------
def _field_shape(name: str, g: Grid3D, t: torch.Tensor, njl: int | None, gj_base: int):
    """(n0, n1, nz+2) of the whole grid, an i-slab (n1 = ny+2) or a pencil
    (n1 = njl+2). A pencil must hold a global interior row: the kernels
    then find every wall's mirror row in the array."""
    if njl is None and gj_base != 0:
        raise ValueError(f"{name}: gj_base={gj_base} needs a pencil's njl")
    n1 = g.ny + 2 if njl is None else int(njl) + 2
    if not (gj_base <= g.ny and gj_base + n1 - 1 >= 1):
        raise ValueError(f"{name}: a pencil of rows {gj_base}..{gj_base + n1 - 1} "
                         f"holds no interior row of 1..{g.ny}")
    if t.dim() != 3 or t.shape[0] < 3 or tuple(t.shape[1:]) != (n1, g.nz + 2):
        raise ValueError(f"{name}: a field is (n0 >= 3, {n1}, {g.nz + 2}), "
                         f"not {tuple(t.shape)}")
    return tuple(t.shape)


def _vol(shape, g: Grid3D, gi_base: int, njl: int | None, gj_base: int):
    """The entry points' block arguments: extents, origin, the pencil flag
    (njl given; it alone picks the kernels' pencil instantiation) and the
    grid."""
    return (shape[0], shape[1], int(gi_base), int(gj_base), int(njl is not None),
            g.nx, g.ny, g.nz)


def predict3d_rhs(g: Grid3D, fl: Fluid, dt, u, v, w, F, csf: bool = False,
                  gi_base: int = 0, njl: int | None = None, gj_base: int = 0):
    """(u*, v*, w*, rhs) of the lean step; counterpart of tpuvof's
    pallas_predict3d_rhs. With csf a curvature pre-pass kernel runs first,
    in the same call."""
    shape = _field_shape("predict3d_rhs", g, F, njl, gj_base)
    if _on_cpu(F):
        return predict3d_rhs_plain(g, fl, dt, u, v, w, F, csf, gi_base, njl, gj_base)
    return _launch(LAUNCHES, "predict3d_rhs", _predict3d_call,
                   (g, fl, dt, u, v, w, F, csf, shape, gi_base, njl, gj_base))


def _predict3d_call(g, fl, dt, u, v, w, F, csf, shape, gi_base, njl, gj_base):
    lib, fn, stream = _checked("predict3d", shape, u, v, w, F)
    outs = [torch.empty_like(F) for _ in range(4)]
    kappa = torch.empty_like(F) if csf else None
    c_args = (u.data_ptr(), v.data_ptr(), w.data_ptr(), F.data_ptr(),
              None if kappa is None else kappa.data_ptr(),
              *(o.data_ptr() for o in outs), *_vol(shape, g, gi_base, njl, gj_base),
              _predict3d_constants(g, fl, float(dt)), stream)
    return lib, fn, c_args, tuple(outs), 2 if csf else 1


def correct3d(g: Grid3D, fl: Fluid, dt, u_star, v_star, w_star, p, F, gi_base: int = 0,
              njl: int | None = None, gj_base: int = 0):
    """(u, v, w) after the velocity correction, zero off the update
    ranges; counterpart of tpuvof's pallas_correct3d."""
    shape = _field_shape("correct3d", g, F, njl, gj_base)
    if _on_cpu(F):
        return correct3d_plain(g, fl, dt, u_star, v_star, w_star, p, F, gi_base, njl,
                               gj_base)
    return _launch(LAUNCHES, "correct3d", _correct3d_call,
                   (g, fl, dt, u_star, v_star, w_star, p, F, shape, gi_base, njl, gj_base))


def _correct3d_call(g, fl, dt, u_star, v_star, w_star, p, F, shape, gi_base, njl, gj_base):
    lib, fn, stream = _checked("correct3d", shape, u_star, v_star, w_star, p, F)
    outs = [torch.empty_like(F) for _ in range(3)]
    c_args = (u_star.data_ptr(), v_star.data_ptr(), w_star.data_ptr(), p.data_ptr(),
              F.data_ptr(), *(o.data_ptr() for o in outs),
              *_vol(shape, g, gi_base, njl, gj_base),
              _correct3d_constants(g, fl, float(dt)), stream)
    return lib, fn, c_args, tuple(outs), 1


def fct3d_sweep(g: Grid3D, dt, F, vel, axis: int, mirror_out: bool = False,
                gi_base: int = 0, njl: int | None = None, gj_base: int = 0):
    """F after one FCT sweep along ``axis`` (0, 1, 2 with vel = u, v, w);
    ``mirror_out`` for the step's last sweep. Counterpart of tpuvof's
    pallas_fct3d_sweep."""
    if axis not in (0, 1, 2):
        raise ValueError(f"axis must be 0, 1 or 2, not {axis}")
    shape = _field_shape("fct3d_sweep", g, F, njl, gj_base)
    if _on_cpu(F):
        return fct3d_sweep_plain(g, dt, F, vel, axis, mirror_out, gi_base, njl, gj_base)
    return _launch(LAUNCHES, "fct3d_sweep", _fct3d_call,
                   (g, dt, F, vel, axis, mirror_out, shape, gi_base, njl, gj_base))


def _fct3d_call(g, dt, F, vel, axis, mirror_out, shape, gi_base, njl, gj_base):
    lib, fn, stream = _checked("fct3d", shape, F, vel)
    out = torch.empty_like(F)
    c_args = (F.data_ptr(), vel.data_ptr(), out.data_ptr(),
              *_vol(shape, g, gi_base, njl, gj_base), axis, int(bool(mirror_out)),
              _sweep3d_constants(g, float(dt), axis), stream)
    return lib, fn, c_args, out, 1


def jacobi3d(g: Grid3D, n_iter: int, p, rhs, gi_base: int = 0, njl: int | None = None,
             gj_base: int = 0):
    """p after ``n_iter`` >= 1 Jacobi iterations, with a zeroed ghost ring;
    one launch per entry of ``jacobi3d_plan(n_iter)``, each running its
    iterations in shared memory. Counterpart of tpuvof's pallas_jacobi_3d
    and streamed_jacobi_3d, which compute the same iteration."""
    plan = jacobi3d_plan(n_iter)
    shape = _field_shape("jacobi3d", g, p, njl, gj_base)
    if _on_cpu(p):
        return jacobi3d_plain(g, n_iter, p, rhs, gi_base, njl, gj_base)
    return _launch(LAUNCHES, "jacobi3d", _jacobi3d_call,
                   (g, plan, p, rhs, shape, gi_base, njl, gj_base))


def _jacobi3d_call(g, plan, p, rhs, shape, gi_base, njl, gj_base):
    lib, fn, stream = _checked("jacobi3d", shape, p, rhs)
    out = torch.empty_like(p)
    tmp = torch.empty_like(p) if len(plan) > 1 else out
    c_args = (p.data_ptr(), rhs.data_ptr(), out.data_ptr(), tmp.data_ptr(),
              *_vol(shape, g, gi_base, njl, gj_base), len(plan), _levels_array(plan),
              _jacobi3d_constants(g), stream)
    return lib, fn, c_args, out, len(plan)
