"""Plain reference of the 3-D two-phase step and the frame's read-back line.

The dam break of taichi-2d-vof's ``3dvof.py``: material mixing, the upwind
momentum predictor with gravity (surface tension inert, as in the source,
whose 3-D normals are switched off: the curvature is zero, so the CSF term
vanishes and is left out), the rhs and a fixed number of Jacobi sweeps of
the Neumann-edged 7-point stencil, the velocity correction, three
Rudman/Zalesak FCT sweeps in the source's istep % 3 rotation, each clamping
F, and the wall BCs (y-faces, then x, then z).

Written from the equations in plain torch, in the state's dtype (float64
for the check, bfloat16 for its control), in the order the solver's plain
path has the operations. A run applies the BCs once at entry; every step
then ends with them.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Flow3D", "SWEEP_ORDER"]

#: The sweep axes of a step whose global index is istep: istep % 3 picks.
SWEEP_ORDER = {0: (0, 1, 2), 1: (1, 2, 0), 2: (2, 0, 1)}


#: Offsets of the four faces of velocity k averaged onto a face of
#: component ax, keyed (ax, k).
_AVERAGE = {
    (0, 1): ((-1, 0, 0), (-1, 1, 0), (0, 0, 0), (0, 1, 0)),
    (0, 2): ((-1, 0, 0), (-1, 0, 1), (0, 0, 0), (0, 0, 1)),
    (1, 0): ((0, -1, 0), (0, 0, 0), (1, -1, 0), (1, 0, 0)),
    (1, 2): ((0, -1, 1), (0, -1, 0), (0, 0, 0), (0, 0, 1)),
    (2, 0): ((1, 0, -1), (0, 0, -1), (1, 0, 0), (0, 0, 0)),
    (2, 1): ((0, 1, -1), (0, 0, -1), (0, 0, 0), (0, 1, 0)),
}


def _spacing(L: float, n: int) -> float:
    xs = np.hstack((0.0, np.linspace(0.0, L, n + 1), L)).astype(np.float32)
    return float(xs[3] - xs[2])


def clamp01(x):
    return torch.where(x < 0.0, 0.0, torch.where(x > 1.0, 1.0, x))


def shift(x, axis: int, d: int):
    """x[.. + d along axis], zero where that lies off the array."""
    out = torch.zeros_like(x)
    n = x.shape[axis]
    src = [slice(None)] * 3
    dst = [slice(None)] * 3
    src[axis] = slice(max(d, 0), n + min(d, 0))
    dst[axis] = slice(max(-d, 0), n + min(-d, 0))
    out[tuple(dst)] = x[tuple(src)]
    return out


def _iota(shape, axis: int, device):
    view = [1, 1, 1]
    view[axis] = shape[axis]
    return torch.arange(shape[axis], device=device).reshape(view)


class Flow3D:
    """The 3-D case of a configuration dict (keys nx, ny, nz, Lx, Ly, Lz,
    dt, n_jacobi, and the fluid's rho_l, rho_g, nu_l, nu_g, gx, gy, gz)."""

    def __init__(self, config: dict):
        if config.get("csf"):
            raise NotImplementedError("the 3-D reference has no surface tension (csf)")
        self.n = (int(config["nx"]), int(config["ny"]), int(config["nz"]))
        self.L = (float(config["Lx"]), float(config["Ly"]), float(config["Lz"]))
        self.dt = float(config["dt"])
        self.n_jacobi = int(config["n_jacobi"])
        fl = config["fluid"]
        self.rho_l, self.rho_g = float(fl["rho_l"]), float(fl["rho_g"])
        self.nu_l, self.nu_g = float(fl["nu_l"]), float(fl["nu_g"])
        self.g = (float(fl["gx"]), float(fl["gy"]), float(fl["gz"]))
        self.d = tuple(_spacing(L, n) for L, n in zip(self.L, self.n))
        self.di = tuple(1.0 / d for d in self.d)

    @staticmethod
    def bc_(u, v, w, F, p):
        """Walls in place: y-faces, then x, then z."""
        for a in (u, w, F, p):
            a[:, 0, :] = a[:, 1, :]
            a[:, -1, :] = a[:, -2, :]
        v[:, 1, :] = 0.0
        v[:, -1, :] = 0.0
        u[1, :, :] = 0.0
        u[-1, :, :] = 0.0
        for a in (v, w, F, p):
            a[0, :, :] = a[1, :, :]
            a[-1, :, :] = a[-2, :, :]
        for a in (u, v, F, p):
            a[:, :, 0] = a[:, :, 1]
            a[:, :, -1] = a[:, :, -2]
        w[:, :, 1] = 0.0
        w[:, :, -1] = 0.0

    def mix(self, F):
        Fc = clamp01(F)
        rho = self.rho_g * (1.0 - Fc) + self.rho_l * Fc
        nu = self.nu_l * Fc + self.nu_g * (1.0 - Fc)
        return rho, nu

    def _component(self, ax: int, vel, rho, nu):
        """The predicted component along ``ax`` on faces [2, n] along ax and
        the interior across it; zero elsewhere."""
        lo = [1, 1, 1]
        lo[ax] = 2
        win = tuple(slice(lo[a], self.n[a] + 1) for a in range(3))

        def at(a, off):
            return a[tuple(slice(lo[k] + off[k], self.n[k] + 1 + off[k]) for k in range(3))]

        def e(k, s):
            o = [0, 0, 0]
            o[k] = s
            return o

        c = at(vel[ax], (0, 0, 0))
        dxi = self.di
        terms = None
        for k in range(3):
            lap = nu[win] * (at(vel[ax], e(k, -1)) - 2 * c + at(vel[ax], e(k, 1))) * dxi[k] ** 2
            terms = lap if terms is None else terms + lap
        adv = []
        for k in range(3):
            if k == ax:
                here = c
            else:
                # the k-velocity averaged onto this face, from the four
                # faces around it, summed in the order the source has them
                a0, a1, a2, a3 = (at(vel[k], o) for o in _AVERAGE[ax, k])
                here = 0.25 * (a0 + a1 + a2 + a3)
            der = torch.where(here > 0, (c - at(vel[ax], e(k, -1))) * dxi[k],
                              (at(vel[ax], e(k, 1)) - c) * dxi[k])
            adv.append((here, der))
        for here, der in adv:
            terms = terms - here * der
        val = c + self.dt * (terms + self.g[ax])
        out = torch.zeros_like(vel[ax])
        out[win] = val
        return out

    def coefficients(self, dtype, device):
        """(ae, aw, an, as, af, ab, 1/ap) on the interior; 1/ap from the
        float64 edge classes in ((((ae+aw)+an)+as)+ab)+af order."""
        c2 = [float(np.float64(d) ** 2) for d in self.di]
        idx = [_iota(self.n, a, device) for a in range(3)]

        def c(x):
            return torch.full((), x, dtype=dtype, device=device)

        out = []
        for a in range(3):
            out.append(torch.where(idx[a] == self.n[a] - 1, c(0.0), c(c2[a])))
            out.append(torch.where(idx[a] == 0, c(0.0), c(c2[a])))

        def diag(ex, ey, ez):
            t = np.float64(c2[0]) if ex else np.float64(c2[0]) + np.float64(c2[0])
            for _ in range(2 - ey):
                t = t + np.float64(c2[1])
            for _ in range(2 - ez):
                t = t + np.float64(c2[2])
            return float(-1.0 / t)

        edge = [(idx[a] == 0) | (idx[a] == self.n[a] - 1) for a in range(3)]
        ap_inv = torch.where(
            edge[0],
            torch.where(edge[1], torch.where(edge[2], c(diag(1, 1, 1)), c(diag(1, 1, 0))),
                        torch.where(edge[2], c(diag(1, 0, 1)), c(diag(1, 0, 0)))),
            torch.where(edge[1], torch.where(edge[2], c(diag(0, 1, 1)), c(diag(0, 1, 0))),
                        torch.where(edge[2], c(diag(0, 0, 1)), c(diag(0, 0, 0)))))
        out.append(ap_inv)
        return out

    def pressure(self, p, stars, rho):
        I = (slice(1, -1),) * 3
        us, vs, ws = stars
        dxi, dyi, dzi = self.di
        rhs = rho[I] / self.dt * ((us[2:, 1:-1, 1:-1] - us[I]) * dxi
                                  + (vs[1:-1, 2:, 1:-1] - vs[I]) * dyi
                                  + (ws[1:-1, 1:-1, 2:] - ws[I]) * dzi)
        co = self.coefficients(p.dtype, p.device)
        p = p.clone()

        def window(ax, lo, hi):
            return tuple(slice(lo, hi) if k == ax else slice(1, -1) for k in range(3))

        for _ in range(self.n_jacobi):
            acc = rhs
            for ax in range(3):
                acc = acc - co[2 * ax] * p[window(ax, 2, None)] \
                    - co[2 * ax + 1] * p[window(ax, 0, -2)]
            p[I] = acc * co[6]
        return p

    def correct(self, vel, stars, p, rho):
        out = []
        for ax in range(3):
            lo = [1, 1, 1]
            lo[ax] = 2
            win = tuple(slice(lo[k], self.n[k] + 1) for k in range(3))
            back = tuple(slice(lo[k] - (k == ax), self.n[k] + 1 - (k == ax)) for k in range(3))
            r = (rho[win] + rho[back]) * 0.5
            val = stars[ax][win] - self.dt / r * (p[win] - p[back]) * self.di[ax]
            a = vel[ax].clone()
            a[win] = val
            out.append(a)
        return out

    def _scales(self, axis: int):
        dx, dy, dz = self.d
        vol = dx * dy * dz
        if axis == 0:
            return vol, dy * dz, dy * dz / vol, dx, dy
        if axis == 1:
            return vol, dx * dz, dy / (dx * dy), dx, dy
        return vol, dx * dy, dy * dx / vol, dz, dz

    def sweep(self, F, vel, axis: int):
        """One FCT sweep along ``axis`` with the source's literal scale
        factors; positions off the interior keep F."""
        vol, dv_area, flux_scale, q_scale, final_div = self._scales(axis)
        dev, dt = F.device, self.dt
        idx = _iota(F.shape, axis, dev)
        if axis == 0:
            j, k = _iota(F.shape, 1, dev), _iota(F.shape, 2, dev)
            o_int = (j >= 1) & (j <= self.n[1]) & (k >= 1) & (k <= self.n[2])
        else:
            other = 2 if axis == 1 else 1
            io = _iota(F.shape, other, dev)
            o_int = (io >= 1) & (io <= self.n[other])

        def sh(x, d):
            return shift(x, axis, d)

        zero = torch.zeros((), dtype=F.dtype, device=dev)
        F_up = sh(F, -1)
        fL = vel * dt * torch.where(vel >= 0, F_up, F)
        fH = vel * dt * torch.where(vel <= 0, F_up, F)
        face = (idx >= 1) & o_int
        a = torch.where(face, fH - fL, zero)
        dv = vol - dt * dv_area * (sh(vel, 1) - vel)
        ftd = clamp01((F + (fL - sh(fL, 1)) * flux_scale) * vol / dv)
        int_m = (idx >= 1) & (idx <= self.n[axis]) & o_int
        Ftd = torch.where(int_m, ftd, zero)
        fmax = torch.maximum(Ftd, torch.maximum(sh(Ftd, -1), sh(Ftd, 1)))
        fmin = torch.minimum(Ftd, torch.minimum(sh(Ftd, -1), sh(Ftd, 1)))
        a_hi = sh(a, 1)
        pp = torch.maximum(zero, a) - torch.minimum(zero, a_hi)
        qp = (fmax - Ftd) * q_scale
        rp = torch.where(int_m & (pp > 0),
                         torch.clamp_max(qp / torch.where(pp > 0, pp, 1.0), 1.0), zero)
        pm = torch.maximum(zero, a_hi) - torch.minimum(zero, a)
        qm = (Ftd - fmin) * q_scale
        rm = torch.where(int_m & (pm > 0),
                         torch.clamp_max(qm / torch.where(pm > 0, pm, 1.0), 1.0), zero)
        cf = torch.where(face, torch.where(a >= 0, torch.minimum(rp, sh(rm, -1)),
                                           torch.minimum(sh(rp, -1), rm)), zero)
        corr = (sh(a, 1) * sh(cf, 1) - a * cf) / final_div
        out = torch.where(int_m, clamp01(Ftd - corr * vol / dv), F)
        out[0] = F[0]
        out[-1] = F[-1]
        return out

    def step(self, state, istep: int):
        """One lean step (global index istep) from BC-consistent ghosts."""
        F, u, v, w, p = state
        rho, nu = self.mix(F)
        vel = (u, v, w)
        stars = [self._component(ax, vel, rho, nu) for ax in range(3)]
        p = self.pressure(p, stars, rho)
        u, v, w = self.correct(vel, stars, p, rho)
        for ax in SWEEP_ORDER[istep % 3]:
            F = self.sweep(F, (u, v, w)[ax], ax)
        F = clamp01(F)
        self.bc_(u, v, w, F, p)
        return F, u, v, w, p

    def advance(self, state, n_steps: int, istep0: int):
        """``n_steps`` steps after global step ``istep0``, BCs at entry."""
        F, u, v, w, p = (a.clone() for a in state)
        self.bc_(u, v, w, F, p)
        state = (F, u, v, w, p)
        for k in range(n_steps):
            state = self.step(state, istep0 + 1 + k)
        return state

    @staticmethod
    def readback(F, dtype=torch.float64) -> dict:
        """The frame line's numbers: liquid mass over the interior and the
        range of F, computed in ``dtype``."""
        F = F.to(dtype)
        return {"mass": float(F[1:-1, 1:-1, 1:-1].sum()), "min": float(F.min()),
                "max": float(F.max())}
