"""Plain reference of the 2-D two-phase step, the CFL report, the frame's
metrics and the vof frame.

The dam break of taichi-2d-vof's ``2dvof.py`` on a staggered MAC grid with
one ghost ring: material mixing, Youngs normals and curvature (CSF surface
tension), the upwind momentum predictor, the rhs and a fixed number of
Jacobi sweeps of the Neumann-edged 5-point Poisson stencil, the velocity
correction, two Rudman/Zalesak FCT sweeps in the order the step's parity
gives (odd steps x then y), the clamp of F to [0, 1] and the wall BCs.

Written from the equations in plain torch, in whatever dtype the state
has (float64 for the check, bfloat16 for its control). The operations are
in the order the solver's plain path has them, so in float64 the two agree
to rounding. A run advances from a state with the BCs applied once at
entry; each step then ends with them (the lean step).

Everything is worked out from the configuration dict and the state: grid
spacing, coefficients, masks and colour table.
"""
from __future__ import annotations

import numpy as np
import torch

from .colours import blues

__all__ = ["Flow2D"]


def _nodes(L: float, n: int) -> np.ndarray:
    """Node coordinates with duplicated endpoints, float32, as the grid
    convention of the configuration defines them."""
    return np.hstack((0.0, np.linspace(0.0, L, n + 1), L)).astype(np.float32)


def _spacing(L: float, n: int) -> float:
    xs = _nodes(L, n)
    return float(xs[3] - xs[2])


def clamp01(x):
    return torch.where(x < 0.0, 0.0, torch.where(x > 1.0, 1.0, x))


def _pad(x):
    return torch.nn.functional.pad(x, (1, 1, 1, 1))


class Flow2D:
    """The 2-D case of a configuration dict (keys nx, ny, Lx, Ly, dt,
    n_jacobi, and the fluid's rho_l, rho_g, nu_l, nu_g, sigma, gx, gy)."""

    def __init__(self, config: dict):
        self.nx, self.ny = int(config["nx"]), int(config["ny"])
        self.Lx, self.Ly = float(config["Lx"]), float(config["Ly"])
        self.dt = float(config["dt"])
        self.n_jacobi = int(config["n_jacobi"])
        fl = config["fluid"]
        self.rho_l, self.rho_g = float(fl["rho_l"]), float(fl["rho_g"])
        self.nu_l, self.nu_g = float(fl["nu_l"]), float(fl["nu_g"])
        self.sigma, self.gx, self.gy = float(fl["sigma"]), float(fl["gx"]), float(fl["gy"])
        self.dx = _spacing(self.Lx, self.nx)
        self.dy = _spacing(self.Ly, self.ny)
        self.dxi, self.dyi = 1.0 / self.dx, 1.0 / self.dy

    # ---- boundary conditions -------------------------------------------
    @staticmethod
    def bc_(u, v, F, p, rho=None):
        """Walls in place: y-boundaries first, then x (corner order)."""
        scalars = (F, p) if rho is None else (F, p, rho)
        u[:, 0] = u[:, 1]
        u[:, -1] = u[:, -2]
        v[:, 1] = 0.0
        v[:, -1] = 0.0
        for a in scalars:
            a[:, 0] = a[:, 1]
            a[:, -1] = a[:, -2]
        u[1, :] = 0.0
        u[-1, :] = 0.0
        v[0, :] = v[1, :]
        v[-1, :] = v[-2, :]
        for a in scalars:
            a[0, :] = a[1, :]
            a[-1, :] = a[-2, :]

    # ---- the step's parts ----------------------------------------------
    def mix(self, F):
        Fc = clamp01(F)
        rho = self.rho_g * (1.0 - Fc) + self.rho_l * Fc
        nu = self.nu_l * Fc + self.nu_g * (1.0 - Fc)
        return rho, nu

    def curvature(self, F):
        """kappa = -div(n) of the normalised Youngs normals, zero ghosts."""
        I = slice(1, -1)

        def f(di, dj):
            return F[1 + di:F.shape[0] - 1 + di, 1 + dj:F.shape[1] - 1 + dj]

        a = 1.0 / (2.0 * self.dx)
        b = 1.0 / (2.0 * self.dy)
        mx1 = -a * (f(1, 1) + f(1, 0) - f(0, 1) - f(0, 0))
        my1 = -b * (f(1, 1) - f(1, 0) + f(0, 1) - f(0, 0))
        mx2 = -a * (f(1, 0) + f(1, -1) - f(0, 0) - f(0, -1))
        my2 = -b * (f(1, 0) - f(1, -1) + f(0, 0) - f(0, -1))
        mx3 = -a * (f(0, 0) + f(0, -1) - f(-1, 0) - f(-1, -1))
        my3 = -b * (f(0, 0) - f(0, -1) + f(-1, 0) - f(-1, -1))
        mx4 = -a * (f(0, 1) + f(0, 0) - f(-1, 1) - f(-1, 0))
        my4 = -b * (f(0, 1) - f(0, 0) + f(-1, 1) - f(-1, 0))
        mxs = (mx1 + mx2 + mx3 + mx4) * 0.25
        mys = (my1 + my2 + my3 + my4) * 0.25
        degenerate = (torch.abs(mxs) < 1e-10) & (torch.abs(mys) < 1e-10)
        mag = torch.sqrt(torch.where(degenerate, 1.0, mxs * mxs + mys * mys))
        mx = _pad(torch.where(degenerate, mxs, mxs / mag))
        my = _pad(torch.where(degenerate, mys, mys / mag))
        kap = -(a * (mx[2:, I] - mx[:-2, I]) + b * (my[I, 2:] - my[I, :-2]))
        return _pad(kap)

    def predict(self, u, v, F, rho, nu, kappa):
        """(u*, v*), zero outside u on i in [2, nx] and v on j in [2, ny]."""
        dt, dxi, dyi, n0, n1 = self.dt, self.dxi, self.dyi, self.nx, self.ny

        def w(a, di=0, dj=0):
            return a[1 + di:n0 + 1 + di, 1 + dj:n1 + 1 + dj]

        uc = w(u)
        vh = 0.25 * (w(v, -1, 0) + w(v, -1, 1) + w(v) + w(v, 0, 1))
        dudx = torch.where(uc > 0, (uc - w(u, -1, 0)) * dxi, (w(u, 1, 0) - uc) * dxi)
        dudy = torch.where(vh > 0, (uc - w(u, 0, -1)) * dyi, (w(u, 0, 1) - uc) * dyi)
        kav = (w(kappa) + w(kappa, -1, 0)) * 0.5
        fx = -self.sigma * (w(F) - w(F, -1, 0)) * kav / self.dx
        nuc = w(nu)
        us = uc + dt * (
            nuc * (w(u, -1, 0) - 2.0 * uc + w(u, 1, 0)) * dxi**2
            + nuc * (w(u, 0, -1) - 2.0 * uc + w(u, 0, 1)) * dyi**2
            - uc * dudx - vh * dudy + self.gx
            + fx * 2.0 / (w(rho) + w(rho, -1, 0)))

        vc = w(v)
        uh = 0.25 * (w(u, 0, -1) + w(u) + w(u, 1, -1) + w(u, 1, 0))
        dvdx = torch.where(uh > 0, (vc - w(v, -1, 0)) * dxi, (w(v, 1, 0) - vc) * dxi)
        dvdy = torch.where(vc > 0, (vc - w(v, 0, -1)) * dyi, (w(v, 0, 1) - vc) * dyi)
        kav = (w(kappa) + w(kappa, 0, -1)) * 0.5
        fy = -self.sigma * (w(F) - w(F, 0, -1)) * kav / self.dy
        vs = vc + dt * (
            nuc * (w(v, -1, 0) - 2.0 * vc + w(v, 1, 0)) * dxi**2
            + nuc * (w(v, 0, -1) - 2.0 * vc + w(v, 0, 1)) * dyi**2
            - uh * dvdx - vc * dvdy + self.gy
            + fy * 2.0 / (w(rho) + w(rho, 0, -1)))
        u_star = torch.zeros_like(u)
        v_star = torch.zeros_like(v)
        u_star[2:n0 + 1, 1:n1 + 1] = us[1:, :]
        v_star[1:n0 + 1, 2:n1 + 1] = vs[:, 1:]
        return u_star, v_star

    def coefficients(self, dtype, device):
        """(ae, aw, an, as, 1/ap) of the Neumann-edged 5-point stencil on the
        interior; 1/ap from float64 edge classes, in ((ae+aw)+an)+as order."""
        dxi2 = float(np.float64(self.dxi) ** 2)
        dyi2 = float(np.float64(self.dyi) ** 2)
        i = torch.arange(self.nx, device=device).reshape(-1, 1)
        j = torch.arange(self.ny, device=device).reshape(1, -1)

        def c(x):
            return torch.full((), x, dtype=dtype, device=device)

        ae = torch.where(i == self.nx - 1, c(0.0), c(dxi2))
        aw = torch.where(i == 0, c(0.0), c(dxi2))
        an = torch.where(j == self.ny - 1, c(0.0), c(dyi2))
        a_s = torch.where(j == 0, c(0.0), c(dyi2))

        def diag(x_edge, y_edge):
            t = np.float64(dxi2) if x_edge else np.float64(dxi2) + np.float64(dxi2)
            for _ in range(2 - y_edge):
                t = t + np.float64(dyi2)
            return float(-1.0 / t)

        ex = (i == 0) | (i == self.nx - 1)
        ey = (j == 0) | (j == self.ny - 1)
        ap_inv = torch.where(ex, torch.where(ey, c(diag(1, 1)), c(diag(1, 0))),
                             torch.where(ey, c(diag(0, 1)), c(diag(0, 0))))
        return ae, aw, an, a_s, ap_inv

    def pressure(self, p, u_star, v_star, rho):
        """rhs = rho/dt div(u*), then n_jacobi out-of-place Jacobi sweeps."""
        I = slice(1, -1)
        rhs = rho[I, I] / self.dt * ((u_star[2:, I] - u_star[I, I]) * self.dxi
                                     + (v_star[I, 2:] - v_star[I, I]) * self.dyi)
        ae, aw, an, a_s, ap_inv = self.coefficients(p.dtype, p.device)
        p = p.clone()
        for _ in range(self.n_jacobi):
            p[I, I] = (rhs - ae * p[2:, I] - aw * p[:-2, I]
                       - an * p[I, 2:] - a_s * p[I, :-2]) * ap_inv
        return p

    def correct(self, u, v, u_star, v_star, p, rho):
        dt, n0, n1 = self.dt, self.nx, self.ny

        def w(a, di=0, dj=0):
            return a[1 + di:n0 + 1 + di, 1 + dj:n1 + 1 + dj]

        ui = w(u_star) - dt / ((w(rho) + w(rho, -1, 0)) * 0.5) * (w(p) - w(p, -1, 0)) * self.dxi
        vi = w(v_star) - dt / ((w(rho) + w(rho, 0, -1)) * 0.5) * (w(p) - w(p, 0, -1)) * self.dyi
        u = u.clone()
        v = v.clone()
        u[2:n0 + 1, 1:n1 + 1] = ui[1:, :]
        v[1:n0 + 1, 2:n1 + 1] = vi[:, 1:]
        return u, v

    def _sweep0(self, da: float, db: float, F, u):
        """One FCT sweep along axis 0; ghosts of F kept."""
        dt = self.dt
        uf = u[1:, 1:-1]
        f_up, f_dn = F[:-1, 1:-1], F[1:, 1:-1]
        fL = uf * dt * torch.where(uf >= 0, f_up, f_dn)
        fH = uf * dt * torch.where(uf <= 0, f_up, f_dn)
        a = torch.nn.functional.pad(fH - fL, (1, 1, 1, 0))
        Fc = F[1:-1, 1:-1]
        dv = da * db - dt * db * (uf[1:] - uf[:-1])
        ftd = clamp01((Fc + (fL[:-1] - fL[1:]) * db / (da * db)) * da * db / dv)
        Ftd = _pad(ftd)
        fmax = torch.maximum(Ftd[1:-1, 1:-1], torch.maximum(Ftd[:-2, 1:-1], Ftd[2:, 1:-1]))
        fmin = torch.minimum(Ftd[1:-1, 1:-1], torch.minimum(Ftd[:-2, 1:-1], Ftd[2:, 1:-1]))
        a_lo, a_hi = a[1:-1, 1:-1], a[2:, 1:-1]
        zero = torch.zeros((), dtype=F.dtype, device=F.device)
        one = torch.ones((), dtype=F.dtype, device=F.device)
        pp = torch.maximum(zero, a_lo) - torch.minimum(zero, a_hi)
        qp = (fmax - ftd) * da
        rp = torch.where(pp > 0.0, torch.minimum(one, qp / torch.where(pp > 0.0, pp, 1.0)), 0.0)
        pm = torch.maximum(zero, a_hi) - torch.minimum(zero, a_lo)
        qm = (ftd - fmin) * da
        rm = torch.where(pm > 0.0, torch.minimum(one, qm / torch.where(pm > 0.0, pm, 1.0)), 0.0)
        rp, rm = _pad(rp), _pad(rm)
        af = a[1:, 1:-1]
        cf = torch.where(af >= 0, torch.minimum(rp[1:, 1:-1], rm[:-1, 1:-1]),
                         torch.minimum(rp[:-1, 1:-1], rm[1:, 1:-1]))
        c = torch.nn.functional.pad(cf, (1, 1, 1, 0))
        corr = (a[2:, 1:-1] * c[2:, 1:-1] - a[1:-1, 1:-1] * c[1:-1, 1:-1]) / db
        out = F.clone()
        out[1:-1, 1:-1] = clamp01(ftd - corr * da * db / dv)
        return out

    def advect(self, F, u, v, even: bool):
        """The double sweep: even steps y then x, odd steps x then y. The y
        sweep is the x sweep of the transposed fields (square cells)."""
        def sx(F):
            return self._sweep0(self.dx, self.dy, F, u)

        def sy(F):
            return self._sweep0(self.dy, self.dx, F.T, v.T).T.contiguous()

        return sx(sy(F)) if even else sy(sx(F))

    def step(self, state, even: bool):
        """One lean step from a state whose ghosts hold the walls' values."""
        F, u, v, p = state
        rho, nu = self.mix(F)
        kappa = self.curvature(F)
        u_star, v_star = self.predict(u, v, F, rho, nu, kappa)
        p = self.pressure(p, u_star, v_star, rho)
        u, v = self.correct(u, v, u_star, v_star, p, rho)
        F = clamp01(self.advect(F, u, v, even))
        self.bc_(u, v, F, p)
        return F, u, v, p

    def advance(self, state, n_steps: int, istep0: int, track_cfl: bool = False,
                probe=None):
        """``n_steps`` steps after global step ``istep0``: BCs at entry, then
        lean steps whose parity continues the global counter (the first
        step taken is istep0 + 1; odd steps sweep x first). Returns the
        state, and with ``track_cfl`` the Courant report: the largest
        signed u dt/dx or v dt/dy after any step, its 1-based global step
        and face (the first largest entry; u where u and v tie), the count
        of (face, step) pairs above 0.25 and the step of the first. ``probe`` =
        (global step, axis 'u' or 'v', i, j) also returns the Courant
        number at that face after that step."""
        F, u, v, p = (a.clone() for a in state)
        self.bc_(u, v, F, p)
        state = (F, u, v, p)
        best, where, count, first, at_probe = -float("inf"), None, 0, None, None
        for k in range(n_steps):
            istep = istep0 + 1 + k
            state = self.step(state, even=istep % 2 == 0)
            if track_cfl:
                cu = state[1] * (self.dt * self.dxi)
                cv = state[2] * (self.dt * self.dyi)
                ku, kv = int(torch.argmax(cu)), int(torch.argmax(cv))
                mu, mv = float(cu.reshape(-1)[ku]), float(cv.reshape(-1)[kv])
                m, axis, kk = (mv, "v", kv) if mv > mu else (mu, "u", ku)
                if m > best:
                    best = m
                    where = (istep, axis, kk // cu.shape[1], kk % cu.shape[1])
                nv = int((cu > 0.25).sum()) + int((cv > 0.25).sum())
                if count == 0 and nv > 0:
                    first = istep
                count += nv
                if probe is not None and probe[0] == istep:
                    field = cu if probe[1] == "u" else cv
                    at_probe = float(field[probe[2], probe[3]])
        if not track_cfl:
            return state
        return state, {"cfl": best, "step": where[0], "axis": where[1], "i": where[2],
                       "j": where[3], "violations": count, "first_step": first,
                       "at_probe": at_probe}

    # ---- frame outputs -------------------------------------------------
    def metrics(self, state, dtype=torch.float64) -> dict:
        """Mass of liquid, largest |u| and |v|, their Courant numbers and the
        largest |div u| over the interior, computed in ``dtype``, as host
        numbers."""
        F, u, v, p = (a.to(dtype) for a in state)
        I = slice(1, -1)
        mu, mv = u.abs().max(), v.abs().max()
        div = (u[2:, I] - u[I, I]) * self.dxi + (v[I, 2:] - v[I, I]) * self.dyi
        return {"mass": float(F[I, I].sum()), "max_u": float(mu), "max_v": float(mv),
                "cfl_u": float(mu * self.dt * self.dxi), "cfl_v": float(mv * self.dt * self.dyi),
                "max_div": float(div.abs().max())}

    def vof_image(self, F) -> np.ndarray:
        """The vof frame as a PNG holds it: (2 ny, 2 nx, 3) uint8 rows from
        the top. Cell (i, j) of F[:nx, :ny] fills a 2x2 block; its colour is
        entry int(clamp(255 F, 0, 255)) of the Blues table."""
        idx = self.vof_index(F)
        rgb = (np.clip(blues()[idx], 0.0, 1.0) * 255).astype(np.uint8)
        return rgb

    def vof_index(self, F) -> np.ndarray:
        """The colour-table index of every pixel of the vof frame, laid out
        as ``vof_image``."""
        f = F[: self.nx, : self.ny].double().cpu().numpy()
        idx = np.clip(f * 255.0, 0.0, 255.0).astype(np.int32)
        idx = idx.repeat(2, axis=0).repeat(2, axis=1)
        return np.ascontiguousarray(idx.T[::-1])
