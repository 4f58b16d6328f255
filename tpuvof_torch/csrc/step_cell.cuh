// Per-cell bodies of the 2-D step, shared by every 2-D kernel (predict.cu,
// project.cu, fct_sweep.cu, fullstep.cu, fullstep_dma.cu).
//
// Every function computes one cell of one stage on a Block: a row-major
// (E0, E1) array whose (0, 0) sits at global index (oi, oj) of a grid with
// nx x ny interior cells. Each stage's arithmetic is written once, in a
// function ``*_of`` that reads its fields through accessors: A(di, dj) is
// the field at (i + di, j + dj), zero outside the block and the global
// domain. The kernels call them on shared-memory tiles (stage_groups.cuh,
// phase_tiles.cuh, step_groups.cuh).
// A kernel on the whole grid is the case oi = oj = 0,
// (E0, E1) = (nx+2, ny+2). Masks are taken at global indices,
// and ld() zeroes every value outside the global ghost-included domain
// (tpuvof's load sanitizer, step_kernels.py:472-482, 836-851) and past the
// block's own edges, whose values feed only the block's junk margin.
//
// The arithmetic follows the Pallas bodies (step_kernels.py:_predict_body,
// _inline_poisson_coeffs, _project_kernel, _sweep_body) term by term and in
// their order, and the library is built with --fmad=false, so every kernel
// that evaluates these functions rounds as the plain PyTorch versions do.
#pragma once

#include "common.cuh"

namespace tv {

struct Block {
  int E0, E1;  // the block's extents
  int oi, oj;  // global index of its (0, 0)
  int nx, ny;  // the grid's interior extents

  __device__ __forceinline__ bool inside(int i, int j) const {
    return i >= 0 && i < E0 && j >= 0 && j < E1;
  }
  // global box [r0, r1) x [c0, c1)
  __device__ __forceinline__ bool region(int i, int j, int r0, int r1, int c0,
                                         int c1) const {
    const int gi = i + oi, gj = j + oj;
    return gi >= r0 && gi < r1 && gj >= c0 && gj < c1;
  }
  __device__ __forceinline__ bool domain(int i, int j) const {
    return region(i, j, 0, nx + 2, 0, ny + 2);
  }
  __device__ __forceinline__ bool interior(int i, int j) const {
    return region(i, j, 1, nx + 1, 1, ny + 1);
  }
};

// a[i, j], or 0 outside the block or outside the global domain.
template <typename T>
__device__ __forceinline__ T ld(const T* __restrict__ a, const Block& b, int i,
                                int j) {
  return b.inside(i, j) && b.domain(i, j) ? a[i * b.E1 + j] : T(0);
}

// ---- predict: materials, Youngs normals, curvature, momentum ----

template <typename T>
struct PredictParams {
  T rho_l, rho_g, nu_l, nu_g;
  T neg_inv2dx, neg_inv2dy, inv2dx, inv2dy;
  T dt, dxi, dyi, dxi2, dyi2;
  T neg_sigma, dx, dy, gx, gy;
};

// The order of c[] is kernels/step_kernels.py:_predict_constants.
template <typename T>
PredictParams<T> predict_params(const double* c) {
  PredictParams<T> q;
  q.rho_l = T(c[0]);
  q.rho_g = T(c[1]);
  q.nu_l = T(c[2]);
  q.nu_g = T(c[3]);
  q.neg_inv2dx = T(c[4]);
  q.neg_inv2dy = T(c[5]);
  q.inv2dx = T(c[6]);
  q.inv2dy = T(c[7]);
  q.dt = T(c[8]);
  q.dxi = T(c[9]);
  q.dyi = T(c[10]);
  q.dxi2 = T(c[11]);
  q.dyi2 = T(c[12]);
  q.neg_sigma = T(c[13]);
  q.dx = T(c[14]);
  q.dy = T(c[15]);
  q.gx = T(c[16]);
  q.gy = T(c[17]);
  return q;
}

// Youngs normal of a cell of the global interior: the mean of the four
// corner gradients, normalized unless both components are below 1e-10.
template <typename T, class A>
__device__ __forceinline__ void normal_of(const A& f, const PredictParams<T>& q, T& mx,
                                          T& my) {
  const T mx1 = q.neg_inv2dx * (f(1, 1) + f(1, 0) - f(0, 1) - f(0, 0));
  const T my1 = q.neg_inv2dy * (f(1, 1) - f(1, 0) + f(0, 1) - f(0, 0));
  const T mx2 = q.neg_inv2dx * (f(1, 0) + f(1, -1) - f(0, 0) - f(0, -1));
  const T my2 = q.neg_inv2dy * (f(1, 0) - f(1, -1) + f(0, 0) - f(0, -1));
  const T mx3 = q.neg_inv2dx * (f(0, 0) + f(0, -1) - f(-1, 0) - f(-1, -1));
  const T my3 = q.neg_inv2dy * (f(0, 0) - f(0, -1) + f(-1, 0) - f(-1, -1));
  const T mx4 = q.neg_inv2dx * (f(0, 1) + f(0, 0) - f(-1, 1) - f(-1, 0));
  const T my4 = q.neg_inv2dy * (f(0, 1) - f(0, 0) + f(-1, 1) - f(-1, 0));
  const T mxsum = (mx1 + mx2 + mx3 + mx4) * T(0.25);
  const T mysum = (my1 + my2 + my3 + my4) * T(0.25);
  const bool degenerate = fabs(mxsum) < T(1e-10) && fabs(mysum) < T(1e-10);
  const T mag_sq = mxsum * mxsum + mysum * mysum;
  const T safe_mag = sqrt(degenerate ? T(1) : mag_sq);
  mx = degenerate ? mxsum : quot(mxsum, safe_mag);
  my = degenerate ? mysum : quot(mysum, safe_mag);
}

// kappa = -div(normal) at a cell of the global interior, from the normals
// of its four neighbours.
template <typename T>
__device__ __forceinline__ T curvature_of(T mx_e, T mx_w, T my_n, T my_s,
                                          const PredictParams<T>& q) {
  return -(q.inv2dx * (mx_e - mx_w) + q.inv2dy * (my_n - my_s));
}

// u* on global rows [2, nx+1) x cols [1, ny+1), v* on [1, nx+1) x
// [2, ny+1), 0 elsewhere; kappa is curvature_of's field.
template <typename T, class A>
__device__ __forceinline__ void momentum_of(const A& U, const A& V, const A& Fv, const A& K,
                                            const Block& b, int i, int j,
                                            const PredictParams<T>& q, T& us, T& vs) {
  us = T(0);
  vs = T(0);
  if (!b.interior(i, j)) return;
  const T rho_c = mix_rho(Fv(0, 0), q.rho_l, q.rho_g);
  const T nu_c = mix_nu(Fv(0, 0), q.nu_l, q.nu_g);
  if (i + b.oi >= 2) {
    const T uc = U(0, 0);
    const T v_here = T(0.25) * (V(-1, 0) + V(-1, 1) + V(0, 0) + V(0, 1));
    const T dudx = uc > T(0) ? (uc - U(-1, 0)) * q.dxi : (U(1, 0) - uc) * q.dxi;
    const T dudy = v_here > T(0) ? (uc - U(0, -1)) * q.dyi : (U(0, 1) - uc) * q.dyi;
    const T kap_u = (K(0, 0) + K(-1, 0)) * T(0.5);
    const T fx_kappa = quot(q.neg_sigma * (Fv(0, 0) - Fv(-1, 0)) * kap_u, q.dx);
    const T rho_w = mix_rho(Fv(-1, 0), q.rho_l, q.rho_g);
    us = uc + q.dt * (nu_c * (U(-1, 0) - T(2) * uc + U(1, 0)) * q.dxi2 +
                      nu_c * (U(0, -1) - T(2) * uc + U(0, 1)) * q.dyi2 -
                      uc * dudx - v_here * dudy + q.gx +
                      quot(fx_kappa * T(2), rho_c + rho_w));
  }
  if (j + b.oj >= 2) {
    const T vc = V(0, 0);
    const T u_here = T(0.25) * (U(0, -1) + U(0, 0) + U(1, -1) + U(1, 0));
    const T dvdx = u_here > T(0) ? (vc - V(-1, 0)) * q.dxi : (V(1, 0) - vc) * q.dxi;
    const T dvdy = vc > T(0) ? (vc - V(0, -1)) * q.dyi : (V(0, 1) - vc) * q.dyi;
    const T kap_v = (K(0, 0) + K(0, -1)) * T(0.5);
    const T fy_kappa = quot(q.neg_sigma * (Fv(0, 0) - Fv(0, -1)) * kap_v, q.dy);
    const T rho_s = mix_rho(Fv(0, -1), q.rho_l, q.rho_g);
    vs = vc + q.dt * (nu_c * (V(-1, 0) - T(2) * vc + V(1, 0)) * q.dxi2 +
                      nu_c * (V(0, -1) - T(2) * vc + V(0, 1)) * q.dyi2 -
                      u_here * dvdx - vc * dvdy + q.gy +
                      quot(fy_kappa * T(2), rho_c + rho_s));
  }
}

// ---- projection: rhs, Jacobi, correction ----

template <typename T>
struct ProjectParams {
  T rho_l, rho_g, dt, dxi, dyi, dxi2, dyi2;
  T ap_inv[2][2];  // [on an x-edge][on a y-edge]
};

// The order of c[] is kernels/step_kernels.py:_project_constants.
template <typename T>
ProjectParams<T> project_params(const double* c) {
  ProjectParams<T> q;
  q.rho_l = T(c[0]);
  q.rho_g = T(c[1]);
  q.dt = T(c[2]);
  q.dxi = T(c[3]);
  q.dyi = T(c[4]);
  q.dxi2 = T(c[5]);
  q.dyi2 = T(c[6]);
  q.ap_inv[0][0] = T(c[7]);
  q.ap_inv[0][1] = T(c[8]);
  q.ap_inv[1][0] = T(c[9]);
  q.ap_inv[1][1] = T(c[10]);
  return q;
}

// rhs = rho/dt * div(u*) at a cell of the global interior.
template <typename T, class A>
__device__ __forceinline__ T rhs_of(const A& F, const A& us, const A& vs,
                                    const ProjectParams<T>& q) {
  const T rho = mix_rho(F(0, 0), q.rho_l, q.rho_g);
  return rho / q.dt * ((us(1, 0) - us(0, 0)) * q.dxi + (vs(0, 1) - vs(0, 0)) * q.dyi);
}

// One Jacobi update of a cell of the global interior; the edge
// coefficients are zero on the global walls and ap_inv is picked from the
// four edge-class constants (_inline_poisson_coeffs).
template <typename T, class A>
__device__ __forceinline__ T jacobi_of(const A& src, T rhs, const Block& b, int i, int j,
                                       const ProjectParams<T>& q) {
  const int gi = i + b.oi, gj = j + b.oj;
  const T ae = gi == b.nx ? T(0) : q.dxi2;
  const T aw = gi == 1 ? T(0) : q.dxi2;
  const T an = gj == b.ny ? T(0) : q.dyi2;
  const T a_s = gj == 1 ? T(0) : q.dyi2;
  const int x_edge = gi == 1 || gi == b.nx;
  const int y_edge = gj == 1 || gj == b.ny;
  return (rhs - ae * src(1, 0) - aw * src(-1, 0) - an * src(0, 1) - a_s * src(0, -1)) *
         q.ap_inv[x_edge][y_edge];
}

// u on global rows [2, nx+1) x cols [1, ny+1) and v on [1, nx+1) x
// [2, ny+1) from u*, v* and grad p; elsewhere the (sanitized) entry u, v.
template <typename T, class A>
__device__ __forceinline__ void correct_of(const A& F, const A& us, const A& vs, const A& p,
                                           const A& u, const A& v, const Block& b, int i,
                                           int j, const ProjectParams<T>& q, T& uo, T& vo) {
  uo = u(0, 0);
  vo = v(0, 0);
  if (!b.interior(i, j)) return;
  const T rho_c = mix_rho(F(0, 0), q.rho_l, q.rho_g);
  const T pc = p(0, 0);
  if (i + b.oi >= 2) {
    const T r_u = (rho_c + mix_rho(F(-1, 0), q.rho_l, q.rho_g)) * T(0.5);
    uo = us(0, 0) - q.dt / r_u * (pc - p(-1, 0)) * q.dxi;
  }
  if (j + b.oj >= 2) {
    const T r_v = (rho_c + mix_rho(F(0, -1), q.rho_l, q.rho_g)) * T(0.5);
    vo = vs(0, 0) - q.dt / r_v * (pc - p(0, -1)) * q.dyi;
  }
}

// ---- one Rudman/Zalesak FCT sweep ----

template <typename T>
struct SweepParams {
  int n_ax, n_ot;  // global interior extents along and across the sweep
  T dt, dx, dy, dxdy, dtdy, guard_eps, denom_eps;
  int full_dv, clamp;
};

// The order of c[] is kernels/step_kernels.py:_sweep_constants. For the
// y-sweep (dx, dy) are the grid's (dy, dx), as in pallas_fct_sweep_y.
template <typename T>
SweepParams<T> sweep_params(int n_ax, int n_ot, const double* c, int full_dv,
                            int clamp) {
  SweepParams<T> q;
  q.n_ax = n_ax;
  q.n_ot = n_ot;
  q.dt = T(c[0]);
  q.dx = T(c[1]);
  q.dy = T(c[2]);
  q.dxdy = T(c[3]);
  q.dtdy = T(c[4]);
  q.guard_eps = T(c[5]);
  q.denom_eps = T(c[6]);
  q.full_dv = full_dv;
  q.clamp = clamp;
  return q;
}

// The sweep's quantities at one position of its line, global index k
// along the sweep (a face is the lower face of its cell, between cells
// k - 1 and k): each is a function of its position alone.
// phase_tiles.cuh's sweep_lines evaluates each once a position. Ftd, rp,
// rm and a are zero off their global ranges, as in _sweep_body.

// low- and high-order fluxes through face k (velocity u at k, donor cells
// F_lo at k - 1 and F at k)
template <typename T>
__device__ __forceinline__ void sweep_fluxes(T u, T F_lo, T F, const SweepParams<T>& q, T& fL,
                                             T& fH) {
  const T udt = u * q.dt;
  fL = udt * (u >= T(0) ? F_lo : F);
  fH = udt * (u <= T(0) ? F_lo : F);
}

// anti-diffusive flux through face k, zero below face 1
template <typename T>
__device__ __forceinline__ T sweep_anti(int k, T fL, T fH) {
  return k >= 1 ? fH - fL : T(0);
}

template <typename T>
__device__ __forceinline__ T sweep_dv(T u, T u_hi, const SweepParams<T>& q) {
  return q.dxdy - q.dtdy * (u_hi - u);
}

// the low-order update of cell k (fluxes through its faces k and k + 1)
template <typename T>
__device__ __forceinline__ T sweep_ftd(int k, T F, T fL, T fL_hi, T dv,
                                       const SweepParams<T>& q) {
  const T netflux = quot((fL - fL_hi) * q.dy, q.dxdy);
  T ftd = q.full_dv ? quot((F + netflux) * q.dx * q.dy, dv)
                    : F + quot(netflux * q.dx * q.dy, dv);
  if (q.clamp) ftd = clamp01(ftd);
  return k >= 1 && k <= q.n_ax ? ftd : T(0);
}

// limiter ratios of cell k, zero off the interior and where the limiter
// does not fire (a_lo, a_hi: the fluxes through its lower and upper faces)
template <typename T>
__device__ __forceinline__ void sweep_ratios(int k, T Ftd_lo, T Ftd, T Ftd_hi, T a_lo, T a_hi,
                                             const SweepParams<T>& q, T& rp, T& rm) {
  const bool cell = k >= 1 && k <= q.n_ax;
  const T fmax = tmax(Ftd, tmax(Ftd_lo, Ftd_hi));
  const T fmin = tmin(Ftd, tmin(Ftd_lo, Ftd_hi));
  const T pp = tmax(T(0), a_lo) - tmin(T(0), a_hi);
  const T qp = (fmax - Ftd) * q.dx;
  rp = cell && pp > q.guard_eps ? tmin(T(1), quot(qp, pp + q.denom_eps)) : T(0);
  const T pm = tmax(T(0), a_hi) - tmin(T(0), a_lo);
  const T qm = (Ftd - fmin) * q.dx;
  rm = cell && pm > q.guard_eps ? tmin(T(1), quot(qm, pm + q.denom_eps)) : T(0);
}

// corrected flux factor on face k from the ratios of cells k - 1 and k
template <typename T>
__device__ __forceinline__ T sweep_factor(T a, T rp_lo, T rm_lo, T rp, T rm) {
  return a >= T(0) ? tmin(rp, rm_lo) : tmin(rp_lo, rm);
}

// the limited anti-diffusion of cell k (faces k: a, c; k + 1: a_hi, c_hi)
template <typename T>
__device__ __forceinline__ T sweep_result(T Ftd, T a, T c, T a_hi, T c_hi, T dv,
                                          const SweepParams<T>& q) {
  const T corr = quot(a_hi * c_hi - a * c, q.dy);
  T f_new = Ftd - quot(corr * q.dx * q.dy, dv);
  if (q.clamp) f_new = clamp01(f_new);
  return f_new;
}

}  // namespace tv
