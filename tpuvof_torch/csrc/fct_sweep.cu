// One Rudman/Zalesak FCT sweep of F along x or y, for Hopper (sm_90a).
//
// Replaces tpuvof/pallas_kernels/step_kernels.py:_pallas_sweep
// (pallas_fct_sweep_x/_y, body _sweep_body): donor-cell flux, Ftd with the
// divergence compensation dV/dv, the limiter ratios rp/rm, the corrected
// anti-diffusive flux, and the optional clamps.
//
// What bounds it on the H100: a sweep reads F and one velocity and writes F:
// 3 field-sized arrays, ~3.2 MB at 514^2 f32, ~1 us at 3.35 TB/s. The step
// makes two, so at the main path's size the sweep is bound by its launch.
//
// What the design does about it: nothing yet; it is the simple form. One
// launch per sweep and one thread per output cell. The output at a cell
// depends on F and the velocity within +-3 along the sweep axis, so each
// thread loads that 7-cell line into registers and recomputes the face
// quantities it needs (fluxes on 6 faces, Ftd on 5 cells, rp/rm on 3, c on
// 2) instead of storing them: no scratch field and no second pass. The
// x-sweep's line is strided across rows (each load still coalesces along j);
// the y-sweep's line is contiguous and neighbouring threads share it through
// L1. A shared-memory line tile is the faster later form.
//
// Ghost conventions follow the Pallas body: Ftd, rp, rm, a and c are zero
// off their ranges, a is zero below face 1, and the output keeps F's ghost
// ring. Loads past the array's ends read 0; they feed only masked values.
// The library is built with --fmad=false, so the f64 build agrees with
// kernels/step_kernels.py:fct_sweep_plain to rounding.
#include "common.cuh"

namespace {

template <typename T>
struct SweepParams {
  int n_ax, n_ot;  // interior extents along and across the sweep
  T dt, dx, dy, dxdy, dtdy, guard_eps, denom_eps;
  int full_dv, clamp;
};

// The order of c[] is kernels/step_kernels.py:_sweep_constants. For the
// y-sweep (dx, dy) are the grid's (dy, dx), as in pallas_fct_sweep_y.
template <typename T>
SweepParams<T> make_params(int n_ax, int n_ot, const double* c, int full_dv,
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

// AXIS 0 sweeps along i (rows), AXIS 1 along j (columns).
template <typename T, int AXIS>
__global__ void fct_sweep_kernel(const T* __restrict__ F,
                                 const T* __restrict__ vel, T* __restrict__ out,
                                 const SweepParams<T> q) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int n0 = (AXIS == 0 ? q.n_ax : q.n_ot) + 2;
  const int n1 = (AXIS == 0 ? q.n_ot : q.n_ax) + 2;
  if (i >= n0 || j >= n1) return;
  const int o = i * n1 + j;
  const int k = AXIS == 0 ? i : j;  // index along the sweep
  const int m = AXIS == 0 ? j : i;  // index across it
  if (k < 1 || k > q.n_ax || m < 1 || m > q.n_ot) {
    out[o] = F[o];
    return;
  }
  const int stride = AXIS == 0 ? n1 : 1;

  // position r of a window holds index k - 3 + r along the sweep
  T Fw[7], uw[7];
#pragma unroll
  for (int r = 0; r < 7; ++r) {
    const int kk = k - 3 + r;
    const bool in = kk >= 0 && kk <= q.n_ax + 1;
    Fw[r] = in ? F[o + (r - 3) * stride] : T(0);
    uw[r] = in ? vel[o + (r - 3) * stride] : T(0);
  }

  // low- and high-order face fluxes on faces k-2 .. k+3 (r = 1..6); face r
  // is the lower face of cell r, with donor cells r-1 below and r above
  T fL[7], fH[7];
#pragma unroll
  for (int r = 1; r < 7; ++r) {
    const T udt = uw[r] * q.dt;
    fL[r] = udt * (uw[r] >= T(0) ? Fw[r - 1] : Fw[r]);
    fH[r] = udt * (uw[r] <= T(0) ? Fw[r - 1] : Fw[r]);
  }

  // anti-diffusive flux on faces k-1 .. k+2 (r = 2..5), zero below face 1
  T a[7];
#pragma unroll
  for (int r = 2; r < 6; ++r) a[r] = k - 3 + r >= 1 ? fH[r] - fL[r] : T(0);

  // pass 1: Ftd on cells k-2 .. k+2 (r = 1..5), zero off the interior
  T Ftd[7], dv[7];
#pragma unroll
  for (int r = 1; r < 6; ++r) {
    const int kk = k - 3 + r;
    dv[r] = q.dxdy - q.dtdy * (uw[r + 1] - uw[r]);
    const T netflux = (fL[r] - fL[r + 1]) * q.dy / q.dxdy;
    T ftd = q.full_dv ? (Fw[r] + netflux) * q.dx * q.dy / dv[r]
                      : Fw[r] + netflux * q.dx * q.dy / dv[r];
    if (q.clamp) ftd = tv::clamp01(ftd);
    Ftd[r] = kk >= 1 && kk <= q.n_ax ? ftd : T(0);
  }

  // pass 2: limiter ratios on cells k-1 .. k+1 (r = 2..4), zero off the
  // interior and where the limiter does not fire
  T rp[7], rm[7];
#pragma unroll
  for (int r = 2; r < 5; ++r) {
    const int kk = k - 3 + r;
    const bool cell = kk >= 1 && kk <= q.n_ax;
    const T fmax = tv::tmax(Ftd[r], tv::tmax(Ftd[r - 1], Ftd[r + 1]));
    const T fmin = tv::tmin(Ftd[r], tv::tmin(Ftd[r - 1], Ftd[r + 1]));
    const T a_lo = a[r];      // flux through the cell's lower face
    const T a_hi = a[r + 1];  // flux through its upper face
    const T pp = tv::tmax(T(0), a_lo) - tv::tmin(T(0), a_hi);
    const T qp = (fmax - Ftd[r]) * q.dx;
    rp[r] = cell && pp > q.guard_eps ? tv::tmin(T(1), qp / (pp + q.denom_eps))
                                     : T(0);
    const T pm = tv::tmax(T(0), a_hi) - tv::tmin(T(0), a_lo);
    const T qm = (Ftd[r] - fmin) * q.dx;
    rm[r] = cell && pm > q.guard_eps ? tv::tmin(T(1), qm / (pm + q.denom_eps))
                                     : T(0);
  }

  // pass 3: corrected flux factor on faces k and k+1 (r = 3, 4), both >= 1
  const T c3 = a[3] >= T(0) ? tv::tmin(rp[3], rm[2]) : tv::tmin(rp[2], rm[3]);
  const T c4 = a[4] >= T(0) ? tv::tmin(rp[4], rm[3]) : tv::tmin(rp[3], rm[4]);

  // pass 4: the limited anti-diffusion
  const T corr = (a[4] * c4 - a[3] * c3) / q.dy;
  T f_new = Ftd[3] - corr * q.dx * q.dy / dv[3];
  if (q.clamp) f_new = tv::clamp01(f_new);
  out[o] = f_new;
}

template <typename T>
int launch_sweep(const T* F, const T* vel, T* out, int nx, int ny, int axis,
                 const double* c, int full_dv, int clamp, cudaStream_t stream) {
  const dim3 grid = tv::grid2d(nx + 2, ny + 2);
  if (axis == 0) {
    fct_sweep_kernel<T, 0><<<grid, tv::block2d(), 0, stream>>>(
        F, vel, out, make_params<T>(nx, ny, c, full_dv, clamp));
  } else {
    fct_sweep_kernel<T, 1><<<grid, tv::block2d(), 0, stream>>>(
        F, vel, out, make_params<T>(ny, nx, c, full_dv, clamp));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// F, vel: inputs; out: output; all (nx+2, ny+2). axis 0 sweeps along x with
// vel = u, axis 1 along y with vel = v.
extern "C" int tv_fct_sweep_f32(const void* F, const void* vel, void* out,
                                int nx, int ny, int axis, const double* c,
                                int full_dv, int clamp, void* stream) {
  return launch_sweep<float>(static_cast<const float*>(F),
                             static_cast<const float*>(vel),
                             static_cast<float*>(out), nx, ny, axis, c, full_dv,
                             clamp, static_cast<cudaStream_t>(stream));
}

extern "C" int tv_fct_sweep_f64(const void* F, const void* vel, void* out,
                                int nx, int ny, int axis, const double* c,
                                int full_dv, int clamp, void* stream) {
  return launch_sweep<double>(static_cast<const double*>(F),
                              static_cast<const double*>(vel),
                              static_cast<double*>(out), nx, ny, axis, c,
                              full_dv, clamp, static_cast<cudaStream_t>(stream));
}
