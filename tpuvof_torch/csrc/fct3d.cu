// One 3-D Rudman/Zalesak FCT sweep of F along x, y or z, for Hopper
// (sm_90a).
//
// Replaces tpuvof/pallas_kernels/step3d.py:pallas_fct3d_sweep (_fct_x_kernel
// and _fct_yz_kernel, bodies ops/fct3d.py:sweep_x_masked and
// sweep_inplane_masked): donor-cell flux, Ftd = clamp01((F + (fL - fL+) *
// flux_scale) * vol/dv), the limiter ratios min(1, q/p) where p > 0, the
// corrected anti-diffusion divided by final_div, clamped; the reference's
// literal per-axis scale factors come from the host.
//
// What bounds it on the H100: it must read F and one velocity and write F:
// 3 fields, 98.9 MB at 200^3 f32, 29.5 us at 3.35 TB/s.
//
// What the design does about it: one thread per output cell, which loads the
// 7-cell line of F and of the velocity through it along the sweep axis (the
// axis is a template parameter, the line a stride) and recomputes the face
// quantities it needs; no scratch and one pass. The x and y lines are
// strided across rows, each load still coalesced along k.
//
// Ghosts. A sweep in the middle of a step passes the input's ghosts through
// (the sweeps read stale F mirrors, as the reference does). The step's last
// sweep (mirror_out) writes fresh mirrors of its own output instead: the
// j/k ghosts in set_BC's y-then-z order and the first and last planes as
// copies of their neighbours (_mirror_jk, _ghost_planes_out); in a pencil
// the j mirrors are written at the global walls only, mid-block on a y-edge
// shard and nowhere on an interior one. A thread at a ghost position
// computes the interior value it mirrors itself, so no thread reads
// another's output and one launch does it all.
#include "cell3d.cuh"

namespace {

template <typename T>
struct S3Params {
  T dt, vol, dt_area, flux_scale, q_scale, final_div;
};

// F at (l, j, k) after the sweep along AXIS: the limited update on the
// sweep's interior, the input F elsewhere.
template <typename T, int AXIS, bool PENCIL>
__device__ __forceinline__ T sweep3d_at(const T* __restrict__ F, const T* __restrict__ vel,
                                        const tv::Vol& g, int l, int j, int k,
                                        const S3Params<T>& q) {
  const long long o = g.at(l, j, k);
  const int gi = l + g.gi_base;
  const int gj = j + g.gj_base;
  // global index along the sweep, its interior extent, the interior test
  // across it. On the whole grid and a slab the in-plane sweeps take every
  // i-plane they are given; a pencil's also require an interior global i
  // (tpuvof's two-axis-masked body, sweep_masked_2axis).
  const int idx = AXIS == 0 ? gi : (AXIS == 1 ? gj : k);
  const int n_sw = AXIS == 0 ? g.nx : (AXIS == 1 ? g.ny : g.nz);
  const bool i_ok = !PENCIL || (gi >= 1 && gi <= g.nx);
  const bool o_int = AXIS == 0   ? (gj >= 1 && gj <= g.ny && k >= 1 && k <= g.nz)
                     : AXIS == 1 ? (i_ok && k >= 1 && k <= g.nz)
                                 : (i_ok && gj >= 1 && gj <= g.ny);
  if (!o_int || idx < 1 || idx > n_sw) return F[o];

  // position r of the line is r - 3 cells from this one along the axis
  const int pos = AXIS == 0 ? l : (AXIS == 1 ? j : k);
  const int n_ax = AXIS == 0 ? g.n0 : (AXIS == 1 ? g.n1 : g.n2);
  const long long stride =
      AXIS == 0 ? static_cast<long long>(g.n1) * g.n2 : (AXIS == 1 ? g.n2 : 1);
  bool in[7];
  T Fw[7], uw[7];
#pragma unroll
  for (int r = 0; r < 7; ++r) {
    const int p = pos - 3 + r;
    in[r] = p >= 0 && p < n_ax;
    Fw[r] = in[r] ? F[o + (r - 3) * stride] : T(0);
    uw[r] = in[r] ? vel[o + (r - 3) * stride] : T(0);
  }
  // donor-cell and high-order fluxes through the lower face of cell r
  T fL[7], fH[7];
#pragma unroll
  for (int r = 1; r < 7; ++r) {
    const T udt = uw[r] * q.dt;
    fL[r] = in[r] ? udt * (uw[r] >= T(0) ? Fw[r - 1] : Fw[r]) : T(0);
    fH[r] = in[r] ? udt * (uw[r] <= T(0) ? Fw[r - 1] : Fw[r]) : T(0);
  }
  // anti-diffusive flux on faces r = 2..5, zero below global face 1
  T a[7];
#pragma unroll
  for (int r = 2; r < 6; ++r) a[r] = in[r] && idx - 3 + r >= 1 ? fH[r] - fL[r] : T(0);
  // Ftd on cells r = 1..5, zero off the sweep's interior
  T Ftd[7], dv[7];
#pragma unroll
  for (int r = 1; r < 6; ++r) {
    const int kk = idx - 3 + r;
    dv[r] = q.vol - q.dt_area * (uw[r + 1] - uw[r]);
    const T ftd = tv::clamp01((Fw[r] + (fL[r] - fL[r + 1]) * q.flux_scale) * q.vol / dv[r]);
    Ftd[r] = in[r] && kk >= 1 && kk <= n_sw ? ftd : T(0);
  }
  // limiter ratios on cells r = 2..4
  T rp[7], rm[7];
#pragma unroll
  for (int r = 2; r < 5; ++r) {
    const int kk = idx - 3 + r;
    const bool cell = in[r] && kk >= 1 && kk <= n_sw;
    const T fmax = tv::tmax(Ftd[r], tv::tmax(Ftd[r - 1], Ftd[r + 1]));
    const T fmin = tv::tmin(Ftd[r], tv::tmin(Ftd[r - 1], Ftd[r + 1]));
    const T pp = tv::tmax(T(0), a[r]) - tv::tmin(T(0), a[r + 1]);
    const T qp = (fmax - Ftd[r]) * q.q_scale;
    rp[r] = cell && pp > T(0) ? tv::tmin(T(1), qp / pp) : T(0);
    const T pm = tv::tmax(T(0), a[r + 1]) - tv::tmin(T(0), a[r]);
    const T qm = (Ftd[r] - fmin) * q.q_scale;
    rm[r] = cell && pm > T(0) ? tv::tmin(T(1), qm / pm) : T(0);
  }
  // corrected flux factor on this cell's faces (r = 3, 4; both >= face 1)
  const T c3 = a[3] >= T(0) ? tv::tmin(rp[3], rm[2]) : tv::tmin(rp[2], rm[3]);
  const T c4 = !in[4] ? T(0)
               : a[4] >= T(0) ? tv::tmin(rp[4], rm[3]) : tv::tmin(rp[3], rm[4]);
  const T corr = (a[4] * c4 - a[3] * c3) / q.final_div;
  return tv::clamp01(Ftd[3] - corr * q.vol / dv[3]);
}

template <typename T, int AXIS, bool MIRROR, bool PENCIL>
__global__ void fct3d_kernel(const T* __restrict__ F, const T* __restrict__ vel,
                             T* __restrict__ out, const tv::Vol block, const S3Params<T> q) {
  const tv::Vol g = tv::rows<PENCIL>(block);
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int l = blockIdx.z;
  if (j >= g.n1 || k >= g.n2) return;
  T val;
  if (MIRROR) {
    // the output's first and last planes copy their neighbours, whose
    // j/k ghosts mirror the swept interior; the j mirrors sit at the
    // global walls (mid-block in a pencil)
    const int ls = l == 0 ? 1 : (l == g.n0 - 1 ? g.n0 - 2 : l);
    val = sweep3d_at<T, AXIS, PENCIL>(F, vel, g, ls, g.jc(j), g.kc(k), q);
  } else if (l == 0 || l == g.n0 - 1) {
    val = F[g.at(l, j, k)];
  } else {
    val = sweep3d_at<T, AXIS, PENCIL>(F, vel, g, l, j, k, q);
  }
  out[g.at(l, j, k)] = val;
}

template <typename T, int AXIS, bool PENCIL>
void launch_mode(const T* F, const T* vel, T* out, tv::Vol g, const S3Params<T>& q,
                 int mirror_out, cudaStream_t stream) {
  if (mirror_out) {
    fct3d_kernel<T, AXIS, true, PENCIL><<<tv::grid3d(g), tv::block3d(), 0, stream>>>(
        F, vel, out, g, q);
  } else {
    fct3d_kernel<T, AXIS, false, PENCIL><<<tv::grid3d(g), tv::block3d(), 0, stream>>>(
        F, vel, out, g, q);
  }
}

template <typename T, int AXIS>
void launch_axis(const T* F, const T* vel, T* out, tv::Vol g, const S3Params<T>& q,
                 int mirror_out, bool pencil, cudaStream_t stream) {
  if (pencil) {
    launch_mode<T, AXIS, true>(F, vel, out, g, q, mirror_out, stream);
  } else {
    launch_mode<T, AXIS, false>(F, vel, out, g, q, mirror_out, stream);
  }
}

template <typename T>
int launch_fct3d(const T* F, const T* vel, T* out, tv::Vol g, int pencil, int axis,
                 int mirror_out, const double* c, cudaStream_t stream) {
  // the order of c[] is kernels/step3d_kernels.py:_sweep3d_constants
  const S3Params<T> q{T(c[0]), T(c[1]), T(c[2]), T(c[3]), T(c[4]), T(c[5])};
  const bool pen = pencil != 0;
  if (axis == 0) {
    launch_axis<T, 0>(F, vel, out, g, q, mirror_out, pen, stream);
  } else if (axis == 1) {
    launch_axis<T, 1>(F, vel, out, g, q, mirror_out, pen, stream);
  } else if (axis == 2) {
    launch_axis<T, 2>(F, vel, out, g, q, mirror_out, pen, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// F, vel: inputs; out: output; all (n0, n1, nz+2), local plane l at global
// i gi_base + l, local row m at global j gj_base + m. axis 0, 1, 2 sweeps
// x, y, z with vel = u, v, w. pencil != 0 for a pencil (tpuvof's njl
// given): its in-plane sweeps also require an interior global i.
extern "C" int tv_fct3d_f32(const void* F, const void* vel, void* out, int n0, int n1,
                            int gi_base, int gj_base, int pencil, int nx, int ny, int nz,
                            int axis, int mirror_out, const double* c, void* stream) {
  using T = float;
  return launch_fct3d<T>(static_cast<const T*>(F), static_cast<const T*>(vel),
                         static_cast<T*>(out),
                         tv::Vol{n0, n1, nz + 2, gi_base, gj_base, nx, ny, nz}, pencil,
                         axis, mirror_out, c, static_cast<cudaStream_t>(stream));
}

extern "C" int tv_fct3d_f64(const void* F, const void* vel, void* out, int n0, int n1,
                            int gi_base, int gj_base, int pencil, int nx, int ny, int nz,
                            int axis, int mirror_out, const double* c, void* stream) {
  using T = double;
  return launch_fct3d<T>(static_cast<const T*>(F), static_cast<const T*>(vel),
                         static_cast<T*>(out),
                         tv::Vol{n0, n1, nz + 2, gi_base, gj_base, nx, ny, nz}, pencil,
                         axis, mirror_out, c, static_cast<cudaStream_t>(stream));
}
