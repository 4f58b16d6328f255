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
// What the design does about it: every quantity of the sweep is computed
// once, at its position along the sweep line, and every field value is
// loaded once a chunk. Each quantity (a face's fluxes fL/fH and
// anti-diffusive flux a, a cell's dv, Ftd, limiter ratios rp/rm, a face's
// corrected factor c) is a function of its absolute position along the
// line alone, so one evaluation gives the bits that the per-cell
// recomputation of the reference's 7-cell window gave.
// - x and y sweeps (fct3d_march_kernel): a thread owns a column across the
//   sweep (a (j, k) tile of 32 x 8 threads for x, an (l, k) tile for y;
//   k on the lanes, so every load is a coalesced row segment) and marches
//   along the sweep axis over a chunk of positions (tv::plane_chunk),
//   holding a rolling window of the line in registers: at position t it
//   loads F and the velocity (issued one position ahead), then computes
//   the fluxes of face t, Ftd of cell t-1, rp/rm of cell t-2, c of face
//   t-2 and the result of cell t-3. A chunk re-loads 3 positions at each
//   end (4 with mirror_out).
// - z sweep (fct3d_z_kernel): the line runs along the lanes. A warp takes
//   32 consecutive k of one row, computes each position's quantities once
//   and passes neighbours by warp shuffles; lanes 3..28 hold complete
//   windows and write 26 results. Each warp marches along l over a chunk
//   of planes, loading the next plane before the current one's arithmetic.
//
// Ghosts. A sweep in the middle of a step passes the input's ghosts through
// (the sweeps read stale F mirrors, as the reference does). The step's last
// sweep (mirror_out) writes fresh mirrors of its own output instead: the
// j/k ghosts in set_BC's y-then-z order and the first and last planes as
// copies of their neighbours (_mirror_jk, _ghost_planes_out); in a pencil
// the j mirrors are written at the global walls only, mid-block on a y-edge
// shard and nowhere on an interior one. Every mirror's source is the
// adjacent position: across the march a ghost thread sweeps its source
// column (the same work as any column), along it the march writes position
// r from the value it holds for r - 1, r or r + 1, and in the z sweep the
// value comes from the neighbouring lane.
#include "cell3d.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTK = 32;    // lanes along k
constexpr int kTC = 8;     // columns (march) or rows (z) across, one a warp row
constexpr int kZOut = 26;  // results of a z warp: lanes 3..28
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct S3Params {
  T dt, vol, dt_area, flux_scale, q_scale, final_div;
};

// ---- the sweep's quantities at one position p of the line (the window
// cell r of the reference's sweep3d_at at p = pos - 3 + r); ``in``: p lies
// in the array, ``cell``: also in the sweep's global interior ----

// donor-cell and high-order fluxes through the lower face of p (u at p,
// F at p - 1 and p, 0 off the array)
template <typename T>
__device__ __forceinline__ void face_fluxes(bool in, T u, T F_lo, T F_hi,
                                            const S3Params<T>& q, T& fL, T& fH) {
  const T udt = u * q.dt;
  fL = in ? udt * (u >= T(0) ? F_lo : F_hi) : T(0);
  fH = in ? udt * (u <= T(0) ? F_lo : F_hi) : T(0);
}

// anti-diffusive flux through the lower face of p, zero below global face 1
template <typename T>
__device__ __forceinline__ T anti(bool in, int gidx, T fL, T fH) {
  return in && gidx >= 1 ? fH - fL : T(0);
}

template <typename T>
__device__ __forceinline__ T cell_dv(T u_lo, T u_hi, const S3Params<T>& q) {
  return q.vol - q.dt_area * (u_hi - u_lo);
}

template <typename T>
__device__ __forceinline__ T cell_ftd(bool cell, T F, T fL_lo, T fL_hi, T dv,
                                      const S3Params<T>& q) {
  const T ftd = tv::clamp01(tv::quot((F + (fL_lo - fL_hi) * q.flux_scale) * q.vol, dv));
  return cell ? ftd : T(0);
}

// limiter ratios of cell p from Ftd at p - 1, p, p + 1 and a on its faces
template <typename T>
__device__ __forceinline__ void cell_ratios(bool cell, T Ftd_lo, T Ftd, T Ftd_hi, T a_lo,
                                            T a_hi, const S3Params<T>& q, T& rp, T& rm) {
  const T fmax = tv::tmax(Ftd, tv::tmax(Ftd_lo, Ftd_hi));
  const T fmin = tv::tmin(Ftd, tv::tmin(Ftd_lo, Ftd_hi));
  const T pp = tv::tmax(T(0), a_lo) - tv::tmin(T(0), a_hi);
  const T qp = (fmax - Ftd) * q.q_scale;
  rp = cell && pp > T(0) ? tv::tmin(T(1), tv::quot(qp, pp)) : T(0);
  const T pm = tv::tmax(T(0), a_hi) - tv::tmin(T(0), a_lo);
  const T qm = (Ftd - fmin) * q.q_scale;
  rm = cell && pm > T(0) ? tv::tmin(T(1), tv::quot(qm, pm)) : T(0);
}

// corrected flux factor on the lower face of p (cells p - 1 and p)
template <typename T>
__device__ __forceinline__ T face_factor(bool in, T a, T rp_lo, T rm_lo, T rp, T rm) {
  return !in ? T(0) : a >= T(0) ? tv::tmin(rp, rm_lo) : tv::tmin(rp_lo, rm);
}

// the limited update of cell p from its faces p (a, c) and p + 1 (a_hi, c_hi)
template <typename T>
__device__ __forceinline__ T cell_result(T Ftd, T a, T c, T a_hi, T c_hi, T dv,
                                         const S3Params<T>& q) {
  const T corr = tv::quot(a_hi * c_hi - a * c, q.final_div);
  return tv::clamp01(Ftd - tv::quot(corr * q.vol, dv));
}

// the plane a ghost plane copies with mirror_out
__device__ __forceinline__ int plane_src(int l, int n0) {
  return l == 0 ? 1 : (l == n0 - 1 ? n0 - 2 : l);
}

// One column's march along the x (AXIS 0) or y (AXIS 1) sweep: the rolling
// window of the line in registers (the values at t - 1, t - 2, ...), and
// one step of it. A step at position t loads t + 1 (the load is issued
// before t's arithmetic), computes the fluxes of face t, Ftd of cell t - 1,
// rp/rm of cell t - 2, c of face t - 2 and the result of cell t - 3, and
// writes position t - L. With EDGE false every position it touches lies
// in the array and the sweep's global interior, so its tests fold away.
template <typename T, int AXIS, bool MIRROR>
struct March {
  static constexpr int L = MIRROR ? 4 : 3;  // the results trail the loads by L
  const T* __restrict__ F;
  const T* __restrict__ vel;
  T* __restrict__ out;  // position 0 of the output column
  long long stride;     // between two positions
  int n_ax, n0, base, n_sw, p0;
  bool o_int;           // the column lies in the sweep's interior across it
  const tv::Vol& g;
  const S3Params<T>& q;
  T Fn = T(0), un = T(0);  // position t + 1, loaded ahead
  T F1 = T(0), F2 = T(0), F3 = T(0), u1 = T(0), fL1 = T(0);
  T a1 = T(0), a2 = T(0), a3 = T(0), dv2 = T(0), dv3 = T(0), Ftd2 = T(0), Ftd3 = T(0);
  T rp3 = T(0), rm3 = T(0), c3 = T(0), s4 = T(0), s5 = T(0);

  __device__ __forceinline__ bool in(int t) const { return t >= 0 && t < n_ax; }
  __device__ __forceinline__ bool cell(int t) const {
    return in(t) && base + t >= 1 && base + t <= n_sw;
  }
  __device__ __forceinline__ void load(int t) {
    const bool ok = in(t);
    Fn = ok ? F[t * stride] : T(0);
    un = ok ? vel[t * stride] : T(0);
  }

  template <bool EDGE>
  __device__ __forceinline__ void step(int t) {
    const T F0 = Fn, u0 = un;
    const bool in0 = !EDGE || in(t);
    load(t + 1);
    // face t
    T fL0, fH0;
    face_fluxes(in0, u0, F1, F0, q, fL0, fH0);
    const T a0 = anti(in0, EDGE ? base + t : 1, fL0, fH0);
    // cell t - 1
    const T dv1 = cell_dv(u1, u0, q);
    const T Ftd1 = cell_ftd(!EDGE || cell(t - 1), F1, fL1, fL0, dv1, q);
    // cell t - 2, face t - 2
    T rp2, rm2;
    cell_ratios(!EDGE || cell(t - 2), Ftd3, Ftd2, Ftd1, a2, a1, q, rp2, rm2);
    const T c2 = face_factor(!EDGE || in(t - 2), a2, rp3, rm3, rp2, rm2);
    // cell t - 3
    const T s3 = o_int && (!EDGE || cell(t - 3)) ? cell_result(Ftd3, a3, c3, a2, c2, dv3, q)
                                                 : F3;
    if (MIRROR) {
      // position r = t - 4 takes its source's value, at r - 1, r or r + 1
      const int r = t - 4;
      if (r >= p0) {
        const int src = AXIS == 0 ? plane_src(r, n0) : g.jc(r);
        out[r * stride] = src < r ? s5 : (src > r ? s3 : s4);
      }
      s5 = s4;
      s4 = s3;
    } else {
      const int r = t - 3;
      if (r >= p0) out[r * stride] = AXIS == 0 && (r == 0 || r == n0 - 1) ? F3 : s3;
    }
    F3 = F2;
    F2 = F1;
    F1 = F0;
    u1 = u0;
    fL1 = fL0;
    a3 = a2;
    a2 = a1;
    a1 = a0;
    dv3 = dv2;
    dv2 = dv1;
    Ftd3 = Ftd2;
    Ftd2 = Ftd1;
    rp3 = rp2;
    rm3 = rm2;
    c3 = c2;
  }
};

// The x (AXIS 0) and y (AXIS 1) sweeps: a thread marches its column along
// the sweep axis over positions [p0, p0 + chunk).
template <typename T, int AXIS, bool MIRROR, bool PENCIL>
__global__ void __launch_bounds__(kThreads)
    fct3d_march_kernel(const T* __restrict__ F, const T* __restrict__ vel, T* __restrict__ out,
                       const tv::Vol block, const S3Params<T> q, const int chunk) {
  const tv::Vol g = tv::rows<PENCIL>(block);
  const int k = blockIdx.x * kTK + threadIdx.x;
  const int c = blockIdx.y * kTC + threadIdx.y;  // j (x sweep) or l (y sweep)
  const int n_ax = AXIS == 0 ? g.n0 : g.n1;
  if (k >= g.n2 || c >= (AXIS == 0 ? g.n1 : g.n0)) return;
  const int p0 = blockIdx.z * chunk;
  const int p1 = min(p0 + chunk, n_ax);
  const long long stride = AXIS == 0 ? static_cast<long long>(g.n1) * g.n2 : g.n2;
  const long long o_out = AXIS == 0 ? g.at(0, c, k) : g.at(c, 0, k);
  if (!MIRROR && AXIS == 1 && (c == 0 || c == g.n0 - 1)) {
    for (int p = p0; p < p1; ++p) out[o_out + p * stride] = F[o_out + p * stride];
    return;
  }
  // the column swept (with mirror_out a ghost's source) and the sweep's
  // interior test across it; a pencil's y sweep also needs an interior i
  const int cs = !MIRROR ? c : (AXIS == 0 ? g.jc(c) : plane_src(c, g.n0));
  const int ks = MIRROR ? g.kc(k) : k;
  const long long o_src = AXIS == 0 ? g.at(0, cs, ks) : g.at(cs, 0, ks);
  const int gc = cs + (AXIS == 0 ? g.gj_base : g.gi_base);
  const bool k_ok = ks >= 1 && ks <= g.nz;
  const bool o_int = AXIS == 0 ? gc >= 1 && gc <= g.ny && k_ok
                               : (!PENCIL || (gc >= 1 && gc <= g.nx)) && k_ok;
  const int base = AXIS == 0 ? g.gi_base : g.gj_base;  // global index of position 0
  const int n_sw = AXIS == 0 ? g.nx : g.ny;
  March<T, AXIS, MIRROR> m{F + o_src, vel + o_src, out + o_out, stride, n_ax, g.n0, base,
                           n_sw, p0, o_int, g, q};
  constexpr int L = March<T, AXIS, MIRROR>::L;
  const int t0 = p0 - L, t1 = p1 - 1 + L;
  // the steps whose positions t - 3 .. t + 1 all lie in the array and the
  // sweep's global interior run without the edge tests
  const int s0 = max(t0, max(3, 4 - base));
  const int s1 = max(s0, min(t1 + 1, min(n_ax - 1, n_sw - base + 1)));
  m.load(t0);
  int t = t0;
  for (; t < s0; ++t) m.template step<true>(t);
#pragma unroll 2
  for (; t < s1; ++t) m.template step<false>(t);
  for (; t <= t1; ++t) m.template step<true>(t);
}

// The z sweep: warp (blockIdx.x, row) holds k = base - 3 .. base + 28 on
// its lanes and marches along l over planes [l0, l0 + chunk).
template <typename T, bool MIRROR, bool PENCIL>
__global__ void __launch_bounds__(kThreads)
    fct3d_z_kernel(const T* __restrict__ F, const T* __restrict__ w, T* __restrict__ out,
                   const tv::Vol block, const S3Params<T> q, const int chunk) {
  const tv::Vol g = tv::rows<PENCIL>(block);
  const int j = blockIdx.y * kTC + threadIdx.y;
  if (j >= g.n1) return;  // the whole warp
  const int lane = threadIdx.x;
  // the segment's results start at seg0; the last segment's window ends at
  // the row's end, so a ghost's neighbour never sits on a window edge
  const int seg0 = blockIdx.x * kZOut;
  const int base = max(0, min(seg0, g.n2 - kZOut));
  const int k = base - 3 + lane;
  const bool in = k >= 0 && k < g.n2;
  const bool mine = lane >= 3 && lane < 3 + kZOut && k >= seg0 && k < g.n2;
  const bool cell = in && k >= 1 && k <= g.nz;
  const int ks = MIRROR && in ? g.kc(k) : k;
  const int js = MIRROR ? g.jc(j) : j;
  const int gj = js + g.gj_base;
  const bool j_ok = gj >= 1 && gj <= g.ny;
  const int l0 = blockIdx.z * chunk;
  const int l1 = min(l0 + chunk, g.n0);
  const int ls0 = MIRROR ? plane_src(l0, g.n0) : l0;
  T Fn = in ? F[g.at(ls0, js, k)] : T(0);
  T wn = in ? w[g.at(ls0, js, k)] : T(0);
  for (int l = l0; l < l1; ++l) {
    const T Fz = Fn, wz = wn;
    if (l + 1 < l1) {
      const int lsn = MIRROR ? plane_src(l + 1, g.n0) : l + 1;
      Fn = in ? F[g.at(lsn, js, k)] : T(0);
      wn = in ? w[g.at(lsn, js, k)] : T(0);
    }
    const long long o = g.at(l, j, k);
    if (!MIRROR && (l == 0 || l == g.n0 - 1)) {
      if (mine) out[o] = Fz;
      continue;
    }
    const int gi = (MIRROR ? plane_src(l, g.n0) : l) + g.gi_base;
    T s = Fz;
    if (j_ok && (!PENCIL || (gi >= 1 && gi <= g.nx))) {  // the warp's row is swept
      T fL, fH;
      face_fluxes(in, wz, __shfl_up_sync(kFull, Fz, 1), Fz, q, fL, fH);
      const T a = anti(in, k, fL, fH);
      const T dv = cell_dv(wz, __shfl_down_sync(kFull, wz, 1), q);
      const T Ftd = cell_ftd(cell, Fz, fL, __shfl_down_sync(kFull, fL, 1), dv, q);
      const T a_hi = __shfl_down_sync(kFull, a, 1);
      T rp, rm;
      cell_ratios(cell, __shfl_up_sync(kFull, Ftd, 1), Ftd, __shfl_down_sync(kFull, Ftd, 1), a,
                  a_hi, q, rp, rm);
      const T c = face_factor(in, a, __shfl_up_sync(kFull, rp, 1),
                              __shfl_up_sync(kFull, rm, 1), rp, rm);
      const T c_hi = __shfl_down_sync(kFull, c, 1);
      if (cell) s = cell_result(Ftd, a, c, a_hi, c_hi, dv, q);
    }
    if (MIRROR) {
      const T lo = __shfl_up_sync(kFull, s, 1);
      const T hi = __shfl_down_sync(kFull, s, 1);
      s = ks < k ? lo : (ks > k ? hi : s);
    }
    if (mine) out[o] = s;
  }
}

// The kernel of one sweep (type, axis, mode), with the CTAs it keeps
// resident on an SM (asked once a device) and its launch.
template <typename T, int AXIS, bool MIRROR, bool PENCIL>
struct Sweep {
  static auto kernel() {
    if constexpr (AXIS == 2) {
      return fct3d_z_kernel<T, MIRROR, PENCIL>;
    } else {
      return fct3d_march_kernel<T, AXIS, MIRROR, PENCIL>;
    }
  }
  static int resident() {
    static std::atomic<int> cache[tv::kMaxDevices];
    return tv::per_device(cache, [](int) {
      int n = 0;
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel(), kThreads, 0);
      return n;
    });
  }
  static int launch(const T* F, const T* vel, T* out, tv::Vol g, const S3Params<T>& q,
                    cudaStream_t stream) {
    // tiles across the march and the positions it marches; a march chunk
    // re-loads 2L positions, a z chunk prefetches one plane
    int tiles, n_march, halo;
    if (AXIS == 2) {
      tiles = (g.n2 + kZOut - 1) / kZOut * ((g.n1 + kTC - 1) / kTC);
      n_march = g.n0;
      halo = 1;
    } else {
      tiles = (g.n2 + kTK - 1) / kTK * (((AXIS == 0 ? g.n1 : g.n0) + kTC - 1) / kTC);
      n_march = AXIS == 0 ? g.n0 : g.n1;
      halo = MIRROR ? 8 : 6;
    }
    const int chunk = tv::plane_chunk(n_march, tiles, resident(), halo);
    const dim3 grid(AXIS == 2 ? (g.n2 + kZOut - 1) / kZOut : (g.n2 + kTK - 1) / kTK,
                    ((AXIS == 0 || AXIS == 2 ? g.n1 : g.n0) + kTC - 1) / kTC,
                    (n_march + chunk - 1) / chunk);
    kernel()<<<grid, dim3(kTK, kTC), 0, stream>>>(F, vel, out, g, q, chunk);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T, int AXIS, bool PENCIL>
int launch_mode(const T* F, const T* vel, T* out, tv::Vol g, const S3Params<T>& q,
                int mirror_out, cudaStream_t stream) {
  return mirror_out ? Sweep<T, AXIS, true, PENCIL>::launch(F, vel, out, g, q, stream)
                    : Sweep<T, AXIS, false, PENCIL>::launch(F, vel, out, g, q, stream);
}

template <typename T, int AXIS>
int launch_axis(const T* F, const T* vel, T* out, tv::Vol g, const S3Params<T>& q,
                int mirror_out, bool pencil, cudaStream_t stream) {
  return pencil ? launch_mode<T, AXIS, true>(F, vel, out, g, q, mirror_out, stream)
                : launch_mode<T, AXIS, false>(F, vel, out, g, q, mirror_out, stream);
}

template <typename T>
int launch_fct3d(const T* F, const T* vel, T* out, tv::Vol g, int pencil, int axis,
                 int mirror_out, const double* c, cudaStream_t stream) {
  // the order of c[] is kernels/step3d_kernels.py:_sweep3d_constants
  const S3Params<T> q{T(c[0]), T(c[1]), T(c[2]), T(c[3]), T(c[4]), T(c[5])};
  const bool pen = pencil != 0;
  if (axis == 0) return launch_axis<T, 0>(F, vel, out, g, q, mirror_out, pen, stream);
  if (axis == 1) return launch_axis<T, 1>(F, vel, out, g, q, mirror_out, pen, stream);
  if (axis == 2) return launch_axis<T, 2>(F, vel, out, g, q, mirror_out, pen, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// threads a CTA, shared bytes a CTA, CTAs resident per SM (without
// mirror_out)
template <typename T, int AXIS>
int shape_of(int pencil, int* out) {
  out[0] = kThreads;
  out[1] = 0;
  out[2] = pencil ? Sweep<T, AXIS, false, true>::resident()
                  : Sweep<T, AXIS, false, false>::resident();
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fct3d_shape(int axis, int pencil, int* out) {
  if (axis == 0) return shape_of<T, 0>(pencil, out);
  if (axis == 1) return shape_of<T, 1>(pencil, out);
  if (axis == 2) return shape_of<T, 2>(pencil, out);
  return static_cast<int>(cudaErrorInvalidValue);
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

// A sweep's launch shape: out = {threads a CTA, shared bytes a CTA, CTAs
// resident per SM}.
extern "C" int tv_fct3d_shape_f32(int axis, int pencil, int* out) {
  return fct3d_shape<float>(axis, pencil, out);
}

extern "C" int tv_fct3d_shape_f64(int axis, int pencil, int* out) {
  return fct3d_shape<double>(axis, pencil, out);
}
