// The 3-D fixed-iteration Jacobi pressure solve, for Hopper (sm_90a).
//
// Replaces tpuvof/pallas_kernels/jacobi3d.py:pallas_jacobi_3d (_kernel, the
// VMEM-resident volume) and streamed_jacobi_3d (_streamed_iter_kernel, one
// HBM-streamed iteration per launch): both compute the same exact Jacobi
// iteration of the 7-point Neumann operator, so one kernel serves both.
// The ghost ring is zeroed instead of the edge coefficients (equal values:
// a zeroed coefficient meets a zeroed neighbour), the diagonal 1/ap is one
// of 8 edge-class constants the host computes in double in tpuvof's
// accumulation order and casts, and the neighbours are subtracted in the
// order e, w, n, s, f, b (jacobi3d.py:171-204, 244-253).
//
// What bounds it on the H100: the whole solve must read p and rhs and write
// p once: 3 fields, 98.9 MB at 200^3 f32, 29.5 us at 3.35 TB/s.
//
// What the first design cost: one out-of-place iteration per launch, one
// thread per cell: n_iter launches, each moving 3 fields (p and rhs in, p
// out); the 10 iterations of a step took ~540 us at 200^3 f32, 18x the
// bound. The TPU kernel keeps p resident across its iterations for the same
// reason (jacobi3d.py:1-8).
//
// What this design does: temporal blocking, a 2.5-D wavefront. Each launch
// runs NLEV (1..kLevelsMax) exact Jacobi levels. A CTA of 32 (k) x ROWS (j)
// threads covers a (j, k) region and owns its inner part, NLEV cells in
// from each side (overlapped tiling: the rim is recomputed by the
// neighbouring CTAs, as level t is exact only t cells in from the region's
// edge), and marches along l over a chunk of planes plus NLEV planes of
// halo on each side. At step s the thread of column (j, k) has p at plane
// s (level 0, loaded a step ahead) and computes level t at plane s - t for
// t = 1..NLEV: the e and w neighbours are its own level t-1 at planes
// s-t+1 and s-t-1 (three registers a level), the n, s, f, b neighbours are
// level t-1 at plane s-t in shared memory (written at step s-1; two
// buffers a level, so one barrier a step), and rhs at plane s-t is a
// register ring. Level NLEV goes to the output. Every level holds the ghost
// positions at 0 exactly as plane_ghost, row_ghost and col_ghost classify
// them (the block's edge planes and rows too), so a halo never feeds a
// value where the one-iteration form reads 0, and every level reads only
// the previous one.
//
// The launch plan (kernels/step3d_kernels.py:jacobi3d_plan) splits n_iter
// into launches of at most JACOBI_LEVELS = 4 levels of near-equal depth,
// ping-ponging two buffers: (4, 3, 3) for the step's 10. Each launch must
// still read p and rhs and write p, so the plan's floor is 3 x 29.5 = 88.6
// us at 200^3 f32. Measured on the H100 (scripts/torch_ab3d.py, every
// depth): ~333 us at depth 4 against the parent's ~537; depth 3 ~335, 5
// ~432 (39 registers: one 1024-thread CTA an SM, where depth 4's 32 allow
// two). At ROWS = 32 the kernel issues about as many instructions as the
// SMs can (~170 a thread and step at depth 4, estimated from the SASS
// counts of the depths; 56% of the cells on owned positions): it is bound
// by the recomputed rim and the per-level instructions, not by bytes. An
// earlier form with ROWS = 16 took ~500 us (the rim is 2 x NLEV of 16
// rows).
//
// The ghost positions of a slab or a pencil (local planes 0 and n0-1, a
// pencil's rows 0 and n1-1, and any position at or beyond a global wall)
// are held at zero, as the resident kernel holds them: those of a block's
// edges go stale by design and are junk by contract.
#include "cell3d.cuh"

namespace {

template <typename T>
struct J3Params {
  T cx, cy, cz;
  T ap_inv[2][2][2];  // [on an x-edge][on a y-edge][on a z-edge]
};

// A position is a ghost iff its plane, its row or its column is one, so a
// thread classifies its three planes, rows and columns; a position off the
// array counts as a ghost and reads 0. (On the whole grid and a slab, rows
// 0 and n1-1 are the walls.)
__device__ __forceinline__ bool plane_ghost(const tv::Vol& g, int l) {
  const int gi = l + g.gi_base;
  return l <= 0 || l >= g.n0 - 1 || gi <= 0 || gi >= g.nx + 1;
}
__device__ __forceinline__ bool row_ghost(const tv::Vol& g, int j) {
  const int gj = j + g.gj_base;
  return j <= 0 || j >= g.n1 - 1 || gj <= 0 || gj >= g.ny + 1;
}
__device__ __forceinline__ bool col_ghost(const tv::Vol& g, int k) {
  return k <= 0 || k >= g.nz + 1;
}

// The CTA: kJK columns (k, one per lane) by ROWS rows (j, one per warp):
// 32 in f32, 16 in f64 (whose registers would spill at 1024 threads); at
// most kLevelsMax levels a launch, the depth NLEV a template argument so
// that each depth's loop over levels unrolls to exactly its levels. A
// level's plane in shared memory has a border of one cell on each side that
// nothing writes, so every thread reads its four in-plane neighbours
// without a bounds test (a cell that reads the border is not exact, as it
// is not with any value there).
constexpr int kJK = 32;
constexpr int kLevelsMax = 5;
constexpr int kPitch = kJK + 2;

template <typename T, int NLEV>
struct Depth {
  static constexpr int rows = sizeof(T) == 4 ? 32 : 16;
  static constexpr int threads = kJK * rows;
  static constexpr int level = (rows + 2) * kPitch;
  // two buffers of levels 0 .. NLEV-1 over the region and its border
  static constexpr size_t smem = sizeof(T) * 2 * NLEV * level;
};

template <typename T, bool PENCIL, int NLEV>
__global__ void __launch_bounds__(Depth<T, NLEV>::threads)
    jacobi3d_kernel(const T* __restrict__ src, const T* __restrict__ rhs, T* __restrict__ dst,
                    const tv::Vol block, const J3Params<T> q, const int lc) {
  constexpr int kRows = Depth<T, NLEV>::rows;
  constexpr int kLevel = Depth<T, NLEV>::level;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const buf = reinterpret_cast<T*>(smem);  // [2][NLEV][kRows + 2][kPitch]
  const tv::Vol g = tv::rows<PENCIL>(block);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int me = (ty + 1) * kPitch + tx + 1;
  const int k = blockIdx.x * (kJK - 2 * NLEV) - NLEV + tx;
  const int j = blockIdx.y * (kRows - 2 * NLEV) - NLEV + ty;
  const int l0 = blockIdx.z * lc;
  const int l1 = min(l0 + lc, g.n0);
  const bool in_plane = j >= 0 && j < g.n1 && k >= 0 && k < g.n2;
  const bool owner = in_plane && tx >= NLEV && tx < kJK - NLEV && ty >= NLEV && ty < kRows - NLEV;
  const bool rc_ghost = row_ghost(g, j) || col_ghost(g, k);
  const int gj = j + g.gj_base;
  const int ey = gj == 1 || gj == g.ny;
  const int ez = k == 1 || k == g.nz;
  const T ap_inner = q.ap_inv[0][ey][ez], ap_xedge = q.ap_inv[1][ey][ez];
  const long long plane = static_cast<long long>(g.n1) * g.n2;
  const long long col = in_plane ? static_cast<long long>(j) * g.n2 + k : 0;
  for (int i = ty * kJK + tx; i < 2 * NLEV * kLevel; i += kJK * kRows) buf[i] = T(0);

  // level 0 (p, 0 at the ghosts) and rhs of plane s, loaded one step ahead
  T p_at = T(0), r_at = T(0);
  bool ghost_at = true, xedge_at = false;
  auto fetch = [&](int s) {
    const int gi = s + g.gi_base;
    ghost_at = plane_ghost(g, s);
    xedge_at = gi == 1 || gi == g.nx;
    p_at = r_at = T(0);
    if (in_plane && s >= 0 && s < g.n0) {
      r_at = rhs[s * plane + col];
      if (!rc_ghost && !ghost_at) p_at = src[s * plane + col];
    }
  };
  // c[t]: level t of this column at the last three planes it reached
  // (m-1, m, m+1 of level t+1's plane m); r[t]: rhs at plane s - t; bit t
  // of ghost_bits / xedge_bits: plane s - t is a ghost plane / on an x edge
  T c[NLEV][3] = {};
  T r[NLEV + 1] = {};
  unsigned ghost_bits = 0, xedge_bits = 0;
  T* put = buf;
  T* got = buf + NLEV * kLevel;
  fetch(l0 - NLEV);
  __syncthreads();
  for (int s = l0 - NLEV; s < l1 + NLEV; ++s) {
    const T p0 = p_at;
#pragma unroll
    for (int t = NLEV; t > 0; --t) r[t] = r[t - 1];
    r[0] = r_at;
    ghost_bits = ghost_bits << 1 | ghost_at;
    xedge_bits = xedge_bits << 1 | xedge_at;
    fetch(s + 1);
    c[0][0] = c[0][1];
    c[0][1] = c[0][2];
    c[0][2] = p0;
    put[me] = p0;
#pragma unroll
    for (int t = 1; t <= NLEV; ++t) {
      const T* const nb = got + (t - 1) * kLevel + me;
      // the neighbours: e, w along i, n, s along j, f, b along k
      const T e = c[t - 1][2];
      const T w = c[t - 1][0];
      const T n = nb[kPitch];
      const T so = nb[-kPitch];
      const T f = nb[1];
      const T b = nb[-1];
      const T val = rc_ghost || (ghost_bits >> t & 1u)
                        ? T(0)
                        : (r[t] - q.cx * e - q.cx * w - q.cy * n - q.cy * so - q.cz * f -
                           q.cz * b) *
                              (xedge_bits >> t & 1u ? ap_xedge : ap_inner);
      if (t == NLEV) {
        const int m = s - NLEV;
        if (owner && m >= l0 && m < l1) dst[m * plane + col] = val;
      } else {
        c[t][0] = c[t][1];
        c[t][1] = c[t][2];
        c[t][2] = val;
        put[t * kLevel + me] = val;
      }
    }
    T* const was = put;
    put = got;
    got = was;
    __syncthreads();
  }
}

// The kernel of one (type, mode, depth), with its shared memory granted and
// the CTAs it keeps resident on an SM (asked once a device).
template <typename T, bool PENCIL, int NLEV>
struct Jacobi {
  using D = Depth<T, NLEV>;
  static int resident() {
    static std::atomic<int> cache[tv::kMaxDevices];
    return tv::per_device(cache, [](int) {
      cudaFuncSetAttribute(jacobi3d_kernel<T, PENCIL, NLEV>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(D::smem));
      int n = 0;
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, jacobi3d_kernel<T, PENCIL, NLEV>,
                                                    D::threads, D::smem);
      return n;
    });
  }
  static int launch(const T* src, const T* rhs, T* dst, tv::Vol g, const J3Params<T>& q,
                    cudaStream_t stream) {
    constexpr int own_k = kJK - 2 * NLEV, own_j = D::rows - 2 * NLEV;
    const int tiles_k = (g.n2 + own_k - 1) / own_k;
    const int tiles_j = (g.n1 + own_j - 1) / own_j;
    // a chunk runs 2 NLEV steps of halo planes
    const int lc = tv::plane_chunk(g.n0, tiles_k * tiles_j, resident(), 2 * NLEV);
    const dim3 grid(tiles_k, tiles_j, (g.n0 + lc - 1) / lc);
    jacobi3d_kernel<T, PENCIL, NLEV><<<grid, dim3(kJK, D::rows), D::smem, stream>>>(
        src, rhs, dst, g, q, lc);
    return static_cast<int>(cudaGetLastError());
  }
  // threads a CTA, shared bytes a CTA, CTAs resident per SM
  static void shape(int* out) {
    out[0] = D::threads;
    out[1] = static_cast<int>(D::smem);
    out[2] = resident();
  }
};

template <typename T, bool PENCIL>
int launch_depth(const T* src, const T* rhs, T* dst, tv::Vol g, const J3Params<T>& q, int nlev,
                 cudaStream_t stream) {
  switch (nlev) {
    case 1: return Jacobi<T, PENCIL, 1>::launch(src, rhs, dst, g, q, stream);
    case 2: return Jacobi<T, PENCIL, 2>::launch(src, rhs, dst, g, q, stream);
    case 3: return Jacobi<T, PENCIL, 3>::launch(src, rhs, dst, g, q, stream);
    case 4: return Jacobi<T, PENCIL, 4>::launch(src, rhs, dst, g, q, stream);
    case 5: return Jacobi<T, PENCIL, 5>::launch(src, rhs, dst, g, q, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_jacobi3d(const T* p, const T* rhs, T* out, T* tmp, tv::Vol g, int pencil,
                    int n_launch, const int* levels, const double* c, cudaStream_t stream) {
  // the order of c[] is kernels/step3d_kernels.py:_jacobi3d_constants
  J3Params<T> q;
  q.cx = T(c[0]);
  q.cy = T(c[1]);
  q.cz = T(c[2]);
  for (int e = 0; e < 8; ++e) q.ap_inv[e >> 2][(e >> 1) & 1][e & 1] = T(c[3 + e]);
  for (int i = 0; i < n_launch; ++i) {
    if (levels[i] < 1 || levels[i] > kLevelsMax) return static_cast<int>(cudaErrorInvalidValue);
  }
  const T* src = p;
  for (int i = 0; i < n_launch; ++i) {
    // the last launch writes out
    T* dst = (n_launch - 1 - i) % 2 == 0 ? out : tmp;
    const int err = pencil ? launch_depth<T, true>(src, rhs, dst, g, q, levels[i], stream)
                           : launch_depth<T, false>(src, rhs, dst, g, q, levels[i], stream);
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return 0;
}

template <typename T, bool PENCIL>
int depth_shape(int nlev, int* out) {
  switch (nlev) {
    case 1: Jacobi<T, PENCIL, 1>::shape(out); break;
    case 2: Jacobi<T, PENCIL, 2>::shape(out); break;
    case 3: Jacobi<T, PENCIL, 3>::shape(out); break;
    case 4: Jacobi<T, PENCIL, 4>::shape(out); break;
    case 5: Jacobi<T, PENCIL, 5>::shape(out); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// p, rhs: inputs; out: output; tmp: scratch (unused with one launch); all
// (n0, n1, nz+2), local plane l at global i gi_base + l, local row m at
// global j gj_base + m; pencil != 0 for a pencil (tpuvof's njl given).
// levels[0 .. n_launch-1]: the Jacobi levels of each launch, each in
// 1..kLevelsMax (kernels/step3d_kernels.py:jacobi3d_plan).
extern "C" int tv_jacobi3d_f32(const void* p, const void* rhs, void* out, void* tmp, int n0,
                               int n1, int gi_base, int gj_base, int pencil, int nx,
                               int ny, int nz, int n_launch, const int* levels,
                               const double* c, void* stream) {
  using T = float;
  return launch_jacobi3d<T>(static_cast<const T*>(p), static_cast<const T*>(rhs),
                            static_cast<T*>(out), static_cast<T*>(tmp),
                            tv::Vol{n0, n1, nz + 2, gi_base, gj_base, nx, ny, nz}, pencil,
                            n_launch, levels, c, static_cast<cudaStream_t>(stream));
}

extern "C" int tv_jacobi3d_f64(const void* p, const void* rhs, void* out, void* tmp, int n0,
                               int n1, int gi_base, int gj_base, int pencil, int nx,
                               int ny, int nz, int n_launch, const int* levels,
                               const double* c, void* stream) {
  using T = double;
  return launch_jacobi3d<T>(static_cast<const T*>(p), static_cast<const T*>(rhs),
                            static_cast<T*>(out), static_cast<T*>(tmp),
                            tv::Vol{n0, n1, nz + 2, gi_base, gj_base, nx, ny, nz}, pencil,
                            n_launch, levels, c, static_cast<cudaStream_t>(stream));
}

// The Jacobi's launch shape at nlev levels a launch: out = {threads a CTA,
// shared bytes a CTA, CTAs resident per SM}.
extern "C" int tv_jacobi3d_shape_f32(int pencil, int nlev, int* out) {
  return pencil ? depth_shape<float, true>(nlev, out) : depth_shape<float, false>(nlev, out);
}

extern "C" int tv_jacobi3d_shape_f64(int pencil, int nlev, int* out) {
  return pencil ? depth_shape<double, true>(nlev, out) : depth_shape<double, false>(nlev, out);
}
