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
// What the design does: temporal blocking, a 2.5-D wavefront. Each launch
// runs NLEV (1..kLevelsMax) exact Jacobi levels. A CTA of 32 lanes (k) x
// ROWS warps (j) covers a (j, k) region and owns its inner part, NLEV cells
// in from each side (overlapped tiling: the rim is recomputed by the
// neighbouring CTAs, as level t is exact only t cells in from the region's
// edge), and marches along l over a chunk of planes plus NLEV planes of
// halo on each side. Each lane computes a run of RUN consecutive k
// positions. At step s the run has p at plane s (level 0, loaded a step
// ahead) and computes level t at plane s - t for t = 1..NLEV: the e and w
// neighbours are its own level t-1 at planes s-t+1 and s-t-1 (three
// registers a position and level), the f and b neighbours of the run's
// inner positions are its own level t-1 at plane s-t and those of its ends
// the next lanes' (a warp shuffle each), the n and s neighbours are level
// t-1 at plane s-t in shared memory (written at step s-1, one access a run;
// two buffers a level, so one barrier a step), and rhs at plane s-t is a
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
// us at 200^3 f32 (and 3 x 5.1 GB / 3.35 TB/s = 4.56 ms on the four-card
// cell's 606 x 606 x 1154 block).
//
// What bounds it: the instructions a cell and level, and the rim they are
// spent on, not bytes. The previous design (one k position a thread, 32 x 32
// regions, two CTAs an SM) issued ~170 instructions a thread and step at
// depth 4 with 56% of the computed cells owned: ~332 us at 200^3, 13.4 ms
// on the 606 x 606 x 1154 block. A run of RUN = 2 pays the shared reads,
// the shuffles, the ghost and edge bits and the address arithmetic once for
// two positions, and widens the region to 64 x 32 (66% owned at depth 4);
// it takes 46-61 registers at depths 2-5 in f32 (no spills), so one
// 1024-thread CTA an SM. A ghost is zeroed by a mask (keep), not by a
// select, which the compiler turned into a branch around each cell's
// arithmetic (8% slower at 200^3). Measured on the H100
// (scripts/torch_ab3d.py; H100 80GB HBM3, 700 W), (4, 3, 3): ~251 us at
// 200^3 (2.8x the floor) and ~8.93 ms on the pencil block (2.0x). A
// launch's time a step an SM is ~0.67 us and ~0.17 a level (the pencil
// block: depth 3 1.18, depth 4 1.35 us): the step's fixed part (the loads a
// step ahead, ~35 register moves of the rotations, the barrier) now weighs
// about as much as the levels' instructions (~40 a run and level, 26 of
// them the two cells' arithmetic). Measured and dropped: loading two steps
// ahead (within 1.5%: the loads' latency is hidden), unrolling the march 2-4
// times to drop the rotations (slower on the pencil block; depth 5 spills),
// the plane ghost as a uniform branch (depth 3 4% faster, depth 4 6%
// slower). RUN 4 was not built: its state (~80 registers) passes the 64 a
// 1024-thread CTA allows.
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

// The CTA: 32 lanes along k by ROWS warps along j; each lane computes a
// run of RUN consecutive k positions, so a region is 32 RUN columns by ROWS
// rows: in f32 RUN 2 and 32 rows (64 x 32), in f64 RUN 1 and 16 rows (32 x
// 16, as before: twice the registers a value). At most kLevelsMax levels a
// launch, the depth NLEV a template argument so that each depth's loop over
// levels unrolls to exactly its levels. A level's plane in shared memory has
// a border row above and below that nothing writes, so every thread reads
// its n and s neighbours without a bounds test; the f and b neighbours are
// the run's own registers, and at a run's ends the next lane's (a warp
// shuffle: lanes 0 and 31 get their own value back, at the region's edge,
// where a cell is not exact with any value).
constexpr int kLanes = 32;
constexpr int kLevelsMax = 5;

template <typename T, int NLEV>
struct Depth {
  static constexpr int run = sizeof(T) == 4 ? 2 : 1;
  static constexpr int rows = sizeof(T) == 4 ? 32 : 16;
  static constexpr int threads = kLanes * rows;
  static constexpr int cols = kLanes * run;
  // the owned part: NLEV cells in from each side of the region
  static constexpr int own_k = cols - 2 * NLEV;
  static constexpr int own_j = rows - 2 * NLEV;
  static constexpr int level = (rows + 2) * cols;
  // two buffers of levels 0 .. NLEV-1 over the region and its border rows
  static constexpr size_t smem = sizeof(T) * 2 * NLEV * level;
};

// x where m is all ones, +0 where it is 0: a ghost's select as one bitwise
// and, which the compiler does not turn into a branch around the cell's
// arithmetic (a branch a cell costs more than the cell's select).
template <typename T>
struct Mask;
template <>
struct Mask<float> {
  using type = unsigned;
};
template <>
struct Mask<double> {
  using type = unsigned long long;
};
__device__ __forceinline__ float keep(float x, unsigned m) {
  return __uint_as_float(__float_as_uint(x) & m);
}
__device__ __forceinline__ double keep(double x, unsigned long long m) {
  return __longlong_as_double(__double_as_longlong(x) & m);
}

// A run's values, moved to and from shared memory in one access.
template <typename T, int RUN>
struct alignas(sizeof(T) * RUN) Run {
  T v[RUN];
};

template <typename T, bool PENCIL, int NLEV>
__global__ void __launch_bounds__(Depth<T, NLEV>::threads)
    jacobi3d_kernel(const T* __restrict__ src, const T* __restrict__ rhs, T* __restrict__ dst,
                    const tv::Vol block, const J3Params<T> q, const int lc) {
  using D = Depth<T, NLEV>;
  constexpr int V = D::run;
  constexpr int kCols = D::cols;
  constexpr int kLevel = D::level;
  using R = Run<T, V>;
  using M = typename Mask<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const buf = reinterpret_cast<T*>(smem);  // [2][NLEV][ROWS + 2][kCols]
  const tv::Vol g = tv::rows<PENCIL>(block);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int me = (ty + 1) * kCols + tx * V;
  const int k0 = blockIdx.x * D::own_k - NLEV + tx * V;
  const int j = blockIdx.y * D::own_j - NLEV + ty;
  const int l0 = blockIdx.z * lc;
  const int l1 = min(l0 + lc, g.n0);
  const bool row_in = j >= 0 && j < g.n1;
  const bool row_owned = ty >= NLEV && ty < D::rows - NLEV;
  const bool rg = row_ghost(g, j);
  const int gj = j + g.gj_base;
  const int ey = gj == 1 || gj == g.ny;
  // per position of the run: in the array, owned, a ghost row or column
  // (and its mask: 0 there), and its diagonal off and on an x edge
  bool in[V], owner[V], rc_ghost[V];
  M rc_live[V];
  T ap_inner[V], ap_xedge[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int k = k0 + v;
    const int c = tx * V + v;
    const int ez = k == 1 || k == g.nz;
    in[v] = row_in && k >= 0 && k < g.n2;
    owner[v] = in[v] && row_owned && c >= NLEV && c < kCols - NLEV;
    rc_ghost[v] = rg || col_ghost(g, k);
    rc_live[v] = rc_ghost[v] ? M(0) : ~M(0);
    ap_inner[v] = q.ap_inv[0][ey][ez];
    ap_xedge[v] = q.ap_inv[1][ey][ez];
  }
  const long long plane = static_cast<long long>(g.n1) * g.n2;
  // the run's first position in a plane (read only where in[v])
  const long long col = static_cast<long long>(j) * g.n2 + k0;
  for (int i = ty * kLanes + tx; i < 2 * NLEV * kLevel; i += D::threads) buf[i] = T(0);

  // level 0 (p, 0 at the ghosts) and rhs of plane s, loaded one step ahead
  T p_at[V], r_at[V];
  bool ghost_at = true, xedge_at = false;
  auto fetch = [&](int s) {
    const int gi = s + g.gi_base;
    const bool plane_in = s >= 0 && s < g.n0;
    ghost_at = plane_ghost(g, s);
    xedge_at = gi == 1 || gi == g.nx;
    const long long at = s * plane + col;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const bool read = plane_in && in[v];
      r_at[v] = read ? rhs[at + v] : T(0);
      p_at[v] = read && !rc_ghost[v] && !ghost_at ? src[at + v] : T(0);
    }
  };
  // c[t]: level t of the run at the last three planes it reached (m-1, m,
  // m+1 of level t+1's plane m); r[t]: rhs at plane s - t; bit t of
  // ghost_bits / xedge_bits: plane s - t is a ghost plane / on an x edge
  T c[NLEV][3][V] = {};
  T r[NLEV + 1][V] = {};
  unsigned ghost_bits = 0, xedge_bits = 0;
  T* put = buf;
  T* got = buf + NLEV * kLevel;
  fetch(l0 - NLEV);
  __syncthreads();
  for (int s = l0 - NLEV; s < l1 + NLEV; ++s) {
    R p0;
#pragma unroll
    for (int v = 0; v < V; ++v) {
#pragma unroll
      for (int t = NLEV; t > 0; --t) r[t][v] = r[t - 1][v];
      r[0][v] = r_at[v];
      p0.v[v] = p_at[v];
      c[0][0][v] = c[0][1][v];
      c[0][1][v] = c[0][2][v];
      c[0][2][v] = p_at[v];
    }
    ghost_bits = ghost_bits << 1 | ghost_at;
    xedge_bits = xedge_bits << 1 | xedge_at;
    fetch(s + 1);
    *reinterpret_cast<R*>(put + me) = p0;
#pragma unroll
    for (int t = 1; t <= NLEV; ++t) {
      const T* const nb = got + (t - 1) * kLevel + me;
      // the neighbours: e, w along i, n, s along j, f, b along k; level
      // t-1 at plane s-t is the middle of c[t-1] and, in shared memory,
      // the n and s rows
      const R n = *reinterpret_cast<const R*>(nb + kCols);
      const R so = *reinterpret_cast<const R*>(nb - kCols);
      const T* const mid = c[t - 1][1];
      const T lo = __shfl_up_sync(0xffffffffu, mid[V - 1], 1);
      const T hi = __shfl_down_sync(0xffffffffu, mid[0], 1);
      const M plane_live = ghost_bits >> t & 1u ? M(0) : ~M(0);
      const bool xedge_t = xedge_bits >> t & 1u;
      R val;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const T e = c[t - 1][2][v];
        const T w = c[t - 1][0][v];
        const T f = v + 1 < V ? mid[v + 1 < V ? v + 1 : v] : hi;
        const T b = v > 0 ? mid[v > 0 ? v - 1 : v] : lo;
        val.v[v] = keep((r[t][v] - q.cx * e - q.cx * w - q.cy * n.v[v] - q.cy * so.v[v] -
                         q.cz * f - q.cz * b) *
                            (xedge_t ? ap_xedge[v] : ap_inner[v]),
                        rc_live[v] & plane_live);
      }
      if (t == NLEV) {
        const int m = s - NLEV;
        if (m >= l0 && m < l1) {
          const long long at = m * plane + col;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            if (owner[v]) dst[at + v] = val.v[v];
          }
        }
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          c[t][0][v] = c[t][1][v];
          c[t][1][v] = c[t][2][v];
          c[t][2][v] = val.v[v];
        }
        *reinterpret_cast<R*>(put + t * kLevel + me) = val;
      }
    }
    T* const was = put;
    put = got;
    got = was;
    __syncthreads();
  }
}

// The kernel of one (type, mode, depth), with its shared memory granted and
// the CTAs it keeps resident on an SM (asked once a device), and its grid
// on a block: one CTA a region and chunk of planes.
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
  // the grid on a block of n0 planes of n1 x n2, and its chunk length
  static dim3 grid(int n0, int n1, int n2, int* lc) {
    const int tiles_k = (n2 + D::own_k - 1) / D::own_k;
    const int tiles_j = (n1 + D::own_j - 1) / D::own_j;
    // a chunk runs 2 NLEV steps of halo planes
    *lc = tv::plane_chunk(n0, tiles_k * tiles_j, resident(), 2 * NLEV);
    return dim3(tiles_k, tiles_j, (n0 + *lc - 1) / *lc);
  }
  static int launch(const T* src, const T* rhs, T* dst, tv::Vol g, const J3Params<T>& q,
                    cudaStream_t stream) {
    int lc = 0;
    const dim3 grid_ = grid(g.n0, g.n1, g.n2, &lc);
    jacobi3d_kernel<T, PENCIL, NLEV><<<grid_, dim3(kLanes, D::rows), D::smem, stream>>>(
        src, rhs, dst, g, q, lc);
    return static_cast<int>(cudaGetLastError());
  }
  // threads a CTA, shared bytes a CTA, CTAs resident per SM, the run,
  // the region's rows and columns, its owned columns and rows
  static void shape(int* out) {
    out[0] = D::threads;
    out[1] = static_cast<int>(D::smem);
    out[2] = resident();
    out[3] = D::run;
    out[4] = D::rows;
    out[5] = D::cols;
    out[6] = D::own_k;
    out[7] = D::own_j;
  }
  // the launch on a block of n0 x n1 x n2: CTAs along k, j and l, the
  // chunk length; ratio: the cell-levels its threads compute (every
  // position of every region, at every step of every chunk and its halo)
  // over the block's cells' levels
  static void geometry(int n0, int n1, int n2, int* out, double* ratio) {
    int lc = 0;
    const dim3 gr = grid(n0, n1, n2, &lc);
    out[0] = static_cast<int>(gr.x);
    out[1] = static_cast<int>(gr.y);
    out[2] = static_cast<int>(gr.z);
    out[3] = lc;
    const double steps = n0 + 2.0 * NLEV * gr.z;  // a tile's steps over its chunks
    *ratio = static_cast<double>(gr.x) * gr.y * D::rows * D::cols * steps /
             (static_cast<double>(n0) * n1 * n2);
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

template <typename T, bool PENCIL>
int depth_geometry(int n0, int n1, int n2, int nlev, int* out, double* ratio) {
  if (n0 < 1 || n1 < 1 || n2 < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (nlev) {
    case 1: Jacobi<T, PENCIL, 1>::geometry(n0, n1, n2, out, ratio); break;
    case 2: Jacobi<T, PENCIL, 2>::geometry(n0, n1, n2, out, ratio); break;
    case 3: Jacobi<T, PENCIL, 3>::geometry(n0, n1, n2, out, ratio); break;
    case 4: Jacobi<T, PENCIL, 4>::geometry(n0, n1, n2, out, ratio); break;
    case 5: Jacobi<T, PENCIL, 5>::geometry(n0, n1, n2, out, ratio); break;
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
// shared bytes a CTA, CTAs resident per SM, the run (k positions a
// thread), the region's rows and columns, its owned columns and rows}.
extern "C" int tv_jacobi3d_shape_f32(int pencil, int nlev, int* out) {
  return pencil ? depth_shape<float, true>(nlev, out) : depth_shape<float, false>(nlev, out);
}

extern "C" int tv_jacobi3d_shape_f64(int pencil, int nlev, int* out) {
  return pencil ? depth_shape<double, true>(nlev, out) : depth_shape<double, false>(nlev, out);
}

// The Jacobi's launch at nlev levels on a block of n0 x n1 x n2 (n2 = nz +
// 2): out = {CTAs along k, along j, chunks of planes, planes a chunk};
// ratio = the cell-levels its threads compute over the block's.
extern "C" int tv_jacobi3d_grid_f32(int n0, int n1, int n2, int pencil, int nlev, int* out,
                                    double* ratio) {
  return pencil ? depth_geometry<float, true>(n0, n1, n2, nlev, out, ratio)
                : depth_geometry<float, false>(n0, n1, n2, nlev, out, ratio);
}

extern "C" int tv_jacobi3d_grid_f64(int n0, int n1, int n2, int pencil, int nlev, int* out,
                                    double* ratio) {
  return pencil ? depth_geometry<double, true>(n0, n1, n2, nlev, out, ratio)
                : depth_geometry<double, false>(n0, n1, n2, nlev, out, ratio);
}
