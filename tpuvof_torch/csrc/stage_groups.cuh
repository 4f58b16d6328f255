// Shared-memory stage groups of the 2-D cooperative kernels (fullstep.cu,
// project.cu), and the tiles, staging and launch planning that the 2-D
// phase kernels (predict.cu, fct_sweep.cu) use too.
//
// Both kernels are one cooperative launch whose grid is what the card holds
// resident at once (a grid-wide barrier needs every CTA resident), running
// a chain of stage groups with one grid.sync() between two. In a group a
// CTA of kTX x kTY threads takes tiles of TH rows x kTW columns in turn
// (TH 16 or 24, plan_rows), stages the tile and a rim that covers the
// group's reach into shared memory (stage: every load of a thread issued
// before its first store), runs the group's passes there with a
// __syncthreads() between two, each pass over the cells of a compile-time
// region (for_cells), and writes the tile's outputs.
//
// The Jacobi sweeps run in groups of at most kJacobiLevels on overlapped
// tiles: a group of depth d stages p and rhs on the tile + d, and sweep m
// is exact on the tile + d - m (one less valid ring a sweep), so the tile
// is exact after d sweeps and one grid barrier separates two groups
// (jacobi_depth: 10 -> 4, 3, 3; fullstep.cu exports the split as
// tv_fullstep_levels). Every update is step_cell.cuh's jacobi_of on a Tile
// accessor, the same IEEE operations on the same inputs as a sweep over
// global memory. Jacobi runs out of place, ping-ponging two boxes; it
// updates the cells of the global interior that are not on the block's
// edge, so every other p keeps its staged entry value.
//
// A group's tile is described once (its boxes, its inputs, its passes)
// and run under a staging policy: thread loads (stage, thread_tile) here,
// bulk asynchronous copies in fullstep_dma.cu. The boxes come from a
// layout object: in(i0, j0, rows, cols, w) for a box whose cells are
// loaded, work(i0, j0, rows, w) for one the passes fill, w the pitch the
// thread-load layout (Packed) gives it.
#pragma once

#include <type_traits>

#include "step_cell.cuh"

namespace tv {

constexpr int kTX = 32;  // threads along j (the contiguous axis)
constexpr int kTY = 8;   // along i
constexpr int kThreads = kTX * kTY;
constexpr int kTW = 32;            // a tile's output cells along j (16 or 24 along i)
constexpr int kJacobiLevels = 4;   // the most Jacobi sweeps a stage group

// The Jacobi sweeps of each stage group: ceil(n_jacobi / kJacobiLevels)
// groups of near-equal depth, the deeper ones first (10 -> 4, 3, 3).
__host__ __device__ __forceinline__ int jacobi_groups(int n_jacobi) {
  return (n_jacobi + kJacobiLevels - 1) / kJacobiLevels;
}

__host__ __device__ __forceinline__ int jacobi_depth(int n_jacobi, int group) {
  const int n = jacobi_groups(n_jacobi);
  return n_jacobi / n + (group < n_jacobi % n ? 1 : 0);
}

// A box of a field in shared memory: block cell (i, j) at
// s[(i - i0) * w + (j - j0)].
template <typename T>
struct Box {
  T* s;
  int i0, j0, w;
  __device__ __forceinline__ T& operator()(int i, int j) const {
    return s[(i - i0) * w + (j - j0)];
  }
  __device__ __forceinline__ T* end(int h) const { return s + h * w; }
};

// A box read at offsets from one cell (step_cell.cuh's accessor form).
template <typename T>
struct Tile {
  const T* s;
  int w;
  __device__ __forceinline__ Tile(const Box<T>& box, int i, int j) : s(&box(i, j)), w(box.w) {}
  __device__ __forceinline__ T operator()(int di, int dj) const { return s[di * w + dj]; }
};

// Every block cell (i, j) of the H x W region at (i0, j0): the CTA's
// threads take consecutive cells of the flattened region, so that every
// lane has a cell while cells remain; H and W are compile-time, so the
// split of the index is a multiply and the loop is unrolled.
template <int H, int W, class Body>
__device__ __forceinline__ void for_cells(int i0, int j0, const Body& body) {
  constexpr int N = H * W;
  const int tid = static_cast<int>(threadIdx.y) * kTX + static_cast<int>(threadIdx.x);
#pragma unroll
  for (int k = 0; k < (N + kThreads - 1) / kThreads; ++k) {
    const int idx = tid + k * kThreads;
    if (N % kThreads == 0 || idx < N) body(i0 + idx / W, j0 + idx % W);
  }
}

// Loads the H x W cells at each box's origin of its block field into the
// box through ld(), each thread issuing all its loads of all NF fields
// before its first store, so that their latencies overlap.
template <int H, int W, int NF, typename T>
__device__ __forceinline__ void stage(const Block& b, const Box<T> (&box)[NF],
                                      const T* const (&src)[NF]) {
  constexpr int N = H * W, K = (N + kThreads - 1) / kThreads;
  const int tid = static_cast<int>(threadIdx.y) * kTX + static_cast<int>(threadIdx.x);
  T r[NF][K];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int idx = tid + k * kThreads;
      r[f][k] = N % kThreads == 0 || idx < N
                    ? ld(src[f], b, box[f].i0 + idx / W, box[f].j0 + idx % W)
                    : T(0);
    }
  }
#pragma unroll
  for (int f = 0; f < NF; ++f) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int idx = tid + k * kThreads;
      if (N % kThreads == 0 || idx < N) box[f].s[idx / W * box[f].w + idx % W] = r[f][k];
    }
  }
}

// The layout of thread loads: boxes packed from ``next`` in the order
// asked, each at the pitch given.
template <typename T>
struct Packed {
  T* next;
  __device__ __forceinline__ Box<T> work(int i0, int j0, int rows, int w) {
    const Box<T> box{next, i0, j0, w};
    next += rows * w;
    return box;
  }
  __device__ __forceinline__ Box<T> in(int i0, int j0, int rows, int /*cols*/, int w) {
    return work(i0, j0, rows, w);
  }
};

// Thread loads as a visitor of a group's inputs (G::load): each H x W
// region of NF fields is staged at once (stage).
struct ThreadStage {
  template <int H, int W, int NF, typename T>
  __device__ __forceinline__ void load(const Block& b, const Box<T> (&box)[NF],
                                       const T* const (&src)[NF]) const {
    stage<H, W, NF, T>(b, box, src);
  }
};

// The tile at (ti, tj) of group g with thread loads into the boxes at sm:
// stage its inputs, run its passes, and a barrier before the next tile
// reuses the boxes.
template <class G, typename T>
__device__ __forceinline__ void thread_tile(const G& g, T* sm, int ti, int tj) {
  const typename G::Boxes s(Packed<T>{sm}, ti, tj);
  g.load(ThreadStage{}, s);
  __syncthreads();
  g.compute(s, ti, tj);
  __syncthreads();
}

// f(std::integral_constant<int, d>) for a depth 1 <= d <= D known at run
// time.
template <int D, class F>
__device__ __forceinline__ void with_depth(int d, const F& f) {
  if constexpr (D > 1) {
    if (d < D) {
      with_depth<D - 1>(d, f);
      return;
    }
  }
  f(std::integral_constant<int, D>{});
}

// Sweeps M..D of a Jacobi group whose exact region at the end is the
// TH x TW region at (ti, tj), from cur into nxt: sweep M is exact on that
// region + D - M.
template <int TH, int TW, int D, int M, typename T>
__device__ __forceinline__ void jacobi_sweeps(const Block& b, const ProjectParams<T>& q,
                                              const Box<T>& cur, const Box<T>& nxt,
                                              const Box<T>& rhs, int ti, int tj) {
  if constexpr (M <= D) {
    for_cells<TH + 2 * (D - M), TW + 2 * (D - M)>(ti - D + M, tj - D + M, [&](int i, int j) {
      const bool upd = b.interior(i, j) && i >= 1 && i < b.E0 - 1 && j >= 1 && j < b.E1 - 1;
      nxt(i, j) = upd ? jacobi_of(Tile<T>(cur, i, j), rhs(i, j), b, i, j, q) : cur(i, j);
    });
    __syncthreads();
    jacobi_sweeps<TH, TW, D, M + 1>(b, q, nxt, cur, rhs, ti, tj);
  }
}

// Shared values of T of a Jacobi group's boxes at depth D: two levels and rhs.
constexpr int jacobi_tile_values(int th, int d) {
  return 3 * (th + 2 * d) * (kTW + 2 * d);
}

// A Jacobi group of depth D on tiles of TH rows: D sweeps from src into
// dst, rhs a block field (0 off the global interior). Its boxes: p and rhs
// on the tile + D (loaded) and the second level (filled).
template <int TH, int D, typename T>
struct JacobiGroup {
  static constexpr int kRows = TH;
  static constexpr int H = TH + 2 * D, W = kTW + 2 * D;
  const Block& b;
  const ProjectParams<T>& q;
  const T* src;
  const T* rhs;
  T* dst;

  struct Boxes {
    Box<T> p0, p1, rhs;
    template <class L>
    __device__ __forceinline__ Boxes(L&& lay, int ti, int tj)
        : p0(lay.in(ti - D, tj - D, H, W, W)),
          p1(lay.work(ti - D, tj - D, H, W)),
          rhs(lay.in(ti - D, tj - D, H, W, W)) {}
  };

  template <class V>
  __device__ __forceinline__ void load(V&& st, const Boxes& s) const {
    st.template load<H, W, 2, T>(b, {s.p0, s.rhs}, {src, rhs});
  }

  __device__ __forceinline__ void compute(const Boxes& s, int ti, int tj) const {
    jacobi_sweeps<TH, kTW, D, 1>(b, q, s.p0, s.p1, s.rhs, ti, tj);
    const Box<T>& out = D % 2 ? s.p1 : s.p0;
    for_cells<TH, kTW>(ti, tj, [&](int i, int j) {
      if (b.inside(i, j)) dst[i * b.E1 + j] = out(i, j);
    });
  }
};

// d <= D sweeps (d known at run time) of the tile at (ti, tj) with thread
// loads, from src into dst, with rhs a block field (0 off the global
// interior).
template <int TH, int D, typename T>
__device__ __forceinline__ void jacobi_depth_tile(int d, const Block& b,
                                                  const ProjectParams<T>& q, T* sm, int ti,
                                                  int tj, const T* src, const T* rhs_f, T* dst) {
  with_depth<D>(d, [&](auto depth) {
    const JacobiGroup<TH, decltype(depth)::value, T> g{b, q, src, rhs_f, dst};
    thread_tile(g, sm, ti, tj);
  });
}

// The tiles of TH rows x kTW columns that cover an (E0, E1) block.
inline long long tiles_of(int th, int E0, int E1) {
  return static_cast<long long>((E0 + th - 1) / th) * ((E1 + kTW - 1) / kTW);
}

// The CTAs of kThreads an SM holds of ``kernel`` with ``smem`` dynamic
// shared bytes (granted here, above the default 48 KB too), asked once a
// device and kept in ``cache``; a negative CUDA error where the device
// cannot run it (with ``coop``: cooperatively).
template <class Kernel>
int resident_per_sm(std::atomic<int> (&cache)[kMaxDevices], Kernel kernel, int smem,
                    bool coop = false) {
  return per_device(cache, [&](int dev) {
    int can = 1, ctas = 0;
    cudaError_t e = coop ? cudaDeviceGetAttribute(&can, cudaDevAttrCooperativeLaunch, dev)
                         : cudaSuccess;
    if (e == cudaSuccess && !can) e = cudaErrorNotSupported;
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, kThreads, smem);
    if (e == cudaSuccess && ctas < 1) e = cudaErrorLaunchOutOfResources;
    return e == cudaSuccess ? ctas : -static_cast<int>(e);
  });
}

// resident_per_sm of a cooperative kernel.
template <class Kernel>
int coop_per_sm(std::atomic<int> (&cache)[kMaxDevices], Kernel kernel, int smem) {
  return resident_per_sm(cache, kernel, smem, true);
}

// The tile of a launch among n tile choices, ordered from the smallest
// tile (the most CTAs) to the largest, of which ctas[k] cover the block
// and an SM holds per_sm[k]: the first whose CTAs all run at once, else
// the last. A CTA's work is a chain of dependent passes, shorter on a
// smaller tile, so a block that fits on the card in one wave runs fastest
// on the most, smallest tiles, and a larger one on the fewest rims. Returns
// the choice's index, or the first negative per_sm (a CUDA error).
inline int pick_tile(int n, const long long* ctas, const int* per_sm) {
  for (int k = 0; k < n; ++k) {
    if (per_sm[k] < 0) return per_sm[k];
  }
  for (int k = 0; k < n - 1; ++k) {
    if (ctas[k] <= static_cast<long long>(per_sm[k]) * sm_count()) return k;
  }
  return n - 1;
}

// The launch on an (E0, E1) block of a cooperative kernel built for 16-
// and 24-row tiles, of which an SM holds n16 and n24 CTAs: the tile height
// (pick_tile: 16 rows when the block's 16-row tiles all fit on the card at
// once, else 24, whose fullstep sweep lines, 26 cells across a tile, fit
// one warp and which beat 32 rows at 562^2 to 2050^2, PERF.md) and the
// CTAs, one a tile up to what the card holds resident. Negative CTAs: a
// CUDA error.
inline void plan_rows(int E0, int E1, int n16, int n24, int& th, int& ctas) {
  const long long tiles[2] = {tiles_of(16, E0, E1), tiles_of(24, E0, E1)};
  const int per_sm[2] = {n16, n24};
  const int k = pick_tile(2, tiles, per_sm);
  th = k == 0 ? 16 : 24;
  if (k < 0) {
    ctas = k;
    return;
  }
  const long long resident = static_cast<long long>(per_sm[k]) * sm_count();
  ctas = static_cast<int>(tiles[k] < resident ? tiles[k] : resident);
}

}  // namespace tv
