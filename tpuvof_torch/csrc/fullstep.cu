// The whole lean 2-D step as one kernel launch, for Hopper (sm_90a).
//
// Replaces three tpuvof/pallas_kernels/step_kernels.py sites, which compute
// the same step on different layouts:
//   pallas_fullstep        (_fullstep_kernel): the whole grid;
//   pallas_fullstep_win    (_fullstep_win_kernel, body _win_step_values): a
//                          W-halo block with a global origin (the tiled engine);
//   pallas_fullstep_strips (_fullstep_strips_kernel): the W2-padded resident
//                          layout at origin (-W2, -W2) (the strips engine).
// All three are one computation on a Block (step_cell.cuh): the load
// sanitizer, the predictor, rhs, n_jacobi Jacobi sweeps, the velocity
// correction, both FCT sweeps in parity order, the clamp and the wall BCs.
// On the H100 the fields live in HBM at every size, so the TPU's strip DMA
// ring is not carried over: the strips engine is this kernel on the padded
// layout, whose margins it sanitizes at load.
//
// What bounds it on the H100: the step's stages depend on each other across
// cells (kappa at +-1 feeds the momentum, u* at +1 the rhs, each Jacobi
// sweep the next, the correction the sweeps, the sweeps the BCs). The
// compulsory traffic is 4 fields in and 4 out, ~8.5 MB at 514^2 f32 (~2.5
// us at 3.35 TB/s). What the card spends is latency: each stage's chain of
// dependent loads and divisions, and a grid-wide barrier between two
// dependent stages (n_jacobi + 7 stages, 16 barriers at n_jacobi 10, ~21
// of the 144 us at 514^2 in the per-stage form; PERF.md).
//
// What the design does about it: one cooperative launch
// (cudaLaunchCooperativeKernel) whose grid is what the card holds resident
// at once, running the stages in a few stage groups with one grid-wide
// barrier (cooperative_groups' grid.sync()) between two groups. In each
// group a CTA of 32 x 8 threads takes tiles of TH rows x 32 columns in
// turn, loads the tile and a rim that covers the group's reach into shared
// memory (every load of a thread issued before its first store), runs the
// group's stages there with a __syncthreads() between two, each pass over
// the cells of a compile-time region, and writes the tile's outputs (the
// tiles, staging, Jacobi groups and launch plan live in stage_groups.cuh,
// shared with project.cu; the predictor's passes and the sweeps' lines in
// phase_tiles.cuh, shared with predict.cu and fct_sweep.cu):
//   predict: the Youngs normals once a cell (rim 3 of F), kappa, u*/v* on
//            the tile and one row/column beyond, rhs; writes u*, v*, rhs;
//   jacobi:  d <= kJacobiLevels Jacobi sweeps on overlapped tiles (rim d,
//            one less valid ring a sweep), a group per split of n_jacobi
//            (jacobi_depth: 10 -> 4, 3, 3); writes p;
//   finish:  the correction on the tile +4 (rim 5 of F and p), the first
//            sweep on the tile +1 across it and +4 along the second, the
//            second sweep and the clamp on the tile +1, each quantity of a
//            sweep once a position (a warp a line segment, neighbours by
//            shuffles), the BCs; writes F, u, v, p.
// Four barriers a step at n_jacobi 10, and kappa, the normals, the
// corrected velocities and both sweeps' F never leave shared memory. A
// CTA's group is a chain of dependent passes, so the tile is small: 16
// rows when all of a block's 16-row tiles fit on the card at once, else 24
// (tv::plan_rows). Every stage runs step_cell.cuh's ``*_of`` function on a
// Tile accessor, so each value is the same IEEE operations on the same
// inputs as before; a value at a position outside the block is 0, as ld()
// reads it from a block-sized field.
//
// Jacobi runs out of place, ping-ponging two scratch blocks; it updates
// cells of the global interior that are not on the block's edge, so every
// other p keeps its sanitized entry value (the global ghost ring, then
// overwritten by the BCs).
#include <cooperative_groups.h>

#include "phase_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

using tv::Box;
using tv::for_cells;
using tv::kJacobiLevels;
using tv::kThreads;
using tv::kTW;
using tv::kTX;
using tv::kTY;
using tv::stage;
using tv::Tile;

// Shared values of T a CTA needs for tiles of TH rows: the largest stage
// group's boxes. predict: F (rim 3), u and v, kappa, the normals (u*/v*
// reuse their space); jacobi: tv::jacobi_tile's at the greatest depth;
// finish: F and p (rim 5), u*, v*, u, v (rim 4), at odd pitches.
constexpr int smem_values(int th) {
  const int predict = tv::predict_tile_values(th, 1);
  const int jacobi = tv::jacobi_tile_values(th, kJacobiLevels);
  const int finish = 2 * (th + 10) * (kTW + 11) + 4 * (th + 8) * (kTW + 9);
  const int m = predict > jacobi ? predict : jacobi;
  return m > finish ? m : finish;
}

template <typename T>
struct StepArgs {
  const T *F, *u, *v, *p;  // entry block fields
  T *F_out, *u_out, *v_out, *p_out;
  T *us, *vs, *rhs, *pa, *pb;  // scratch, each one block
  tv::Block b;
  tv::PredictParams<T> pq;
  tv::ProjectParams<T> jq;
  tv::SweepParams<T> sx, sy;
  int n_jacobi, even_step;
};

// predict: u*, v* and rhs of the tile at (ti, tj): phase_tiles.cuh's
// predictor on the tile +1 (rhs reads u*, v* at +1), u* and v* kept in
// boxes over the normals, which are dead by then.
template <int TH, typename T>
__device__ __forceinline__ void predict_tile(const StepArgs<T>& a, T* sm, int ti, int tj) {
  const tv::Block& b = a.b;
  constexpr int H = TH, W = kTW;
  const tv::PredictBoxes<TH, 1, T> s(sm, ti, tj);
  const Box<T> us{s.mx.s, ti, tj, W + 1};
  const Box<T> vs{us.end(H + 1), ti, tj, W + 1};
  static_assert(2 * (H + 1) * (W + 1) <= 2 * (H + 4) * (W + 4), "u*/v* fit over the normals");
  tv::predict_values(b, a.pq, s, a.F, a.u, a.v, ti, tj, [&](int i, int j, T x, T y) {
    const bool in = b.inside(i, j);
    us(i, j) = in ? x : T(0);
    vs(i, j) = in ? y : T(0);
    if (in && i < ti + H && j < tj + W) {
      a.us[i * b.E1 + j] = x;
      a.vs[i * b.E1 + j] = y;
    }
  });
  __syncthreads();
  for_cells<H, W>(ti, tj, [&](int i, int j) {
    if (b.inside(i, j)) {
      a.rhs[i * b.E1 + j] = b.interior(i, j)
                                ? tv::rhs_of(Tile<T>(s.F, i, j), Tile<T>(us, i, j),
                                             Tile<T>(vs, i, j), a.jq)
                                : T(0);
    }
  });
  __syncthreads();  // the next tile reuses the boxes
}

// finish: the correction, both sweeps, the clamp and the BCs of the tile
// at (ti, tj), with p the last Jacobi output.
template <int TH, typename T>
__device__ __forceinline__ void finish_tile(const StepArgs<T>& a, T* sm, int ti, int tj,
                                            const T* p) {
  const tv::Block& b = a.b;
  constexpr int H = TH, W = kTW;
  // odd pitches: a warp reading down a column hits 32 banks
  const Box<T> F{sm, ti - 5, tj - 5, W + 11};
  const Box<T> P{F.end(H + 10), ti - 5, tj - 5, W + 11};
  const Box<T> un{P.end(H + 10), ti - 4, tj - 4, W + 9};  // u*, then the corrected u
  const Box<T> vn{un.end(H + 8), ti - 4, tj - 4, W + 9};  // v*, then the corrected v
  const Box<T> s1{vn.end(H + 8), ti - 4, tj - 4, W + 9};  // u, then the first sweep
  const Box<T> s2{s1.end(H + 8), ti - 4, tj - 4, W + 9};  // v, then the second
  stage<H + 10, W + 10, 2, T>(b, {F, P}, {a.F, p});
  stage<H + 8, W + 8, 4, T>(b, {un, vn, s1, s2}, {a.us, a.vs, a.u, a.v});
  __syncthreads();
  // the correction, in place: a cell reads u*, v*, u, v only at itself
  for_cells<H + 8, W + 8>(ti - 4, tj - 4, [&](int i, int j) {
    T x, y;
    tv::correct_of(Tile<T>(F, i, j), Tile<T>(un, i, j), Tile<T>(vn, i, j), Tile<T>(P, i, j),
                   Tile<T>(s1, i, j), Tile<T>(s2, i, j), b, i, j, a.jq, x, y);
    const bool in = b.inside(i, j);
    un(i, j) = in ? x : T(0);
    vn(i, j) = in ? y : T(0);
  });
  __syncthreads();
  // the first sweep, where the second reads it: the tile +1 across it,
  // +4 along the second sweep's axis
  if (a.even_step) {
    tv::sweep_lines<T, 1, false>(F, vn, s1, ti - 4, ti + H + 4, tj - 1, tj + W + 1, b, a.sy);
  } else {
    tv::sweep_lines<T, 0, false>(F, un, s1, ti - 1, ti + H + 1, tj - 4, tj + W + 4, b, a.sx);
  }
  __syncthreads();
  // the second sweep and the clamp on the tile +1 (the BCs read +-1)
  if (a.even_step) {
    tv::sweep_lines<T, 0, true>(s1, un, s2, ti - 1, ti + H + 1, tj - 1, tj + W + 1, b, a.sx);
  } else {
    tv::sweep_lines<T, 1, true>(s1, vn, s2, ti - 1, ti + H + 1, tj - 1, tj + W + 1, b, a.sy);
  }
  __syncthreads();
  // wall BCs at global indices (tpuvof's _bc_values): u mirrored across
  // the j-walls then zero on the i-wall faces; v zero on the j-wall faces
  // then mirrored across the i-walls; F and p mirrored j first, then i.
  for_cells<H, W>(ti, tj, [&](int i, int j) {
    if (b.inside(i, j)) {
      const int gi = i + b.oi, gj = j + b.oj;
      const int di = gi == 0 ? 1 : (gi == b.nx + 1 ? -1 : 0);
      const int dj = gj == 0 ? 1 : (gj == b.ny + 1 ? -1 : 0);
      const int c = i * b.E1 + j;
      a.u_out[c] = gi == 1 || gi == b.nx + 1 ? T(0) : un(i, j + dj);
      a.v_out[c] = gj == 1 || gj == b.ny + 1 ? T(0) : vn(i + di, j);
      a.F_out[c] = s2(i + di, j + dj);
      a.p_out[c] = P(i + di, j + dj);
    }
  });
  __syncthreads();
}

// At least 3 CTAs an SM in f32, so that the 374 tiles of a 514^2 grid run
// at once (the f64 boxes allow 2).
template <typename T, int TH>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 3 : 2)
    fullstep_kernel(const StepArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  const int tiles_j = (a.b.E1 + kTW - 1) / kTW;
  const int n_tiles = tiles_j * ((a.b.E0 + TH - 1) / TH);
#define TV_TILES for (int t = blockIdx.x, ti = t / tiles_j * TH, tj = t % tiles_j * kTW; \
                      t < n_tiles; t += gridDim.x, ti = t / tiles_j * TH,                  \
                      tj = t % tiles_j * kTW)

  TV_TILES predict_tile<TH>(a, sm, ti, tj);
  grid.sync();
  const T* p = a.p;
  T* dst = a.pa;
  for (int g = 0, n = tv::jacobi_groups(a.n_jacobi); g < n; ++g) {
    const int d = tv::jacobi_depth(a.n_jacobi, g);
    TV_TILES tv::jacobi_depth_tile<TH, kJacobiLevels>(d, a.b, a.jq, sm, ti, tj, p, a.rhs, dst);
    grid.sync();
    p = dst;
    dst = dst == a.pa ? a.pb : a.pa;
  }
  TV_TILES finish_tile<TH>(a, sm, ti, tj, p);
#undef TV_TILES
}

// The kernel with TH-row tiles: its shared bytes (granted once a device)
// and the CTAs an SM holds with them (asked once a device), or a negative
// CUDA error.
template <typename T, int TH>
struct Step {
  static constexpr int smem = smem_values(TH) * static_cast<int>(sizeof(T));
  static int per_sm() {
    static std::atomic<int> cache[tv::kMaxDevices];
    return tv::coop_per_sm(cache, fullstep_kernel<T, TH>, smem);
  }
};

// The launch on an (E0, E1) block: the tile height and the CTAs
// (tv::plan_rows). Negative CTAs: a CUDA error.
template <typename T>
void plan_launch(int E0, int E1, int& th, int& ctas) {
  tv::plan_rows(E0, E1, Step<T, 16>::per_sm(), Step<T, 24>::per_sm(), th, ctas);
}

template <typename T>
const void* kernel_of(int th) {
  return th == 16 ? reinterpret_cast<const void*>(fullstep_kernel<T, 16>)
                  : reinterpret_cast<const void*>(fullstep_kernel<T, 24>);
}

template <typename T>
int smem_of(int th) {
  return th == 16 ? Step<T, 16>::smem : Step<T, 24>::smem;
}

template <typename T>
int launch_fullstep(const void* const* fields, void* const* outs, void* scratch,
                    tv::Block b, int n_jacobi, int even_step, const double* pc,
                    const double* jc, const double* sxc, const double* syc,
                    int full_dv, int clamp, cudaStream_t stream) {
  if (n_jacobi < 0) return static_cast<int>(cudaErrorInvalidValue);
  StepArgs<T> a;
  a.F = static_cast<const T*>(fields[0]);
  a.u = static_cast<const T*>(fields[1]);
  a.v = static_cast<const T*>(fields[2]);
  a.p = static_cast<const T*>(fields[3]);
  a.F_out = static_cast<T*>(outs[0]);
  a.u_out = static_cast<T*>(outs[1]);
  a.v_out = static_cast<T*>(outs[2]);
  a.p_out = static_cast<T*>(outs[3]);
  T* s = static_cast<T*>(scratch);
  const size_t n = static_cast<size_t>(b.E0) * b.E1;
  T** bufs[] = {&a.us, &a.vs, &a.rhs, &a.pa, &a.pb};
  for (int k = 0; k < 5; ++k) *bufs[k] = s + k * n;
  a.b = b;
  a.pq = tv::predict_params<T>(pc);
  a.jq = tv::project_params<T>(jc);
  a.sx = tv::sweep_params<T>(b.nx, b.ny, sxc, full_dv, clamp);
  a.sy = tv::sweep_params<T>(b.ny, b.nx, syc, full_dv, clamp);
  a.n_jacobi = n_jacobi;
  a.even_step = even_step;
  int th, ctas;
  plan_launch<T>(b.E0, b.E1, th, ctas);
  if (ctas < 0) return -ctas;
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(kernel_of<T>(th), dim3(ctas),
                                                    dim3(kTX, kTY), args, smem_of<T>(th),
                                                    stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// out = {threads a CTA, shared bytes a CTA, CTAs an SM, CTAs launched, tile
// rows} on an (E0, E1) block
template <typename T>
int fullstep_shape(int E0, int E1, int* out) {
  int th, ctas;
  plan_launch<T>(E0, E1, th, ctas);
  if (ctas < 0) return -ctas;
  out[0] = kThreads;
  out[1] = smem_of<T>(th);
  out[2] = th == 16 ? Step<T, 16>::per_sm() : Step<T, 24>::per_sm();
  out[3] = ctas;
  out[4] = th;
  return 0;
}

}  // namespace

// fields: F, u, v, p (inputs); outs: F, u, v, p (outputs); scratch: 5
// blocks; all (E0, E1) blocks whose (0, 0) is global (oi, oj) of
// an nx x ny grid. pc, jc, sxc, syc: the predict, project, x-sweep and
// y-sweep constants (kernels/step_kernels.py).
extern "C" int tv_fullstep_f32(const void* const* fields, void* const* outs,
                               void* scratch, int E0, int E1, int oi, int oj,
                               int nx, int ny, int n_jacobi, int even_step,
                               const double* pc, const double* jc,
                               const double* sxc, const double* syc,
                               int full_dv, int clamp, void* stream) {
  return launch_fullstep<float>(fields, outs, scratch,
                                tv::Block{E0, E1, oi, oj, nx, ny}, n_jacobi,
                                even_step, pc, jc, sxc, syc, full_dv, clamp,
                                static_cast<cudaStream_t>(stream));
}

extern "C" int tv_fullstep_f64(const void* const* fields, void* const* outs,
                               void* scratch, int E0, int E1, int oi, int oj,
                               int nx, int ny, int n_jacobi, int even_step,
                               const double* pc, const double* jc,
                               const double* sxc, const double* syc,
                               int full_dv, int clamp, void* stream) {
  return launch_fullstep<double>(fields, outs, scratch,
                                 tv::Block{E0, E1, oi, oj, nx, ny}, n_jacobi,
                                 even_step, pc, jc, sxc, syc, full_dv, clamp,
                                 static_cast<cudaStream_t>(stream));
}

// The launch shape on an (E0, E1) block: out = {threads a CTA, shared
// bytes a CTA, CTAs an SM, CTAs launched, tile rows}.
extern "C" int tv_fullstep_shape_f32(int E0, int E1, int* out) {
  return fullstep_shape<float>(E0, E1, out);
}

extern "C" int tv_fullstep_shape_f64(int E0, int E1, int* out) {
  return fullstep_shape<double>(E0, E1, out);
}

// The Jacobi sweeps of each stage group for n_jacobi: writes at most cap
// depths to out and returns the number of groups.
extern "C" int tv_fullstep_levels(int n_jacobi, int* out, int cap) {
  const int n = n_jacobi > 0 ? tv::jacobi_groups(n_jacobi) : 0;
  for (int g = 0; g < n && g < cap; ++g) out[g] = tv::jacobi_depth(n_jacobi, g);
  return n;
}
