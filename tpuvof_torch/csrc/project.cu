// The pressure projection of the 2-D step, for Hopper (sm_90a).
//
// Replaces tpuvof/pallas_kernels/step_kernels.py:project_pressure_and_correct
// (_project_kernel, coefficients _inline_poisson_coeffs): rho from F, the
// divergence rhs, n_jacobi Jacobi sweeps with Neumann-edge coefficients, and
// the face-rho velocity correction.
//
// What bounds it on the H100: it must read F, u*, v*, p, u, v and write p,
// u, v: 9 fields, ~9.5 MB at 514^2 f32, 2.84 us at 3.35 TB/s. Each sweep
// depends on the previous one across cells, so what the card spends is the
// chain of dependent passes and what separates them.
//
// What the first design cost: one thread per cell and one launch per pass
// (rhs, each sweep, the correction: 12 launches at n_jacobi 10), nothing
// kept on chip between two; 43.40 us at 514^2 f32 on an H100 80GB HBM3 at
// 700 W (PERF.md), each launch paying its ramp and drain.
//
// What this design does: one cooperative launch of stage_groups.cuh's
// stage groups (fullstep.cu's Jacobi groups), a grid-wide barrier between
// two, each CTA taking tiles of 16 or 24 rows x 32 columns in turn:
//   first: stages the entry p, F, u* and v* on the tile + the group's rim
//          and forms rhs there, then the group's sweeps; writes the tile's
//          rhs (the later groups stage it) and p;
//   middle: tv::jacobi_depth_tile (stages p and rhs); writes p;
//   last:  its sweeps on the tile + 1 (one more rim), so that p is final
//          where the correction reads it (the cell and one below/left),
//          then the correction of the tile; writes p, u, v.
// One group does it all up to n_jacobi = kJacobiLevels, with no grid
// barrier; at n_jacobi 10 (4, 3, 3) two barriers replace 11 kernel
// boundaries. Every value is step_cell.cuh's rhs_of, jacobi_of or
// correct_of on Tile accessors, the same IEEE operations on the same inputs
// as the one-thread-per-cell form, so p, u and v are its outputs bit for
// bit: p keeps the entry p's ghost ring (no sweep updates it), u and v the
// entry values off the corrected ranges.
#include <cooperative_groups.h>

#include "stage_groups.cuh"

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

template <typename T>
struct ProjectArgs {
  const T *F, *us, *vs, *p, *u, *v;  // inputs
  T *p_out, *u_out, *v_out;
  T *p_tmp, *rhs;  // scratch, each one block
  tv::Block b;
  tv::ProjectParams<T> q;
  int n_jacobi;
};

// Shared values of T of a first and/or last group of depth d on tiles of
// th rows (rim R = d, one more in a last group). first: p, F, u*, v*, the
// second level and rhs on the tile + R; last also u and v on the tile.
// last alone: p, the second level and rhs on the tile + R; F, u*, v*, u, v
// on the tile and one row and column below it.
constexpr int edge_values(int th, int d, bool first, bool last) {
  const int r = d + (last ? 1 : 0);
  const int box = (th + 2 * r) * (kTW + 2 * r);
  return first ? 6 * box + (last ? 2 * th * kTW : 0) : 3 * box + 5 * (th + 1) * (kTW + 1);
}

// Shared values of T a CTA needs for tiles of th rows: the largest group
// at the greatest depth.
constexpr int smem_values(int th) {
  const int d = kJacobiLevels;
  const int values[] = {edge_values(th, d, true, true), edge_values(th, d, true, false),
                        edge_values(th, d, false, true), tv::jacobi_tile_values(th, d)};
  int m = 0;
  for (int v : values) m = v > m ? v : m;
  return m;
}

// The first (FIRST) and/or last (LAST) group of depth D on the tile at
// (ti, tj): the sweeps from src (the entry p in a first group) into dst.
template <int TH, int D, bool FIRST, bool LAST, typename T>
__device__ __forceinline__ void edge_tile(const ProjectArgs<T>& a, T* sm, int ti, int tj,
                                          const T* src, T* dst) {
  const tv::Block& b = a.b;
  constexpr int R = D + (LAST ? 1 : 0);
  constexpr int H = TH + 2 * R, W = kTW + 2 * R;
  const Box<T> p0{sm, ti - R, tj - R, W};
  const Box<T> p1{p0.end(H), ti - R, tj - R, W};
  const Box<T> rhs{p1.end(H), ti - R, tj - R, W};
  // F, u*, v* (and u, v) of the rhs and the correction
  const int o = FIRST ? R : 1;
  const int w = FIRST ? W : kTW + 1;
  const int h = FIRST ? H : TH + 1;
  const Box<T> F{rhs.end(H), ti - o, tj - o, w};
  const Box<T> us{F.end(h), ti - o, tj - o, w};
  const Box<T> vs{us.end(h), ti - o, tj - o, w};
  const Box<T> u{vs.end(h), ti - (FIRST ? 0 : 1), tj - (FIRST ? 0 : 1), FIRST ? kTW : w};
  const Box<T> v{u.end(FIRST ? TH : h), u.i0, u.j0, u.w};
  if constexpr (FIRST) {
    stage<H, W, 4, T>(b, {p0, F, us, vs}, {src, a.F, a.us, a.vs});
    if constexpr (LAST) stage<TH, kTW, 2, T>(b, {u, v}, {a.u, a.v});
    __syncthreads();
    // rhs where the first sweep updates (the box less one ring); the tile's
    // for the later groups, 0 off the global interior
    for_cells<H - 2, W - 2>(ti - R + 1, tj - R + 1, [&](int i, int j) {
      const T r = b.inside(i, j) && b.interior(i, j)
                      ? tv::rhs_of(Tile<T>(F, i, j), Tile<T>(us, i, j), Tile<T>(vs, i, j), a.q)
                      : T(0);
      rhs(i, j) = r;
      if (!LAST && b.inside(i, j) && i >= ti && i < ti + TH && j >= tj && j < tj + kTW)
        a.rhs[i * b.E1 + j] = r;
    });
  } else {
    stage<H, W, 2, T>(b, {p0, rhs}, {src, a.rhs});
    stage<TH + 1, kTW + 1, 5, T>(b, {F, us, vs, u, v}, {a.F, a.us, a.vs, a.u, a.v});
  }
  __syncthreads();
  tv::jacobi_sweeps<TH + 2 * (R - D), kTW + 2 * (R - D), D, 1>(b, a.q, p0, p1, rhs, ti - R + D,
                                                                tj - R + D);
  const Box<T>& pf = D % 2 ? p1 : p0;  // exact on the tile (+ 1 in a last group)
  for_cells<TH, kTW>(ti, tj, [&](int i, int j) {
    if (!b.inside(i, j)) return;
    const int c = i * b.E1 + j;
    dst[c] = pf(i, j);
    if (LAST) {
      T uo, vo;
      tv::correct_of(Tile<T>(F, i, j), Tile<T>(us, i, j), Tile<T>(vs, i, j), Tile<T>(pf, i, j),
                     Tile<T>(u, i, j), Tile<T>(v, i, j), b, i, j, a.q, uo, vo);
      a.u_out[c] = uo;
      a.v_out[c] = vo;
    }
  });
  __syncthreads();  // the next tile reuses the boxes
}

// edge_tile at a depth d <= D known at run time (a first and last group
// may have depth 0: n_jacobi 0, the correction from the entry p).
template <int TH, bool FIRST, bool LAST, int D = kJacobiLevels, typename T>
__device__ __forceinline__ void edge_depth_tile(int d, const ProjectArgs<T>& a, T* sm, int ti,
                                                int tj, const T* src, T* dst) {
  if constexpr (D > (FIRST && LAST ? 0 : 1)) {
    if (d < D) {
      edge_depth_tile<TH, FIRST, LAST, D - 1>(d, a, sm, ti, tj, src, dst);
      return;
    }
  }
  edge_tile<TH, D, FIRST, LAST>(a, sm, ti, tj, src, dst);
}

template <typename T, int TH>
__global__ void __launch_bounds__(kThreads) project_kernel(const ProjectArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  const int tiles_j = (a.b.E1 + kTW - 1) / kTW;
  const int n_tiles = tiles_j * ((a.b.E0 + TH - 1) / TH);
  const int n = a.n_jacobi > 0 ? tv::jacobi_groups(a.n_jacobi) : 1;
  const T* src = a.p;
  for (int g = 0; g < n; ++g) {
    const int d = a.n_jacobi > 0 ? tv::jacobi_depth(a.n_jacobi, g) : 0;
    // the last group writes p_out, the groups before it alternate
    T* dst = (n - 1 - g) % 2 ? a.p_tmp : a.p_out;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int ti = t / tiles_j * TH, tj = t % tiles_j * kTW;
      if (n == 1) {
        edge_depth_tile<TH, true, true>(d, a, sm, ti, tj, src, dst);
      } else if (g == 0) {
        edge_depth_tile<TH, true, false>(d, a, sm, ti, tj, src, dst);
      } else if (g == n - 1) {
        edge_depth_tile<TH, false, true>(d, a, sm, ti, tj, src, dst);
      } else {
        tv::jacobi_depth_tile<TH, kJacobiLevels>(d, a.b, a.q, sm, ti, tj, src, a.rhs, dst);
      }
    }
    if (g + 1 < n) grid.sync();
    src = dst;
  }
}

// The kernel with TH-row tiles: its shared bytes (granted once a device)
// and the CTAs an SM holds with them (asked once a device), or a negative
// CUDA error.
template <typename T, int TH>
struct Project {
  static constexpr int smem = smem_values(TH) * static_cast<int>(sizeof(T));
  static int per_sm() {
    static std::atomic<int> cache[tv::kMaxDevices];
    return tv::coop_per_sm(cache, project_kernel<T, TH>, smem);
  }
};

template <typename T>
void plan_launch(int E0, int E1, int& th, int& ctas) {
  tv::plan_rows(E0, E1, Project<T, 16>::per_sm(), Project<T, 24>::per_sm(), th, ctas);
}

template <typename T>
int launch_project(const T* F, const T* us, const T* vs, const T* p, const T* u,
                   const T* v, T* p_out, T* p_tmp, T* rhs, T* u_out, T* v_out,
                   int nx, int ny, int n_jacobi, const double* c,
                   cudaStream_t stream) {
  if (n_jacobi < 0) return static_cast<int>(cudaErrorInvalidValue);
  const ProjectArgs<T> a{F, us, vs, p, u, v, p_out, u_out, v_out, p_tmp, rhs,
                         tv::Block{nx + 2, ny + 2, 0, 0, nx, ny}, tv::project_params<T>(c),
                         n_jacobi};
  int th, ctas;
  plan_launch<T>(nx + 2, ny + 2, th, ctas);
  if (ctas < 0) return -ctas;
  const void* kernel = th == 16 ? reinterpret_cast<const void*>(project_kernel<T, 16>)
                                : reinterpret_cast<const void*>(project_kernel<T, 24>);
  void* args[] = {const_cast<ProjectArgs<T>*>(&a)};
  const int smem = th == 16 ? Project<T, 16>::smem : Project<T, 24>::smem;
  const cudaError_t e =
      cudaLaunchCooperativeKernel(kernel, dim3(ctas), dim3(kTX, kTY), args, smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// out = {threads a CTA, shared bytes a CTA, CTAs an SM, CTAs launched, tile
// rows} on an (E0, E1) grid
template <typename T>
int project_shape(int E0, int E1, int* out) {
  int th, ctas;
  plan_launch<T>(E0, E1, th, ctas);
  if (ctas < 0) return -ctas;
  out[0] = kThreads;
  out[1] = th == 16 ? Project<T, 16>::smem : Project<T, 24>::smem;
  out[2] = th == 16 ? Project<T, 16>::per_sm() : Project<T, 24>::per_sm();
  out[3] = ctas;
  out[4] = th;
  return 0;
}

}  // namespace

// F, us, vs, p, u, v: inputs; p_out, u_out, v_out: outputs; p_tmp, rhs:
// scratch; all (nx+2, ny+2).
extern "C" int tv_project_f32(const void* F, const void* us, const void* vs,
                              const void* p, const void* u, const void* v,
                              void* p_out, void* p_tmp, void* rhs, void* u_out,
                              void* v_out, int nx, int ny, int n_jacobi,
                              const double* c, void* stream) {
  return launch_project<float>(
      static_cast<const float*>(F), static_cast<const float*>(us),
      static_cast<const float*>(vs), static_cast<const float*>(p),
      static_cast<const float*>(u), static_cast<const float*>(v),
      static_cast<float*>(p_out), static_cast<float*>(p_tmp),
      static_cast<float*>(rhs), static_cast<float*>(u_out),
      static_cast<float*>(v_out), nx, ny, n_jacobi, c,
      static_cast<cudaStream_t>(stream));
}

extern "C" int tv_project_f64(const void* F, const void* us, const void* vs,
                              const void* p, const void* u, const void* v,
                              void* p_out, void* p_tmp, void* rhs, void* u_out,
                              void* v_out, int nx, int ny, int n_jacobi,
                              const double* c, void* stream) {
  return launch_project<double>(
      static_cast<const double*>(F), static_cast<const double*>(us),
      static_cast<const double*>(vs), static_cast<const double*>(p),
      static_cast<const double*>(u), static_cast<const double*>(v),
      static_cast<double*>(p_out), static_cast<double*>(p_tmp),
      static_cast<double*>(rhs), static_cast<double*>(u_out),
      static_cast<double*>(v_out), nx, ny, n_jacobi, c,
      static_cast<cudaStream_t>(stream));
}

// The launch shape on an (E0, E1) grid: out = {threads a CTA, shared bytes
// a CTA, CTAs an SM, CTAs launched, tile rows}.
extern "C" int tv_project_shape_f32(int E0, int E1, int* out) {
  return project_shape<float>(E0, E1, out);
}

extern "C" int tv_project_shape_f64(int E0, int E1, int* out) {
  return project_shape<double>(E0, E1, out);
}

// The message of a status code returned by any entry point of this library.
extern "C" const char* tv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
