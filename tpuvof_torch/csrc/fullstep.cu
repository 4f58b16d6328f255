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
// barrier (cooperative_groups' grid.sync()) between two. In each group a
// CTA of 32 x 8 threads takes tiles of TH rows x 32 columns in turn, loads
// the tile and a rim that covers the group's reach into shared memory
// (every load of a thread issued before its first store), runs the group's
// stages there with a __syncthreads() between two, each pass over the
// cells of a compile-time region, and writes the tile's outputs. The
// groups (predict, the Jacobi groups, finish) and their loop live in
// step_groups.cuh, shared with fullstep_dma.cu, which runs them with bulk
// copies; this kernel runs them under its ThreadLoads policy (the tiles,
// staging, Jacobi groups and launch plan live in stage_groups.cuh, shared
// with project.cu; the predictor's passes and the sweeps' lines in
// phase_tiles.cuh, shared with predict.cu and fct_sweep.cu).
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
#include "step_groups.cuh"

namespace {

using tv::kJacobiLevels;
using tv::kThreads;
using tv::kTW;
using tv::kTX;
using tv::kTY;
using tv::StepArgs;

// Shared values of T a CTA needs for tiles of TH rows: the largest stage
// group's boxes. predict: F (rim 3), u and v, kappa, the normals (u*/v*
// reuse their space); jacobi: a Jacobi group's at the greatest depth;
// finish: F and p (rim 5), u*, v*, u, v (rim 4), at odd pitches.
constexpr int smem_values(int th) {
  const int predict = tv::predict_tile_values(th, 1);
  const int jacobi = tv::jacobi_tile_values(th, kJacobiLevels);
  const int finish = 2 * (th + 10) * (kTW + 11) + 4 * (th + 8) * (kTW + 9);
  const int m = predict > jacobi ? predict : jacobi;
  return m > finish ? m : finish;
}

// At least 3 CTAs an SM in f32, so that the 374 tiles of a 514^2 grid run
// at once (the f64 boxes allow 2).
template <typename T, int TH>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 3 : 2)
    fullstep_kernel(const StepArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  tv::ThreadLoads<T, TH> pol(a.b, reinterpret_cast<T*>(smem_raw));
  tv::step_groups<TH>(a, pol);
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
