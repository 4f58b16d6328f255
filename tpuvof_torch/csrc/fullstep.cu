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
// sweep the next, the correction the sweeps, the sweeps the BCs): n_jacobi
// + 7 stages. The compulsory traffic is 4 fields in and 4 out, ~8.5 MB at
// 514^2 f32 (~2.5 us at 3.35 TB/s); the intermediates (7 block-sized
// scratch fields, ~7.4 MB) stay in the 50 MB L2. With 16 stages of a few
// microseconds each, the grid-wide barriers and the per-stage latency
// bound it, not bytes or arithmetic.
//
// What the design does about it: design (a), one cooperative launch
// (cudaLaunchCooperativeKernel). Each stage is a grid-stride loop over the
// block's cells, one thread per cell at a time, and cooperative_groups'
// grid.sync() separates the stages; the intermediates live in global
// scratch that the wrapper allocates. The grid is sized to what the card
// holds resident at once (occupancy x SMs), as a grid-wide barrier needs.
// One launch replaces the phase route's 16 kernels and ~23 torch ops per
// step, and the same code serves every block layout and both dtypes. Halo-
// cone tiles in shared memory (design (b)) would cut the barriers; that is
// later work.
//
// Jacobi stays out of place with two ping-pong buffers, both seeded with
// the sanitized entry p; it updates cells of the global interior that are
// not on the block's edge, so every other p keeps its entry value (the
// global ghost ring, then overwritten by the BCs). The end-of-step BCs read
// neighbours written by other threads in the stage before, so they run
// after a barrier, from the clamped scratch into the outputs, in tpuvof's
// j-then-i corner order.
#include <cooperative_groups.h>

#include "step_cell.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

template <typename T>
struct StepArgs {
  const T *F, *u, *v, *p;      // entry block fields
  T *F_out, *u_out, *v_out, *p_out;
  T *kr, *us, *vs, *pa, *pb, *un, *vn;  // scratch, each one block
  tv::Block b;
  tv::PredictParams<T> pq;
  tv::ProjectParams<T> jq;
  tv::SweepParams<T> sx, sy;
  int n_jacobi, even_step;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) fullstep_kernel(const StepArgs<T> a) {
  cg::grid_group grid = cg::this_grid();
  const tv::Block& b = a.b;
  const int n = b.E0 * b.E1;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
#define TV_CELLS for (int c = first, i = c / b.E1, j = c % b.E1; c < n; \
                      c += stride, i = c / b.E1, j = c % b.E1)

  // kappa; both Jacobi buffers <- the sanitized entry p
  TV_CELLS {
    a.kr[c] = tv::curvature_at(a.F, b, i, j, a.pq);
    const T pv = tv::ld(a.p, b, i, j);
    a.pa[c] = pv;
    a.pb[c] = pv;
  }
  grid.sync();
  TV_CELLS { tv::momentum_at(a.u, a.v, a.F, a.kr, b, i, j, a.pq, a.us[c], a.vs[c]); }
  grid.sync();
  // rhs over kappa's buffer (kappa is dead)
  TV_CELLS { a.kr[c] = b.interior(i, j) ? tv::rhs_at(a.F, a.us, a.vs, b, i, j, a.jq) : T(0); }
  grid.sync();
  T* src = a.pa;
  T* dst = a.pb;
  for (int it = 0; it < a.n_jacobi; ++it) {
    TV_CELLS {
      if (b.interior(i, j) && i >= 1 && i < b.E0 - 1 && j >= 1 && j < b.E1 - 1)
        dst[c] = tv::jacobi_at(src, a.kr[c], b, i, j, a.jq);
    }
    grid.sync();
    T* t = src;
    src = dst;
    dst = t;
  }
  const T* p = src;
  TV_CELLS {
    tv::correct_at(a.F, a.us, a.vs, p, a.u, a.v, b, i, j, a.jq, a.un[c], a.vn[c]);
  }
  grid.sync();
  // the two sweeps: the first into us' buffer, the second, clamped, into vs'
  // (u* and v* are dead)
  const int ax1 = a.even_step ? 1 : 0;
  TV_CELLS {
    a.us[c] = ax1 ? tv::sweep_at<T, 1>(a.F, a.vn, b, i, j, a.sy)
                  : tv::sweep_at<T, 0>(a.F, a.un, b, i, j, a.sx);
  }
  grid.sync();
  TV_CELLS {
    a.vs[c] = tv::clamp01(ax1 ? tv::sweep_at<T, 0>(a.us, a.un, b, i, j, a.sx)
                              : tv::sweep_at<T, 1>(a.us, a.vn, b, i, j, a.sy));
  }
  grid.sync();
  // wall BCs at global indices (tpuvof's _bc_values): u mirrored across
  // the j-walls then zero on the i-wall faces; v zero on the j-wall faces
  // then mirrored across the i-walls; F and p mirrored j first, then i.
  TV_CELLS {
    const int gi = i + b.oi, gj = j + b.oj;
    const int di = gi == 0 ? 1 : (gi == b.nx + 1 ? -1 : 0);
    const int dj = gj == 0 ? 1 : (gj == b.ny + 1 ? -1 : 0);
    a.u_out[c] = gi == 1 || gi == b.nx + 1 ? T(0) : tv::ld(a.un, b, i, j + dj);
    a.v_out[c] = gj == 1 || gj == b.ny + 1 ? T(0) : tv::ld(a.vn, b, i + di, j);
    a.F_out[c] = tv::ld(a.vs, b, i + di, j + dj);
    a.p_out[c] = tv::ld(p, b, i + di, j + dj);
  }
#undef TV_CELLS
}

// Blocks of kThreads that the card holds resident at once (the most a
// cooperative launch may have), or a negative CUDA error.
template <typename T>
int resident_blocks() {
  static int cached = 0;
  if (cached > 0) return cached;
  int dev, sms, per_sm, coop;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fullstep_kernel<T>,
                                                      kThreads, 0);
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorLaunchOutOfResources;
  if (e != cudaSuccess) return -static_cast<int>(e);
  cached = per_sm * sms;
  return cached;
}

template <typename T>
int launch_fullstep(const void* const* fields, void* const* outs, void* scratch,
                    tv::Block b, int n_jacobi, int even_step, const double* pc,
                    const double* jc, const double* sxc, const double* syc,
                    int full_dv, int clamp, cudaStream_t stream) {
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
  T** bufs[] = {&a.kr, &a.us, &a.vs, &a.pa, &a.pb, &a.un, &a.vn};
  for (int k = 0; k < 7; ++k) *bufs[k] = s + k * n;
  a.b = b;
  a.pq = tv::predict_params<T>(pc);
  a.jq = tv::project_params<T>(jc);
  a.sx = tv::sweep_params<T>(b.nx, b.ny, sxc, full_dv, clamp);
  a.sy = tv::sweep_params<T>(b.ny, b.nx, syc, full_dv, clamp);
  a.n_jacobi = n_jacobi;
  a.even_step = even_step;
  const int resident = resident_blocks<T>();
  if (resident < 0) return -resident;
  const long long want = (static_cast<long long>(n) + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < resident ? want : resident);
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fullstep_kernel<T>), dim3(blocks), dim3(kThreads),
      args, 0, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fields: F, u, v, p (inputs); outs: F, u, v, p (outputs); scratch: 7
// blocks; all (E0, E1) blocks whose (0, 0) is global (oi, oj) of an nx x ny
// grid. pc, jc, sxc, syc: the predict, project, x-sweep and y-sweep
// constants (kernels/step_kernels.py).
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
