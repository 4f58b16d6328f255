// One Rudman/Zalesak FCT sweep of F along x or y, for Hopper (sm_90a).
//
// Replaces tpuvof/pallas_kernels/step_kernels.py:_pallas_sweep
// (pallas_fct_sweep_x/_y, the whole grid) and pallas_fct_sweep_win (a
// block with a global origin, _sweep_win_kernel), both with body
// _sweep_body: donor-cell flux, Ftd with the divergence compensation dV/dv,
// the limiter ratios rp/rm, the corrected anti-diffusive flux, and the
// optional clamps. The per-cell body is step_cell.cuh:sweep_at, shared with
// fullstep.cu.
//
// What bounds it on the H100: a sweep reads F and one velocity and writes F:
// 3 field-sized arrays, ~3.2 MB at 514^2 f32, ~1 us at 3.35 TB/s. The step
// makes two, so at the main path's size the sweep is bound by its launch.
//
// What the design does about it: nothing yet; it is the simple form. One
// launch per sweep and one thread per output cell, which loads its 7-cell
// line into registers and recomputes every face quantity: no scratch field
// and no second pass. The x-sweep's line is strided across rows (each load
// still coalesces along j); the y-sweep's line is contiguous and
// neighbouring threads share it through L1. A shared-memory line tile is
// the faster later form.
//
// Reads outside the global domain are 0 (the load sanitizer), and so are
// reads past the block's edges: for the whole grid the two coincide, and
// for a window the values they feed lie in the junk margin.
#include "step_cell.cuh"

namespace {

template <typename T, int AXIS>
__global__ void fct_sweep_kernel(const T* __restrict__ F,
                                 const T* __restrict__ vel, T* __restrict__ out,
                                 const tv::Block b, const tv::SweepParams<T> q) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= b.E0 || j >= b.E1) return;
  out[i * b.E1 + j] = tv::sweep_at<T, AXIS>(F, vel, b, i, j, q);
}

template <typename T>
int launch_sweep(const T* F, const T* vel, T* out, tv::Block b, int axis,
                 const double* c, int full_dv, int clamp, cudaStream_t stream) {
  const dim3 grid = tv::grid2d(b.E0, b.E1);
  if (axis == 0) {
    fct_sweep_kernel<T, 0><<<grid, tv::block2d(), 0, stream>>>(
        F, vel, out, b, tv::sweep_params<T>(b.nx, b.ny, c, full_dv, clamp));
  } else {
    fct_sweep_kernel<T, 1><<<grid, tv::block2d(), 0, stream>>>(
        F, vel, out, b, tv::sweep_params<T>(b.ny, b.nx, c, full_dv, clamp));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// F, vel: inputs; out: output; all (E0, E1) blocks whose (0, 0) is global
// (oi, oj) of an nx x ny grid. axis 0 sweeps along x with vel = u, axis 1
// along y with vel = v.
extern "C" int tv_fct_sweep_f32(const void* F, const void* vel, void* out,
                                int E0, int E1, int oi, int oj, int nx, int ny,
                                int axis, const double* c, int full_dv,
                                int clamp, void* stream) {
  return launch_sweep<float>(static_cast<const float*>(F),
                             static_cast<const float*>(vel),
                             static_cast<float*>(out),
                             tv::Block{E0, E1, oi, oj, nx, ny}, axis, c, full_dv,
                             clamp, static_cast<cudaStream_t>(stream));
}

extern "C" int tv_fct_sweep_f64(const void* F, const void* vel, void* out,
                                int E0, int E1, int oi, int oj, int nx, int ny,
                                int axis, const double* c, int full_dv,
                                int clamp, void* stream) {
  return launch_sweep<double>(static_cast<const double*>(F),
                              static_cast<const double*>(vel),
                              static_cast<double*>(out),
                              tv::Block{E0, E1, oi, oj, nx, ny}, axis, c,
                              full_dv, clamp, static_cast<cudaStream_t>(stream));
}
