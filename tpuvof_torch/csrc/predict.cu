// The momentum predictor of the 2-D step, for Hopper (sm_90a).
//
// Replaces tpuvof/pallas_kernels/step_kernels.py:pallas_predict (the whole
// grid, _predict_kernel) and pallas_predict_win (a block with a global
// origin, _predict_win_kernel), both with body _predict_body: rho/nu mix,
// Youngs corner normals with the 1e-10 degeneracy guard, curvature kappa,
// and upwind u*/v* with viscosity, gravity and CSF surface tension. The
// per-cell bodies live in step_cell.cuh, shared with fullstep.cu.
//
// What bounds it on the H100: its two launches move about 8 field-sized
// arrays (F twice, u, v, kappa twice, u*, v*): ~8.5 MB at 514^2 f32, ~2.5 us
// at 3.35 TB/s and less still from the 50 MB L2. At the main path's size the
// phase is bound by launch latency, not by bandwidth or arithmetic.
//
// What the design does about it: nothing yet; it is the simple form. One
// thread per cell; u*/v* read F within radius 3 (normals at +-1, kappa at
// +-2, kappa averages at -1), so the phase is two launches: kappa into a
// scratch field, then the momentum update. The normals are recomputed per
// thread from F (four per kappa), which trades arithmetic for two scratch
// fields. The whole-step kernel (fullstep.cu) removes the launches on the
// fixed-Jacobi routes.
#include "step_cell.cuh"

namespace {

template <typename T>
__global__ void curvature_kernel(const T* __restrict__ F, T* __restrict__ kappa,
                                 const tv::Block b, const tv::PredictParams<T> q) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= b.E0 || j >= b.E1) return;
  kappa[i * b.E1 + j] = tv::curvature_at(F, b, i, j, q);
}

template <typename T>
__global__ void momentum_kernel(const T* __restrict__ u, const T* __restrict__ v,
                                const T* __restrict__ F,
                                const T* __restrict__ kappa, T* __restrict__ us,
                                T* __restrict__ vs, const tv::Block b,
                                const tv::PredictParams<T> q) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= b.E0 || j >= b.E1) return;
  T us_o, vs_o;
  tv::momentum_at(u, v, F, kappa, b, i, j, q, us_o, vs_o);
  us[i * b.E1 + j] = us_o;
  vs[i * b.E1 + j] = vs_o;
}

template <typename T>
int launch_predict(const T* u, const T* v, const T* F, T* kappa, T* us, T* vs,
                   tv::Block b, const double* c, cudaStream_t stream) {
  const tv::PredictParams<T> q = tv::predict_params<T>(c);
  const dim3 grid = tv::grid2d(b.E0, b.E1);
  curvature_kernel<T><<<grid, tv::block2d(), 0, stream>>>(F, kappa, b, q);
  momentum_kernel<T><<<grid, tv::block2d(), 0, stream>>>(u, v, F, kappa, us, vs, b, q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// u, v, F: inputs; kappa: scratch; us, vs: outputs; all (E0, E1) blocks whose
// (0, 0) is global (oi, oj) of an nx x ny grid.
extern "C" int tv_predict_f32(const void* u, const void* v, const void* F,
                              void* kappa, void* us, void* vs, int E0, int E1,
                              int oi, int oj, int nx, int ny, const double* c,
                              void* stream) {
  return launch_predict<float>(
      static_cast<const float*>(u), static_cast<const float*>(v),
      static_cast<const float*>(F), static_cast<float*>(kappa),
      static_cast<float*>(us), static_cast<float*>(vs),
      tv::Block{E0, E1, oi, oj, nx, ny}, c, static_cast<cudaStream_t>(stream));
}

extern "C" int tv_predict_f64(const void* u, const void* v, const void* F,
                              void* kappa, void* us, void* vs, int E0, int E1,
                              int oi, int oj, int nx, int ny, const double* c,
                              void* stream) {
  return launch_predict<double>(
      static_cast<const double*>(u), static_cast<const double*>(v),
      static_cast<const double*>(F), static_cast<double*>(kappa),
      static_cast<double*>(us), static_cast<double*>(vs),
      tv::Block{E0, E1, oi, oj, nx, ny}, c, static_cast<cudaStream_t>(stream));
}
