// The pressure projection of the 2-D step, for Hopper (sm_90a).
//
// Replaces tpuvof/pallas_kernels/step_kernels.py:project_pressure_and_correct
// (_project_kernel, coefficients _inline_poisson_coeffs): rho from F, the
// divergence rhs, n_jacobi Jacobi sweeps with Neumann-edge coefficients, and
// the face-rho velocity correction.
//
// What bounds it on the H100: one call moves about 45 field-sized arrays at
// n_jacobi = 10 (7 for rhs and the buffer set-up, 3 per sweep, 8 for the
// correction): ~47 MB at 514^2 f32, ~14 us at 3.35 TB/s, and the whole working
// set (~7 MB) stays in the 50 MB L2 between launches. Its 12 launches cost
// more than that traffic: at the main path's size it is launch-bound.
//
// What the design does about it: nothing yet; it is the simple form. Three
// kernel functions, one thread per cell: rhs (which also seeds both
// ping-pong buffers with the entry p, ghost ring included), one launch per
// Jacobi sweep, and the correction. Jacobi is out of place: a sweep reads one
// buffer and writes the other, as the TPU kernel's whole-array update does;
// a single buffer updated in place would race and be a different method. A
// grid-wide barrier inside one cooperative launch, or temporal blocking of
// the sweeps in shared memory, removes the launches; fullstep.cu does the former for the whole step.
//
// The edge coefficients are zeroed on the global walls and ap_inv is picked
// from four edge-class constants the host computes in double and casts, as
// _inline_poisson_coeffs does. The per-cell bodies are step_cell.cuh's
// rhs_at, jacobi_at and correct_at, shared with fullstep.cu.
#include "step_cell.cuh"

namespace {

// Both ping-pong buffers <- p (whole field); rhs = rho/dt * div(u*) on the
// interior, stored as an (nx, ny) array.
template <typename T>
__global__ void rhs_kernel(const T* __restrict__ F, const T* __restrict__ us,
                           const T* __restrict__ vs, const T* __restrict__ p,
                           T* __restrict__ pa, T* __restrict__ pb,
                           T* __restrict__ rhs, const tv::Block b,
                           const tv::ProjectParams<T> q) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= b.E0 || j >= b.E1) return;
  const int o = i * b.E1 + j;
  const T pv = p[o];
  pa[o] = pv;
  pb[o] = pv;
  if (b.interior(i, j)) rhs[(i - 1) * b.ny + (j - 1)] = tv::rhs_at(F, us, vs, b, i, j, q);
}

// One Jacobi sweep: dst's interior from src; dst's ghost ring is untouched.
template <typename T>
__global__ void jacobi_kernel(const T* __restrict__ src, T* __restrict__ dst,
                              const T* __restrict__ rhs, const tv::Block b,
                              const tv::ProjectParams<T> q) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (!b.inside(i, j) || !b.interior(i, j)) return;
  dst[i * b.E1 + j] = tv::jacobi_at(src, rhs[(i - 1) * b.ny + (j - 1)], b, i, j, q);
}

// u on rows 2..nx x cols 1..ny and v on rows 1..nx x cols 2..ny from u*, v*
// and the pressure gradient; every other entry keeps the entry u, v.
template <typename T>
__global__ void correct_kernel(const T* __restrict__ F, const T* __restrict__ us,
                               const T* __restrict__ vs, const T* __restrict__ p,
                               const T* __restrict__ u, const T* __restrict__ v,
                               T* __restrict__ u_out, T* __restrict__ v_out,
                               const tv::Block b, const tv::ProjectParams<T> q) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= b.E0 || j >= b.E1) return;
  T uo, vo;
  tv::correct_at(F, us, vs, p, u, v, b, i, j, q, uo, vo);
  u_out[i * b.E1 + j] = uo;
  v_out[i * b.E1 + j] = vo;
}

template <typename T>
int launch_project(const T* F, const T* us, const T* vs, const T* p, const T* u,
                   const T* v, T* p_out, T* p_tmp, T* rhs, T* u_out, T* v_out,
                   int nx, int ny, int n_jacobi, const double* c,
                   cudaStream_t stream) {
  const tv::ProjectParams<T> q = tv::project_params<T>(c);
  const tv::Block b{nx + 2, ny + 2, 0, 0, nx, ny};
  const dim3 grid = tv::grid2d(nx + 2, ny + 2);
  rhs_kernel<T><<<grid, tv::block2d(), 0, stream>>>(F, us, vs, p, p_out, p_tmp,
                                                    rhs, b, q);
  // start on the buffer that makes the last sweep write p_out
  T* src = n_jacobi % 2 ? p_tmp : p_out;
  T* dst = n_jacobi % 2 ? p_out : p_tmp;
  for (int it = 0; it < n_jacobi; ++it) {
    jacobi_kernel<T><<<grid, tv::block2d(), 0, stream>>>(src, dst, rhs, b, q);
    T* t = src;
    src = dst;
    dst = t;
  }
  correct_kernel<T><<<grid, tv::block2d(), 0, stream>>>(F, us, vs, p_out, u, v,
                                                        u_out, v_out, b, q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// F, us, vs, p, u, v: inputs; p_out, u_out, v_out: outputs; p_tmp: scratch,
// all (nx+2, ny+2); rhs: (nx, ny) scratch.
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

// The message of a status code returned by any entry point of this library.
extern "C" const char* tv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
