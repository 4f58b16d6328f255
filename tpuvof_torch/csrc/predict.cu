// The momentum predictor of the 2-D step, for Hopper (sm_90a).
//
// Replaces tpuvof/pallas_kernels/step_kernels.py:pallas_predict
// (_predict_kernel, body _predict_body): rho/nu mix, Youngs corner normals
// with the 1e-10 degeneracy guard, curvature kappa, and upwind u*/v* with
// viscosity, gravity and CSF surface tension.
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
// fields. The launch bound goes with the whole-step kernel and the CUDA
// graph of the step loop (ROADMAP Queue 2).
//
// The arithmetic follows the Pallas body term by term and in its order, and
// the library is built with --fmad=false, so the f64 build agrees with the
// plain PyTorch version (kernels/step_kernels.py:predict_plain) to rounding.
#include "common.cuh"

namespace {

template <typename T>
struct PredictParams {
  int nx, ny;
  T rho_l, rho_g, nu_l, nu_g;
  T neg_inv2dx, neg_inv2dy, inv2dx, inv2dy;
  T dt, dxi, dyi, dxi2, dyi2;
  T neg_sigma, dx, dy, gx, gy;
};

// The order of c[] is kernels/step_kernels.py:_predict_constants.
template <typename T>
PredictParams<T> make_params(int nx, int ny, const double* c) {
  PredictParams<T> q;
  q.nx = nx;
  q.ny = ny;
  q.rho_l = T(c[0]);
  q.rho_g = T(c[1]);
  q.nu_l = T(c[2]);
  q.nu_g = T(c[3]);
  q.neg_inv2dx = T(c[4]);
  q.neg_inv2dy = T(c[5]);
  q.inv2dx = T(c[6]);
  q.inv2dy = T(c[7]);
  q.dt = T(c[8]);
  q.dxi = T(c[9]);
  q.dyi = T(c[10]);
  q.dxi2 = T(c[11]);
  q.dyi2 = T(c[12]);
  q.neg_sigma = T(c[13]);
  q.dx = T(c[14]);
  q.dy = T(c[15]);
  q.gx = T(c[16]);
  q.gy = T(c[17]);
  return q;
}

// Youngs normal of cell (i, j): the mean of the four corner gradients,
// normalized unless both components are below 1e-10. Zero outside the
// interior, as the normal fields' ghosts are in the reference.
template <typename T>
__device__ __forceinline__ void normal_at(const T* __restrict__ F, int i, int j,
                                          const PredictParams<T>& q, T& mx,
                                          T& my) {
  if (i < 1 || i > q.nx || j < 1 || j > q.ny) {
    mx = T(0);
    my = T(0);
    return;
  }
  const int n1 = q.ny + 2;
  auto f = [&](int di, int dj) { return F[(i + di) * n1 + (j + dj)]; };
  const T mx1 = q.neg_inv2dx * (f(1, 1) + f(1, 0) - f(0, 1) - f(0, 0));
  const T my1 = q.neg_inv2dy * (f(1, 1) - f(1, 0) + f(0, 1) - f(0, 0));
  const T mx2 = q.neg_inv2dx * (f(1, 0) + f(1, -1) - f(0, 0) - f(0, -1));
  const T my2 = q.neg_inv2dy * (f(1, 0) - f(1, -1) + f(0, 0) - f(0, -1));
  const T mx3 = q.neg_inv2dx * (f(0, 0) + f(0, -1) - f(-1, 0) - f(-1, -1));
  const T my3 = q.neg_inv2dy * (f(0, 0) - f(0, -1) + f(-1, 0) - f(-1, -1));
  const T mx4 = q.neg_inv2dx * (f(0, 1) + f(0, 0) - f(-1, 1) - f(-1, 0));
  const T my4 = q.neg_inv2dy * (f(0, 1) - f(0, 0) + f(-1, 1) - f(-1, 0));
  const T mxsum = (mx1 + mx2 + mx3 + mx4) * T(0.25);
  const T mysum = (my1 + my2 + my3 + my4) * T(0.25);
  const bool degenerate = fabs(mxsum) < T(1e-10) && fabs(mysum) < T(1e-10);
  const T mag_sq = mxsum * mxsum + mysum * mysum;
  const T safe_mag = sqrt(degenerate ? T(1) : mag_sq);
  mx = degenerate ? mxsum : mxsum / safe_mag;
  my = degenerate ? mysum : mysum / safe_mag;
}

// kappa = -div(normal) on the interior, 0 on the ghost ring.
template <typename T>
__global__ void curvature_kernel(const T* __restrict__ F, T* __restrict__ kappa,
                                 const PredictParams<T> q) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i > q.nx + 1 || j > q.ny + 1) return;
  T k = T(0);
  if (i >= 1 && i <= q.nx && j >= 1 && j <= q.ny) {
    T mx_e, my_e, mx_w, my_w, mx_n, my_n, mx_s, my_s;
    normal_at(F, i + 1, j, q, mx_e, my_e);
    normal_at(F, i - 1, j, q, mx_w, my_w);
    normal_at(F, i, j + 1, q, mx_n, my_n);
    normal_at(F, i, j - 1, q, mx_s, my_s);
    k = -(q.inv2dx * (mx_e - mx_w) + q.inv2dy * (my_n - my_s));
  }
  kappa[i * (q.ny + 2) + j] = k;
}

// u* on rows 2..nx x cols 1..ny, v* on rows 1..nx x cols 2..ny, 0 elsewhere.
template <typename T>
__global__ void momentum_kernel(const T* __restrict__ u, const T* __restrict__ v,
                                const T* __restrict__ F,
                                const T* __restrict__ kappa, T* __restrict__ us,
                                T* __restrict__ vs, const PredictParams<T> q) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i > q.nx + 1 || j > q.ny + 1) return;
  const int n1 = q.ny + 2;
  const int o = i * n1 + j;
  auto U = [&](int di, int dj) { return u[o + di * n1 + dj]; };
  auto V = [&](int di, int dj) { return v[o + di * n1 + dj]; };

  T us_o = T(0);
  T vs_o = T(0);
  if (i >= 1 && i <= q.nx && j >= 1 && j <= q.ny) {
    const T rho_c = tv::mix_rho(F[o], q.rho_l, q.rho_g);
    const T nu_c = tv::mix_nu(F[o], q.nu_l, q.nu_g);
    if (i >= 2) {
      const T uc = U(0, 0);
      const T v_here = T(0.25) * (V(-1, 0) + V(-1, 1) + V(0, 0) + V(0, 1));
      const T dudx = uc > T(0) ? (uc - U(-1, 0)) * q.dxi : (U(1, 0) - uc) * q.dxi;
      const T dudy =
          v_here > T(0) ? (uc - U(0, -1)) * q.dyi : (U(0, 1) - uc) * q.dyi;
      const T kap_u = (kappa[o] + kappa[o - n1]) * T(0.5);
      const T fx_kappa = q.neg_sigma * (F[o] - F[o - n1]) * kap_u / q.dx;
      const T rho_w = tv::mix_rho(F[o - n1], q.rho_l, q.rho_g);
      us_o = uc + q.dt * (nu_c * (U(-1, 0) - T(2) * uc + U(1, 0)) * q.dxi2 +
                          nu_c * (U(0, -1) - T(2) * uc + U(0, 1)) * q.dyi2 -
                          uc * dudx - v_here * dudy + q.gx +
                          fx_kappa * T(2) / (rho_c + rho_w));
    }
    if (j >= 2) {
      const T vc = V(0, 0);
      const T u_here = T(0.25) * (U(0, -1) + U(0, 0) + U(1, -1) + U(1, 0));
      const T dvdx =
          u_here > T(0) ? (vc - V(-1, 0)) * q.dxi : (V(1, 0) - vc) * q.dxi;
      const T dvdy = vc > T(0) ? (vc - V(0, -1)) * q.dyi : (V(0, 1) - vc) * q.dyi;
      const T kap_v = (kappa[o] + kappa[o - 1]) * T(0.5);
      const T fy_kappa = q.neg_sigma * (F[o] - F[o - 1]) * kap_v / q.dy;
      const T rho_s = tv::mix_rho(F[o - 1], q.rho_l, q.rho_g);
      vs_o = vc + q.dt * (nu_c * (V(-1, 0) - T(2) * vc + V(1, 0)) * q.dxi2 +
                          nu_c * (V(0, -1) - T(2) * vc + V(0, 1)) * q.dyi2 -
                          u_here * dvdx - vc * dvdy + q.gy +
                          fy_kappa * T(2) / (rho_c + rho_s));
    }
  }
  us[o] = us_o;
  vs[o] = vs_o;
}

template <typename T>
int launch_predict(const T* u, const T* v, const T* F, T* kappa, T* us, T* vs,
                   int nx, int ny, const double* c, cudaStream_t stream) {
  const PredictParams<T> q = make_params<T>(nx, ny, c);
  const dim3 grid = tv::grid2d(nx + 2, ny + 2);
  curvature_kernel<T><<<grid, tv::block2d(), 0, stream>>>(F, kappa, q);
  momentum_kernel<T><<<grid, tv::block2d(), 0, stream>>>(u, v, F, kappa, us, vs, q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// u, v, F: inputs; kappa: scratch; us, vs: outputs; all (nx+2, ny+2).
extern "C" int tv_predict_f32(const void* u, const void* v, const void* F,
                              void* kappa, void* us, void* vs, int nx, int ny,
                              const double* c, void* stream) {
  return launch_predict<float>(
      static_cast<const float*>(u), static_cast<const float*>(v),
      static_cast<const float*>(F), static_cast<float*>(kappa),
      static_cast<float*>(us), static_cast<float*>(vs), nx, ny, c,
      static_cast<cudaStream_t>(stream));
}

extern "C" int tv_predict_f64(const void* u, const void* v, const void* F,
                              void* kappa, void* us, void* vs, int nx, int ny,
                              const double* c, void* stream) {
  return launch_predict<double>(
      static_cast<const double*>(u), static_cast<const double*>(v),
      static_cast<const double*>(F), static_cast<double*>(kappa),
      static_cast<double*>(us), static_cast<double*>(vs), nx, ny, c,
      static_cast<cudaStream_t>(stream));
}
