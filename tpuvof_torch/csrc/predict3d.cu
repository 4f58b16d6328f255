// The 3-D momentum predictor and projection rhs, for Hopper (sm_90a).
//
// Replaces tpuvof/pallas_kernels/step3d.py:pallas_predict3d_rhs
// (_predict_kernel, body _predict_block): the in-block BC fix of the
// velocities (_bc_fix_uvw), rho/nu from F, the upwind u*, v*, w* with
// viscosity and gravity, and the projection rhs = rho/dt * div(u*); with
// csf, the Youngs normals, the curvature and the sigma face terms.
//
// What bounds it on the H100: it must read u, v, w, F and write u*, v*, w*,
// rhs: 8 fields, 263.8 MB at 200^3 f32, 78.7 us at 3.35 TB/s.
//
// What the design does about it: one thread per output cell, and no
// intermediate field on the csf=False path. The rhs at a cell needs u* at
// i+1, v* at j+1 and w* at k+1, so each thread also recomputes those three
// (the star_* functions are pure functions of the loaded state): twice the
// arithmetic of the predictor, no second pass over device memory. The
// neighbours' loads hit L1/L2. With csf a pre-pass kernel (kappa3d_kernel)
// writes the curvature field, each thread recomputing the six normals its
// central differences need; the predictor then reads kappa.
//
// The state's velocity ghosts are not maintained between steps: every
// velocity load goes through FixedVel, which returns what set_BC (y, then
// x, then z faces) would have left there, as a pure index map onto interior
// values (_bc_fix_uvw, step3d.py:165-206).
//
// The arithmetic follows _predict_block term by term, in its order, with
// the constants folded on the host in double as the JAX package folds
// them, and the library is built with --fmad=false.
#include "cell3d.cuh"

namespace {

template <typename T>
struct P3Params {
  T rho_l, rho_g, nu_l, nu_g;
  T dt, dxi, dyi, dzi, dxi2, dyi2, dzi2;
  T gx, gy, gz;
  T neg_sigma, dx, dy, dz;
  T four_h[3];  // 4 dx, 4 dy, 4 dz: the corner-gradient divisors
  T two_h[3];   // 2 dx, 2 dy, 2 dz: the curvature's central differences
};

// The order of c[] is kernels/step3d_kernels.py:_predict3d_constants.
template <typename T>
P3Params<T> p3_params(const double* c) {
  P3Params<T> q;
  T* f[] = {&q.rho_l, &q.rho_g, &q.nu_l, &q.nu_g, &q.dt, &q.dxi, &q.dyi, &q.dzi,
            &q.dxi2, &q.dyi2, &q.dzi2, &q.gx, &q.gy, &q.gz, &q.neg_sigma, &q.dx,
            &q.dy, &q.dz, &q.four_h[0], &q.four_h[1], &q.four_h[2], &q.two_h[0],
            &q.two_h[1], &q.two_h[2]};
  for (int i = 0; i < 24; ++i) *f[i] = T(c[i]);
  return q;
}

// u, v, w as set_BC would leave them: u is 0 on the x-wall faces (global i
// 1 and nx+1) and mirrored into the j and k ghosts; v is 0 on the y-wall
// faces and mirrored into the i and k ghosts; w is 0 on the z-wall faces
// and mirrored into the j and i ghosts. The walls are at global i and j:
// in a pencil the y-wall rows sit mid-block, and the row a wall mirrors from
// lies in the array, since the wrapper takes only blocks that hold an
// interior row. 0 off the array.
template <typename T>
struct FixedVel {
  const T* __restrict__ u;
  const T* __restrict__ v;
  const T* __restrict__ w;
  tv::Vol g;

  __device__ __forceinline__ T U(int l, int j, int k) const {
    if (!g.inside(l, j, k)) return T(0);
    const int gi = l + g.gi_base;
    if (gi == 1 || gi == g.nx + 1) return T(0);
    return u[g.at(l, g.jc(j), g.kc(k))];
  }
  __device__ __forceinline__ T V(int l, int j, int k) const {
    const int gj = j + g.gj_base;
    if (!g.inside(l, j, k) || gj == 1 || gj == g.ny + 1) return T(0);
    const int ic = g.ic(l);
    if (ic < 0 || ic >= g.n0) return T(0);
    return v[g.at(ic, j, g.kc(k))];
  }
  __device__ __forceinline__ T W(int l, int j, int k) const {
    if (!g.inside(l, j, k) || k == 1 || k == g.nz + 1) return T(0);
    const int ic = g.ic(l);
    if (ic < 0 || ic >= g.n0) return T(0);
    return w[g.at(ic, g.jc(j), k)];
  }
};

template <typename T>
__device__ __forceinline__ T rho_at(const T* __restrict__ F, const tv::Vol& g, int l,
                                    int j, int k, const P3Params<T>& q) {
  return g.inside(l, j, k) ? tv::mix_rho(F[g.at(l, j, k)], q.rho_l, q.rho_g) : T(0);
}

// The Youngs normal of a cell of the global interior (young_msum_3d and
// normalize_normals_3d, in their accumulation order); 0 elsewhere.
template <typename T>
__device__ __forceinline__ void normal_at(const T* __restrict__ F, const tv::Vol& g,
                                          int l, int j, int k, const P3Params<T>& q,
                                          T m[3]) {
  m[0] = m[1] = m[2] = T(0);
  if (!g.inside(l, j, k) || !g.interior(l, j, k)) return;
  T f[3][3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
#pragma unroll
      for (int c = 0; c < 3; ++c) f[a][b][c] = tv::ld3(F, g, l + a - 1, j + b - 1, k + c - 1);
  T ms[3];
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
    const int o0 = axis == 0 ? 1 : 0;
    const int o1 = axis == 2 ? 1 : 2;
    T acc = T(0);
#pragma unroll
    for (int corner = 0; corner < 8; ++corner) {
      // corners in tpuvof's order: sx, then sy, then sz over (+1, -1)
      const int s[3] = {corner < 4 ? 1 : -1, (corner >> 1) & 1 ? -1 : 1,
                        corner & 1 ? -1 : 1};
      const int lo = s[axis] > 0 ? 0 : -1;
      T cacc = T(0);
#pragma unroll
      for (int ia = 0; ia < 2; ++ia) {
#pragma unroll
        for (int ib = 0; ib < 2; ++ib) {
          int hi[3], lw[3];
          hi[axis] = lo + 1;
          hi[o0] = ia ? s[o0] : 0;
          hi[o1] = ib ? s[o1] : 0;
          lw[0] = hi[0];
          lw[1] = hi[1];
          lw[2] = hi[2];
          lw[axis] = lo;
          const T d = f[hi[0] + 1][hi[1] + 1][hi[2] + 1] - f[lw[0] + 1][lw[1] + 1][lw[2] + 1];
          cacc = (ia == 0 && ib == 0) ? d : cacc + d;
        }
      }
      const T gax = -cacc / q.four_h[axis];
      acc = corner == 0 ? gax : acc + gax;
    }
    ms[axis] = acc / T(8);
  }
  const bool degenerate = fabs(ms[0]) < T(1e-10) && fabs(ms[1]) < T(1e-10) &&
                          fabs(ms[2]) < T(1e-10);
  const T mag_sq = ms[0] * ms[0] + ms[1] * ms[1] + ms[2] * ms[2];
  const T safe_mag = sqrt(degenerate ? T(1) : mag_sq);
#pragma unroll
  for (int a = 0; a < 3; ++a) m[a] = degenerate ? ms[a] : ms[a] / safe_mag;
}

// kappa = -div(normal) on the global interior, 0 elsewhere.
template <typename T, bool PENCIL>
__global__ void kappa3d_kernel(const T* __restrict__ F, T* __restrict__ kappa,
                               const tv::Vol block, const P3Params<T> q) {
  const tv::Vol g = tv::rows<PENCIL>(block);
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int l = blockIdx.z;
  if (j >= g.n1 || k >= g.n2) return;
  T kap = T(0);
  if (g.interior(l, j, k)) {
    T e[3], w[3], n[3], s[3], f[3], b[3];
    normal_at(F, g, l + 1, j, k, q, e);
    normal_at(F, g, l - 1, j, k, q, w);
    normal_at(F, g, l, j + 1, k, q, n);
    normal_at(F, g, l, j - 1, k, q, s);
    normal_at(F, g, l, j, k + 1, q, f);
    normal_at(F, g, l, j, k - 1, q, b);
    kap = -((e[0] - w[0]) / q.two_h[0] + (n[1] - s[1]) / q.two_h[1] +
            (f[2] - b[2]) / q.two_h[2]);
  }
  kappa[g.at(l, j, k)] = kap;
}

// u* at global i in [2, nx], global j and k interior; 0 elsewhere and off
// the array. kappa is null without csf.
template <typename T>
__device__ __forceinline__ T star_u(const FixedVel<T>& X, const T* __restrict__ F,
                                    const T* __restrict__ kappa, int l, int j, int k,
                                    const P3Params<T>& q) {
  const tv::Vol& g = X.g;
  const int gi = l + g.gi_base;
  const int gj = j + g.gj_base;
  if (!g.inside(l, j, k) || gi < 2 || gi > g.nx || gj < 1 || gj > g.ny || k < 1 || k > g.nz)
    return T(0);
  const T uc = X.U(l, j, k);
  const T v_here = T(0.25) * (X.V(l - 1, j, k) + X.V(l - 1, j + 1, k) + X.V(l, j, k) +
                              X.V(l, j + 1, k));
  const T w_here = T(0.25) * (X.W(l - 1, j, k) + X.W(l - 1, j, k + 1) + X.W(l, j, k) +
                              X.W(l, j, k + 1));
  const T uw = X.U(l - 1, j, k), ue = X.U(l + 1, j, k);
  const T us = X.U(l, j - 1, k), un = X.U(l, j + 1, k);
  const T ub = X.U(l, j, k - 1), uf = X.U(l, j, k + 1);
  const T dudx = uc > T(0) ? (uc - uw) * q.dxi : (ue - uc) * q.dxi;
  const T dudy = v_here > T(0) ? (uc - us) * q.dyi : (un - uc) * q.dyi;
  const T dudz = w_here > T(0) ? (uc - ub) * q.dzi : (uf - uc) * q.dzi;
  const T Fc = F[g.at(l, j, k)];
  const T nu = tv::mix_nu(Fc, q.nu_l, q.nu_g);
  T acc = nu * (uw - T(2) * uc + ue) * q.dxi2 + nu * (us - T(2) * uc + un) * q.dyi2 +
          nu * (ub - T(2) * uc + uf) * q.dzi2 - uc * dudx - v_here * dudy -
          w_here * dudz + q.gx;
  if (kappa) {
    const T kap = (kappa[g.at(l, j, k)] + tv::ld3(kappa, g, l - 1, j, k)) * T(0.5);
    const T fx = q.neg_sigma * (Fc - tv::ld3(F, g, l - 1, j, k)) * kap / q.dx;
    acc = acc + fx * T(2) / (rho_at(F, g, l, j, k, q) + rho_at(F, g, l - 1, j, k, q));
  }
  return uc + q.dt * acc;
}

// v* at global i in [1, nx], global j in [2, ny], k interior.
template <typename T>
__device__ __forceinline__ T star_v(const FixedVel<T>& X, const T* __restrict__ F,
                                    const T* __restrict__ kappa, int l, int j, int k,
                                    const P3Params<T>& q) {
  const tv::Vol& g = X.g;
  const int gi = l + g.gi_base;
  const int gj = j + g.gj_base;
  if (!g.inside(l, j, k) || gi < 1 || gi > g.nx || gj < 2 || gj > g.ny || k < 1 || k > g.nz)
    return T(0);
  const T vc = X.V(l, j, k);
  const T u_here = T(0.25) * (X.U(l, j - 1, k) + X.U(l, j, k) + X.U(l + 1, j - 1, k) +
                              X.U(l + 1, j, k));
  const T w_here = T(0.25) * (X.W(l, j - 1, k + 1) + X.W(l, j - 1, k) + X.W(l, j, k) +
                              X.W(l, j, k + 1));
  const T vw = X.V(l - 1, j, k), ve = X.V(l + 1, j, k);
  const T vs = X.V(l, j - 1, k), vn = X.V(l, j + 1, k);
  const T vb = X.V(l, j, k - 1), vf = X.V(l, j, k + 1);
  const T dvdx = u_here > T(0) ? (vc - vw) * q.dxi : (ve - vc) * q.dxi;
  const T dvdy = vc > T(0) ? (vc - vs) * q.dyi : (vn - vc) * q.dyi;
  const T dvdz = w_here > T(0) ? (vc - vb) * q.dzi : (vf - vc) * q.dzi;
  const T Fc = F[g.at(l, j, k)];
  const T nu = tv::mix_nu(Fc, q.nu_l, q.nu_g);
  T acc = nu * (vw - T(2) * vc + ve) * q.dxi2 + nu * (vs - T(2) * vc + vn) * q.dyi2 +
          nu * (vb - T(2) * vc + vf) * q.dzi2 - u_here * dvdx - vc * dvdy -
          w_here * dvdz + q.gy;
  if (kappa) {
    const T kap = (kappa[g.at(l, j, k)] + tv::ld3(kappa, g, l, j - 1, k)) * T(0.5);
    const T fy = q.neg_sigma * (Fc - tv::ld3(F, g, l, j - 1, k)) * kap / q.dy;
    acc = acc + fy * T(2) / (rho_at(F, g, l, j, k, q) + rho_at(F, g, l, j - 1, k, q));
  }
  return vc + q.dt * acc;
}

// w* at global i in [1, nx], global j interior, k in [2, nz].
template <typename T>
__device__ __forceinline__ T star_w(const FixedVel<T>& X, const T* __restrict__ F,
                                    const T* __restrict__ kappa, int l, int j, int k,
                                    const P3Params<T>& q) {
  const tv::Vol& g = X.g;
  const int gi = l + g.gi_base;
  const int gj = j + g.gj_base;
  if (!g.inside(l, j, k) || gi < 1 || gi > g.nx || gj < 1 || gj > g.ny || k < 2 || k > g.nz)
    return T(0);
  const T wc = X.W(l, j, k);
  const T u_here = T(0.25) * (X.U(l + 1, j, k - 1) + X.U(l, j, k - 1) + X.U(l + 1, j, k) +
                              X.U(l, j, k));
  const T v_here = T(0.25) * (X.V(l, j + 1, k - 1) + X.V(l, j, k - 1) + X.V(l, j, k) +
                              X.V(l, j + 1, k));
  const T ww = X.W(l - 1, j, k), we = X.W(l + 1, j, k);
  const T ws = X.W(l, j - 1, k), wn = X.W(l, j + 1, k);
  const T wb = X.W(l, j, k - 1), wf = X.W(l, j, k + 1);
  const T dwdx = u_here > T(0) ? (wc - ww) * q.dxi : (we - wc) * q.dxi;
  const T dwdy = v_here > T(0) ? (wc - ws) * q.dyi : (wn - wc) * q.dyi;
  const T dwdz = wc > T(0) ? (wc - wb) * q.dzi : (wf - wc) * q.dzi;
  const T Fc = F[g.at(l, j, k)];
  const T nu = tv::mix_nu(Fc, q.nu_l, q.nu_g);
  T acc = nu * (ww - T(2) * wc + we) * q.dxi2 + nu * (ws - T(2) * wc + wn) * q.dyi2 +
          nu * (wb - T(2) * wc + wf) * q.dzi2 - u_here * dwdx - v_here * dwdy -
          wc * dwdz + q.gz;
  if (kappa) {
    const T kap = (kappa[g.at(l, j, k)] + tv::ld3(kappa, g, l, j, k - 1)) * T(0.5);
    const T fz = q.neg_sigma * (Fc - tv::ld3(F, g, l, j, k - 1)) * kap / q.dz;
    acc = acc + fz * T(2) / (rho_at(F, g, l, j, k, q) + rho_at(F, g, l, j, k - 1, q));
  }
  return wc + q.dt * acc;
}

// u*, v*, w* and rhs of one cell; all four are 0 on the array's first and
// last planes (the Pallas kernel's zeroed ghost planes).
template <typename T, bool PENCIL>
__global__ void predict3d_kernel(const T* __restrict__ u, const T* __restrict__ v,
                                 const T* __restrict__ w, const T* __restrict__ F,
                                 const T* __restrict__ kappa, T* __restrict__ us,
                                 T* __restrict__ vs, T* __restrict__ ws,
                                 T* __restrict__ rhs, const tv::Vol block,
                                 const P3Params<T> q) {
  const tv::Vol g = tv::rows<PENCIL>(block);
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int l = blockIdx.z;
  if (j >= g.n1 || k >= g.n2) return;
  const long long o = g.at(l, j, k);
  if (l == 0 || l == g.n0 - 1) {
    us[o] = vs[o] = ws[o] = rhs[o] = T(0);
    return;
  }
  const FixedVel<T> X{u, v, w, g};
  const T usc = star_u(X, F, kappa, l, j, k, q);
  const T vsc = star_v(X, F, kappa, l, j, k, q);
  const T wsc = star_w(X, F, kappa, l, j, k, q);
  us[o] = usc;
  vs[o] = vsc;
  ws[o] = wsc;
  T r = T(0);
  if (g.interior(l, j, k)) {
    const T rho = tv::mix_rho(F[o], q.rho_l, q.rho_g);
    r = rho / q.dt *
        ((star_u(X, F, kappa, l + 1, j, k, q) - usc) * q.dxi +
         (star_v(X, F, kappa, l, j + 1, k, q) - vsc) * q.dyi +
         (star_w(X, F, kappa, l, j, k + 1, q) - wsc) * q.dzi);
  }
  rhs[o] = r;
}

template <typename T, bool PENCIL>
int launch_rows(const T* u, const T* v, const T* w, const T* F, T* kappa, T* us, T* vs,
                T* ws, T* rhs, tv::Vol g, const P3Params<T>& q, cudaStream_t stream) {
  const dim3 grid = tv::grid3d(g);
  if (kappa) {
    kappa3d_kernel<T, PENCIL><<<grid, tv::block3d(), 0, stream>>>(F, kappa, g, q);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  predict3d_kernel<T, PENCIL><<<grid, tv::block3d(), 0, stream>>>(u, v, w, F, kappa, us, vs,
                                                                 ws, rhs, g, q);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_predict3d(const T* u, const T* v, const T* w, const T* F, T* kappa, T* us,
                     T* vs, T* ws, T* rhs, tv::Vol g, int pencil, const double* c,
                     cudaStream_t stream) {
  const P3Params<T> q = p3_params<T>(c);
  if (pencil) {
    return launch_rows<T, true>(u, v, w, F, kappa, us, vs, ws, rhs, g, q, stream);
  }
  return launch_rows<T, false>(u, v, w, F, kappa, us, vs, ws, rhs, g, q, stream);
}

}  // namespace

// u, v, w, F: inputs; us, vs, ws, rhs: outputs; kappa: a scratch field for
// csf, or null without it. All (n0, n1, nz+2), local plane l at global i
// gi_base + l, local row m at global j gj_base + m; pencil != 0 for a
// pencil (tpuvof's njl given).
extern "C" int tv_predict3d_f32(const void* u, const void* v, const void* w,
                                const void* F, void* kappa, void* us, void* vs, void* ws,
                                void* rhs, int n0, int n1, int gi_base, int gj_base,
                                int pencil, int nx, int ny, int nz,
                                const double* c, void* stream) {
  using T = float;
  return launch_predict3d<T>(
      static_cast<const T*>(u), static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(F), static_cast<T*>(kappa), static_cast<T*>(us),
      static_cast<T*>(vs), static_cast<T*>(ws), static_cast<T*>(rhs),
      tv::Vol{n0, n1, nz + 2, gi_base, gj_base, nx, ny, nz}, pencil, c,
      static_cast<cudaStream_t>(stream));
}

extern "C" int tv_predict3d_f64(const void* u, const void* v, const void* w,
                                const void* F, void* kappa, void* us, void* vs, void* ws,
                                void* rhs, int n0, int n1, int gi_base, int gj_base,
                                int pencil, int nx, int ny, int nz,
                                const double* c, void* stream) {
  using T = double;
  return launch_predict3d<T>(
      static_cast<const T*>(u), static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(F), static_cast<T*>(kappa), static_cast<T*>(us),
      static_cast<T*>(vs), static_cast<T*>(ws), static_cast<T*>(rhs),
      tv::Vol{n0, n1, nz + 2, gi_base, gj_base, nx, ny, nz}, pencil, c,
      static_cast<cudaStream_t>(stream));
}
