// The 3-D velocity correction, for Hopper (sm_90a).
//
// Replaces tpuvof/pallas_kernels/step3d.py:pallas_correct3d
// (_correct_kernel): u = u* - dt/rho_face * dp/dx on global i in [2, nx],
// v on j in [2, ny], w on k in [2, nz], each over the interior of the other
// two axes (global i and j, so the kernel serves the whole grid, an i-slab
// and an (x, y) pencil alike), with rho mixed from F at the cell and its
// lower neighbour along the face's axis. Every other position is written 0, as the Pallas kernel
// does (step3d.py:629-638): the wall faces and ghosts are rebuilt by the
// next predict's BC fix or by the exit BC.
//
// What bounds it on the H100: it must read u*, v*, w*, p, F and write u, v,
// w: 8 fields, 263.8 MB at 200^3 f32, 78.7 us at 3.35 TB/s.
//
// What the design does about it: one thread per cell, each loading its own
// p and F and the lower neighbours along the three axes (L1/L2 hits); no
// scratch. The arithmetic is _correct_kernel's, in its order.
#include "cell3d.cuh"

namespace {

template <typename T>
struct C3Params {
  T rho_l, rho_g, dt, dxi, dyi, dzi;
};

template <typename T, bool PENCIL>
__global__ void correct3d_kernel(const T* __restrict__ us, const T* __restrict__ vs,
                                 const T* __restrict__ ws, const T* __restrict__ p,
                                 const T* __restrict__ F, T* __restrict__ u,
                                 T* __restrict__ v, T* __restrict__ w, const tv::Vol block,
                                 const C3Params<T> q) {
  const tv::Vol g = tv::rows<PENCIL>(block);
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int l = blockIdx.z;
  if (j >= g.n1 || k >= g.n2) return;
  const long long o = g.at(l, j, k);
  const int gi = l + g.gi_base;
  const int gj = j + g.gj_base;
  const bool i_int = gi >= 1 && gi <= g.nx;
  const bool j_int = gj >= 1 && gj <= g.ny;
  const bool k_int = k >= 1 && k <= g.nz;
  T uo = T(0), vo = T(0), wo = T(0);
  if (l >= 1 && l <= g.n0 - 2 && i_int && j_int && k_int) {
    const T p_c = p[o];
    const T r_c = tv::mix_rho(F[o], q.rho_l, q.rho_g);
    if (gi >= 2) {
      const long long m = g.at(l - 1, j, k);
      const T r_w = tv::mix_rho(F[m], q.rho_l, q.rho_g);
      uo = us[o] - q.dt / ((r_c + r_w) * T(0.5)) * (p_c - p[m]) * q.dxi;
    }
    if (gj >= 2) {
      // a pencil's row 0 may be interior: its south neighbour is off the
      // array, read as 0 (rho too), as the plain version's shift reads it
      const bool in = j >= 1;
      const long long m = g.at(l, j - 1, k);
      const T r_s = in ? tv::mix_rho(F[m], q.rho_l, q.rho_g) : T(0);
      const T p_s = in ? p[m] : T(0);
      vo = vs[o] - q.dt / ((r_c + r_s) * T(0.5)) * (p_c - p_s) * q.dyi;
    }
    if (k >= 2) {
      const long long m = g.at(l, j, k - 1);
      const T r_b = tv::mix_rho(F[m], q.rho_l, q.rho_g);
      wo = ws[o] - q.dt / ((r_c + r_b) * T(0.5)) * (p_c - p[m]) * q.dzi;
    }
  }
  u[o] = uo;
  v[o] = vo;
  w[o] = wo;
}

template <typename T>
int launch_correct3d(const T* us, const T* vs, const T* ws, const T* p, const T* F, T* u,
                     T* v, T* w, tv::Vol g, int pencil, const double* c,
                     cudaStream_t stream) {
  // the order of c[] is kernels/step3d_kernels.py:_correct3d_constants
  const C3Params<T> q{T(c[0]), T(c[1]), T(c[2]), T(c[3]), T(c[4]), T(c[5])};
  if (pencil) {
    correct3d_kernel<T, true><<<tv::grid3d(g), tv::block3d(), 0, stream>>>(us, vs, ws, p, F,
                                                                          u, v, w, g, q);
  } else {
    correct3d_kernel<T, false><<<tv::grid3d(g), tv::block3d(), 0, stream>>>(us, vs, ws, p, F,
                                                                           u, v, w, g, q);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// us, vs, ws, p, F: inputs; u, v, w: outputs; all (n0, n1, nz+2), local
// plane l at global i gi_base + l, local row m at global j gj_base + m;
// pencil != 0 for a pencil (tpuvof's njl given).
extern "C" int tv_correct3d_f32(const void* us, const void* vs, const void* ws,
                                const void* p, const void* F, void* u, void* v, void* w,
                                int n0, int n1, int gi_base, int gj_base, int pencil,
                                int nx, int ny, int nz,
                                const double* c, void* stream) {
  using T = float;
  return launch_correct3d<T>(
      static_cast<const T*>(us), static_cast<const T*>(vs), static_cast<const T*>(ws),
      static_cast<const T*>(p), static_cast<const T*>(F), static_cast<T*>(u),
      static_cast<T*>(v), static_cast<T*>(w),
      tv::Vol{n0, n1, nz + 2, gi_base, gj_base, nx, ny, nz}, pencil, c,
      static_cast<cudaStream_t>(stream));
}

extern "C" int tv_correct3d_f64(const void* us, const void* vs, const void* ws,
                                const void* p, const void* F, void* u, void* v, void* w,
                                int n0, int n1, int gi_base, int gj_base, int pencil,
                                int nx, int ny, int nz,
                                const double* c, void* stream) {
  using T = double;
  return launch_correct3d<T>(
      static_cast<const T*>(us), static_cast<const T*>(vs), static_cast<const T*>(ws),
      static_cast<const T*>(p), static_cast<const T*>(F), static_cast<T*>(u),
      static_cast<T*>(v), static_cast<T*>(w),
      tv::Vol{n0, n1, nz + 2, gi_base, gj_base, nx, ny, nz}, pencil, c,
      static_cast<cudaStream_t>(stream));
}
