// The 3-D fixed-iteration Jacobi pressure solve, for Hopper (sm_90a).
//
// Replaces tpuvof/pallas_kernels/jacobi3d.py:pallas_jacobi_3d (_kernel, the
// VMEM-resident volume) and streamed_jacobi_3d (_streamed_iter_kernel, one
// HBM-streamed iteration per launch): both compute the same exact Jacobi
// iteration of the 7-point Neumann operator, so one kernel serves both.
// The ghost ring is zeroed instead of the edge coefficients (equal values:
// a zeroed coefficient meets a zeroed neighbour), the diagonal 1/ap is one
// of 8 edge-class constants the host computes in double in tpuvof's
// accumulation order and casts, and the neighbours are subtracted in the
// order e, w, n, s, f, b (jacobi3d.py:171-204, 244-253).
//
// What bounds it on the H100: the whole solve must read p and rhs and write
// p once: 3 fields, 98.9 MB at 200^3 f32, 29.5 us at 3.35 TB/s.
//
// What the design does about it: nothing yet; it is the simple form. One
// out-of-place iteration per launch, ping-ponging two buffers, one thread
// per cell, masking ghost-ring reads to zero at load time as
// _streamed_iter_kernel does: n_iter launches, each moving 3 fields. The
// 10 iterations of a step therefore cost about 10x the bound. Temporal
// blocking in shared memory (several iterations per launch on a tile with a
// halo) is the faster later form.
//
// The ghost positions of a slab or a pencil (local planes 0 and n0-1, a
// pencil's rows 0 and n1-1, and any position at or beyond a global wall)
// are held at zero, as the resident kernel holds them: those of a block's
// edges go stale by design and are junk by contract.
#include "cell3d.cuh"

namespace {

template <typename T>
struct J3Params {
  T cx, cy, cz;
  T ap_inv[2][2][2];  // [on an x-edge][on a y-edge][on a z-edge]
};

// A position is a ghost iff its plane, its row or its column is one, so a
// thread classifies its three planes, rows and columns; a position off the
// array counts as a ghost and reads 0. (On the whole grid and a slab, rows
// 0 and n1-1 are the walls.)
__device__ __forceinline__ bool plane_ghost(const tv::Vol& g, int l) {
  const int gi = l + g.gi_base;
  return l <= 0 || l >= g.n0 - 1 || gi <= 0 || gi >= g.nx + 1;
}
__device__ __forceinline__ bool row_ghost(const tv::Vol& g, int j) {
  const int gj = j + g.gj_base;
  return j <= 0 || j >= g.n1 - 1 || gj <= 0 || gj >= g.ny + 1;
}
__device__ __forceinline__ bool col_ghost(const tv::Vol& g, int k) {
  return k <= 0 || k >= g.nz + 1;
}

template <typename T, bool PENCIL>
__global__ void jacobi3d_kernel(const T* __restrict__ src, const T* __restrict__ rhs,
                                T* __restrict__ dst, const tv::Vol block, const J3Params<T> q) {
  const tv::Vol g = tv::rows<PENCIL>(block);
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int l = blockIdx.z;
  if (j >= g.n1 || k >= g.n2) return;
  const long long o = g.at(l, j, k);
  if (plane_ghost(g, l) || row_ghost(g, j) || col_ghost(g, k)) {
    dst[o] = T(0);
    return;
  }
  // the neighbours: e, w along i, n, s along j, f, b along k
  const long long si = static_cast<long long>(g.n1) * g.n2;
  const T e = plane_ghost(g, l + 1) ? T(0) : src[o + si];
  const T w = plane_ghost(g, l - 1) ? T(0) : src[o - si];
  const T n = row_ghost(g, j + 1) ? T(0) : src[o + g.n2];
  const T s = row_ghost(g, j - 1) ? T(0) : src[o - g.n2];
  const T f = col_ghost(g, k + 1) ? T(0) : src[o + 1];
  const T b = col_ghost(g, k - 1) ? T(0) : src[o - 1];
  const int gi = l + g.gi_base;
  const int gj = j + g.gj_base;
  const int ex = gi == 1 || gi == g.nx;
  const int ey = gj == 1 || gj == g.ny;
  const int ez = k == 1 || k == g.nz;
  dst[o] = (rhs[o] - q.cx * e - q.cx * w - q.cy * n - q.cy * s - q.cz * f - q.cz * b) *
           q.ap_inv[ex][ey][ez];
}

template <typename T>
int launch_jacobi3d(const T* p, const T* rhs, T* out, T* tmp, tv::Vol g, int pencil,
                    int n_iter, const double* c, cudaStream_t stream) {
  // the order of c[] is kernels/step3d_kernels.py:_jacobi3d_constants
  J3Params<T> q;
  q.cx = T(c[0]);
  q.cy = T(c[1]);
  q.cz = T(c[2]);
  for (int e = 0; e < 8; ++e) q.ap_inv[e >> 2][(e >> 1) & 1][e & 1] = T(c[3 + e]);
  const T* src = p;
  for (int it = 0; it < n_iter; ++it) {
    // the last iteration writes out
    T* dst = (n_iter - 1 - it) % 2 == 0 ? out : tmp;
    if (pencil) {
      jacobi3d_kernel<T, true><<<tv::grid3d(g), tv::block3d(), 0, stream>>>(src, rhs, dst, g,
                                                                           q);
    } else {
      jacobi3d_kernel<T, false><<<tv::grid3d(g), tv::block3d(), 0, stream>>>(src, rhs, dst, g,
                                                                            q);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  return 0;
}

}  // namespace

// p, rhs: inputs; out: output; tmp: scratch; all (n0, n1, nz+2), local
// plane l at global i gi_base + l, local row m at global j gj_base + m;
// pencil != 0 for a pencil (tpuvof's njl given). n_iter >= 1 launches.
extern "C" int tv_jacobi3d_f32(const void* p, const void* rhs, void* out, void* tmp, int n0,
                               int n1, int gi_base, int gj_base, int pencil, int nx,
                               int ny, int nz, int n_iter, const double* c, void* stream) {
  using T = float;
  return launch_jacobi3d<T>(static_cast<const T*>(p), static_cast<const T*>(rhs),
                            static_cast<T*>(out), static_cast<T*>(tmp),
                            tv::Vol{n0, n1, nz + 2, gi_base, gj_base, nx, ny, nz}, pencil,
                            n_iter,
                            c, static_cast<cudaStream_t>(stream));
}

extern "C" int tv_jacobi3d_f64(const void* p, const void* rhs, void* out, void* tmp, int n0,
                               int n1, int gi_base, int gj_base, int pencil, int nx,
                               int ny, int nz, int n_iter, const double* c, void* stream) {
  using T = double;
  return launch_jacobi3d<T>(static_cast<const T*>(p), static_cast<const T*>(rhs),
                            static_cast<T*>(out), static_cast<T*>(tmp),
                            tv::Vol{n0, n1, nz + 2, gi_base, gj_base, nx, ny, nz}, pencil,
                            n_iter,
                            c, static_cast<cudaStream_t>(stream));
}
