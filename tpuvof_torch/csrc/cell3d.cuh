// Shared device helpers of the 3-D kernels (predict3d.cu, correct3d.cu,
// fct3d.cu, jacobi3d.cu).
//
// Layout: a field is a row-major (n0, n1, n2) array, axis 2 = k (z)
// contiguous, n1 = ny+2 and n2 = nz+2. Local plane l holds global i-index
// gi_base + l of a grid with nx x ny x nz interior cells: the whole grid is
// gi_base = 0, n0 = nx+2, and an i-slab of a larger grid (tpuvof's
// (nloc, gi_base) origin) has n0 = nloc+2. Masks are taken at global i.
// Every kernel runs one thread per cell with k on threadIdx.x, so the loads
// of a warp are one coalesced row segment; offsets are 64-bit (a 512^3
// field with ghosts has 1.36e8 cells).
//
// A read past the array's edge is 0, and so is every quantity derived at
// such a position (the plain versions shift with zero fill). tpuvof's
// kernels roll there instead; on the whole grid no output depends on it,
// and on a slab the values it feeds lie within the stencil's reach of the
// slab's i-edges, junk by contract on both sides.
#pragma once

#include "common.cuh"

namespace tv {

struct Vol {
  int n0, n1, n2;  // the array's extents
  int gi_base;     // global i of local plane 0
  int nx, ny, nz;  // the grid's interior extents

  __device__ __forceinline__ bool inside(int l, int j, int k) const {
    return l >= 0 && l < n0 && j >= 0 && j < n1 && k >= 0 && k < n2;
  }
  __device__ __forceinline__ long long at(int l, int j, int k) const {
    return (static_cast<long long>(l) * n1 + j) * n2 + k;
  }
  // cell (l, j, k) in the global interior
  __device__ __forceinline__ bool interior(int l, int j, int k) const {
    const int gi = l + gi_base;
    return gi >= 1 && gi <= nx && j >= 1 && j <= ny && k >= 1 && k <= nz;
  }
  // the row / column / plane set_BC mirrors a ghost from
  __device__ __forceinline__ int jc(int j) const {
    return j == 0 ? 1 : (j == ny + 1 ? ny : j);
  }
  __device__ __forceinline__ int kc(int k) const {
    return k == 0 ? 1 : (k == nz + 1 ? nz : k);
  }
  __device__ __forceinline__ int ic(int l) const {
    const int gi = l + gi_base;
    return gi == 0 ? l + 1 : (gi == nx + 1 ? l - 1 : l);
  }
};

template <typename T>
__device__ __forceinline__ T ld3(const T* __restrict__ a, const Vol& g, int l, int j,
                                 int k) {
  return g.inside(l, j, k) ? a[g.at(l, j, k)] : T(0);
}

constexpr int kBlock3X = 32;  // along k, the contiguous axis
constexpr int kBlock3Y = 8;   // along j

inline dim3 block3d() { return dim3(kBlock3X, kBlock3Y, 1); }

// Covers a field with block3d() blocks, one grid layer per plane l.
inline dim3 grid3d(const Vol& g) {
  return dim3((g.n2 + kBlock3X - 1) / kBlock3X, (g.n1 + kBlock3Y - 1) / kBlock3Y, g.n0);
}

}  // namespace tv
