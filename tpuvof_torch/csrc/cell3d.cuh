// Shared device helpers of the 3-D kernels (predict3d.cu, correct3d.cu,
// fct3d.cu, jacobi3d.cu).
//
// Layout: a field is a row-major (n0, n1, n2) array, axis 2 = k (z)
// contiguous, n2 = nz+2. Local plane l holds global i-index gi_base + l
// and local row m global j-index gj_base + m of a grid with nx x ny x nz
// interior cells: the whole grid is gi_base = gj_base = 0, n0 = nx+2,
// n1 = ny+2; an i-slab of a larger grid (tpuvof's (nloc, gi_base) origin)
// has n0 = nloc+2; an (x, y) pencil (tpuvof's pencil mode (njl, gj_base))
// also has n1 = njl+2. Masks are taken at global i and j.
// Every kernel runs k on threadIdx.x, so the loads of a warp are one
// coalesced row segment; offsets are 64-bit (a 512^3 field with ghosts has
// 1.36e8 cells). correct3d and fct3d run one thread per cell; predict3d and
// jacobi3d give each CTA a (j, k) tile that marches along l over a chunk of
// planes (plane_chunk).
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
  int gj_base;     // global j of local row 0
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
    const int gj = j + gj_base;
    return gi >= 1 && gi <= nx && gj >= 1 && gj <= ny && k >= 1 && k <= nz;
  }
  // the row / column / plane set_BC mirrors a ghost from (local indices;
  // a pencil's wall rows sit mid-block; the source row lies in the array
  // of any block that holds an interior row, the only blocks the wrappers
  // take)
  // (written with the walls' local rows 1 - gj_base and ny - gj_base, so
  // that with the row origin the constant 0 it is the whole grid's
  // j == 0 ? 1 : (j == ny + 1 ? ny : j))
  __device__ __forceinline__ int jc(int j) const {
    const int gj = j + gj_base;
    return gj == 0 ? 1 - gj_base : (gj == ny + 1 ? ny - gj_base : j);
  }
  __device__ __forceinline__ int kc(int k) const {
    return k == 0 ? 1 : (k == nz + 1 ? nz : k);
  }
  __device__ __forceinline__ int ic(int l) const {
    const int gi = l + gi_base;
    return gi == 0 ? l + 1 : (gi == nx + 1 ? l - 1 : l);
  }
};

// A kernel templated on PENCIL takes its block through rows<PENCIL>: on
// the whole grid and an i-slab (PENCIL false) the row origin is the
// constant 0, so the compiler folds the global-row arithmetic away and
// those paths run the code they ran before pencils existed. Every entry
// point takes the mode as an int flag (the wrappers' njl given or not)
// and picks the instantiation from it alone.
template <bool PENCIL>
__device__ __forceinline__ Vol rows(Vol g) {
  if (!PENCIL) g.gj_base = 0;
  return g;
}

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

// Planes per chunk of a kernel whose CTAs each march along l over one
// chunk of a (j, k) tile plus ``halo`` steps of their own: the chunking
// that takes the fewest steps in all when the card runs ``resident`` CTAs
// an SM in waves (waves x steps a CTA). One chunk per tile leaves SMs idle
// on a block of few tiles; many short chunks pay the halo steps again.
inline int plane_chunk(int n0, int tiles, int resident, int halo) {
  const int sms = sm_count();
  const long long slots =
      static_cast<long long>(sms > 0 ? sms : 1) * (resident > 0 ? resident : 1);
  int best_lc = n0;
  long long best = -1;
  for (int chunks = 1; chunks <= n0 && chunks <= 64; ++chunks) {
    const int lc = (n0 + chunks - 1) / chunks;
    const long long ctas = static_cast<long long>(tiles) * ((n0 + lc - 1) / lc);
    const long long cost = (ctas + slots - 1) / slots * (lc + halo);
    if (best < 0 || cost < best) {
      best = cost;
      best_lc = lc;
    }
  }
  return best_lc;
}

}  // namespace tv
