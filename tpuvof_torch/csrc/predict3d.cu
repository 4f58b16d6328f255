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
// What the first design cost: one thread per cell, each evaluating u*, v*
// and w* at its own cell and again at i+1, j+1 and k+1 for the rhs (six
// momentum updates where three do), each update making ~14 velocity loads
// through FixedVel, whose every load repeats the bounds test, the
// jc/kc/ic mirror maps and the wall branches. At 200^3 f32 it took ~1.1 ms,
// 14x its bound: instructions, not bytes.
//
// What this design does: a CTA of 32 (k) x 8 (j) threads owns a (j, k)
// tile and marches along l over a chunk of planes. It stages u, v, w and F
// (and kappa with csf) for the tile and its halo into shared memory once,
// one plane per step into a ring of four planes, applying FixedVel's rules
// as it stages each value (0 on the wall faces, mirrored into the ghosts,
// 0 off the array); the stencils then read plain shared memory. The halo
// per field, from star_u/v/w at the faces the tile needs (u* at its cells
// and at l+1, v* also at row j0+8, w* also at column k0+32):
//   u: planes l..l+2, rows j0-1..j0+8, columns k0-1..k0+32
//   v: planes l-1..l+1, rows j0-1..j0+9, columns k0-1..k0+32
//   w: planes l-1..l+1, rows j0-1..j0+8, columns k0-1..k0+33
//   F, kappa: planes l..l+1, rows j0-1..j0+8, columns k0-1..k0+32
// so the staged region is planes l-1..l+2 x rows j0-1..j0+9 x columns
// k0-1..k0+33 for every field. Each face's u*, v*, w* is computed once per
// CTA: u* at l+1 is kept in a register and becomes the next plane's own
// u*; v* and w* of the plane go to shared memory, the extra row and column
// computed by warps 0 and 1; the rhs is built from those. Only a chunk's
// first plane of u* is computed by two CTAs.
//
// The chunk of planes is chosen at launch from the tiles and the CTAs an
// SM keeps resident (tv::plane_chunk), so that a block of few tiles, as a
// pencil's, still fills the card.
//
// A thread issues the reads of the plane it stages next (l+3) before it
// computes plane l, and writes them to shared memory a step later, so the
// reads' latency hides behind the stencils: 2 x 4 (5 with csf) values in
// registers, indexed only by unrolled loops. The three updates are
// evaluated one after another from shared memory. Nothing spills: 61
// registers in f32, 105 in f64, no stack frame (scripts/torch_ab3d.py
// --sass). Measured on the H100 at 200^3 f32: ~192 us against the first
// form's ~1116, 2.4x the bound (~245 before the reads were issued a step
// ahead; a 32 x 16 tile took ~277).
//
// The arithmetic of star_u/v/w and of the rhs is _predict_block's term by
// term, in its order, with the constants folded on the host in double as
// the JAX package folds them; the library is built with --fmad=false.
// Only where the operands come from changed, so the outputs are those of
// the one-thread-per-cell form bit for bit.
//
// The csf pre-pass, kappa3d_kernel, computes kappa = -div(n) from the
// Youngs normals n (the csf branch of _predict_block). Its bound is F read
// and kappa written once, 19.68 us at 200^3 f32. The first form ran one
// thread a cell that evaluated the normals of its six neighbours, each from
// a 3 x 3 x 3 cube of F read through ld3: 162 loads and ~180 divisions a
// cell, most with a zero numerator (F is uniform away from the interface),
// which leaves the division's fast path; ~3450 us at 200^3 f32 on an H100
// 80GB HBM3 at 700 W. This form gives a CTA a 14 x 30 (j, k) tile that
// marches along l with one barrier a plane, computes each normal once on
// the tile and a one-cell rim (~1.22 a cell, 16 x 32: two full passes of
// the CTA) from F staged in shared memory, answers a uniform 3 x 3 x 3
// cube (all liquid or all gas) with the signed zeros the arithmetic would
// give, and divides through tv::quot (the same signed zero), so kappa is
// the first form's bit for bit. A plane's cost then depends on the data,
// so the planes go in short chunks, several waves of CTAs (Kappa::chunk).
// Measured on the same card at 200^3 f32: ~150 us (scripts/torch_ab3d.py).
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

// The Youngs normal from the 3 x 3 x 3 cube f of F around a cell of the
// global interior (young_msum_3d and normalize_normals_3d, in their
// accumulation order): the mean of the 8 corner gradients, normalised
// unless every component is below 1e-10. Divisions go through tv::quot.
template <typename T>
__device__ __forceinline__ void youngs_normal(const T (&f)[3][3][3], const P3Params<T>& q,
                                              T m[3]) {
  // A cube of one finite value (most of a VOF field: all liquid or all
  // gas): every difference below is +0, so every corner gradient is
  // tv::quot's zero case -0 * sign(4 h), their sum and mean that signed
  // zero, and the normal is degenerate; the same values without the
  // arithmetic. (A divisor 4 h that is 0 or NaN takes the full path.)
  const T v = f[1][1][1];
  bool uniform = v - v == T(0);
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
#pragma unroll
      for (int c = 0; c < 3; ++c) uniform = uniform && f[a][b][c] == v;
#pragma unroll
  for (int a = 0; a < 3; ++a) uniform = uniform && q.four_h[a] == q.four_h[a] && q.four_h[a] != T(0);
  if (uniform) {
#pragma unroll
    for (int a = 0; a < 3; ++a) m[a] = -T(0) * copysign(T(1), q.four_h[a]);
    return;
  }
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
      const T gax = tv::quot(-cacc, q.four_h[axis]);
      acc = corner == 0 ? gax : acc + gax;
    }
    ms[axis] = tv::quot(acc, T(8));
  }
  const bool degenerate = fabs(ms[0]) < T(1e-10) && fabs(ms[1]) < T(1e-10) &&
                          fabs(ms[2]) < T(1e-10);
  const T mag_sq = ms[0] * ms[0] + ms[1] * ms[1] + ms[2] * ms[2];
  const T safe_mag = sqrt(degenerate ? T(1) : mag_sq);
#pragma unroll
  for (int a = 0; a < 3; ++a) m[a] = degenerate ? ms[a] : tv::quot(ms[a], safe_mag);
}

// kappa3d_kernel's tile: kKapK columns (k) by kKapJ rows (j), marching
// along l. The normals of a plane are computed on the tile and a one-cell
// rim (rows j0-1 .. j0+kKapJ, columns k0-1 .. k0+kKapK: 16 x 32, two full
// passes of the CTA's 256 threads, a warp a rim row), from F staged on a
// two-cell rim (rows j0-2 .. j0+kKapJ+1, columns k0-2 .. k0+kKapK+1).
constexpr int kKapK = 30, kKapJ = 14;
constexpr int kKapThreads = 256;
constexpr int kNormK = kKapK + 2, kNormPlane = (kKapJ + 2) * kNormK;
constexpr int kFK = kKapK + 4, kFPlane = (kKapJ + 4) * kFK;
constexpr int kFStaged = (kFPlane + kKapThreads - 1) / kKapThreads;
constexpr int kNormPasses = kNormPlane / kKapThreads;
constexpr int kKapCells = kKapK * kKapJ;
constexpr int kKapPasses = (kKapCells + kKapThreads - 1) / kKapThreads;
constexpr int kKapWaves = 8, kKapMinPlanes = 4;  // the chunking of Kappa::chunk
static_assert(kNormPlane % kKapThreads == 0, "the normals' passes keep every thread busy");

// Bytes of dynamic shared memory: F's ring of 4 planes, then the normals'
// ring of 4 planes of (mx, my, mz).
template <typename T>
constexpr size_t kappa_smem_bytes() {
  return sizeof(T) * (4 * kFPlane + 4 * 3 * kNormPlane);
}

// kappa = -div(normal) on the global interior, 0 elsewhere, of a (j, k)
// tile over planes [l0, l0 + lc). F's planes and each plane's normals (mx,
// my, mz) go into rings of 4 (plane l at slot l & 3). Step p stages F's
// plane p+1 (its reads issued a step ahead), then, after the step's one
// barrier, computes the normals of plane p once a cell and kappa at p-2
// from the normals of planes p-3, p-2 and p-1, all written before the
// barrier. A slot is rewritten two steps after its last read, so one
// barrier a step separates every write from the reads it must follow.
// Each value is the first form's arithmetic in its order on the same F, as
// ld3 reads it (0 off the array).
// At least 4 CTAs an SM in f32 (2 in f64): the normals' full path is a
// chain of branches that needs resident warps more than registers.
template <typename T, bool PENCIL>
__global__ void __launch_bounds__(kKapThreads, sizeof(T) == 4 ? 4 : 2)
    kappa3d_kernel(const T* __restrict__ F, T* __restrict__ kappa, const tv::Vol block,
                   const P3Params<T> q, const int lc) {
  extern __shared__ __align__(16) unsigned char smem[];
  T(*fs)[kFPlane] = reinterpret_cast<T(*)[kFPlane]>(smem);
  T(*ns)[3][kNormPlane] = reinterpret_cast<T(*)[3][kNormPlane]>(fs + 4);
  const tv::Vol g = tv::rows<PENCIL>(block);
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kKapK, j0 = blockIdx.y * kKapJ;
  const int l0 = blockIdx.z * lc;
  const int l1 = min(l0 + lc, g.n0);

  T next[kFStaged];
  auto load = [&](int l) {
#pragma unroll
    for (int i = 0; i < kFStaged; ++i) {
      const int idx = tid + i * kKapThreads;
      if (idx < kFPlane) next[i] = tv::ld3(F, g, l, j0 - 2 + idx / kFK, k0 - 2 + idx % kFK);
    }
  };
  auto store = [&](int l) {
#pragma unroll
    for (int i = 0; i < kFStaged; ++i) {
      const int idx = tid + i * kKapThreads;
      if (idx < kFPlane) fs[l & 3][idx] = next[i];
    }
  };
  // the normals of plane l on the tile and its rim, 0 off the array and
  // the global interior
  auto normals = [&](int l) {
#pragma unroll
    for (int i = 0; i < kNormPasses; ++i) {
      const int idx = tid + i * kKapThreads;
      const int rj = idx / kNormK, rk = idx % kNormK;  // from (j0 - 1, k0 - 1)
      const int j = j0 - 1 + rj, k = k0 - 1 + rk;
      T m[3] = {T(0), T(0), T(0)};
      if (g.inside(l, j, k) && g.interior(l, j, k)) {
        T f[3][3][3];
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int b = 0; b < 3; ++b)
#pragma unroll
            for (int c = 0; c < 3; ++c) f[a][b][c] = fs[(l + a - 1) & 3][(rj + b) * kFK + rk + c];
        youngs_normal(f, q, m);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) ns[l & 3][c][idx] = m[c];
    }
  };
  // kappa at plane l of the tile from the normals of l-1, l and l+1
  auto curvature = [&](int l) {
    const T(&e)[3][kNormPlane] = ns[(l + 1) & 3];
    const T(&w)[3][kNormPlane] = ns[(l - 1) & 3];
    const T(&m)[3][kNormPlane] = ns[l & 3];
#pragma unroll
    for (int i = 0; i < kKapPasses; ++i) {
      const int idx = tid + i * kKapThreads;
      if (idx >= kKapCells) break;
      const int j = j0 + idx / kKapK, k = k0 + idx % kKapK;
      if (!g.inside(l, j, k)) continue;
      const int cell = (idx / kKapK + 1) * kNormK + idx % kKapK + 1;  // in a normals plane
      T kap = T(0);
      if (g.interior(l, j, k)) {
        kap = -(tv::quot(e[0][cell] - w[0][cell], q.two_h[0]) +
                tv::quot(m[1][cell + kNormK] - m[1][cell - kNormK], q.two_h[1]) +
                tv::quot(m[2][cell + 1] - m[2][cell - 1], q.two_h[2]));
      }
      kappa[g.at(l, j, k)] = kap;
    }
  };

  for (int l = l0 - 2; l < l0; ++l) {
    load(l);
    store(l);
  }
  load(l0);
  for (int p = l0 - 1; p <= l1 + 1; ++p) {
    store(p + 1);  // the slot of p-3, last read by the normals of p-2
    load(p + 2);
    __syncthreads();
    if (p <= l1) normals(p);  // the slot of p-4, last read by kappa at p-3
    if (p >= l0 + 2) curvature(p - 2);
  }
}

// The pre-pass of one (type, mode): its shared memory granted and the
// CTAs it keeps resident on an SM (asked once a device), and its launch
// over chunks of planes.
template <typename T, bool PENCIL>
struct Kappa {
  static constexpr size_t smem = kappa_smem_bytes<T>();
  static int resident() {
    static std::atomic<int> cache[tv::kMaxDevices];
    return tv::per_device(cache, [](int) {
      cudaFuncSetAttribute(kappa3d_kernel<T, PENCIL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
      int n = 0;
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kappa3d_kernel<T, PENCIL>, kKapThreads,
                                                    smem);
      return n;
    });
  }
  // A plane's cost depends on the data (a uniform cube is cheap; the
  // interface and a liquid whose F carries rounding noise are not), so the
  // planes are cut into short chunks, about kKapWaves waves of CTAs that
  // the card balances as they finish, of at least kKapMinPlanes planes (a
  // chunk also computes the normals of one plane beyond each end).
  static int chunk(int n0, int tiles) {
    const long long slots = static_cast<long long>(tv::sm_count()) * resident();
    long long chunks = (kKapWaves * slots + tiles - 1) / tiles;
    chunks = chunks < 1 ? 1 : (chunks > n0 ? n0 : chunks);
    const int lc = static_cast<int>((n0 + chunks - 1) / chunks);
    return lc > kKapMinPlanes ? lc : (kKapMinPlanes < n0 ? kKapMinPlanes : n0);
  }
  static cudaError_t launch(const T* F, T* kappa, tv::Vol g, const P3Params<T>& q,
                            cudaStream_t stream) {
    const int tiles_k = (g.n2 + kKapK - 1) / kKapK, tiles_j = (g.n1 + kKapJ - 1) / kKapJ;
    const int lc = chunk(g.n0, tiles_k * tiles_j);
    const dim3 grid(tiles_k, tiles_j, (g.n0 + lc - 1) / lc);
    kappa3d_kernel<T, PENCIL><<<grid, kKapThreads, smem, stream>>>(F, kappa, g, q, lc);
    return cudaGetLastError();
  }
};

// The tile of one CTA: kTK columns (k, one per lane) by kTJ rows (j, one
// per warp). Its staged region has a one-cell halo below and two above on
// each of j and k, and a ring of four planes.
constexpr int kTK = 32;
constexpr int kTJ = 8;
constexpr int kRK = kTK + 3;     // staged columns k0-1 .. k0+kTK+1
constexpr int kRJ = kTJ + 3;     // staged rows j0-1 .. j0+kTJ+1
constexpr int kRing = 4;         // staged planes l-1 .. l+2
constexpr int kPlane = kRJ * kRK;
constexpr int kThreads = kTK * kTJ;
constexpr int kFieldU = 0, kFieldV = 1, kFieldW = 2, kFieldF = 3, kFieldK = 4;

template <bool CSF>
__host__ __device__ constexpr int staged_fields() {
  return CSF ? 5 : 4;
}

// Bytes of dynamic shared memory: the ring of every staged field, then v*
// of the tile's rows and one more (kTJ + 1) x kTK, then w* of its columns
// and one more kTJ x (kTK + 1).
template <typename T, bool CSF>
constexpr size_t predict_smem_bytes() {
  return sizeof(T) * (staged_fields<CSF>() * kRing * kPlane + (kTJ + 1) * kTK +
                      kTJ * (kTK + 1));
}

// The staged tile, read as the fields themselves: U, V, W are FixedVel's
// values, F and K (kappa) read 0 off the array; rho is rho_at's (0 off the
// array). Valid for planes l-1 .. l+2 of the step that staged l+2, rows
// j0-1 .. j0+kTJ+1, columns k0-1 .. k0+kTK+1.
template <typename T>
struct Staged {
  const T* s;
  int j0, k0;
  tv::Vol g;

  __device__ __forceinline__ T at(int f, int l, int j, int k) const {
    return s[((f * kRing + ((l + 1) & (kRing - 1))) * kRJ + (j - j0 + 1)) * kRK + (k - k0 + 1)];
  }
  __device__ __forceinline__ T U(int l, int j, int k) const { return at(kFieldU, l, j, k); }
  __device__ __forceinline__ T V(int l, int j, int k) const { return at(kFieldV, l, j, k); }
  __device__ __forceinline__ T W(int l, int j, int k) const { return at(kFieldW, l, j, k); }
  __device__ __forceinline__ T F(int l, int j, int k) const { return at(kFieldF, l, j, k); }
  __device__ __forceinline__ T K(int l, int j, int k) const { return at(kFieldK, l, j, k); }
  __device__ __forceinline__ T rho(int l, int j, int k, const P3Params<T>& q) const {
    return g.inside(l, j, k) ? tv::mix_rho(F(l, j, k), q.rho_l, q.rho_g) : T(0);
  }
};

// A plane of the region as one thread stages it: its cells idx = tid,
// tid + kThreads, ... of the plane, each field by FixedVel's rules for u,
// v, w and 0 off the array for F and kappa. load() issues the reads,
// store() writes them into the plane's ring slot; the kernel loads plane
// l+3 while it computes plane l, so the reads' latency hides behind the
// stencils.
constexpr int kStaged = (kPlane + kThreads - 1) / kThreads;

template <typename T, bool CSF>
struct PlaneCells {
  T val[kStaged][5];

  __device__ __forceinline__ void load(const FixedVel<T>& X, const T* __restrict__ F,
                                       const T* __restrict__ kappa, int l, int j0, int k0,
                                       int tid) {
#pragma unroll
    for (int i = 0; i < kStaged; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < kPlane) {
        const int j = j0 - 1 + idx / kRK;
        const int k = k0 - 1 + idx % kRK;
        val[i][kFieldU] = X.U(l, j, k);
        val[i][kFieldV] = X.V(l, j, k);
        val[i][kFieldW] = X.W(l, j, k);
        val[i][kFieldF] = tv::ld3(F, X.g, l, j, k);
        if (CSF) val[i][kFieldK] = tv::ld3(kappa, X.g, l, j, k);
      }
    }
  }
  __device__ __forceinline__ void store(T* s, int l, int tid) const {
    T* const slot = s + ((l + 1) & (kRing - 1)) * kPlane;
#pragma unroll
    for (int i = 0; i < kStaged; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < kPlane) {
#pragma unroll
        for (int f = 0; f < staged_fields<CSF>(); ++f) slot[f * kRing * kPlane + idx] = val[i][f];
      }
    }
  }
};

// u* at global i in [2, nx], global j and k interior; 0 elsewhere and off
// the array.
template <typename T, bool CSF>
__device__ __forceinline__ T star_u(const Staged<T>& X, int l, int j, int k,
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
  const T Fc = X.F(l, j, k);
  const T nu = tv::mix_nu(Fc, q.nu_l, q.nu_g);
  T acc = nu * (uw - T(2) * uc + ue) * q.dxi2 + nu * (us - T(2) * uc + un) * q.dyi2 +
          nu * (ub - T(2) * uc + uf) * q.dzi2 - uc * dudx - v_here * dudy -
          w_here * dudz + q.gx;
  if (CSF) {
    const T kap = (X.K(l, j, k) + X.K(l - 1, j, k)) * T(0.5);
    const T fx = q.neg_sigma * (Fc - X.F(l - 1, j, k)) * kap / q.dx;
    acc = acc + fx * T(2) / (X.rho(l, j, k, q) + X.rho(l - 1, j, k, q));
  }
  return uc + q.dt * acc;
}

// v* at global i in [1, nx], global j in [2, ny], k interior.
template <typename T, bool CSF>
__device__ __forceinline__ T star_v(const Staged<T>& X, int l, int j, int k,
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
  const T Fc = X.F(l, j, k);
  const T nu = tv::mix_nu(Fc, q.nu_l, q.nu_g);
  T acc = nu * (vw - T(2) * vc + ve) * q.dxi2 + nu * (vs - T(2) * vc + vn) * q.dyi2 +
          nu * (vb - T(2) * vc + vf) * q.dzi2 - u_here * dvdx - vc * dvdy -
          w_here * dvdz + q.gy;
  if (CSF) {
    const T kap = (X.K(l, j, k) + X.K(l, j - 1, k)) * T(0.5);
    const T fy = q.neg_sigma * (Fc - X.F(l, j - 1, k)) * kap / q.dy;
    acc = acc + fy * T(2) / (X.rho(l, j, k, q) + X.rho(l, j - 1, k, q));
  }
  return vc + q.dt * acc;
}

// w* at global i in [1, nx], global j interior, k in [2, nz].
template <typename T, bool CSF>
__device__ __forceinline__ T star_w(const Staged<T>& X, int l, int j, int k,
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
  const T Fc = X.F(l, j, k);
  const T nu = tv::mix_nu(Fc, q.nu_l, q.nu_g);
  T acc = nu * (ww - T(2) * wc + we) * q.dxi2 + nu * (ws - T(2) * wc + wn) * q.dyi2 +
          nu * (wb - T(2) * wc + wf) * q.dzi2 - u_here * dwdx - v_here * dwdy -
          wc * dwdz + q.gz;
  if (CSF) {
    const T kap = (X.K(l, j, k) + X.K(l, j, k - 1)) * T(0.5);
    const T fz = q.neg_sigma * (Fc - X.F(l, j, k - 1)) * kap / q.dz;
    acc = acc + fz * T(2) / (X.rho(l, j, k, q) + X.rho(l, j, k - 1, q));
  }
  return wc + q.dt * acc;
}

// u*, v*, w* and rhs of a (j, k) tile over planes [l0, l0 + lc); all four
// are 0 on the array's first and last planes (the Pallas kernel's zeroed
// ghost planes).
template <typename T, bool PENCIL, bool CSF>
__global__ void __launch_bounds__(kThreads)
    predict3d_kernel(const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ w,
                     const T* __restrict__ F, const T* __restrict__ kappa, T* __restrict__ us,
                     T* __restrict__ vs, T* __restrict__ ws, T* __restrict__ rhs,
                     const tv::Vol block, const P3Params<T> q, const int lc) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  T* v_star = tile + staged_fields<CSF>() * kRing * kPlane;  // [kTJ + 1][kTK]
  T* w_star = v_star + (kTJ + 1) * kTK;                      // [kTJ][kTK + 1]
  const tv::Vol g = tv::rows<PENCIL>(block);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTK + tx;
  const int k0 = blockIdx.x * kTK, j0 = blockIdx.y * kTJ;
  const int k = k0 + tx, j = j0 + ty;
  const int l0 = blockIdx.z * lc;
  const int l1 = min(l0 + lc, g.n0);
  const FixedVel<T> X{u, v, w, g};
  const Staged<T> S{tile, j0, k0, g};

  PlaneCells<T, CSF> cells;
  for (int l = l0 - 1; l <= l0 + 1; ++l) {
    cells.load(X, F, kappa, l, j0, k0, tid);
    cells.store(tile, l, tid);
  }
  cells.load(X, F, kappa, l0 + 2, j0, k0, tid);
  __syncthreads();
  T u_cur = star_u<T, CSF>(S, l0, j, k, q);
  for (int l = l0; l < l1; ++l) {
    // plane l+2 takes the slot of plane l-2, last read before the previous
    // step's second barrier; plane l+3's reads are issued now
    cells.store(tile, l + 2, tid);
    cells.load(X, F, kappa, l + 3, j0, k0, tid);
    __syncthreads();
    const T u_next = star_u<T, CSF>(S, l + 1, j, k, q);
    v_star[ty * kTK + tx] = star_v<T, CSF>(S, l, j, k, q);
    w_star[ty * (kTK + 1) + tx] = star_w<T, CSF>(S, l, j, k, q);
    if (ty == 0) v_star[kTJ * kTK + tx] = star_v<T, CSF>(S, l, j0 + kTJ, k, q);
    if (ty == 1 && tx < kTJ) {
      w_star[tx * (kTK + 1) + kTK] = star_w<T, CSF>(S, l, j0 + tx, k0 + kTK, q);
    }
    __syncthreads();
    if (j < g.n1 && k < g.n2) {
      const long long o = g.at(l, j, k);
      if (l == 0 || l == g.n0 - 1) {
        us[o] = vs[o] = ws[o] = rhs[o] = T(0);
      } else {
        const T vsc = v_star[ty * kTK + tx];
        const T wsc = w_star[ty * (kTK + 1) + tx];
        us[o] = u_cur;
        vs[o] = vsc;
        ws[o] = wsc;
        T r = T(0);
        if (g.interior(l, j, k)) {
          const T rho = tv::mix_rho(S.F(l, j, k), q.rho_l, q.rho_g);
          r = rho / q.dt *
              ((u_next - u_cur) * q.dxi + (v_star[(ty + 1) * kTK + tx] - vsc) * q.dyi +
               (w_star[ty * (kTK + 1) + tx + 1] - wsc) * q.dzi);
        }
        rhs[o] = r;
      }
    }
    u_cur = u_next;
  }
}

// The kernel of one (type, mode, csf), with its shared memory granted and
// the CTAs it keeps resident on an SM (asked once a device).
template <typename T, bool PENCIL, bool CSF>
struct Predict {
  static constexpr size_t smem = predict_smem_bytes<T, CSF>();
  static int resident() {
    static std::atomic<int> cache[tv::kMaxDevices];
    return tv::per_device(cache, [](int) {
      cudaFuncSetAttribute(predict3d_kernel<T, PENCIL, CSF>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      int n = 0;
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, predict3d_kernel<T, PENCIL, CSF>,
                                                    kThreads, smem);
      return n;
    });
  }
  static int launch(const T* u, const T* v, const T* w, const T* F, const T* kappa, T* us,
                    T* vs, T* ws, T* rhs, tv::Vol g, const P3Params<T>& q,
                    cudaStream_t stream) {
    const int tiles_k = (g.n2 + kTK - 1) / kTK, tiles_j = (g.n1 + kTJ - 1) / kTJ;
    // a chunk stages three planes and computes one plane of u* of its own
    const int lc = tv::plane_chunk(g.n0, tiles_k * tiles_j, resident(), 3);
    const dim3 grid(tiles_k, tiles_j, (g.n0 + lc - 1) / lc);
    predict3d_kernel<T, PENCIL, CSF><<<grid, dim3(kTK, kTJ), smem, stream>>>(
        u, v, w, F, kappa, us, vs, ws, rhs, g, q, lc);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T, bool PENCIL>
int launch_rows(const T* u, const T* v, const T* w, const T* F, T* kappa, T* us, T* vs,
                T* ws, T* rhs, tv::Vol g, const P3Params<T>& q, cudaStream_t stream) {
  if (!kappa) return Predict<T, PENCIL, false>::launch(u, v, w, F, kappa, us, vs, ws, rhs, g, q,
                                                       stream);
  const cudaError_t err = Kappa<T, PENCIL>::launch(F, kappa, g, q, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return Predict<T, PENCIL, true>::launch(u, v, w, F, kappa, us, vs, ws, rhs, g, q, stream);
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

// threads a CTA, shared bytes a CTA, CTAs resident per SM
template <typename T, bool PENCIL, bool CSF>
void shape_of(int* out) {
  out[0] = kThreads;
  out[1] = static_cast<int>(Predict<T, PENCIL, CSF>::smem);
  out[2] = Predict<T, PENCIL, CSF>::resident();
}

template <typename T>
int predict3d_shape(int pencil, int csf, int* out) {
  if (pencil) {
    csf ? shape_of<T, true, true>(out) : shape_of<T, true, false>(out);
  } else {
    csf ? shape_of<T, false, true>(out) : shape_of<T, false, false>(out);
  }
  return static_cast<int>(cudaGetLastError());
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

// The predictor's launch shape: out = {threads a CTA, shared bytes a CTA,
// CTAs resident per SM}.
extern "C" int tv_predict3d_shape_f32(int pencil, int csf, int* out) {
  return predict3d_shape<float>(pencil, csf, out);
}

extern "C" int tv_predict3d_shape_f64(int pencil, int csf, int* out) {
  return predict3d_shape<double>(pencil, csf, out);
}
