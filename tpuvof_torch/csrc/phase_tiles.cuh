// The 2-D step's predictor and FCT sweep on shared-memory tiles, shared by
// the phase kernels (predict.cu, fct_sweep.cu) and the whole-step kernels
// (step_groups.cuh).
//
// predict_values: a CTA stages F (rim 3) and u, v (rim 1) of its TH x kTW
// tile through ld(), computes each Youngs normal once a cell, then kappa,
// then u*/v* on the tile and EXT rows and columns beyond it (fullstep's rhs
// reads u*/v* at +1; the phase kernel wants the tile alone), and hands each
// (u*, v*) to the caller. sweep_lines: one FCT sweep over a region, each
// quantity once a position, a warp a 32-position line segment passing
// neighbours by shuffles. Both evaluate step_cell.cuh's functions on the
// same inputs in the order of the Pallas bodies, so every value is the
// same IEEE operations on the same operands as the plain versions.
#pragma once

#include "stage_groups.cuh"

namespace tv {

// ---- predict ----

// Shared values of T of the predictor's boxes (PredictBoxes) on TH-row
// tiles with u*/v* wanted EXT rows and columns beyond them.
constexpr int predict_tile_values(int th, int ext) {
  return (th + ext + 5) * (kTW + ext + 5) + 2 * (th + ext + 2) * (kTW + ext + 2) +
         (th + ext + 1) * (kTW + ext + 1) + 2 * (th + ext + 3) * (kTW + ext + 3);
}

// The predictor's shared-memory boxes for the TH x kTW tile at (ti, tj),
// with u*/v* wanted on the tile and EXT (0 or 1) rows and columns beyond
// it: F from (ti - 3, tj - 3), u and v from (ti - 1, tj - 1) (loaded),
// kappa from (ti - 1, tj - 1), the normals from (ti - 2, tj - 2) (filled);
// from a layout (stage_groups.cuh), or packed at sm.
template <int TH, int EXT, typename T>
struct PredictBoxes {
  static constexpr int H = TH + EXT, W = kTW + EXT;  // the u*/v* region
  Box<T> F, u, v, K, mx, my;
  template <class L>
  __device__ __forceinline__ PredictBoxes(L&& lay, int ti, int tj)
      : F(lay.in(ti - 3, tj - 3, H + 5, W + 5, W + 5)),
        u(lay.in(ti - 1, tj - 1, H + 2, W + 2, W + 2)),
        v(lay.in(ti - 1, tj - 1, H + 2, W + 2, W + 2)),
        K(lay.work(ti - 1, tj - 1, H + 1, W + 1)),
        mx(lay.work(ti - 2, tj - 2, H + 3, W + 3)),
        my(lay.work(ti - 2, tj - 2, H + 3, W + 3)) {}
  __device__ __forceinline__ PredictBoxes(T* sm, int ti, int tj)
      : PredictBoxes(Packed<T>{sm}, ti, tj) {}
};

// The predictor's inputs as a visitor sees them: F (rim 3), u and v (rim
// 1) of their block fields.
template <int TH, int EXT, typename T, class V>
__device__ __forceinline__ void predict_load(V&& st, const Block& b,
                                             const PredictBoxes<TH, EXT, T>& s, const T* F,
                                             const T* u, const T* v) {
  constexpr int H = PredictBoxes<TH, EXT, T>::H, W = PredictBoxes<TH, EXT, T>::W;
  st.template load<H + 5, W + 5, 1, T>(b, {s.F}, {F});
  st.template load<H + 2, W + 2, 2, T>(b, {s.u, s.v}, {u, v});
}

// On the staged boxes s: the normals once a cell (zero off the global
// interior), kappa (0 off the global interior and outside the block) and
// u*, v* on the (TH + EXT) x (kTW + EXT) region at (ti, tj), handing each
// to out(i, j, u*, v*). The normals are dead during the u*/v* pass, so
// out may store into their space; the caller syncs before the boxes are
// used again.
template <int TH, int EXT, typename T, class Out>
__device__ __forceinline__ void predict_passes(const Block& b, const PredictParams<T>& q,
                                               const PredictBoxes<TH, EXT, T>& s, int ti, int tj,
                                               const Out& out) {
  constexpr int H = PredictBoxes<TH, EXT, T>::H, W = PredictBoxes<TH, EXT, T>::W;
  for_cells<H + 3, W + 3>(ti - 2, tj - 2, [&](int i, int j) {
    T x = T(0), y = T(0);
    if (b.interior(i, j)) normal_of(Tile<T>(s.F, i, j), q, x, y);
    s.mx(i, j) = x;
    s.my(i, j) = y;
  });
  __syncthreads();
  for_cells<H + 1, W + 1>(ti - 1, tj - 1, [&](int i, int j) {
    s.K(i, j) = b.inside(i, j) && b.interior(i, j)
                    ? curvature_of(s.mx(i + 1, j), s.mx(i - 1, j), s.my(i, j + 1),
                                   s.my(i, j - 1), q)
                    : T(0);
  });
  __syncthreads();
  for_cells<H, W>(ti, tj, [&](int i, int j) {
    T x, y;
    momentum_of(Tile<T>(s.u, i, j), Tile<T>(s.v, i, j), Tile<T>(s.F, i, j), Tile<T>(s.K, i, j),
                b, i, j, q, x, y);
    out(i, j, x, y);
  });
}

// Stages F, u, v into the boxes s with thread loads (read through ld():
// 0 outside the block and the global domain), then predict_passes.
template <int TH, int EXT, typename T, class Out>
__device__ __forceinline__ void predict_values(const Block& b, const PredictParams<T>& q,
                                               const PredictBoxes<TH, EXT, T>& s, const T* F,
                                               const T* u, const T* v, int ti, int tj,
                                               const Out& out) {
  predict_load(ThreadStage{}, b, s, F, u, v);
  __syncthreads();
  predict_passes(b, q, s, ti, tj, out);
}

// ---- one FCT sweep ----

// A block field in global memory read as ld() reads it, as an accessor of
// sweep_lines.
template <typename T>
struct Global {
  const T* __restrict__ a;
  const Block& b;
  __device__ __forceinline__ T operator()(int i, int j) const { return ld(a, b, i, j); }
};

// A block field in global memory written at (i, j).
template <typename T>
struct GlobalOut {
  T* __restrict__ a;
  int E1;
  __device__ __forceinline__ T& operator()(int i, int j) const { return a[i * E1 + j]; }
};

// One FCT sweep along AXIS (then the clamp, with CLAMP) of the cells of
// rows [r0, r1) x columns [c0, c1), from F and the velocity vel into out
// (accessors: a Box, or Global / GlobalOut), every quantity once a
// position (step_cell.cuh's sweep_* functions): a warp takes 32
// consecutive positions of one line, k0 - 3 .. k0 + 28, passes neighbours'
// values by shuffles, and its lanes 3..28 hold the complete windows of
// cells k0 .. k0 + 25. The inputs are read 3 positions past the region at
// both ends and as 0 beyond. A result outside the block is 0, as ld()
// would read it. SEGS > 0 takes SEGS segments a line whatever the region's
// length (the caller's region is at most SEGS * 26 long; a segment past
// its end writes nothing), so the split of a task is a constant division.
template <typename T, int AXIS, bool CLAMP, int SEGS = 0, class In, class Out>
__device__ __forceinline__ void sweep_lines(const In& F, const In& vel, const Out& out, int r0,
                                            int r1, int c0, int c1, const Block& b,
                                            const SweepParams<T>& q) {
  constexpr unsigned kAll = 0xffffffffu;
  constexpr int kOut = kTX - 6;
  const int lane = static_cast<int>(threadIdx.x);
  const int p0 = AXIS == 0 ? r0 : c0;  // the region along the line
  const int p1 = AXIS == 0 ? r1 : c1;
  const int l0 = AXIS == 0 ? c0 : r0;  // and its lines
  const int segs = SEGS > 0 ? SEGS : (p1 - p0 + kOut - 1) / kOut;
  const int tasks = segs * (AXIS == 0 ? c1 - c0 : r1 - r0);
  for (int task = static_cast<int>(threadIdx.y); task < tasks; task += kTY) {
    const int line = l0 + task / segs;
    const int k0 = p0 + task % segs * kOut;
    const int pos = k0 - 3 + lane;
    const int i = AXIS == 0 ? pos : line;
    const int j = AXIS == 0 ? line : pos;
    const bool held = pos < p1 + 3;  // the inputs are read 3 past the region
    const T Fz = held ? F(i, j) : T(0);
    const T uz = held ? vel(i, j) : T(0);
    const int k = AXIS == 0 ? i + b.oi : j + b.oj;  // global index along
    const int m = AXIS == 0 ? j + b.oj : i + b.oi;  // and across the sweep
    T fL, fH;
    sweep_fluxes(uz, __shfl_up_sync(kAll, Fz, 1), Fz, q, fL, fH);
    const T av = sweep_anti(k, fL, fH);
    const T dv = sweep_dv(uz, __shfl_down_sync(kAll, uz, 1), q);
    const T Ftd = sweep_ftd(k, Fz, fL, __shfl_down_sync(kAll, fL, 1), dv, q);
    const T a_hi = __shfl_down_sync(kAll, av, 1);
    T rp, rm;
    sweep_ratios(k, __shfl_up_sync(kAll, Ftd, 1), Ftd, __shfl_down_sync(kAll, Ftd, 1), av,
                 a_hi, q, rp, rm);
    const T c = sweep_factor(av, __shfl_up_sync(kAll, rp, 1), __shfl_up_sync(kAll, rm, 1), rp,
                             rm);
    const T c_hi = __shfl_down_sync(kAll, c, 1);
    if (lane >= 3 && lane < 3 + kOut && pos < p1) {
      T s = k < 1 || k > q.n_ax || m < 1 || m > q.n_ot ? Fz
                                                        : sweep_result(Ftd, av, c, a_hi, c_hi,
                                                                       dv, q);
      if (CLAMP) s = clamp01(s);
      out(i, j) = b.inside(i, j) ? s : T(0);
    }
  }
}

}  // namespace tv
