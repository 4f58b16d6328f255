// The whole 2-D step as stage groups (fullstep.cu, fullstep_dma.cu).
//
// One cooperative launch runs the step in stage groups with one grid-wide
// barrier between two; in each group a CTA takes tiles of TH rows x kTW
// columns in turn (stage_groups.cuh):
//   predict: the Youngs normals once a cell (rim 3 of F), kappa, u*/v* on
//            the tile and one row/column beyond, rhs; writes u*, v*, rhs;
//   jacobi:  d <= kJacobiLevels Jacobi sweeps on overlapped tiles (rim d,
//            one less valid ring a sweep), a group per split of n_jacobi
//            (jacobi_depth: 10 -> 4, 3, 3); writes p;
//   finish:  the correction on the tile +4 (rim 5 of F and p), the first
//            sweep on the tile +1 across it and +4 along the second, the
//            second sweep and the clamp on the tile +1, each quantity of a
//            sweep once a position (a warp a line segment, neighbours by
//            shuffles), the BCs; writes F, u, v, p.
// Each group is a struct: its boxes (from a layout), its inputs (load, seen
// by a visitor) and its passes (compute, which stores the group's outputs
// with the threads). step_groups runs them under a staging policy Pol,
// which moves each tile's inputs into its boxes:
//   pol.run(g, pre)      every tile of this CTA in group g (pre: the first
//                        tile's inputs were issued by early/late);
//   pol.jacobi(d, make, x)  the Jacobi group of depth d, make(depth) its
//                        struct, x the field of its first tile issued
//                        before the barrier (late issues the rest);
//   pol.early(g, x, o)   before a grid barrier, the inputs of this CTA's
//                        first tile of g that are final already: the field
//                        x alone (o) or all but x (!o);
//   pol.late(g, x, o)    after it, the rest, in the same terms;
//   pol.begin(g)         at the kernel's start (g: the first Jacobi group,
//                        whose entry p is final);
//   pol.sync(grid)       the grid-wide barrier.
// ThreadLoads below is fullstep.cu's policy: each tile's inputs loaded by
// the CTA's threads when the tile starts, nothing issued ahead.
#pragma once

#include <cooperative_groups.h>

#include "phase_tiles.cuh"

namespace tv {

template <typename T>
struct StepArgs {
  const T *F, *u, *v, *p;  // entry block fields
  T *F_out, *u_out, *v_out, *p_out;
  T *us, *vs, *rhs, *pa, *pb;  // scratch, each one block
  Block b;
  PredictParams<T> pq;
  ProjectParams<T> jq;
  SweepParams<T> sx, sy;
  int n_jacobi, even_step;
};

// predict: u*, v* and rhs of the tile at (ti, tj): phase_tiles.cuh's
// predictor on the tile +1 (rhs reads u*, v* at +1), u* and v* kept in
// boxes over the normals, which are dead by then.
template <int TH, typename T>
struct PredictGroup {
  static constexpr int kRows = TH;
  using Boxes = PredictBoxes<TH, 1, T>;
  const StepArgs<T>& a;

  template <class V>
  __device__ __forceinline__ void load(V&& st, const Boxes& s) const {
    predict_load(st, a.b, s, a.F, a.u, a.v);
  }

  __device__ __forceinline__ void compute(const Boxes& s, int ti, int tj) const {
    const Block& b = a.b;
    constexpr int H = TH, W = kTW;
    const Box<T> us{s.mx.s, ti, tj, W + 1};
    const Box<T> vs{us.end(H + 1), ti, tj, W + 1};
    static_assert(2 * (H + 1) * (W + 1) <= 2 * (H + 4) * (W + 4), "u*/v* fit over the normals");
    predict_passes(b, a.pq, s, ti, tj, [&](int i, int j, T x, T y) {
      const bool in = b.inside(i, j);
      us(i, j) = in ? x : T(0);
      vs(i, j) = in ? y : T(0);
      if (in && i < ti + H && j < tj + W) {
        a.us[i * b.E1 + j] = x;
        a.vs[i * b.E1 + j] = y;
      }
    });
    __syncthreads();
    for_cells<H, W>(ti, tj, [&](int i, int j) {
      if (b.inside(i, j)) {
        a.rhs[i * b.E1 + j] = b.interior(i, j)
                                  ? rhs_of(Tile<T>(s.F, i, j), Tile<T>(us, i, j),
                                           Tile<T>(vs, i, j), a.jq)
                                  : T(0);
      }
    });
  }
};

// finish: the correction, both sweeps, the clamp and the BCs of the tile
// at (ti, tj), with p the last Jacobi output.
template <int TH, typename T>
struct FinishGroup {
  static constexpr int kRows = TH;
  static constexpr int H = TH, W = kTW;
  const StepArgs<T>& a;
  const T* p;

  // F and p from (ti - 5, tj - 5); u*, v*, u, v from (ti - 4, tj - 4), all
  // loaded; the thread-load layout's pitches are odd, so that a warp
  // reading down a column hits 32 banks.
  struct Boxes {
    Box<T> F, P;
    Box<T> un, vn;  // u*, v*, then the corrected u, v
    Box<T> s1, s2;  // u, v, then the first and the second sweep
    template <class L>
    __device__ __forceinline__ Boxes(L&& lay, int ti, int tj)
        : F(lay.in(ti - 5, tj - 5, H + 10, W + 10, W + 11)),
          P(lay.in(ti - 5, tj - 5, H + 10, W + 10, W + 11)),
          un(lay.in(ti - 4, tj - 4, H + 8, W + 8, W + 9)),
          vn(lay.in(ti - 4, tj - 4, H + 8, W + 8, W + 9)),
          s1(lay.in(ti - 4, tj - 4, H + 8, W + 8, W + 9)),
          s2(lay.in(ti - 4, tj - 4, H + 8, W + 8, W + 9)) {}
  };

  template <class V>
  __device__ __forceinline__ void load(V&& st, const Boxes& s) const {
    st.template load<H + 10, W + 10, 2, T>(a.b, {s.F, s.P}, {a.F, p});
    st.template load<H + 8, W + 8, 4, T>(a.b, {s.un, s.vn, s.s1, s.s2}, {a.us, a.vs, a.u, a.v});
  }

  __device__ __forceinline__ void compute(const Boxes& s, int ti, int tj) const {
    const Block& b = a.b;
    const Box<T>&F = s.F, &P = s.P, &un = s.un, &vn = s.vn, &s1 = s.s1, &s2 = s.s2;
    // the correction, in place: a cell reads u*, v*, u, v only at itself
    for_cells<H + 8, W + 8>(ti - 4, tj - 4, [&](int i, int j) {
      T x, y;
      correct_of(Tile<T>(F, i, j), Tile<T>(un, i, j), Tile<T>(vn, i, j), Tile<T>(P, i, j),
                 Tile<T>(s1, i, j), Tile<T>(s2, i, j), b, i, j, a.jq, x, y);
      const bool in = b.inside(i, j);
      un(i, j) = in ? x : T(0);
      vn(i, j) = in ? y : T(0);
    });
    __syncthreads();
    // the first sweep, where the second reads it: the tile +1 across it,
    // +4 along the second sweep's axis
    if (a.even_step) {
      sweep_lines<T, 1, false>(F, vn, s1, ti - 4, ti + H + 4, tj - 1, tj + W + 1, b, a.sy);
    } else {
      sweep_lines<T, 0, false>(F, un, s1, ti - 1, ti + H + 1, tj - 4, tj + W + 4, b, a.sx);
    }
    __syncthreads();
    // the second sweep and the clamp on the tile +1 (the BCs read +-1)
    if (a.even_step) {
      sweep_lines<T, 0, true>(s1, un, s2, ti - 1, ti + H + 1, tj - 1, tj + W + 1, b, a.sx);
    } else {
      sweep_lines<T, 1, true>(s1, vn, s2, ti - 1, ti + H + 1, tj - 1, tj + W + 1, b, a.sy);
    }
    __syncthreads();
    // wall BCs at global indices (tpuvof's _bc_values): u mirrored across
    // the j-walls then zero on the i-wall faces; v zero on the j-wall faces
    // then mirrored across the i-walls; F and p mirrored j first, then i.
    for_cells<H, W>(ti, tj, [&](int i, int j) {
      if (b.inside(i, j)) {
        const int gi = i + b.oi, gj = j + b.oj;
        const int di = gi == 0 ? 1 : (gi == b.nx + 1 ? -1 : 0);
        const int dj = gj == 0 ? 1 : (gj == b.ny + 1 ? -1 : 0);
        const int c = i * b.E1 + j;
        a.u_out[c] = gi == 1 || gi == b.nx + 1 ? T(0) : un(i, j + dj);
        a.v_out[c] = gj == 1 || gj == b.ny + 1 ? T(0) : vn(i + di, j);
        a.F_out[c] = s2(i + di, j + dj);
        a.p_out[c] = P(i + di, j + dj);
      }
    });
  }
};

// The step on this CTA's tiles under the staging policy pol: predict, the
// Jacobi groups, finish, one pol.sync() between two.
template <int TH, typename T, class Pol>
__device__ __forceinline__ void step_groups(const StepArgs<T>& a, Pol& pol) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int n = jacobi_groups(a.n_jacobi);
  if (n > 0) {
    with_depth<kJacobiLevels>(jacobi_depth(a.n_jacobi, 0), [&](auto depth) {
      pol.begin(JacobiGroup<TH, decltype(depth)::value, T>{a.b, a.jq, a.p, a.rhs, a.pa});
    });
  }
  pol.run(PredictGroup<TH, T>{a}, false);
  pol.sync(grid);
  const T* p = a.p;
  T* dst = a.pa;
  for (int g = 0; g < n; ++g) {
    // the entry p of the first group went at begin, the rhs of a later one
    // before the barrier
    pol.jacobi(
        jacobi_depth(a.n_jacobi, g),
        [&](auto depth) {
          return JacobiGroup<TH, decltype(depth)::value, T>{a.b, a.jq, p, a.rhs, dst};
        },
        g == 0 ? a.p : a.rhs);
    if (g + 1 < n) {
      with_depth<kJacobiLevels>(jacobi_depth(a.n_jacobi, g + 1), [&](auto depth) {
        pol.early(JacobiGroup<TH, decltype(depth)::value, T>{a.b, a.jq, dst, a.rhs, a.pa},
                  a.rhs, true);
      });
    } else {
      pol.early(FinishGroup<TH, T>{a, dst}, dst, false);
    }
    pol.sync(grid);
    p = dst;
    dst = dst == a.pa ? a.pb : a.pa;
  }
  const FinishGroup<TH, T> fg{a, p};
  pol.late(fg, n > 0 ? p : nullptr, n > 0);
  pol.run(fg, true);
}

// fullstep.cu's policy: each tile's inputs loaded by the CTA's threads
// through ld() when the tile starts (stage).
template <typename T, int TH>
struct ThreadLoads {
  T* sm;
  int tiles_j, n_tiles;

  __device__ __forceinline__ ThreadLoads(const Block& b, T* sm_)
      : sm(sm_), tiles_j((b.E1 + kTW - 1) / kTW), n_tiles(tiles_j * ((b.E0 + TH - 1) / TH)) {}

  template <class G>
  __device__ __forceinline__ void run(const G& g, bool) {
    for (int t = blockIdx.x, ti = t / tiles_j * TH, tj = t % tiles_j * kTW; t < n_tiles;
         t += gridDim.x, ti = t / tiles_j * TH, tj = t % tiles_j * kTW) {
      thread_tile(g, sm, ti, tj);
    }
  }

  // a Jacobi group of depth d, the depth picked at each tile as
  // jacobi_depth_tile picks it
  template <class Make>
  __device__ __forceinline__ void jacobi(int d, const Make& make, const T*) {
    for (int t = blockIdx.x, ti = t / tiles_j * TH, tj = t % tiles_j * kTW; t < n_tiles;
         t += gridDim.x, ti = t / tiles_j * TH, tj = t % tiles_j * kTW) {
      with_depth<kJacobiLevels>(
          d, [&](auto depth) { thread_tile(make(depth), sm, ti, tj); });
    }
  }

  template <class G>
  __device__ __forceinline__ void begin(const G&) {}
  template <class G>
  __device__ __forceinline__ void early(const G&, const T*, bool) {}
  template <class G>
  __device__ __forceinline__ void late(const G&, const T*, bool) {}
  __device__ __forceinline__ void sync(cooperative_groups::grid_group& grid) { grid.sync(); }
};

}  // namespace tv
