// One Rudman/Zalesak FCT sweep of F along x or y, for Hopper (sm_90a).
//
// Replaces tpuvof/pallas_kernels/step_kernels.py:_pallas_sweep
// (pallas_fct_sweep_x/_y, the whole grid) and pallas_fct_sweep_win (a
// block with a global origin, _sweep_win_kernel), both with body
// _sweep_body: donor-cell flux, Ftd with the divergence compensation dV/dv,
// the limiter ratios rp/rm, the corrected anti-diffusive flux, and the
// optional clamps.
//
// What bounds it on the H100: a sweep reads F and one velocity and writes F:
// 3 field-sized arrays, ~3.2 MB at 514^2 f32, ~1 us at 3.35 TB/s. What it
// spends is its launch, the chain of dependent quantities a line needs
// (fluxes, then Ftd, then the limiter ratios, then the corrected factors,
// six IEEE divisions deep), and the instructions of that chain.
//
// What the design does about it: every quantity of the sweep (a face's
// fluxes fL/fH and anti-diffusive flux a, a cell's dv, Ftd and limiter
// ratios rp/rm, a face's corrected factor c) is computed once a position
// (the per-cell form evaluated 6 faces, 5 Ftd, 3 ratios and 2 factors for
// each cell), by phase_tiles.cuh's sweep_lines, which fullstep.cu runs
// too: a warp takes 32 consecutive positions of one line, passes
// neighbours' values by shuffles and writes the 26 cells whose windows it
// holds. Each quantity is a function of its position alone, so one
// evaluation gives the bits of the per-cell 7-cell window.
// - y sweep (axis 1, along the contiguous j): each warp reads its line
//   segments straight from global memory as coalesced row segments and
//   writes them the same way; a CTA takes 8 rows x 26 * SEGS columns.
//   Staging the rows in shared memory first was no faster (PERF.md).
// - x sweep (axis 0, strided): a CTA stages 32 rows x TC columns of F and
//   u (its 26 rows and 3 each side) in shared memory at an odd pitch, runs
//   sweep_lines down the columns into a shared box, and writes that as
//   rows. A thread marching its column along i with a rolling register
//   window (fct3d.cu's x sweep) was slower at 514^2 (PERF.md).
// The tile (SEGS 1, 2, 4; TC 8, 16, 32) is picked from the block size
// (tv::pick_tile): the most CTAs where they all run at once, else the
// fewest rims.
//
// Reads outside the global domain are 0 (the load sanitizer), and so are
// reads past the block's edges: for the whole grid the two coincide, and
// for a window the values they feed lie in the junk margin.
#include "phase_tiles.cuh"

namespace {

using tv::Box;
using tv::kThreads;
using tv::kTX;
using tv::kTY;

constexpr int kSeg = kTX - 6;  // results of a warp's line segment

// The y sweep of the cells of kTY rows x kSeg * SEGS columns a CTA, from
// global memory (SEGS fixed, so the split of a warp's tasks into lines and
// segments is a constant division).
template <typename T, int SEGS>
__global__ void __launch_bounds__(kThreads)
    sweep_y_kernel(const T* __restrict__ F, const T* __restrict__ vel, T* __restrict__ out,
                   const tv::Block b, const tv::SweepParams<T> q) {
  constexpr int cols = kSeg * SEGS;
  const int tiles_j = (b.E1 + cols - 1) / cols;
  const int r0 = static_cast<int>(blockIdx.x) / tiles_j * kTY;
  const int c0 = static_cast<int>(blockIdx.x) % tiles_j * cols;
  tv::sweep_lines<T, 1, false, SEGS>(tv::Global<T>{F, b}, tv::Global<T>{vel, b},
                                     tv::GlobalOut<T>{out, b.E1}, r0, min(r0 + kTY, b.E0), c0,
                                     min(c0 + cols, b.E1), b, q);
}

// Shared values of T of the x sweep's boxes on TC columns: F and u on 32
// rows, the result on kSeg, at pitch TC + 1.
__host__ __device__ constexpr int x_tile_values(int tc) { return (2 * kTX + kSeg) * (tc + 1); }

// The x sweep of the cells of kSeg rows x TC columns a CTA, through
// shared memory.
template <typename T, int TC>
__global__ void __launch_bounds__(kThreads)
    sweep_x_kernel(const T* __restrict__ F, const T* __restrict__ vel, T* __restrict__ out,
                   const tv::Block b, const tv::SweepParams<T> q) {
  constexpr int P = TC + 1;  // odd: a warp reading down a column hits 32 banks
  __shared__ T sm[x_tile_values(TC)];
  const int tiles_j = (b.E1 + TC - 1) / TC;
  const int ti = static_cast<int>(blockIdx.x) / tiles_j * kSeg;
  const int tj = static_cast<int>(blockIdx.x) % tiles_j * TC;
  const Box<T> Fb{sm, ti - 3, tj, P};
  const Box<T> vb{Fb.end(kTX), ti - 3, tj, P};
  const Box<T> ob{vb.end(kTX), ti, tj, P};
  tv::stage<kTX, TC, 2, T>(b, {Fb, vb}, {F, vel});
  __syncthreads();
  tv::sweep_lines<T, 0, false>(Fb, vb, ob, ti, ti + kSeg, tj, tj + TC, b, q);
  __syncthreads();
  tv::for_cells<kSeg, TC>(ti, tj, [&](int i, int j) {
    if (b.inside(i, j)) out[i * b.E1 + j] = ob(i, j);
  });
}

// Each axis's tile choices, smallest first (segments a warp for y,
// columns for x), and the CTAs an SM holds of each kernel (asked once a
// device; a negative CUDA error).
constexpr int kChoices = 3;
constexpr int kSegs[kChoices] = {1, 2, 4};
constexpr int kCols[kChoices] = {8, 16, 32};

template <typename T, int SEGS>
int y_per_sm() {
  static std::atomic<int> cache[tv::kMaxDevices];
  return tv::resident_per_sm(cache, sweep_y_kernel<T, SEGS>, 0);
}

template <typename T, int TC>
int x_per_sm() {
  static std::atomic<int> cache[tv::kMaxDevices];
  return tv::resident_per_sm(cache, sweep_x_kernel<T, TC>, 0);
}

// A sweep's launch on an (E0, E1) block.
struct Plan {
  int choice;              // index into kSegs / kCols, or a negative CUDA error
  long long ctas;          // CTAs launched
  int per_sm, rows, cols;  // CTAs an SM; a CTA's output tile
};

template <typename T>
Plan plan(int E0, int E1, int axis) {
  long long ctas[kChoices];
  int per_sm[kChoices];
  for (int k = 0; k < kChoices; ++k) {
    ctas[k] = axis == 1 ? static_cast<long long>((E0 + kTY - 1) / kTY) *
                              ((E1 + kSeg * kSegs[k] - 1) / (kSeg * kSegs[k]))
                        : static_cast<long long>((E0 + kSeg - 1) / kSeg) *
                              ((E1 + kCols[k] - 1) / kCols[k]);
  }
  if (axis == 1) {
    per_sm[0] = y_per_sm<T, kSegs[0]>();
    per_sm[1] = y_per_sm<T, kSegs[1]>();
    per_sm[2] = y_per_sm<T, kSegs[2]>();
  } else {
    per_sm[0] = x_per_sm<T, kCols[0]>();
    per_sm[1] = x_per_sm<T, kCols[1]>();
    per_sm[2] = x_per_sm<T, kCols[2]>();
  }
  const int k = tv::pick_tile(kChoices, ctas, per_sm);
  if (k < 0) return {k, 0, 0, 0, 0};
  return axis == 1 ? Plan{k, ctas[k], per_sm[k], kTY, kSeg * kSegs[k]}
                   : Plan{k, ctas[k], per_sm[k], kSeg, kCols[k]};
}

template <typename T>
int launch_sweep(const T* F, const T* vel, T* out, tv::Block b, int axis, const double* c,
                 int full_dv, int clamp, cudaStream_t stream) {
  if (axis != 0 && axis != 1) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan<T>(b.E0, b.E1, axis);
  if (p.choice < 0) return -p.choice;
  const dim3 grid(static_cast<unsigned>(p.ctas)), block(kTX, kTY);
  if (axis == 1) {
    const tv::SweepParams<T> q = tv::sweep_params<T>(b.ny, b.nx, c, full_dv, clamp);
    if (p.choice == 0) {
      sweep_y_kernel<T, kSegs[0]><<<grid, block, 0, stream>>>(F, vel, out, b, q);
    } else if (p.choice == 1) {
      sweep_y_kernel<T, kSegs[1]><<<grid, block, 0, stream>>>(F, vel, out, b, q);
    } else {
      sweep_y_kernel<T, kSegs[2]><<<grid, block, 0, stream>>>(F, vel, out, b, q);
    }
  } else {
    const tv::SweepParams<T> q = tv::sweep_params<T>(b.nx, b.ny, c, full_dv, clamp);
    if (p.choice == 0) {
      sweep_x_kernel<T, kCols[0]><<<grid, block, 0, stream>>>(F, vel, out, b, q);
    } else if (p.choice == 1) {
      sweep_x_kernel<T, kCols[1]><<<grid, block, 0, stream>>>(F, vel, out, b, q);
    } else {
      sweep_x_kernel<T, kCols[2]><<<grid, block, 0, stream>>>(F, vel, out, b, q);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// out = {threads a CTA, shared bytes a CTA, CTAs an SM, CTAs launched,
// tile rows, tile columns} of the sweep along ``axis`` on an (E0, E1) block
template <typename T>
int sweep_shape(int E0, int E1, int axis, int* out) {
  if (axis != 0 && axis != 1) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan<T>(E0, E1, axis);
  if (p.choice < 0) return -p.choice;
  out[0] = kThreads;
  out[1] = axis == 1 ? 0 : x_tile_values(p.cols) * static_cast<int>(sizeof(T));
  out[2] = p.per_sm;
  out[3] = static_cast<int>(p.ctas);
  out[4] = p.rows;
  out[5] = p.cols;
  return 0;
}

}  // namespace

// F, vel: inputs; out: output; all (E0, E1) blocks whose (0, 0) is global
// (oi, oj) of an nx x ny grid. axis 0 sweeps along x with vel = u, axis 1
// along y with vel = v.
extern "C" int tv_fct_sweep_f32(const void* F, const void* vel, void* out,
                                int E0, int E1, int oi, int oj, int nx, int ny,
                                int axis, const double* c, int full_dv,
                                int clamp, void* stream) {
  return launch_sweep<float>(static_cast<const float*>(F),
                             static_cast<const float*>(vel),
                             static_cast<float*>(out),
                             tv::Block{E0, E1, oi, oj, nx, ny}, axis, c, full_dv,
                             clamp, static_cast<cudaStream_t>(stream));
}

extern "C" int tv_fct_sweep_f64(const void* F, const void* vel, void* out,
                                int E0, int E1, int oi, int oj, int nx, int ny,
                                int axis, const double* c, int full_dv,
                                int clamp, void* stream) {
  return launch_sweep<double>(static_cast<const double*>(F),
                              static_cast<const double*>(vel),
                              static_cast<double*>(out),
                              tv::Block{E0, E1, oi, oj, nx, ny}, axis, c,
                              full_dv, clamp, static_cast<cudaStream_t>(stream));
}

// The launch shape of the sweep along ``axis`` on an (E0, E1) block: out =
// {threads a CTA, shared bytes a CTA, CTAs an SM, CTAs launched, tile rows,
// tile columns}.
extern "C" int tv_fct_sweep_shape_f32(int E0, int E1, int axis, int* out) {
  return sweep_shape<float>(E0, E1, axis, out);
}

extern "C" int tv_fct_sweep_shape_f64(int E0, int E1, int axis, int* out) {
  return sweep_shape<double>(E0, E1, axis, out);
}
