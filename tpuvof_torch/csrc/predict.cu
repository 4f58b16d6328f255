// The momentum predictor of the 2-D step, for Hopper (sm_90a).
//
// Replaces tpuvof/pallas_kernels/step_kernels.py:pallas_predict (the whole
// grid, _predict_kernel) and pallas_predict_win (a block with a global
// origin, _predict_win_kernel), both with body _predict_body: rho/nu mix,
// Youngs corner normals with the 1e-10 degeneracy guard, curvature kappa,
// and upwind u*/v* with viscosity, gravity and CSF surface tension.
//
// What bounds it on the H100: it must read u, v, F and write u*, v*: 5
// field-sized arrays, ~5.3 MB at 514^2 f32, ~1.6 us at 3.35 TB/s and less
// from the 50 MB L2. What a CTA spends is the chain of its dependent
// passes (loads, normals, kappa, momentum), each ending at a barrier, and
// the launch itself.
//
// What the design does about it: one launch, one CTA of 32 x 8 threads a
// tile of TH rows x 32 columns, no scratch field. The CTA stages F with a
// rim of 3 and u, v with a rim of 1 into shared memory (every load issued
// before the first store; reads outside the block or the global domain are
// 0, as ld() gives them), computes each Youngs normal once a cell, then
// kappa, then u*, v* of the tile, which it writes as coalesced rows: the
// predictor of the whole-step kernel, shared with it through
// phase_tiles.cuh (predict_values). TH is 8 or 24, picked from the block
// size (plan): a small block runs short tiles over more SMs.
#include "phase_tiles.cuh"

namespace {

using tv::kThreads;
using tv::kTW;

template <typename T, int TH>
__global__ void __launch_bounds__(kThreads)
    predict_kernel(const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ F,
                   T* __restrict__ us, T* __restrict__ vs, const tv::Block b,
                   const tv::PredictParams<T> q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int tiles_j = (b.E1 + kTW - 1) / kTW;
  const int ti = static_cast<int>(blockIdx.x) / tiles_j * TH;
  const int tj = static_cast<int>(blockIdx.x) % tiles_j * kTW;
  const tv::PredictBoxes<TH, 0, T> s(sm, ti, tj);
  tv::predict_values(b, q, s, F, u, v, ti, tj, [&](int i, int j, T x, T y) {
    if (b.inside(i, j)) {
      us[i * b.E1 + j] = x;
      vs[i * b.E1 + j] = y;
    }
  });
}

// The kernel with TH-row tiles: its shared bytes and the CTAs an SM holds
// with them (asked once a device), or a negative CUDA error.
template <typename T, int TH>
struct Predict {
  static constexpr int smem = tv::predict_tile_values(TH, 0) * static_cast<int>(sizeof(T));
  static int per_sm() {
    static std::atomic<int> cache[tv::kMaxDevices];
    return tv::resident_per_sm(cache, predict_kernel<T, TH>, smem);
  }
};

// The tile heights the launch chooses from, smallest first.
constexpr int kRows[] = {8, 24};
constexpr int kChoices = 2;

template <typename T>
int per_sm_of(int th) {
  return th == 8 ? Predict<T, 8>::per_sm() : Predict<T, 24>::per_sm();
}

template <typename T>
int smem_of(int th) {
  return th == 8 ? Predict<T, 8>::smem : Predict<T, 24>::smem;
}

// The tile height on an (E0, E1) block (tv::pick_tile: 8 rows where all
// 8-row tiles run at once, else 24); ``rows`` > 0 asks for that height
// instead. Negative: a CUDA error; 0: no such height.
template <typename T>
int plan(int E0, int E1, int rows) {
  if (rows > 0) return rows == kRows[0] || rows == kRows[1] ? rows : 0;
  long long ctas[kChoices];
  int per_sm[kChoices];
  for (int k = 0; k < kChoices; ++k) {
    ctas[k] = tv::tiles_of(kRows[k], E0, E1);
    per_sm[k] = per_sm_of<T>(kRows[k]);
  }
  const int k = tv::pick_tile(kChoices, ctas, per_sm);
  return k < 0 ? k : kRows[k];
}

template <typename T>
int launch_predict(const T* u, const T* v, const T* F, T* us, T* vs, tv::Block b,
                   const double* c, int rows, cudaStream_t stream) {
  const int th = plan<T>(b.E0, b.E1, rows);
  if (th <= 0) return th < 0 ? -th : static_cast<int>(cudaErrorInvalidValue);
  const int n = per_sm_of<T>(th);  // grants the shared memory
  if (n < 0) return -n;
  const tv::PredictParams<T> q = tv::predict_params<T>(c);
  const dim3 grid(static_cast<unsigned>(tv::tiles_of(th, b.E0, b.E1)));
  const int smem = smem_of<T>(th);
  if (th == 8) {
    predict_kernel<T, 8><<<grid, dim3(tv::kTX, tv::kTY), smem, stream>>>(u, v, F, us, vs, b, q);
  } else {
    predict_kernel<T, 24><<<grid, dim3(tv::kTX, tv::kTY), smem, stream>>>(u, v, F, us, vs, b, q);
  }
  return static_cast<int>(cudaGetLastError());
}

// out = {threads a CTA, shared bytes a CTA, CTAs an SM, CTAs launched,
// tile rows, tile columns} on an (E0, E1) block
template <typename T>
int predict_shape(int E0, int E1, int* out) {
  const int th = plan<T>(E0, E1, 0);
  if (th < 0) return -th;
  const int n = per_sm_of<T>(th);
  if (n < 0) return -n;
  out[0] = kThreads;
  out[1] = smem_of<T>(th);
  out[2] = n;
  out[3] = static_cast<int>(tv::tiles_of(th, E0, E1));
  out[4] = th;
  out[5] = kTW;
  return 0;
}

}  // namespace

// u, v, F: inputs; us, vs: outputs; all (E0, E1) blocks whose (0, 0) is
// global (oi, oj) of an nx x ny grid. rows: the tile height (8 or 24), or
// 0 for the launch's own choice.
extern "C" int tv_predict_f32(const void* u, const void* v, const void* F, void* us, void* vs,
                              int E0, int E1, int oi, int oj, int nx, int ny, const double* c,
                              int rows, void* stream) {
  return launch_predict<float>(
      static_cast<const float*>(u), static_cast<const float*>(v), static_cast<const float*>(F),
      static_cast<float*>(us), static_cast<float*>(vs), tv::Block{E0, E1, oi, oj, nx, ny}, c,
      rows, static_cast<cudaStream_t>(stream));
}

extern "C" int tv_predict_f64(const void* u, const void* v, const void* F, void* us, void* vs,
                              int E0, int E1, int oi, int oj, int nx, int ny, const double* c,
                              int rows, void* stream) {
  return launch_predict<double>(
      static_cast<const double*>(u), static_cast<const double*>(v),
      static_cast<const double*>(F), static_cast<double*>(us), static_cast<double*>(vs),
      tv::Block{E0, E1, oi, oj, nx, ny}, c, rows, static_cast<cudaStream_t>(stream));
}

// The launch shape on an (E0, E1) block: out = {threads a CTA, shared
// bytes a CTA, CTAs an SM, CTAs launched, tile rows, tile columns}.
extern "C" int tv_predict_shape_f32(int E0, int E1, int* out) {
  return predict_shape<float>(E0, E1, out);
}

extern "C" int tv_predict_shape_f64(int E0, int E1, int* out) {
  return predict_shape<double>(E0, E1, out);
}
