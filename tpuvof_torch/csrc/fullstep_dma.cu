// The whole lean 2-D step as one kernel launch whose tiles move by bulk
// asynchronous copies, for Hopper (sm_90a).
//
// Replaces tpuvof/pallas_kernels/step_kernels.py:pallas_fullstep_dma
// (_fullstep_dma_kernel): fullstep.cu's step, bit for bit, with the TPU
// kernel's I/O. There, each load starts as early as its data is final and
// each output is stored by the copy engine as soon as it is. Here the
// step is fullstep.cu's stage groups (step_groups.cuh: predict, the Jacobi
// groups, finish), run under the Bulk policy below instead of thread loads:
//   - a tile's input boxes are filled by cp.async.bulk (the TMA unit's 1-D
//     form), one copy a box row, each thread of the CTA issuing at most one
//     row of a load, completing on the boxes' mbarrier; the
//     threads wait on it, then zero the cells outside the block (which
//     ld() reads as 0) before the first pass;
//   - inputs final before a grid barrier are issued before it: the entry p
//     of the CTA's first tile of the first Jacobi group at kernel entry,
//     the rhs of a later Jacobi group's first tile, and all but p of the
//     first finish tile, on a second mbarrier; only the rest waits for the
//     barrier;
//   - the finish tile's outputs are stored by the threads, as fullstep.cu
//     stores them. One slot of boxes: a second slot, with the copies of a
//     CTA's next tile in flight while the current tile computes, and bulk
//     stores of each output row's aligned middle were measured on the H100
//     and lost in both dtypes (PERF.md): the copies are bound by the copy
//     unit's rate of row requests, which neither raises, and the stores'
//     requests queue on the same unit as the loads.
// The per-cell arithmetic is step_groups.cuh's, in fullstep.cu's order on
// the same operands; only the staging differs.
//
// Row copies, not tensor maps: a tiled tensor map needs every row pitch to
// be a multiple of 16 bytes, and the grids this kernel runs have E1 = n + 2
// of any residue. So each box row is copied as the 16-byte-aligned span
// that covers its cells inside the block. A box's pitch is congruent to E1
// modulo a 16-byte unit (kU cells) and at least its width + kU - 1, and its
// first cell sits at the unit residue of its global index: every aligned
// global span then lands on an aligned shared address, the spans of two
// rows never overlap, and Box keeps one uniform pitch. The pitch is a
// compile-time constant (the kernel is instantiated for each residue of E1
// modulo kU), so the passes' stencil offsets fold into their shared-memory
// instructions as in fullstep.cu. The cells a span pulls in from a
// neighbouring row land either in a row's slack or on box cells outside
// the block, which the threads zero. No copy reads past the field's last
// whole unit: the cells after it (the last E0 * E1 mod kU of the field, at
// most 3 in f32 and 1 in f64) go by thread loads, and they are the only
// cells of an input box that do. A row outside the block is not copied:
// its cells are zeroed.
//
// What bounds it on the H100: a chain of dependent passes a tile and a
// grid barrier between two groups, as fullstep.cu, and beside them the
// copy unit's rate of requests: a box row is 33-44 cells, so a finish tile
// is ~196 requests, a predict tile ~84 and a Jacobi tile ~64, which an
// SM's unit serves one at a time, while fullstep.cu's threads stage the
// same boxes in a few wide loads each (the barrier stamps of
// scripts/torch_ab2d.py --stamps, PERF.md). So this kernel stays slower
// than fullstep.cu: 1.2-1.5x in f32 from 2050^2 down to 514^2.
//
// The scratch is five blocks (u*, v*, rhs and two Jacobi levels), each of
// E0 * E1 cells rounded up to a 16-byte unit, so that each starts aligned
// (scratch_block; the wrappers ask tv_fullstep_dma_scratch_* for its size).
#include <cstdint>

#include "step_groups.cuh"

namespace {

using tv::Block;
using tv::Box;
using tv::kJacobiLevels;
using tv::kThreads;
using tv::kTW;
using tv::kTX;
using tv::kTY;
using tv::StepArgs;

// ---- the bulk-copy and mbarrier instructions (PTX ISA 8.0, sm_90) ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(arrivals)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// global -> shared, completing `bytes` on the mbarrier
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// orders this thread's shared-memory accesses before later bulk copies
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// the same for global memory: stores before a grid barrier, bulk loads
// after it
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// ---- the memory map ----

// Cells of T in a 16-byte unit.
template <typename T>
constexpr int kU = 16 / static_cast<int>(sizeof(T));

// Rows of a tile: 24, as fullstep.cu's at every block whose 16-row tiles
// do not all fit on the card at once (514^2 and beyond); the memory map and
// the pitches below are compile-time for it.
constexpr int kRowsDma = 24;

constexpr int max_of(int a, int b) { return a > b ? a : b; }

// The most values a bulk box of rows x cols takes: its lead (< kU), and
// rows at its largest pitch, cols + 2 (kU - 1), rounded up to a unit.
template <typename T>
constexpr int box_values(int rows, int cols) {
  return (kU<T> - 1 + rows * (cols + 2 * kU<T> - 2) + kU<T> - 1) / kU<T> * kU<T>;
}

// Where each group's boxes go, in values of T from the dynamic shared
// memory's start. Predict's and finish's input boxes start at 0; Jacobi's
// start after predict's, so that the entry p copied at kernel entry lands
// where no predict tile works. A group's work boxes (the ones its passes
// fill: predict's kappa and normals, Jacobi's second level) sit at the end.
template <typename T, int TH>
struct Map {
  static constexpr int predict_in =
      box_values<T>(TH + 6, kTW + 6) + 2 * box_values<T>(TH + 3, kTW + 3);
  static constexpr int predict_work = (TH + 2) * (kTW + 2) + 2 * (TH + 4) * (kTW + 4);
  static constexpr int jacobi_box =
      box_values<T>(TH + 2 * kJacobiLevels, kTW + 2 * kJacobiLevels);
  static constexpr int jacobi_work = (TH + 2 * kJacobiLevels) * (kTW + 2 * kJacobiLevels);
  static constexpr int finish_in =
      2 * box_values<T>(TH + 10, kTW + 10) + 4 * box_values<T>(TH + 8, kTW + 8);
  static constexpr int values =
      (max_of(max_of(finish_in, predict_in + predict_work),
              max_of(predict_in + 2 * jacobi_box + jacobi_work,
                     predict_in + jacobi_box + predict_work)) +
       kU<T> - 1) / kU<T> * kU<T>;
  static constexpr int smem = values * static_cast<int>(sizeof(T));
};

// The work values of a group (Map's terms), and whether it is a Jacobi
// group.
template <class G>
struct GroupOf;
template <int TH, typename T>
struct GroupOf<tv::PredictGroup<TH, T>> {
  static constexpr int work = Map<T, TH>::predict_work;
  static constexpr bool jacobi = false;
};
template <int TH, int D, typename T>
struct GroupOf<tv::JacobiGroup<TH, D, T>> {
  static constexpr int work = (TH + 2 * D) * (kTW + 2 * D);
  static constexpr bool jacobi = true;
};
template <int TH, typename T>
struct GroupOf<tv::FinishGroup<TH, T>> {
  static constexpr int work = 0;
  static constexpr bool jacobi = false;
};

// The layout of bulk boxes (stage_groups.cuh's layout form) on a block
// whose E1 is R modulo kU: input boxes from value `at` on, each at a
// compile-time pitch congruent to R modulo kU and at least its width +
// kU - 1, its first cell at the unit residue of its global index; work
// boxes packed from `work_at` at the pitch given.
template <typename T, int R>
struct BulkLayout {
  static constexpr int U = kU<T>;
  T* base;
  int at;
  T* work_at;
  __device__ __forceinline__ Box<T> in(int i0, int j0, int rows, int cols, int /*w*/) {
    const int w = cols + (U - 1) + ((R - cols - (U - 1)) & (U - 1));
    const int lead = (i0 * R + j0) & (U - 1);
    const Box<T> box{base + at + lead, i0, j0, w};
    at = (at + lead + rows * w + U - 1) & ~(U - 1);
    return box;
  }
  __device__ __forceinline__ Box<T> work(int i0, int j0, int rows, int w) {
    const Box<T> box{work_at, i0, j0, w};
    work_at += rows * w;
    return box;
  }
};

// The block's rows [rlo, rhi) and columns [clo, chi) inside the global
// domain, and `tail`, the first cell past the field's last whole unit.
struct Reach {
  int rlo, rhi, clo, chi, tail;
  __device__ __forceinline__ Reach(const Block& b, int U)
      : rlo(max(0, -b.oi)),
        rhi(min(b.E0, b.nx + 2 - b.oi)),
        clo(max(0, -b.oj)),
        chi(min(b.E1, b.ny + 2 - b.oj)),
        tail(b.E0 * b.E1 & ~(U - 1)) {}
};

// The aligned global cells [as, ae) that cover row i of a box from
// column j0, W wide, inside the block and the domain (q), up to the
// field's last whole unit; gs: the global index of the row's first such
// cell. False where there is nothing to copy.
template <int U>
__device__ __forceinline__ bool row_span(const Block& b, const Reach& q, int i, int j0, int W,
                                         int& gs, int& as, int& ae) {
  const int jl = max(j0, q.clo), jh = min(j0 + W, q.chi);
  if (i < q.rlo || i >= q.rhi || jh <= jl) return false;
  gs = i * b.E1 + jl;
  as = gs & ~(U - 1);
  ae = min((i * b.E1 + jh + U - 1) & ~(U - 1), q.tail);
  return ae > as;
}

// The staging policy of bulk copies (step_groups.cuh's policy form) on a
// block whose E1 is R modulo kU. Every warp issues a share of the copies;
// bar[0] is the boxes' mbarrier, bar[1] that of the inputs of a group's
// first tile issued before a grid barrier; each expects one arrival a
// warp. Its one piece of state is the mbarriers' phase bits: every other
// quantity is derived from the block where it is used.
template <typename T, int TH, int R>
struct Bulk {
  using M = Map<T, TH>;
  static constexpr int U = kU<T>;
  static constexpr uint32_t kEarly = 1u << 2;  // a first tile's inputs on bar[1]
  const Block& b;
  T* sm;
  uint64_t* bar;
  uint32_t phase = 0;  // bit k < 2: the parity bar[k] completes next; kEarly

  __device__ __forceinline__ Bulk(const Block& b_, T* sm_, uint64_t* bar_)
      : b(b_), sm(sm_), bar(bar_) {
    if (threadIdx.x == 0 && threadIdx.y == 0) {
      for (int k = 0; k < 2; ++k) mbar_init(&bar[k], kThreads / kTX);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }

  __device__ __forceinline__ int tiles_j() const { return (b.E1 + kTW - 1) / kTW; }
  __device__ __forceinline__ int n_tiles() const { return tiles_j() * ((b.E0 + TH - 1) / TH); }

  template <class G>
  __device__ __forceinline__ BulkLayout<T, R> layout() const {
    return {sm, GroupOf<G>::jacobi ? M::predict_in : 0, sm + M::values - GroupOf<G>::work};
  }

  // A visitor of a group's inputs (G::load) in every thread: the rows of
  // each load's NF boxes are numbered box by box, and thread r takes row r
  // (every load has fewer rows than the CTA has threads). It counts the
  // bytes of the row copies of the fields it takes (src == x if only,
  // src != x else), or issues them on mbarrier m.
  struct Issue {
    const Block& b;
    const T* x;
    bool only, send;
    uint64_t* m;
    uint32_t bytes;
    template <int H, int W, int NF, typename>
    __device__ __forceinline__ void load(const Block&, const Box<T> (&box)[NF],
                                         const T* const (&src)[NF]) {
      static_assert(NF * H <= kThreads, "a row a thread");
      const int tid = static_cast<int>(threadIdx.y) * kTX + static_cast<int>(threadIdx.x);
      const Reach q(b, U);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const int r = tid - f * H;
        if (r < 0 || r >= H || (src[f] == x) != only) continue;
        const int i = box[f].i0 + r;
        int gs, as, ae;
        if (!row_span<U>(b, q, i, box[f].j0, W, gs, as, ae)) continue;
        const uint32_t n = static_cast<uint32_t>(ae - as) * sizeof(T);
        if (send) bulk_load(&box[f](i, gs - i * b.E1) - (gs - as), src[f] + as, n, m);
        bytes += n;
      }
    }
  };

  // A visitor of a group's inputs in every thread, once the copies have
  // landed: in each box that reaches outside the block or the domain or
  // past the field's last whole unit (a CTA-uniform test), zeroes the
  // cells outside the block or the domain and loads those past the unit.
  struct Fix {
    template <int H, int W, int NF, typename>
    __device__ __forceinline__ void load(const Block& b, const Box<T> (&box)[NF],
                                         const T* const (&src)[NF]) const {
      const Reach q(b, U);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const Box<T>& bx = box[f];
        if (bx.i0 >= q.rlo && bx.i0 + H <= q.rhi && bx.j0 >= q.clo && bx.j0 + W <= q.chi &&
            (bx.i0 + H - 1) * b.E1 + bx.j0 + W <= q.tail)
          continue;
        const T* a = src[f];
        tv::for_cells<H, W>(bx.i0, bx.j0, [&](int i, int j) {
          if (i < q.rlo || i >= q.rhi || j < q.clo || j >= q.chi) {
            bx(i, j) = T(0);
          } else if (i * b.E1 + j >= q.tail) {
            bx(i, j) = a[i * b.E1 + j];
          }
        });
      }
    }
  };

  // The CTA issues the inputs of tile t of group g (those the filter x,
  // only takes) on mbarrier k: each warp counts its copies' bytes, and its
  // lane 0 arrives with them before the warp issues them (the mbarrier
  // expects one arrival a warp).
  template <class G>
  __device__ __forceinline__ void issue(const G& g, int t, const T* x, bool only, int k) {
    const typename G::Boxes boxes(layout<G>(), t / tiles_j() * TH, t % tiles_j() * kTW);
    Issue count{b, x, only, false, &bar[k], 0};
    g.load(count, boxes);
    const uint32_t bytes = __reduce_add_sync(0xffffffffu, count.bytes);
    if (threadIdx.x == 0) mbar_arrive_expect_tx(&bar[k], bytes);
    __syncwarp();
    Issue copy{b, x, only, true, &bar[k], 0};
    g.load(copy, boxes);
  }

  __device__ __forceinline__ void wait(int k) {
    mbar_wait(&bar[k], (phase >> k) & 1u);
    phase ^= 1u << k;
  }

  template <class G>
  __device__ __forceinline__ void run(const G& g, bool pre) {
    const int n = n_tiles();
    for (int t = blockIdx.x; t < n; t += gridDim.x) {
      const bool first = t == static_cast<int>(blockIdx.x);
      if (!first || !pre) issue(g, t, nullptr, false, 0);
      wait(0);
      if (first && pre && (phase & kEarly)) {
        wait(1);
        phase &= ~kEarly;
      }
      const int ti = t / tiles_j() * TH, tj = t % tiles_j() * kTW;
      const typename G::Boxes s(layout<G>(), ti, tj);
      g.load(Fix{}, s);
      __syncthreads();
      g.compute(s, ti, tj);
      fence_async_shared();  // before the boxes' next copies
      __syncthreads();
    }
  }

  // the Jacobi group of depth d: the rest of its first tile, then its tiles
  template <class Make>
  __device__ __forceinline__ void jacobi(int d, const Make& make, const T* x) {
    tv::with_depth<kJacobiLevels>(d, [&](auto depth) {
      const auto g = make(depth);
      late(g, x, false);
      run(g, true);
    });
  }

  template <class G>
  __device__ __forceinline__ void early(const G& g, const T* x, bool only) {
    if (static_cast<int>(blockIdx.x) >= n_tiles()) return;
    issue(g, blockIdx.x, x, only, 1);
    phase |= kEarly;
  }

  template <class G>
  __device__ __forceinline__ void late(const G& g, const T* x, bool only) {
    if (static_cast<int>(blockIdx.x) < n_tiles()) issue(g, blockIdx.x, x, only, 0);
  }

  // the entry p of the first Jacobi group's first tile
  template <class G>
  __device__ __forceinline__ void begin(const G& g) {
    early(g, g.src, true);
  }

  __device__ __forceinline__ void sync(cooperative_groups::grid_group& grid) {
    fence_async_global();
    grid.sync();
    fence_async_global();
  }
};

// At least 3 CTAs an SM in f32, as fullstep.cu's kernel (the f64 boxes
// allow 2). R: the block's E1 modulo kU, which sets the boxes' pitches.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 3 : 2)
    fullstep_dma_kernel(const StepArgs<T> a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2];
  Bulk<T, kRowsDma, R> pol(a.b, reinterpret_cast<T*>(smem_raw), bars);
  tv::step_groups<kRowsDma>(a, pol);
}

// The kernel for E1 = R modulo kU (R < kU), or null.
template <typename T>
const void* kernel_of(int r) {
  if constexpr (sizeof(T) == 4) {
    const void* k[] = {reinterpret_cast<const void*>(fullstep_dma_kernel<T, 0>),
                       reinterpret_cast<const void*>(fullstep_dma_kernel<T, 1>),
                       reinterpret_cast<const void*>(fullstep_dma_kernel<T, 2>),
                       reinterpret_cast<const void*>(fullstep_dma_kernel<T, 3>)};
    return k[r];
  } else {
    const void* k[] = {reinterpret_cast<const void*>(fullstep_dma_kernel<T, 0>),
                       reinterpret_cast<const void*>(fullstep_dma_kernel<T, 1>)};
    return k[r];
  }
}

// The CTAs an SM holds of the kernel for E1 = R modulo kU with its shared
// bytes (granted once a device), asked once a device; or a negative CUDA
// error. The kernels for the residues share their resources but not their
// grants.
template <typename T>
int per_sm(int r) {
  static std::atomic<int> cache[4][tv::kMaxDevices];
  return tv::coop_per_sm(cache[r], kernel_of<T>(r), Map<T, kRowsDma>::smem);
}

// The launch on an (E0, E1) block: one CTA a 24-row tile up to what the
// card holds resident, or a negative CUDA error.
template <typename T>
int plan_ctas(int E0, int E1) {
  const int n = per_sm<T>(E1 % kU<T>);
  if (n < 0) return n;
  const long long tiles = tv::tiles_of(kRowsDma, E0, E1);
  const long long resident = static_cast<long long>(n) * tv::sm_count();
  return static_cast<int>(tiles < resident ? tiles : resident);
}

// Cells of T in one block of the scratch on an (E0, E1) block.
template <typename T>
size_t scratch_block(int E0, int E1) {
  return (static_cast<size_t>(E0) * E1 + kU<T> - 1) / kU<T> * kU<T>;
}

template <typename T>
int launch_fullstep_dma(const void* const* fields, void* const* outs, void* scratch,
                        Block b, int n_jacobi, int even_step, const double* pc,
                        const double* jc, const double* sxc, const double* syc,
                        int full_dv, int clamp, cudaStream_t stream) {
  if (n_jacobi < 0) return static_cast<int>(cudaErrorInvalidValue);
  StepArgs<T> a;
  a.F = static_cast<const T*>(fields[0]);
  a.u = static_cast<const T*>(fields[1]);
  a.v = static_cast<const T*>(fields[2]);
  a.p = static_cast<const T*>(fields[3]);
  a.F_out = static_cast<T*>(outs[0]);
  a.u_out = static_cast<T*>(outs[1]);
  a.v_out = static_cast<T*>(outs[2]);
  a.p_out = static_cast<T*>(outs[3]);
  for (int k = 0; k < 4; ++k)  // cp.async.bulk's alignment
    if (reinterpret_cast<uintptr_t>(fields[k]) % 16 || reinterpret_cast<uintptr_t>(outs[k]) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
  if (reinterpret_cast<uintptr_t>(scratch) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  T* s = static_cast<T*>(scratch);
  const size_t n = scratch_block<T>(b.E0, b.E1);
  T** bufs[] = {&a.us, &a.vs, &a.rhs, &a.pa, &a.pb};
  for (int k = 0; k < 5; ++k) *bufs[k] = s + k * n;
  a.b = b;
  a.pq = tv::predict_params<T>(pc);
  a.jq = tv::project_params<T>(jc);
  a.sx = tv::sweep_params<T>(b.nx, b.ny, sxc, full_dv, clamp);
  a.sy = tv::sweep_params<T>(b.ny, b.nx, syc, full_dv, clamp);
  a.n_jacobi = n_jacobi;
  a.even_step = even_step;
  const int ctas = plan_ctas<T>(b.E0, b.E1);
  if (ctas < 0) return -ctas;
  void* args[] = {&a};
  const cudaError_t e =
      cudaLaunchCooperativeKernel(kernel_of<T>(b.E1 % kU<T>), dim3(ctas), dim3(kTX, kTY), args,
                                  Map<T, kRowsDma>::smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// out = {threads a CTA, shared bytes a CTA, CTAs an SM, CTAs launched, tile
// rows} on an (E0, E1) block
template <typename T>
int fullstep_dma_shape(int E0, int E1, int* out) {
  const int ctas = plan_ctas<T>(E0, E1);
  if (ctas < 0) return -ctas;
  out[0] = kThreads;
  out[1] = Map<T, kRowsDma>::smem;
  out[2] = per_sm<T>(E1 % kU<T>);
  out[3] = ctas;
  out[4] = kRowsDma;
  return 0;
}

}  // namespace

// tv_fullstep_*'s interface (fullstep.cu), but the scratch holds
// tv_fullstep_dma_scratch_*'s cells; every field, output and the scratch
// must be 16-byte aligned (cudaErrorMisalignedAddress otherwise).
extern "C" int tv_fullstep_dma_f32(const void* const* fields, void* const* outs,
                                   void* scratch, int E0, int E1, int oi, int oj,
                                   int nx, int ny, int n_jacobi, int even_step,
                                   const double* pc, const double* jc,
                                   const double* sxc, const double* syc,
                                   int full_dv, int clamp, void* stream) {
  return launch_fullstep_dma<float>(fields, outs, scratch, Block{E0, E1, oi, oj, nx, ny},
                                    n_jacobi, even_step, pc, jc, sxc, syc, full_dv, clamp,
                                    static_cast<cudaStream_t>(stream));
}

extern "C" int tv_fullstep_dma_f64(const void* const* fields, void* const* outs,
                                   void* scratch, int E0, int E1, int oi, int oj,
                                   int nx, int ny, int n_jacobi, int even_step,
                                   const double* pc, const double* jc,
                                   const double* sxc, const double* syc,
                                   int full_dv, int clamp, void* stream) {
  return launch_fullstep_dma<double>(fields, outs, scratch, Block{E0, E1, oi, oj, nx, ny},
                                     n_jacobi, even_step, pc, jc, sxc, syc, full_dv, clamp,
                                     static_cast<cudaStream_t>(stream));
}

// The cells of T the scratch holds on an (E0, E1) block: five blocks, each
// of E0 * E1 cells rounded up to 16 bytes.
extern "C" long long tv_fullstep_dma_scratch_f32(int E0, int E1) {
  return static_cast<long long>(5 * scratch_block<float>(E0, E1));
}

extern "C" long long tv_fullstep_dma_scratch_f64(int E0, int E1) {
  return static_cast<long long>(5 * scratch_block<double>(E0, E1));
}

// The launch shape on an (E0, E1) block: out = {threads a CTA, shared
// bytes a CTA, CTAs an SM, CTAs launched, tile rows}.
extern "C" int tv_fullstep_dma_shape_f32(int E0, int E1, int* out) {
  return fullstep_dma_shape<float>(E0, E1, out);
}

extern "C" int tv_fullstep_dma_shape_f64(int E0, int E1, int* out) {
  return fullstep_dma_shape<double>(E0, E1, out);
}
