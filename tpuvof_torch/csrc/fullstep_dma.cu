// The whole lean 2-D step as one kernel launch whose state moves by bulk
// asynchronous copies, for Hopper (sm_90a).
//
// Replaces tpuvof/pallas_kernels/step_kernels.py:pallas_fullstep_dma
// (_fullstep_dma_kernel): fullstep.cu's step, bit for bit, with the state
// I/O of the TPU kernel. There, four DMAs start together, p's completes
// under the predictor, and each output is stored the moment its field and
// its wall BC are final: p under the correction and the sweeps, u and v
// under the sweeps, F last. Here:
//   - at entry each CTA starts bulk copies (cp.async.bulk, the TMA unit's
//     1-D form) of its chunks of p into shared memory, completing on an
//     mbarrier that it waits on only in the rhs stage, where the two Jacobi
//     buffers are seeded (fullstep.cu seeds them in its first stage);
//   - in the correction stage each warp writes p's BC'd value into a
//     shared staging chunk and bulk-stores it to p_out without waiting; in
//     the first sweep stage u's and v's BC'd values (the sweeps go on
//     reading the pre-BC un and vn); the last stage stores only F;
//   - F, u and v are read by stencils across chunk edges, so they stay
//     global loads, as in fullstep.cu.
// The per-cell arithmetic is step_cell.cuh's, called in fullstep.cu's
// order; only the staging and the copies differ.
//
// What bounds it on the H100: what bounds fullstep.cu (n_jacobi + 7
// dependent stages and the grid-wide barriers between them). The outputs
// it moves off the last stage are ~3 MB at 514^2 f32, all in the 50 MB
// L2; the staging adds shared-memory writes, async-proxy fences and warp
// barriers to three stages. Measured on an H100 it is 0.6-3.3% slower
// than fullstep.cu (PERF.md).
//
// The layout of the copies:
//   - Stores go in chunks of kWarp cells: a warp stages the kWarp
//     consecutive cells it handles in one round of the grid-stride loop,
//     and its lane 0 sends them. Staging per CTA would put a __syncthreads()
//     around every chunk and make a CTA's warps take their rounds in step;
//     at 2050^2 (25 rounds a stage) that cost 3% (PERF.md).
//   - Every chunk starts at a multiple of 128 bytes (f32) or 256 (f64) from
//     the field's base, which the wrapper checks to be 16-byte aligned.
//     cp.async.bulk takes multiples of 16 bytes: the last chunk of a field
//     whose E0*E1 is not a multiple of 4 (f32) or 2 (f64) sends its ragged
//     tail by plain stores.
//   - Each warp has a ring of kRing staging chunks; a chunk is written again
//     only after cp.async.bulk.wait_group.read has seen the copy that used
//     it kRing stores before finish reading it. Every store commits one
//     bulk group, even an empty one, so the group count is the store count.
//     The ring keeps the staging bounded: all four outputs staged at once
//     would not fit the card's ~30 MB of shared memory at 2050^2 f64.
//   - p's entry copies go in chunks of kThreads cells, a CTA's round, and
//     take up to kPinBytes a CTA. Where the CTA owns more chunks than that
//     (f64 beyond ~1270^2 at three CTAs an SM, f32 beyond ~2320^2 at
//     five), the rest of its entry p is read from global memory at the
//     seed.
//   - The cooperative launch is sized with the occupancy at the most
//     shared memory any launch of the type asks for.
#include <cooperative_groups.h>

#include <cstdint>

#include "step_cell.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kRing = 4;
constexpr int kPinBytes = 32768;

template <typename T>
constexpr int pin_slots_max() {
  return kPinBytes / (kThreads * static_cast<int>(sizeof(T)));
}

template <typename T>
constexpr int smem_bytes_max() {
  return (pin_slots_max<T>() + kRing) * kThreads * static_cast<int>(sizeof(T));
}

// ---- the bulk-copy and mbarrier instructions (PTX ISA 8.0, sm_90) ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
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

// shared -> global, in the issuing thread's current bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// until at most kRing - 1 of this thread's bulk groups still read shared memory
__device__ __forceinline__ void bulk_wait_ring_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(kRing - 1) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// makes this thread's shared-memory writes visible to the bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

template <typename T>
struct StepArgs {
  const T *F, *u, *v, *p;      // entry block fields
  T *F_out, *u_out, *v_out, *p_out;
  T *kr, *us, *vs, *pa, *pb, *un, *vn;  // scratch, each one block
  tv::Block b;
  tv::PredictParams<T> pq;
  tv::ProjectParams<T> jq;
  tv::SweepParams<T> sx, sy;
  int n_jacobi, even_step;
  int pin_slots;  // entry chunks of p each CTA copies into shared memory
};

// The elements of a chunk of `len` cells that one bulk copy moves: the
// largest whole number of 16-byte units.
template <typename T>
__device__ __forceinline__ int bulk_elems(int len) {
  return (len * static_cast<int>(sizeof(T))) / 16 * 16 / static_cast<int>(sizeof(T));
}

// A warp's store ring: the warp stages a chunk's values, then its lane 0
// sends the chunk to global memory. Every lane of the warp calls acquire()
// and send() the same number of times (the rounds loop is warp-uniform),
// and no CTA barrier is needed: the warps go through their rounds
// independently, as in fullstep.cu.
template <typename T>
struct StoreRing {
  T* slots;   // this warp's kRing chunks of kWarp values
  int lane;
  int count;  // stores issued so far

  // The next staging chunk, once the copy that used it last has read it.
  __device__ __forceinline__ T* acquire() {
    if (count >= kRing && lane == 0) bulk_wait_ring_read();
    __syncwarp();
    return slots + (count % kRing) * kWarp;
  }

  // Chunk `base` of `out` (len cells) from the staged slot; this lane
  // staged `val` for cell base + lane if lane < len.
  __device__ __forceinline__ void send(T* slot, T* out, int base, int len, T val) {
    const int n_bulk = bulk_elems<T>(len);
    if (lane >= n_bulk && lane < len) out[base + lane] = val;  // the ragged tail
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) {
      if (n_bulk > 0) bulk_store(out + base, slot, n_bulk * sizeof(T));
      bulk_commit();
    }
    ++count;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) fullstep_dma_kernel(const StepArgs<T> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t p_bar;
  cg::grid_group grid = cg::this_grid();
  const tv::Block& b = a.b;
  const int n = b.E0 * b.E1;
  const int t = threadIdx.x;
  const int first = blockIdx.x * blockDim.x + t;
  const int stride = gridDim.x * blockDim.x;
  const int cta0 = blockIdx.x * kThreads;  // this CTA's first chunk
  const int lane = t % kWarp;
  T* pin = reinterpret_cast<T*>(smem);
  StoreRing<T> ring{pin + a.pin_slots * kThreads + (t - lane) * kRing, lane, 0};
#define TV_CELLS for (int c = first, i = c / b.E1, j = c % b.E1; c < n; \
                      c += stride, i = c / b.E1, j = c % b.E1)
// This warp's chunks of kWarp cells, in warp-uniform rounds (the body may
// hold __syncwarp()): each starts at cell base; this lane's cell is
// base + lane, the cell TV_CELLS gives this thread.
#define TV_CHUNKS for (int base = first - lane; base < n; base += stride)

  // entry: start the copies of this CTA's first pin_slots chunks of p
  if (t == 0) mbar_init(&p_bar);
  __syncthreads();
  if (t == 0) {
    uint32_t bytes = 0;
    for (int k = 0, base = cta0; base < n && k < a.pin_slots; ++k, base += stride)
      bytes += bulk_elems<T>(min(kThreads, n - base)) * sizeof(T);
    mbar_arrive_expect_tx(&p_bar, bytes);
    for (int k = 0, base = cta0; base < n && k < a.pin_slots; ++k, base += stride) {
      const int m = bulk_elems<T>(min(kThreads, n - base));
      if (m > 0) bulk_load(pin + k * kThreads, a.p + base, m * sizeof(T), &p_bar);
    }
  }

  TV_CELLS { a.kr[c] = tv::curvature_at(a.F, b, i, j, a.pq); }
  grid.sync();
  TV_CELLS { tv::momentum_at(a.u, a.v, a.F, a.kr, b, i, j, a.pq, a.us[c], a.vs[c]); }
  grid.sync();
  // rhs over kappa's buffer (kappa is dead); both Jacobi buffers <- the
  // sanitized entry p, from shared memory where it was copied
  mbar_wait(&p_bar, 0);
  for (int k = 0, base = cta0; base < n; ++k, base += stride) {
    const int c = base + t;
    if (c >= n) continue;
    const int i = c / b.E1, j = c % b.E1;
    a.kr[c] = b.interior(i, j) ? tv::rhs_at(a.F, a.us, a.vs, b, i, j, a.jq) : T(0);
    const T pv = k < a.pin_slots && t < bulk_elems<T>(min(kThreads, n - base))
                     ? (b.inside(i, j) && b.domain(i, j) ? pin[k * kThreads + t] : T(0))
                     : tv::ld(a.p, b, i, j);
    a.pa[c] = pv;
    a.pb[c] = pv;
  }
  grid.sync();
  T* src = a.pa;
  T* dst = a.pb;
  for (int it = 0; it < a.n_jacobi; ++it) {
    TV_CELLS {
      if (b.interior(i, j) && i >= 1 && i < b.E0 - 1 && j >= 1 && j < b.E1 - 1)
        dst[c] = tv::jacobi_at(src, a.kr[c], b, i, j, a.jq);
    }
    grid.sync();
    T* tmp = src;
    src = dst;
    dst = tmp;
  }
  const T* p = src;
  // wall BCs at global indices (tpuvof's _bc_u, _bc_v, _bc_scal): u
  // mirrored across the j-walls then zero on the i-wall faces; v zero on
  // the j-wall faces then mirrored across the i-walls; F and p mirrored j
  // first, then i.
  auto mirror = [&](int i, int j, int& di, int& dj) {
    const int gi = i + b.oi, gj = j + b.oj;
    di = gi == 0 ? 1 : (gi == b.nx + 1 ? -1 : 0);
    dj = gj == 0 ? 1 : (gj == b.ny + 1 ? -1 : 0);
  };
  // the correction; p is final: its BC'd chunk goes out under the rest
  TV_CHUNKS {
    const int c = base + lane;
    const int len = min(kWarp, n - base);
    const int i = c / b.E1, j = c % b.E1;
    T pbc = T(0);
    if (lane < len) {
      tv::correct_at(a.F, a.us, a.vs, p, a.u, a.v, b, i, j, a.jq, a.un[c], a.vn[c]);
      int di, dj;
      mirror(i, j, di, dj);
      pbc = tv::ld(p, b, i + di, j + dj);
    }
    T* slot = ring.acquire();
    if (lane < len) slot[lane] = pbc;
    ring.send(slot, a.p_out, base, len, pbc);
  }
  grid.sync();
  // the two sweeps: the first into us' buffer, the second, clamped, into
  // vs' (u* and v* are dead); u and v are final: their BC'd chunks go out
  // under the sweeps, which read the pre-BC un and vn
  const int ax1 = a.even_step ? 1 : 0;
  TV_CHUNKS {
    const int c = base + lane;
    const int len = min(kWarp, n - base);
    const int i = c / b.E1, j = c % b.E1;
    T ubc = T(0), vbc = T(0);
    if (lane < len) {
      a.us[c] = ax1 ? tv::sweep_at<T, 1>(a.F, a.vn, b, i, j, a.sy)
                    : tv::sweep_at<T, 0>(a.F, a.un, b, i, j, a.sx);
      const int gi = i + b.oi, gj = j + b.oj;
      int di, dj;
      mirror(i, j, di, dj);
      ubc = gi == 1 || gi == b.nx + 1 ? T(0) : tv::ld(a.un, b, i, j + dj);
      vbc = gj == 1 || gj == b.ny + 1 ? T(0) : tv::ld(a.vn, b, i + di, j);
    }
    T* slot = ring.acquire();
    if (lane < len) slot[lane] = ubc;
    ring.send(slot, a.u_out, base, len, ubc);
    slot = ring.acquire();
    if (lane < len) slot[lane] = vbc;
    ring.send(slot, a.v_out, base, len, vbc);
  }
  grid.sync();
  TV_CELLS {
    a.vs[c] = tv::clamp01(ax1 ? tv::sweep_at<T, 0>(a.us, a.un, b, i, j, a.sx)
                              : tv::sweep_at<T, 1>(a.us, a.vn, b, i, j, a.sy));
  }
  grid.sync();
  TV_CHUNKS {
    const int c = base + lane;
    const int len = min(kWarp, n - base);
    T fbc = T(0);
    if (lane < len) {
      const int i = c / b.E1, j = c % b.E1;
      int di, dj;
      mirror(i, j, di, dj);
      fbc = tv::ld(a.vs, b, i + di, j + dj);
    }
    T* slot = ring.acquire();
    if (lane < len) slot[lane] = fbc;
    ring.send(slot, a.F_out, base, len, fbc);
  }
  // no bulk store may be in flight when the CTA exits
  if (lane == 0) bulk_wait_all();
#undef TV_CHUNKS
#undef TV_CELLS
}

// Blocks of kThreads that the card holds resident at once with the most
// dynamic shared memory a launch asks for (the most a cooperative launch
// may have), asked once a device, or a negative CUDA error.
template <typename T>
int resident_blocks() {
  static std::atomic<int> cache[tv::kMaxDevices];
  return tv::per_device(cache, [](int dev) {
    int sms, per_sm, coop;
    cudaError_t e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fullstep_dma_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes_max<T>());
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fullstep_dma_kernel<T>,
                                                        kThreads, smem_bytes_max<T>());
    if (e == cudaSuccess && per_sm < 1) e = cudaErrorLaunchOutOfResources;
    return e == cudaSuccess ? per_sm * sms : -static_cast<int>(e);
  });
}

// The launch's shape for an E0 x E1 block: CTAs, chunks of kThreads cells
// the busiest CTA owns (its rounds), and the entry chunks of p each CTA
// copies into shared memory; or a CUDA error.
struct Plan {
  int blocks, rounds, pin_slots;
};

template <typename T>
int plan_fullstep_dma(int E0, int E1, Plan& plan) {
  const int resident = resident_blocks<T>();
  if (resident < 0) return -resident;
  const long long want = (static_cast<long long>(E0) * E1 + kThreads - 1) / kThreads;
  plan.blocks = static_cast<int>(want < resident ? want : resident);
  plan.rounds = static_cast<int>((want + plan.blocks - 1) / plan.blocks);
  plan.pin_slots = plan.rounds < pin_slots_max<T>() ? plan.rounds : pin_slots_max<T>();
  return 0;
}

template <typename T>
int launch_fullstep_dma(const void* const* fields, void* const* outs, void* scratch,
                        tv::Block b, int n_jacobi, int even_step, const double* pc,
                        const double* jc, const double* sxc, const double* syc,
                        int full_dv, int clamp, cudaStream_t stream) {
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
  T* s = static_cast<T*>(scratch);
  const size_t n = static_cast<size_t>(b.E0) * b.E1;
  T** bufs[] = {&a.kr, &a.us, &a.vs, &a.pa, &a.pb, &a.un, &a.vn};
  for (int k = 0; k < 7; ++k) *bufs[k] = s + k * n;
  a.b = b;
  a.pq = tv::predict_params<T>(pc);
  a.jq = tv::project_params<T>(jc);
  a.sx = tv::sweep_params<T>(b.nx, b.ny, sxc, full_dv, clamp);
  a.sy = tv::sweep_params<T>(b.ny, b.nx, syc, full_dv, clamp);
  a.n_jacobi = n_jacobi;
  a.even_step = even_step;
  Plan plan;
  if (const int e = plan_fullstep_dma<T>(b.E0, b.E1, plan)) return e;
  a.pin_slots = plan.pin_slots;
  const size_t smem = static_cast<size_t>(a.pin_slots + kRing) * kThreads * sizeof(T);
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fullstep_dma_kernel<T>), dim3(plan.blocks),
      dim3(kThreads), args, smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tv_fullstep_*'s interface (fullstep.cu); every field and output must be
// 16-byte aligned (cudaErrorMisalignedAddress otherwise).
extern "C" int tv_fullstep_dma_f32(const void* const* fields, void* const* outs,
                                   void* scratch, int E0, int E1, int oi, int oj,
                                   int nx, int ny, int n_jacobi, int even_step,
                                   const double* pc, const double* jc,
                                   const double* sxc, const double* syc,
                                   int full_dv, int clamp, void* stream) {
  return launch_fullstep_dma<float>(fields, outs, scratch,
                                    tv::Block{E0, E1, oi, oj, nx, ny}, n_jacobi,
                                    even_step, pc, jc, sxc, syc, full_dv, clamp,
                                    static_cast<cudaStream_t>(stream));
}

extern "C" int tv_fullstep_dma_f64(const void* const* fields, void* const* outs,
                                   void* scratch, int E0, int E1, int oi, int oj,
                                   int nx, int ny, int n_jacobi, int even_step,
                                   const double* pc, const double* jc,
                                   const double* sxc, const double* syc,
                                   int full_dv, int clamp, void* stream) {
  return launch_fullstep_dma<double>(fields, outs, scratch,
                                     tv::Block{E0, E1, oi, oj, nx, ny}, n_jacobi,
                                     even_step, pc, jc, sxc, syc, full_dv, clamp,
                                     static_cast<cudaStream_t>(stream));
}

// The launch's shape for an E0 x E1 block: plan[0..2] <- CTAs, the busiest
// CTA's rounds, the entry chunks of p each CTA pins in shared memory (the
// rest of its entry p is read from global memory at the seed).
extern "C" int tv_fullstep_dma_plan_f32(int E0, int E1, int* plan) {
  Plan pl{};
  const int e = plan_fullstep_dma<float>(E0, E1, pl);
  plan[0] = pl.blocks, plan[1] = pl.rounds, plan[2] = pl.pin_slots;
  return e;
}

extern "C" int tv_fullstep_dma_plan_f64(int E0, int E1, int* plan) {
  Plan pl{};
  const int e = plan_fullstep_dma<double>(E0, E1, pl);
  plan[0] = pl.blocks, plan[1] = pl.rounds, plan[2] = pl.pin_slots;
  return e;
}
