// Shared device helpers of the 2-D kernels.
//
// Layout: a field is a row-major (nx+2, ny+2) array, axis 0 = i (x), axis 1 =
// j (y), j contiguous. The kernels put threadIdx.x along j, so the loads of
// a warp are coalesced row segments, and mask their own ragged edges.
//
// Each kernel takes its physical and grid constants as arguments of type T.
// The host computes them in double, in the same expressions the JAX package
// folds them in, and casts them once; nothing is baked in per grid.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace tv {

constexpr int kMaxDevices = 64;

// ask(dev) for the current device, asked once a device and kept there: a
// kernel's shared-memory grant, its occupancy and the SM count belong to
// one device. A result <= 0 (none, or a negated CUDA error) is not kept.
template <class Ask>
int per_device(std::atomic<int> (&cache)[kMaxDevices], const Ask& ask) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices) return -static_cast<int>(cudaErrorInvalidDevice);
  int n = cache[dev].load(std::memory_order_relaxed);
  if (n <= 0) {
    n = ask(dev);
    if (n > 0) cache[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

// The current device's SM count, asked once a device.
inline int sm_count() {
  static std::atomic<int> cache[kMaxDevices];
  return per_device(cache, [](int dev) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms;
  });
}

// Strict-select clip to [0, 1], as tpuvof/ops/common.py:clamp01.
template <typename T>
__device__ __forceinline__ T clamp01(T x) {
  return x < T(0) ? T(0) : (x > T(1) ? T(1) : x);
}

// x / y, rounded as IEEE division rounds it, but without the division
// when x is zero and y a non-zero number: the division's instruction
// sequence leaves its fast path for a zero numerator (2.8x slower in f32,
// 3.7x in f64 on the H100, scripts/torch_div_probe.py), and the step's
// fluxes, gradients and volume fractions are zero over wide regions. The
// quotient is then x * copysign(1, y), the same signed zero.
template <typename T>
__device__ __forceinline__ T quot(T x, T y) {
  if (x == T(0) && y == y && y != T(0)) return x * copysign(T(1), y);
  return x / y;
}

// max/min of two finite values (the JAX and torch versions propagate NaN
// where these do not; the step's values are finite).
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) {
  return a > b ? a : b;
}

template <typename T>
__device__ __forceinline__ T tmin(T a, T b) {
  return a < b ? a : b;
}

// Density and viscosity mixed from the clamped volume fraction
// (tpuvof/ops/materials.py:mix_properties).
template <typename T>
__device__ __forceinline__ T mix_rho(T F, T rho_l, T rho_g) {
  const T Fc = clamp01(F);
  return rho_g * (T(1) - Fc) + rho_l * Fc;
}

template <typename T>
__device__ __forceinline__ T mix_nu(T F, T nu_l, T nu_g) {
  const T Fc = clamp01(F);
  return nu_l * Fc + nu_g * (T(1) - Fc);
}

}  // namespace tv
