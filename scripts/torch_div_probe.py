#!/usr/bin/env python3
"""Probe of IEEE division's cost on a CUDA card when the numerator is zero.

    python3 scripts/torch_div_probe.py

The division a / b of float and double compiles to an instruction sequence
with a fast path and a slow path; the sequence leaves its fast path for a
zero numerator. The kernels of tpuvof_torch divide fluxes, gradients and
volume fractions that are zero over wide regions of the dam break, so
they take the quotient of a zero numerator without the division
(``tv::quot`` in tpuvof_torch/csrc/common.cuh). This script compiles, with
the package's nvcc flags, a kernel that divides each of 2^20 values 200
times in a dependent chain, and prints the device ms of that chain for a
numerator of 0.5, of 0 and of 1e-30 (a normal number), plain and through
the same guard as ``tv::quot``, in f32 and f64, and the card's name and
power limit.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdio>
template <typename T>
__device__ __forceinline__ T quot(T x, T y) {
  if (x == T(0) && y == y && y != T(0)) return x * copysign(T(1), y);
  return x / y;
}
template <typename T, bool GUARD>
__global__ void chain(const T* a, const T* b, T* out, int n, int reps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T x = a[i];
  const T y = b[i];
  for (int k = 0; k < reps; ++k) x = GUARD ? quot(x, y) : x / y;
  out[i] = x;
}
template <typename T, bool GUARD>
float run(T numerator) {
  const int n = 1 << 20, reps = 200;
  T *a, *b, *o;
  cudaMalloc(&a, n * sizeof(T));
  cudaMalloc(&b, n * sizeof(T));
  cudaMalloc(&o, n * sizeof(T));
  T* h = new T[n];
  for (int i = 0; i < n; ++i) h[i] = numerator;
  cudaMemcpy(a, h, n * sizeof(T), cudaMemcpyHostToDevice);
  for (int i = 0; i < n; ++i) h[i] = T(1.0001);
  cudaMemcpy(b, h, n * sizeof(T), cudaMemcpyHostToDevice);
  chain<T, GUARD><<<(n + 255) / 256, 256>>>(a, b, o, n, reps);
  cudaEvent_t s, e;
  cudaEventCreate(&s);
  cudaEventCreate(&e);
  cudaEventRecord(s);
  for (int r = 0; r < 5; ++r) chain<T, GUARD><<<(n + 255) / 256, 256>>>(a, b, o, n, reps);
  cudaEventRecord(e);
  cudaEventSynchronize(e);
  float ms;
  cudaEventElapsedTime(&ms, s, e);
  cudaFree(a);
  cudaFree(b);
  cudaFree(o);
  delete[] h;
  return cudaGetLastError() == cudaSuccess ? ms / 5 : -1.0f;
}
int main() {
  printf("f32 a / b: numerator 0.5 %.4f ms, 0 %.4f ms, 1e-30 %.4f ms\n", run<float, false>(0.5f),
         run<float, false>(0.0f), run<float, false>(1e-30f));
  printf("f32 quot(a, b): numerator 0.5 %.4f ms, 0 %.4f ms\n", run<float, true>(0.5f),
         run<float, true>(0.0f));
  printf("f64 a / b: numerator 0.5 %.4f ms, 0 %.4f ms\n", run<double, false>(0.5),
         run<double, false>(0.0));
  printf("f64 quot(a, b): numerator 0.5 %.4f ms, 0 %.4f ms\n", run<double, true>(0.5),
         run<double, true>(0.0));
  return 0;
}
"""


def main() -> int:
    from tpuvof_torch.kernels import build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    flags = [f for f in build._FLAGS if f not in ("-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    with tempfile.TemporaryDirectory() as tmp:
        src, exe = Path(tmp) / "div_probe.cu", Path(tmp) / "div_probe"
        src.write_text(SOURCE)
        subprocess.run([build._nvcc(), *flags, "-o", str(exe), str(src)], check=True)
        out = subprocess.run([str(exe)], capture_output=True, text=True, check=True).stdout
    print(f"[{card}] device ms of 2^20 chains of 200 divisions (nvcc {' '.join(flags)}):")
    print(out, end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
