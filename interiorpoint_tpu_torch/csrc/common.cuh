// Shared helpers of the port's CUDA kernels (built with nvcc for sm_90a
// into one shared library with a plain C interface; see
// interiorpoint_tpu_torch/kernels/_build.py).
//
// Every C entry launches on the stream it is given, allocates nothing,
// does not synchronise, and returns cudaGetLastError() so that the Python
// wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#define IP_API extern "C" __attribute__((visibility("default")))

static inline int ip_status() { return (int)cudaGetLastError(); }

// NaN-propagating max/min, matching torch.amax/amin on the plain path.
__device__ __forceinline__ double ip_nanmax(double a, double b) {
  return (isnan(a) || a > b) ? a : b;
}
__device__ __forceinline__ double ip_nanmin(double a, double b) {
  return (isnan(a) || a < b) ? a : b;
}

// Butterfly reductions: every lane of the warp ends with the result.
__device__ __forceinline__ double ip_warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float ip_warp_sumf(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// D = A B + C on one 8 x 8 x 4 fp64 tensor-core tile (DMMA): lane l holds
// A[l/4][l%4], B[l%4][l/4] and C[l/4][2(l%4) + {0, 1}].
__device__ __forceinline__ void ip_dmma(double (&c)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(c[0]), "+d"(c[1])
      : "d"(a), "d"(b));
}

// Flags in global memory between the blocks of one launch (release and
// acquire at GPU scope), and the nanosecond clock their waits time out
// by.
typedef unsigned long long u64;

__device__ __forceinline__ u64 ld_acquire64(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release64(u64* p, u64 v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}
__device__ __forceinline__ u64 globaltimer() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
