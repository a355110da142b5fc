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
