// Persistent cooperative launches: one block per SM, ordered by grid
// barriers (cooperative_groups' grid.sync()).  Shared by the refined
// solve of K1/K2/K4 (hop.cu) and the dense-KKT direction of K5
// (kktdir.cu).
#pragma once

#include <math.h>

#include "common.cuh"

// First row of band b of nblk: bands of equal area of the lower triangle
// of an r-row matrix (band b holds rows [coop_band(b), coop_band(b + 1))).
// The same on the host and the device (IEEE sqrt).
__host__ __device__ inline int coop_band(int b, int nblk, int r) {
  return b >= nblk ? r : (int)((double)r * sqrt((double)b / (double)nblk));
}

// Host side of a launch, checked once per kernel and dynamic shared size:
// the dynamic shared memory allowed (raised only), the static shared
// memory within static_max, one block per SM resident (a cooperative grid
// that cannot be resident is an error, never a hang).
static cudaError_t coop_ready(const void* kernel, int threads, int smem,
                              int static_max) {
  struct Seen {
    const void* kernel;
    int smem;    // the largest size allowed so far
    int ok;      // sizes up to `ok` checked
  };
  constexpr int kSeen = 32;
  static Seen seen[kSeen];
  static int n = 0;
  int i = 0;
  while (i < n && seen[i].kernel != kernel) ++i;
  if (i < n && seen[i].ok >= smem) return cudaSuccess;
  if (i == n) {
    if (n == kSeen) return cudaErrorInvalidValue;
    seen[n++] = {kernel, -1, -1};
  }
  cudaError_t e = cudaSuccess;
  if (seen[i].smem < smem) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e == cudaSuccess) seen[i].smem = smem;
  }
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
  if (e == cudaSuccess && fa.sharedSizeBytes > (size_t)static_max)
    e = cudaErrorInvalidConfiguration;   // static_max is too small
  int per = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, threads,
                                                      smem);
  if (e == cudaSuccess && per < 1) e = cudaErrorCooperativeLaunchTooLarge;
  if (e == cudaSuccess) seen[i].ok = smem;
  return e;
}

// One launch of nblk blocks of `threads`: cooperative (grid barriers) or
// plain.  Returns the CUDA error (0 on success).
static int coop_launch(const void* kernel, int nblk, int threads, int smem,
                       int static_max, void* arg, cudaStream_t stream,
                       bool coop) {
  void* args[] = {arg};
  cudaError_t e = coop_ready(kernel, threads, smem, static_max);
  if (e == cudaSuccess)
    e = coop ? cudaLaunchCooperativeKernel(kernel, dim3(nblk), dim3(threads),
                                           args, smem, stream)
             : cudaLaunchKernel(kernel, dim3(nblk), dim3(threads), args, smem,
                                stream);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return ip_status();
}
