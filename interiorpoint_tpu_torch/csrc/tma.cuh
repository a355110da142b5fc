// Tensor maps and 2-d TMA copies, shared by the solve kernels that stage
// tiles of a row-major fp32 matrix in shared memory (csolve.cu, wsolve.cu).
// The tensor-map encoder (cuTensorMapEncodeTiled) is fetched at run time
// through the runtime, so nothing links against libcuda.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums
#include <stdint.h>

#include "common.cuh"

typedef CUresult (*IpEncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// The tensor-map encoder, fetched once.
static inline IpEncodeTiled ip_tma_encoder() {
  static IpEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<IpEncodeTiled>(f);
  }
  return fn;
}

// A map of the fp32 matrix at base (rows x cols, row stride ld) with boxes
// of bh rows x bw floats, 128-byte swizzled (chunk c of a box row r at
// c ^ (r % 8)) or dense; reads past the matrix land as zeros.
static inline bool ip_make_map(CUtensorMap* m, const float* base, int rows,
                               int cols, int ld, int bw, int bh,
                               bool swizzle) {
  const IpEncodeTiled enc = ip_tma_encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {(cuuint32_t)bw, (cuuint32_t)bh};
  const cuuint32_t unit[2] = {1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<float*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle ? CU_TENSOR_MAP_SWIZZLE_128B
                     : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One TMA copy of a 2-d box at (x inner, y outer) into S, counted in bytes
// on the barrier bar of S's block.
__device__ __forceinline__ void ip_tma_2d(float* S, const CUtensorMap* map,
                                          int x, int y, u64* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          (unsigned)__cvta_generic_to_shared(S)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"((unsigned)__cvta_generic_to_shared(bar))
      : "memory");
}
