// The strip pass over a row-major fp64 matrix M (m x r): one read of each
// row gives both its row dot M_i . x and its contribution to the column
// sums sum_i y_i M_ij.  K1's pass 1 and right-hand side (rows.cu) run it;
// the fused operator and the refined solve (hop.cu) have a pass of their
// own that forms M_i . x in sp_dot's order.
//
// A persistent grid of one block per SM takes the strips (rows
// [s SR, s SR + SR)) s = blockIdx.x, blockIdx.x + gridDim.x, ... in turn.
// Each strip is staged in shared memory with cp.async (16-byte copies when
// the rows are 16-byte aligned), the next strip's copy in flight while the
// block works on the current one.  One warp per row forms the row dot
// (lanes stride the row, then a butterfly sum: the order of rows.cu's
// row_dot, so M.x is bitwise the same wherever it is formed); a caller's
// functor turns it into the row's column weight y_i; then each thread adds
// y_i M_ij over the strip's rows, in row order, to the columns it owns in
// the block's partial.  The partials are summed over the blocks in block
// order by the column reduction (sp_chunk_sum): no atomics, so every
// result is deterministic.  Where a strip of even one row does not fit in
// shared memory, the rows are read in place and the column pass re-reads
// them from L2; where x and the partial do not fit either, they stay in
// global memory.
#pragma once

#include <stdint.h>

#include "common.cuh"

constexpr int SP_THREADS = 512;                  // threads of a strip block
constexpr int SP_WARPS = SP_THREADS / 32;
constexpr int SP_MAX_ROWS = 32;                  // rows per strip, at most
constexpr int SP_CHUNK = 32;                     // columns per reduction task
constexpr int SP_PHASES = SP_THREADS / SP_CHUNK; // its row phases
constexpr int SP_STATIC = 16384;  // shared bytes kept for static arrays

// Launch geometry of a strip pass (computed on the host).
struct SpGeom {
  int rows;   // rows per strip staged in shared memory (0: read in place)
  int ldt;    // shared row stride in doubles (even: 16-byte rows)
  int v16;    // 16-byte copies (r even, M 16-byte aligned)
  int xsm;    // x and the column partial in shared memory
  int nblk;   // blocks of the persistent grid (one per SM)
  int smem;   // dynamic shared bytes
};

static inline void sp_device(int* sms, int* cap) {
  static int s = 0, c = 0;
  if (s == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&c, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  *sms = s;
  *cap = c;
}

// The geometry of a strip pass over m x r rows of M.
static inline SpGeom sp_geom(int r, const void* M) {
  int sms = 0, cap = 0;
  sp_device(&sms, &cap);
  SpGeom g;
  g.ldt = r + (r & 1);
  g.v16 = (r % 2 == 0) && ((uintptr_t)M % 16 == 0);
  const long ys = SP_MAX_ROWS * 8, xa = 16L * r;
  long avail = (long)cap - ys - SP_STATIC;
  g.xsm = xa <= avail;
  if (g.xsm) avail -= xa;
  int rows = (int)(avail / (16L * g.ldt));
  if (rows > SP_MAX_ROWS) rows = SP_MAX_ROWS;
  if (rows >= SP_WARPS) rows -= rows % SP_WARPS;
  g.rows = rows;
  g.nblk = sms;
  g.smem = (int)((g.xsm ? xa : 0) + 16L * rows * g.ldt + ys);
  return g;
}

// The dynamic shared memory of a strip block: two strip tiles, x, the
// column partial and the strip's column weights.
struct SpSmem {
  double* tiles;
  double* xs;
  double* acc;
  double* ys;
};

__device__ __forceinline__ SpSmem sp_smem(const SpGeom& g, int r) {
  extern __shared__ __align__(16) unsigned char sp_raw[];
  SpSmem s;
  s.tiles = reinterpret_cast<double*>(sp_raw);
  double* p = s.tiles + (size_t)2 * g.rows * g.ldt;
  s.xs = g.xsm ? p : nullptr;
  s.acc = g.xsm ? p + r : nullptr;
  s.ys = g.xsm ? p + 2 * r : p;
  return s;
}

__device__ __forceinline__ void sp_cp16(double* s, const double* g) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(g));
}
__device__ __forceinline__ void sp_cp8(double* s, const double* g) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(a), "l"(g));
}
template <int N>
__device__ __forceinline__ void sp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying rows [i0, i0 + h) of M into T (row stride g.ldt).
__device__ __forceinline__ void sp_stage(double* T, const SpGeom& g,
                                         const double* M, int r, int i0,
                                         int h) {
  const double* src = M + (size_t)i0 * r;
  if (g.v16) {
    const int pr = r >> 1;
    for (int e = threadIdx.x; e < h * pr; e += SP_THREADS) {
      const int row = e / pr, c = (e - row * pr) * 2;
      sp_cp16(T + (size_t)row * g.ldt + c, src + (size_t)row * r + c);
    }
  } else {
    for (int e = threadIdx.x; e < h * r; e += SP_THREADS) {
      const int row = e / r, c = e - row * r;
      sp_cp8(T + (size_t)row * g.ldt + c, src + (size_t)row * r + c);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// row . x (x in shared memory, or in global memory read through L2 when
// XG), lanes strided in order, then a butterfly sum.
template <bool XG>
__device__ __forceinline__ double sp_dot(const double* row, const double* x,
                                         int r, int lane) {
  double acc = 0.0;
  for (int j = lane; j < r; j += 32)
    acc = fma(row[j], XG ? __ldcg(x + j) : x[j], acc);
  return ip_warp_sum(acc);
}

// The block's strips: with DOT, y_i = rw(i, M_i . x) (called by lane 0 of
// the row's warp); without, y_i = rw(i, 0) (one thread per row).  Then
// acc[j] += sum_i y_i M_ij.
template <bool DOT, bool XG, class RW>
__device__ void sp_loop(const double* __restrict__ M, int m, int r,
                        const SpGeom& g, const double* xs, double* acc,
                        double* tiles, double* ys, RW rw) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool staged = g.rows > 0;
  const int SR = staged ? g.rows : SP_MAX_ROWS;
  const int ns = (m + SR - 1) / SR;
  int s = blockIdx.x;
  if (staged && s < ns) sp_stage(tiles, g, M, r, s * SR, min(SR, m - s * SR));
  for (int q = 0; s < ns; s += gridDim.x, ++q) {
    const int i0 = s * SR, h = min(SR, m - i0);
    const double* T = M + (size_t)i0 * r;
    int ldt = r;
    if (staged) {
      const int sn = s + gridDim.x;
      if (sn < ns) {
        sp_stage(tiles + (size_t)((q + 1) & 1) * SR * g.ldt, g, M, r, sn * SR,
                 min(SR, m - sn * SR));
        sp_wait<1>();
      } else {
        sp_wait<0>();
      }
      T = tiles + (size_t)(q & 1) * SR * g.ldt;
      ldt = g.ldt;
      __syncthreads();
    }
    if (DOT) {
      for (int rr = warp; rr < h; rr += SP_WARPS) {
        const double d = sp_dot<XG>(T + (size_t)rr * ldt, xs, r, lane);
        if (lane == 0) ys[rr] = rw(i0 + rr, d);
      }
    } else {
      for (int rr = threadIdx.x; rr < h; rr += SP_THREADS)
        ys[rr] = rw(i0 + rr, 0.0);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < r; j += SP_THREADS) {
      double a = acc[j];
      for (int rr = 0; rr < h; ++rr) a = fma(ys[rr], T[(size_t)rr * ldt + j], a);
      acc[j] = a;
    }
    __syncthreads();
  }
}

// Load x into the block's shared copy (when it fits) and zero the block's
// column partial; returns (x as the row dots read it, the partial).
template <bool XG>
__device__ __forceinline__ void sp_begin(const SpSmem& s, const double* x,
                                         double* part, int r,
                                         const double** xs, double** acc) {
  double* own = part + (size_t)blockIdx.x * r;
  for (int j = threadIdx.x; j < r; j += SP_THREADS) {
    if (XG) {
      own[j] = 0.0;
    } else {
      if (x) s.xs[j] = __ldcg(x + j);
      s.acc[j] = 0.0;
    }
  }
  __syncthreads();
  *xs = XG ? x : s.xs;
  *acc = XG ? own : s.acc;
}

// Write the block's column partial from shared memory.
template <bool XG>
__device__ __forceinline__ void sp_end(const SpSmem& s, double* part, int r) {
  if (!XG)
    for (int j = threadIdx.x; j < r; j += SP_THREADS)
      part[(size_t)blockIdx.x * r + j] = s.acc[j];
}

// (P x)_j = P_j . x over the grid's warps (P r x r row-major).
template <bool XG>
__device__ void sp_prows(const double* __restrict__ P, int r, const double* xs,
                         double* px) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = blockIdx.x * SP_WARPS + warp; j < r; j += gridDim.x * SP_WARPS) {
    const double d = sp_dot<XG>(P + (size_t)j * r, xs, r, lane);
    if (lane == 0) px[j] = d;
  }
}

// Column j = c SP_CHUNK + (threadIdx.x % SP_CHUNK) of the nb partials
// summed in block order (SP_PHASES interleaved phases, then the phases in
// order).  Valid in the threads of phase 0 with j < r; every thread of the
// block must call it.
__device__ __forceinline__ double sp_chunk_sum(const double* part, int nb,
                                               int r, int c) {
  __shared__ double red[SP_PHASES][SP_CHUNK + 1];
  const int tx = threadIdx.x % SP_CHUNK, ty = threadIdx.x / SP_CHUNK;
  const int j = c * SP_CHUNK + tx;
  double a = 0.0;
  if (j < r)
    for (int b = ty; b < nb; b += SP_PHASES) a += __ldcg(part + (size_t)b * r + j);
  red[ty][tx] = a;
  __syncthreads();
  double v = 0.0;
  if (ty == 0)
    for (int p = 0; p < SP_PHASES; ++p) v += red[p][tx];
  __syncthreads();
  return v;
}

__host__ __device__ inline int sp_chunks(int r) {
  return (r + SP_CHUNK - 1) / SP_CHUNK;
}

// Allow a strip kernel the dynamic shared memory it asks for; *set (the
// caller's, one per kernel) remembers the largest size allowed so far.
template <typename K>
static inline cudaError_t sp_allow(K kernel, int smem, int* set) {
  if (*set >= smem) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) *set = smem;
  return e;
}
