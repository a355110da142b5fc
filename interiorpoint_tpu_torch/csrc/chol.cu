// Blocked Cholesky factor, triangular inverse and triangular solves, in
// fp32 (the preconditioners of K1, K2, K4 and K3's callers) and fp64 (the
// dense-KKT direction K5), shared by ops/pd_step.py, ops/kkt_step.py and
// the standalone factor and solve of ops/chol.py (K3a and K3b).
//
// Replaces
//   interiorpoint_tpu/ops/pallas_chol.py:_chol_kernel (K3a) with its
//     diagonal-block factor and inverse _factor_diag_block,
//   interiorpoint_tpu/ops/pallas_chol.py:_solve_kernel (K3b), and the
//     LDL solve of interiorpoint_tpu/ops/pallas_newton.py:_ldl_solve
//     (the same kernel with the tile inverses in its middle),
//   interiorpoint_tpu/ops/pallas_newton.py:_chol_factor_ref,
//     _chol_invert_ref and _w_solve, which the TPU step kernels run.
//
// The factor and the inverse work on np x np row-major matrices, np a
// multiple of BLK = 64, padded with the identity; the fused solve reads an
// n x n factor in place with that padding implicit.  The solve is bound
// by its chain of 2 nb dependent tiles (latency), not by its bytes: it is
// spread over one block per block row and column chunk, handing tiles on
// through flags in global memory (block_solve_kernel).  Only the lower
// triangle of the source is read, and the factor comes out exactly lower.
//
// Bound: latency, at the reduced widths of the main path (r <= 1100, at
// most 18 block columns).  The factor is a chain of nb dependent diagonal
// blocks; the bulk (panels and trailing updates, n^3/3 flops) is small.
// Design:
//  * One persistent cooperative launch per factor and one per inverse
//    (grid <= one block per SM, a grid barrier between stages), instead
//    of a launch per stage.
//  * The factor is right-looking with look-ahead fused into one stage per
//    block column k: the blocks of column k apply step k-1's update to
//    their own tile and (redundantly, each block in its own shared
//    memory) to the diagonal tile, factor and invert it, and write the
//    panel L_ik = A_ik inv(L_kk)^T; the other blocks apply step k-1's
//    update to the trailing tiles of columns > k.  So the chain is nb
//    stages with nb - 1 grid barriers.
//  * The 64 x 64 diagonal block has no block-wide barrier per pivot: two
//    32-pivot halves, each factored by one warp in registers, with a
//    32-row triangular solve (one row per lane, on a second warp while
//    the first inverts L11) and the 32 x 32 update between them; the
//    inverse is 2 x 2 block inversion, inv(L11) and inv(L22) each by one
//    warp (a column per lane), inv(L22) while the other warps form
//    L21 inv(L11).
//  * W = L^-1 works by block columns in parallel, right-looking: stage s
//    finishes W_{k+s,k} = -Dinv_{k+s} Acc_{k+s,k} for every k and adds
//    L_{i,k+s} W_{k+s,k} to the accumulators of the rows below, so its
//    chain is nb stages of two tile products.
//  * Tile products: fp64 on the tensor cores (DMMA,
//    mma.sync.aligned.m8n8k4.row.col.f64), fp32 on FFMA in true fp32
//    (never TF32: the factor preconditions an fp64-refined solve, and
//    refinement converges only when kappa * (factor error) < 1,
//    interiorpoint_tpu/ops/pallas_chol.py:_dot).  Tiles are staged in
//    shared memory with cp.async.
// A non-finite pivot sets a device flag instead of stopping: NaN
// propagates as in jnp.linalg.cholesky, and the caller's jitter ladder
// reads the flag.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int BLK = 64;
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

// The block edge: callers pad to a multiple of it and size Dinv (np x BLK).
IP_API size_t ip_chol_block() { return BLK; }

// Shared-memory row stride of a 64 x 64 tile: conflict-free for the
// FFMA 4 x 4 blocks (fp32) and the DMMA fragments (fp64: 68 = 4 mod 16
// doubles, and a row is a whole number of 16-byte cp.async chunks).
template <typename T> struct Ld;
template <> struct Ld<float> { static constexpr int v = 65; };
template <> struct Ld<double> { static constexpr int v = 68; };
template <typename T>
__host__ __device__ constexpr int tile_elems() { return BLK * Ld<T>::v; }

__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async(double* dst, const double* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Start copying the 64 x 64 tile at G (row stride ldg) into S.
template <typename T>
__device__ void tile_load(T* S, const T* G, int ldg) {
  constexpr int LD = Ld<T>::v;
  constexpr int per = sizeof(T) == 8 ? 2 : 1;  // elements per copy
  for (int e = threadIdx.x; e < BLK * BLK / per; e += THREADS) {
    const int r = e / (BLK / per), c = (e % (BLK / per)) * per;
    cp_async(S + r * LD + c, G + (size_t)r * ldg + c);
  }
}

// ---------------------------------------------------------------------------
// 64 x 64 x 64 tile products, C (registers) += A op(B), A and B tiles in
// shared memory (stride Ld<T>); NT: op(B) = B^T, NN: op(B) = B.
// ---------------------------------------------------------------------------

template <typename T> struct Acc;

// fp32: a 4 x 4 register block per thread (rows 4ty+p, columns 4tx+q).
template <> struct Acc<float> {
  static constexpr int LD = Ld<float>::v;
  float v[4][4];
  __device__ void zero() {
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) v[p][q] = 0.f;
  }
  template <bool NT>
  __device__ void mma(const float* A, const float* B) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    for (int k = 0; k < BLK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = A[(ty * 4 + q) * LD + k];
        b[q] = NT ? B[(tx * 4 + q) * LD + k] : B[k * LD + tx * 4 + q];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) v[p][q] = fmaf(a[p], b[q], v[p][q]);
    }
  }
  __device__ void mma_nt(const float* A, const float* B) { mma<true>(A, B); }
  __device__ void mma_nn(const float* A, const float* B) { mma<false>(A, B); }
  template <class F> __device__ void each(F f) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) f(ty * 4 + p, tx * 4 + q, v[p][q]);
  }
};

// fp64: warp w owns rows 8w..8w+7 as eight 8 x 8 DMMA tiles.
template <> struct Acc<double> {
  static constexpr int LD = Ld<double>::v;
  double v[8][2];
  __device__ void zero() {
#pragma unroll
    for (int cb = 0; cb < 8; ++cb) v[cb][0] = v[cb][1] = 0.0;
  }
  // C += A B^T: the trailing update and the panel product
  __device__ void mma_nt(const double* A, const double* B) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const double* Ar = A + ((threadIdx.x >> 5) * 8 + g) * LD + t;
#pragma unroll 4
    for (int k0 = 0; k0 < BLK; k0 += 4) {
      const double a = Ar[k0];
#pragma unroll
      for (int cb = 0; cb < 8; ++cb)
        ip_dmma(v[cb], a, B[(cb * 8 + g) * LD + k0 + t]);
    }
  }
  // C += A B: the inverse's products
  __device__ void mma_nn(const double* A, const double* B) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const double* Ar = A + ((threadIdx.x >> 5) * 8 + g) * LD + t;
#pragma unroll 4
    for (int kk = 0; kk < BLK; kk += 4) {
      const double a = Ar[kk];
#pragma unroll
      for (int cb = 0; cb < 8; ++cb)
        ip_dmma(v[cb], a, B[(kk + t) * LD + cb * 8 + g]);
    }
  }
  template <class F> __device__ void each(F f) {
    const int lane = threadIdx.x & 31;
    const int r = (threadIdx.x >> 5) * 8 + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
    for (int cb = 0; cb < 8; ++cb) {
      f(r, cb * 8 + c, v[cb][0]);
      f(r, cb * 8 + c + 1, v[cb][1]);
    }
  }
};

// ---------------------------------------------------------------------------
// The 64 x 64 diagonal block
// ---------------------------------------------------------------------------

// The warp-serial parts below keep one row per lane in registers and run
// a rolled loop over the pivots: the register array is shifted by one
// column per pivot (a[u] is column j + u at pivot j), so every register
// index is a compile-time constant while the code stays one loop body
// (fully unrolled, these loops are straight-line code far larger than the
// instruction cache, run once per stage, and instruction fetch then sets
// the block's time).  A pivot's column reaches the other lanes through a
// 32-entry scratch in shared memory, read back with 16-byte broadcast
// loads: four or two entries per load instead of one shuffle per entry.

// 16-byte loads and stores of V = 16 / sizeof(T) entries (16-byte aligned).
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ void load(const float* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* i) {
    *reinterpret_cast<float4*>(p) = make_float4(i[0], i[1], i[2], i[3]);
  }
};
template <> struct Vec<double> {
  static constexpr int V = 2;
  static __device__ __forceinline__ void load(const double* p, double* o) {
    const double2 v = *reinterpret_cast<const double2*>(p);
    o[0] = v.x; o[1] = v.y;
  }
  static __device__ __forceinline__ void store(double* p, const double* i) {
    *reinterpret_cast<double2*>(p) = make_double2(i[0], i[1]);
  }
};

// Factor the 32 x 32 lower block at (o, o) of Ts in place, one warp: lane
// i holds row i; pivot j's column goes through ``col`` (32 entries).
// Entries above the diagonal are neither read nor written.
template <typename T>
__device__ void warp_factor32(T* Ts, int o, int lane, T* col) {
  constexpr int LD = Ld<T>::v, V = Vec<T>::V;
  T* row = Ts + (o + lane) * LD + o;
  T a[32];
#pragma unroll
  for (int u = 0; u < 32; ++u) a[u] = (u <= lane) ? row[u] : T(0);
#pragma unroll 1
  for (int j = 0; j < 32; ++j) {
    // correctly rounded sqrt and division, as LAPACK's: near-singular
    // pivots amplify the error of rsqrt's approximation, and the fp32
    // factor's preconditioning of the deep K1 states does not tolerate it
    const T d = sqrt(__shfl_sync(FULL, a[0], j));  // NaN if not positive
    const T l = (lane == j) ? d : (lane > j ? a[0] / d : T(0));
    if (lane >= j) {
      row[j] = l;
      col[lane - j] = l;   // col[u] = L[j + u][j]
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < 32 / V; ++q) {
      T lc[V];
      Vec<T>::load(col + q * V, lc);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int u = q * V + e;
        if (u == 0) continue;
        if (lane >= j + u) a[u] = fma(-l, lc[e], a[u]);
        a[u - 1] = a[u];
      }
    }
    a[31] = T(0);
    __syncwarp();
  }
}

// X (32 x 32 at (o, o) of Xs, zeros above the diagonal) = the inverse of
// the lower 32 x 32 block at (o, o) of Ts, one warp: lane c solves
// L x = e_c for column c of X, every lane on its own (no exchange between
// lanes); the rows of L are copied to ``lr`` (32 x 32) and read by
// broadcast loads.
template <typename T>
__device__ void warp_invert32(const T* Ts, T* Xs, int o, int lane, T* lr) {
  constexpr int LD = Ld<T>::v, V = Vec<T>::V;
#pragma unroll 1
  for (int i = 0; i < 32; ++i)
    lr[i * 32 + lane] = (lane <= i) ? Ts[(o + i) * LD + o + lane] : T(0);
  __syncwarp();
  T x[32];   // x[i] = X[i][lane], zero until row i is solved
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = T(0);
#pragma unroll 1
  for (int i = 0; i < 32; ++i) {
    const T* li = lr + i * 32;
    T acc[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
    for (int q = 0; q < 32 / V; ++q) {
      T lv[V];
      Vec<T>::load(li + q * V, lv);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int k = q * V + e;
        acc[k & 3] = fma(lv[e], x[k], acc[k & 3]);
      }
    }
    const T xi = ((i == lane ? T(1) : T(0)) -
                  ((acc[0] + acc[1]) + (acc[2] + acc[3]))) / li[i];
#pragma unroll
    for (int k = 0; k < 32; ++k) x[k] = (k == i) ? xi : x[k];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) Xs[(o + i) * LD + o + lane] = x[i];
  __syncwarp();   // lr is reused by the caller's next warp-serial step
}

// Rows 32..63, columns 0..31 of Ts: L21 = A21 inv(L11)^T, one warp; lane
// i solves row 32 + i against L11, whose columns are first copied to
// ``lt`` (32 x 32: lt[c][u] = L11[c + u][c], zero past the block) so
// that each is read by broadcast loads.
template <typename T>
__device__ void warp_trsm32(T* Ts, int lane, T* lt) {
  constexpr int LD = Ld<T>::v, V = Vec<T>::V;
#pragma unroll 1
  for (int c = 0; c < 32; ++c)
    lt[c * 32 + lane] = (c + lane < 32) ? Ts[(c + lane) * LD + c] : T(0);
  __syncwarp();
  T* row = Ts + (32 + lane) * LD;
  T a[32];
#pragma unroll
  for (int u = 0; u < 32; ++u) a[u] = row[u];
#pragma unroll 1
  for (int c = 0; c < 32; ++c) {
    const T* lc = lt + c * 32;
    const T v = a[0] / lc[0];
    row[c] = v;
#pragma unroll
    for (int q = 0; q < 32 / V; ++q) {
      T lv[V];
      Vec<T>::load(lc + q * V, lv);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int u = q * V + e;
        if (u == 0) continue;
        a[u] = fma(-v, lv[e], a[u]);
        a[u - 1] = a[u];
      }
    }
  }
}

// Factor the diagonal tile Ts (lower triangle read) in place and write
// its inverse, lower with zeros above, to Xs; ``scr`` is a 16-byte
// aligned scratch of 2112 entries.  Six block barriers.
template <typename T>
__device__ void factor_diag(T* Ts, T* Xs, T* scr) {
  constexpr int LD = Ld<T>::v;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (warp == 0) warp_factor32(Ts, 0, lane, scr);
  __syncthreads();
  if (warp == 0) {
    warp_invert32(Ts, Xs, 0, lane, scr);
  } else if (warp == 1) {
    warp_trsm32(Ts, lane, scr + 1088);
  }
  __syncthreads();
  // A22 -= L21 L21^T (lower half)
  for (int e = tid; e < 32 * 32; e += THREADS) {
    const int r = e / 32, c = e % 32;
    if (c > r) continue;
    T s = 0;
    for (int q = 0; q < 32; ++q)
      s = fma(Ts[(32 + r) * LD + q], Ts[(32 + c) * LD + q], s);
    Ts[(32 + r) * LD + 32 + c] -= s;
  }
  __syncthreads();
  if (warp == 0) warp_factor32(Ts, 32, lane, scr);
  __syncthreads();
  if (warp == 0) {
    warp_invert32(Ts, Xs, 32, lane, scr);
  } else {
    // P = L21 inv(L11) into the lower-left block of Xs
    for (int e = tid - 32; e < 32 * 32; e += THREADS - 32) {
      const int r = e / 32, c = e % 32;
      T s = 0;
      for (int q = c; q < 32; ++q)
        s = fma(Ts[(32 + r) * LD + q], Xs[q * LD + c], s);
      Xs[(32 + r) * LD + c] = s;
      Xs[c * LD + 32 + r] = 0;  // the upper-right block
    }
  }
  __syncthreads();
  // inv(L)21 = -inv(L22) P
  T out[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int e = tid + u * THREADS, r = e / 32, c = e % 32;
    T s = 0;
    for (int q = 0; q <= r; ++q)
      s = fma(Xs[(32 + r) * LD + 32 + q], Xs[(32 + q) * LD + c], s);
    out[u] = -s;
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int e = tid + u * THREADS;
    Xs[(32 + e / 32) * LD + e % 32] = out[u];
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The factor: one cooperative launch
// ---------------------------------------------------------------------------

// tril(src[:n, :n]) + delta I with identity padding, entry (i, j).
template <typename T>
__device__ __forceinline__ T src_at(const T* src, int n, int lds, T delta,
                                    int i, int j) {
  if (j > i) return T(0);
  if (i < n && j < n) return src[(size_t)i * lds + j] + (i == j ? delta : T(0));
  return i == j ? T(1) : T(0);
}

template <typename T>
__device__ void src_tile(T* S, const T* src, int n, int lds, T delta, int ib,
                         int jb) {
  constexpr int LD = Ld<T>::v, PER = BLK * BLK / THREADS;
  T v[PER];   // all loads in flight before the stores
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int e = threadIdx.x + q * THREADS;
    v[q] = src_at(src, n, lds, delta, ib * BLK + e / BLK, jb * BLK + e % BLK);
  }
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int e = threadIdx.x + q * THREADS;
    S[(e / BLK) * LD + e % BLK] = v[q];
  }
}

// Lower tile index t -> (ii, jj), jj <= ii.
__device__ __forceinline__ void lower_tile(int t, int* ii, int* jj) {
  int i = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  while (i * (i + 1) / 2 > t) --i;
  *ii = i;
  *jj = t - i * (i + 1) / 2;
}

// Stage k's task for row block i >= k (see the header): step k-1's update
// of tiles (k, k) and (i, k), the diagonal factor and inverse, then the
// panel L_ik (i > k) or, for i == k, L_kk and Dinv_k.  L_kk goes to the
// upper tile (k, k+1) first, since other blocks still read tile (k, k) in
// this stage; stage k+1 moves it (the last stage writes it in place).
template <typename T>
__device__ void factor_task(T* sm, const T* src, int n, int lds, T delta,
                            T* A, int np, int nb, int k, int i, T* Dinv,
                            int* bad) {
  constexpr int LD = Ld<T>::v;
  T* Ts = sm;
  T* Xs = sm + tile_elems<T>();   // L_{k,k-1}, then inv(L_kk)
  T* As = sm + 2 * tile_elems<T>();
  T* Ls = sm + 3 * tile_elems<T>();
  const bool diag = i == k;
  auto at = [&](int ib, int jb) { return A + (size_t)ib * BLK * np + jb * BLK; };
  if (k == 0) {
    src_tile(Ts, src, n, lds, delta, 0, 0);
    if (!diag) src_tile(As, src, n, lds, delta, i, 0);
  } else {
    tile_load(Ts, at(k, k), np);
    tile_load(Xs, at(k, k - 1), np);
    if (!diag) {
      tile_load(As, at(i, k), np);
      tile_load(Ls, at(i, k - 1), np);
    }
    cp_async_wait();
  }
  __syncthreads();
  if (k > 0) {
    // step k-1's update; each thread writes only what it alone owns
    Acc<T> acc;
    acc.zero();
    acc.mma_nt(Xs, Xs);
    acc.each([&](int r, int c, T v) { Ts[r * LD + c] -= v; });
    if (!diag) {
      acc.zero();
      acc.mma_nt(Ls, Xs);
      acc.each([&](int r, int c, T v) { As[r * LD + c] -= v; });
    }
    __syncthreads();
  }
  factor_diag(Ts, Xs, Ls);   // Ls is free from here on
  if (diag) {
    T* dst = (k + 1 < nb) ? at(k, k + 1) : at(k, k);
    int local_bad = 0;
    for (int e = threadIdx.x; e < BLK * BLK; e += THREADS) {
      const int r = e / BLK, c = e % BLK;
      dst[(size_t)r * np + c] = (c <= r) ? Ts[r * LD + c] : T(0);
      const T x = Xs[r * LD + c];
      Dinv[(size_t)(k * BLK + r) * BLK + c] = x;
      if (!isfinite(x)) local_bad = 1;
    }
    if (local_bad) atomicExch(bad, 1);  // only ever set: order-free
    if (k > 0) {
      // L_{k-1,k-1} from its parking tile to its place; zero the parking
      T* from = at(k - 1, k);
      T* to = at(k - 1, k - 1);
      for (int e = threadIdx.x; e < BLK * BLK; e += THREADS) {
        const size_t off = (size_t)(e / BLK) * np + e % BLK;
        to[off] = from[off];
        from[off] = T(0);
      }
    }
  } else {
    Acc<T> acc;
    acc.zero();
    acc.mma_nt(As, Xs);   // L_ik = A_ik inv(L_kk)^T
    T* dst = at(i, k);
    acc.each([&](int r, int c, T v) { dst[(size_t)r * np + c] = v; });
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
chol_factor_kernel(const T* __restrict__ src, int n, int lds, T delta,
                   T* __restrict__ A, int np, T* __restrict__ Dinv,
                   int* __restrict__ bad, const int* __restrict__ after) {
  if (after && *after == 0) return;   // every block: no barrier is reached
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  const int nb = np / BLK;
  for (int k = 0; k < nb; ++k) {
    const int na = nb - k;                       // column k's tasks
    const int m = nb - k - 1;                    // trailing block columns
    const int nupd = k > 0 ? m * (m + 1) / 2 : 0;
    // stage 0 also copies the source's lower tiles of columns >= 1 and
    // zeroes the upper tiles but the parking tiles (j, j+1)
    const int ncopy = k == 0 ? nb * (nb - 1) / 2 : 0;
    const int nzero = k == 0 ? nb * (nb - 1) / 2 : 0;
    const int total = na + nupd + ncopy + nzero;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      if (t < na) {
        factor_task(sm, src, n, lds, delta, A, np, nb, k, k + t, Dinv, bad);
      } else if (t < na + nupd) {
        // A_ij -= L_{i,k-1} L_{j,k-1}^T for k < j <= i
        int ii, jj;
        lower_tile(t - na, &ii, &jj);
        const int i = k + 1 + ii, j = k + 1 + jj;
        T* Li = sm;
        T* Lj = sm + tile_elems<T>();
        tile_load(Li, A + (size_t)i * BLK * np + (k - 1) * BLK, np);
        tile_load(Lj, A + (size_t)j * BLK * np + (k - 1) * BLK, np);
        cp_async_wait();
        __syncthreads();
        Acc<T> acc;
        acc.zero();
        acc.mma_nt(Li, Lj);
        T* dst = A + (size_t)i * BLK * np + j * BLK;
        acc.each([&](int r, int c, T v) { dst[(size_t)r * np + c] -= v; });
      } else {
        const int u = t - na - nupd;
        int ii, jj;
        lower_tile(u < ncopy ? u : u - ncopy, &ii, &jj);
        // copy: lower tile (ii + 1, jj + 1); zero: upper tile (jj, ii + 1)
        const int ib = u < ncopy ? ii + 1 : jj;
        const int jb = ii + 1;
        if (u >= ncopy && ib + 1 == jb) continue;   // a parking tile
        const int jc = u < ncopy ? jj + 1 : jb;
        T* dst = A + (size_t)ib * BLK * np + jc * BLK;
        for (int e = threadIdx.x; e < BLK * BLK; e += THREADS) {
          const int r = e / BLK, c = e % BLK;
          dst[(size_t)r * np + c] =
              u < ncopy ? src_at(src, n, lds, delta, ib * BLK + r,
                                 jc * BLK + c)
                        : T(0);
        }
      }
      __syncthreads();   // shared memory is reused by the next task
    }
    if (k + 1 < nb) grid.sync();
  }
}

// ---------------------------------------------------------------------------
// The inverse W = L^-1: one cooperative launch
// ---------------------------------------------------------------------------

// Stage 0: W_kk = Dinv_k, W_ik = 0 above the diagonal, and the
// accumulators Acc_ik = L_ik Dinv_k below it.  Stage s >= 1, task
// (i, k) with i >= k + s: Wt = -Dinv_{k+s} Acc_{k+s,k} (= W_{k+s,k},
// written by the task i == k + s), then Acc_ik += L_{i,k+s} Wt.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
chol_invert_kernel(const T* __restrict__ L, const T* __restrict__ Dinv,
                   T* __restrict__ W, T* __restrict__ Acc_, int np) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  constexpr int LD = Ld<T>::v;
  T* Ds = sm;
  T* Ps = sm + tile_elems<T>();
  T* Ls = sm + 2 * tile_elems<T>();
  cg::grid_group grid = cg::this_grid();
  const int nb = np / BLK;
  auto at = [&](T* M, int ib, int jb) {
    return M + (size_t)ib * BLK * np + jb * BLK;
  };
  for (int s = 0; s < nb; ++s) {
    const int m = nb - s;
    const int total = s == 0 ? nb * nb : m * (m + 1) / 2;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      if (s == 0) {
        const int i = t / nb, k = t % nb;
        T* dst = at(W, i, k);
        if (i <= k) {
          for (int e = threadIdx.x; e < BLK * BLK; e += THREADS) {
            const int r = e / BLK, c = e % BLK;
            dst[(size_t)r * np + c] =
                i == k ? Dinv[(size_t)(k * BLK + r) * BLK + c] : T(0);
          }
        } else {
          tile_load(Ls, L + (size_t)i * BLK * np + k * BLK, np);
          tile_load(Ds, Dinv + (size_t)k * BLK * BLK, BLK);
          cp_async_wait();
          __syncthreads();
          Acc<T> acc;
          acc.zero();
          acc.mma_nn(Ls, Ds);
          T* a = at(Acc_, i, k);
          acc.each([&](int r, int c, T v) { a[(size_t)r * np + c] = v; });
        }
      } else {
        int ii, kk;
        lower_tile(t, &ii, &kk);   // kk <= ii < m
        const int k = kk, j = kk + s, i = ii + s;   // i >= j = k + s
        tile_load(Ds, Dinv + (size_t)j * BLK * BLK, BLK);
        tile_load(Ps, at(Acc_, j, k), np);
        if (i > j) tile_load(Ls, L + (size_t)i * BLK * np + j * BLK, np);
        cp_async_wait();
        __syncthreads();
        Acc<T> acc;
        acc.zero();
        acc.mma_nn(Ds, Ps);
        if (i == j) {
          T* dst = at(W, j, k);
          acc.each([&](int r, int c, T v) { dst[(size_t)r * np + c] = -v; });
        } else {
          __syncthreads();   // every read of Ps is done
          acc.each([&](int r, int c, T v) { Ps[r * LD + c] = -v; });
          __syncthreads();
          acc.zero();
          acc.mma_nn(Ls, Ps);
          T* a = at(Acc_, i, k);
          acc.each([&](int r, int c, T v) { a[(size_t)r * np + c] += v; });
        }
      }
      __syncthreads();
    }
    if (s + 1 < nb) grid.sync();
  }
}

// ---------------------------------------------------------------------------
// W-solves and the fused two-triangle solve
// ---------------------------------------------------------------------------

// u = W[:n,:n] b  (W lower; one warp per row)
template <typename T>
__global__ void w_lower_mv_kernel(const T* __restrict__ W, int ld, int n,
                                  const T* __restrict__ b,
                                  T* __restrict__ u) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * 8 + warp;
  if (i >= n) return;
  T acc = 0;
  for (int j = lane; j <= i; j += 32)
    acc = fma(W[(size_t)i * ld + j], b[j], acc);
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
  if (lane == 0) u[i] = acc;
}

// x = W[:n,:n]^T u  (32 columns per block, 8 row phases, coalesced rows;
// rows above the column tile hold zeros of the lower triangle)
template <typename T>
__global__ void w_lower_tmv_kernel(const T* __restrict__ W, int ld, int n,
                                   const T* __restrict__ u,
                                   T* __restrict__ x) {
  __shared__ T red[8][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * 32 + tx;
  T acc = 0;
  if (j < n)
    for (int i = blockIdx.x * 32 + ty; i < n; i += 8)
      acc = fma(W[(size_t)i * ld + j], u[i], acc);
  red[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && j < n) {
    T s = 0;
    for (int q = 0; q < 8; ++q) s += red[q][tx];
    x[j] = s;
  }
}

// The blocked two-triangle solve, spread over the card (K3b, and the
// barrier step's LDL solve).  TE-row tiles (TE = 64 for K3b's factor, 128
// for the LDL's); task (i, c) owns block row i for the c-th chunk of PC
// right-hand sides.
//   forward:  y_i = F_i (b_i - sum_{j<i} L_ij y_j)        (F = I if null)
//   middle:   u_i = M_i^T y_i                              (M = I if null)
//   backward: x_i = G_i^T (u_i - sum_{j>i} L_ji^T x_j)     (G = I if null)
// K3b: F = G = Dinv (so L L^T X = B); the LDL solve: M = the tile
// inverses.  Each task publishes its tile (y_i, then x_i, in place in X)
// with a release store of a flag in global memory; a task waits for the
// flags of the tiles it reads (an acquire spin by one thread, then a
// block barrier) and reads them through L2.  The L tile it needs next is
// loaded into registers before it waits, so the chain's step is the flag
// hand-off plus a TE x TE tile-vector product.  Every block runs its
// forward tasks in increasing order and then its backward tasks in
// decreasing block row, and every task depends only on tasks earlier in
// that order, so with every block resident (a cooperative launch) the
// chain cannot deadlock.  Thread (a, q) holds row a of the tile and the
// q-th quarter of its columns; the four quarters of a row are four
// neighbouring lanes and sum by shuffles.  L is read in place (row stride
// ldl, the strictly lower tiles of the leading n x n only); rows and
// columns past n read as zero, so its identity padding is implicit.
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}
// One thread spins until the flag is set; the block then goes on.
__device__ __forceinline__ void wait_flag(const int* f) {
  if (threadIdx.x == 0)
    while (ld_acquire(f) == 0) __nanosleep(20);
  __syncthreads();
}

// The sum of v over the four lanes of a row.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

template <int TE, int PC>
__global__ void __launch_bounds__(4 * TE)
block_solve_kernel(const float* __restrict__ L, int ldl, int n,
                   const float* __restrict__ F, const float* __restrict__ M,
                   const float* __restrict__ G,
                   const float* __restrict__ B, float* X, int p,
                   int* flags) {
  constexpr int SEG = TE / 4;
  __shared__ float ts[TE * PC];   // a published tile, y_j or x_j
  __shared__ float rs[TE * PC];   // a tile through a diagonal product
  const int tid = threadIdx.x, a = tid >> 2, q = tid & 3;
  const int nb = (n + TE - 1) / TE, nch = (p + PC - 1) / PC;
  const int tasks = nb * nch;
  int* fwd = flags;
  int* bwd = flags + tasks;

  // ts = rows [j TE, j TE + TE) of X, columns [c0, c0 + PC), through L2
  auto load_tile = [&](int j, int c0) {
    for (int e = tid; e < TE * PC; e += 4 * TE) {
      const int rr = j * TE + e / PC, cc = c0 + e % PC;
      ts[e] = (rr < n && cc < p) ? __ldcg(X + (size_t)rr * p + cc) : 0.f;
    }
    __syncthreads();
  };
  // acc[cc] += sum_kk w[kk] * ts[q SEG + kk][cc]
  auto dot_tile = [&](const float* w, float* acc, const float* t) {
#pragma unroll
    for (int kk = 0; kk < SEG; ++kk)
#pragma unroll
      for (int cc = 0; cc < PC; ++cc)
        acc[cc] = fmaf(w[kk], t[(q * SEG + kk) * PC + cc], acc[cc]);
  };
  // D (TE x TE, row-major at T, row stride TE) applied to v (one value per
  // row a, every lane of the row holding it): trans ? D^T v : D v
  auto diag_apply = [&](const float* T, bool trans, int i, float* v) {
    float dr[SEG];
#pragma unroll
    for (int kk = 0; kk < SEG; ++kk) {
      const int k = q * SEG + kk;
      dr[kk] = trans ? T[(size_t)(i * TE + k) * TE + a]
                     : T[(size_t)(i * TE + a) * TE + k];
    }
    if (q == 0)
#pragma unroll
      for (int cc = 0; cc < PC; ++cc) rs[a * PC + cc] = v[cc];
    __syncthreads();
    float o[PC];
#pragma unroll
    for (int cc = 0; cc < PC; ++cc) o[cc] = 0.f;
    dot_tile(dr, o, rs);
    __syncthreads();
#pragma unroll
    for (int cc = 0; cc < PC; ++cc) v[cc] = quad_sum(o[cc]);
  };
  auto publish = [&](int i, int c0, const float* v, int* flag) {
    const int row = i * TE + a;
    if (q == 0 && row < n)
#pragma unroll
      for (int cc = 0; cc < PC; ++cc)
        if (c0 + cc < p) X[(size_t)row * p + c0 + cc] = v[cc];
    __threadfence();
    __syncthreads();
    if (tid == 0) st_release(flag, 1);
  };

  for (int t = blockIdx.x; t < tasks; t += gridDim.x) {
    const int i = t / nch, c0 = (t % nch) * PC;
    const int row = i * TE + a;
    float acc[PC];
#pragma unroll
    for (int cc = 0; cc < PC; ++cc) acc[cc] = 0.f;
    for (int j = 0; j < i; ++j) {
      float lr[SEG];
#pragma unroll
      for (int kk = 0; kk < SEG; ++kk) {
        const int col = j * TE + q * SEG + kk;
        lr[kk] = (row < n && col < n) ? L[(size_t)row * ldl + col] : 0.f;
      }
      wait_flag(fwd + j * nch + t % nch);
      load_tile(j, c0);
      dot_tile(lr, acc, ts);
      __syncthreads();
    }
    float v[PC];
#pragma unroll
    for (int cc = 0; cc < PC; ++cc) {
      const float sum = quad_sum(acc[cc]);   // every lane takes part
      v[cc] = (row < n && c0 + cc < p) ? B[(size_t)row * p + c0 + cc] - sum
                                       : 0.f;
    }
    if (F) diag_apply(F, false, i, v);
    publish(i, c0, v, fwd + t);
  }

  for (int t = blockIdx.x; t < tasks; t += gridDim.x) {
    const int i = nb - 1 - t / nch, c = t % nch, c0 = c * PC;
    const int row = i * TE + a;
    wait_flag(fwd + i * nch + c);
    load_tile(i, c0);
    float u[PC];
#pragma unroll
    for (int cc = 0; cc < PC; ++cc) u[cc] = ts[a * PC + cc];
    __syncthreads();
    if (M) diag_apply(M, true, i, u);
    float acc[PC];
#pragma unroll
    for (int cc = 0; cc < PC; ++cc) acc[cc] = 0.f;
    for (int j = nb - 1; j > i; --j) {
      float lr[SEG];
#pragma unroll
      for (int kk = 0; kk < SEG; ++kk) {
        const int rj = j * TE + q * SEG + kk;
        lr[kk] = (rj < n && row < n) ? L[(size_t)rj * ldl + row] : 0.f;
      }
      wait_flag(bwd + j * nch + c);
      load_tile(j, c0);
      dot_tile(lr, acc, ts);
      __syncthreads();
    }
#pragma unroll
    for (int cc = 0; cc < PC; ++cc) {
      const float sum = quad_sum(acc[cc]);
      u[cc] = (row < n && c0 + cc < p) ? u[cc] - sum : 0.f;
    }
    if (G) diag_apply(G, true, i, u);
    publish(i, c0, u, bwd + i * nch + c);
  }
}

// ---------------------------------------------------------------------------
// C entries
// ---------------------------------------------------------------------------

// Launch a persistent kernel cooperatively: at most one block per SM (and
// no more than co-reside), no more blocks than the widest stage has
// tasks.  The shared-memory attribute and the occupancy are set and read
// once per kernel.
template <typename K>
static int coop_launch(K kernel, int tiles, void** args, int ntiles_smem,
                       size_t elem, cudaStream_t stream) {
  static int cap = 0;   // one per kernel type: blocks that may co-reside
  const size_t smem = (size_t)ntiles_smem * BLK * (elem == 8 ? 68 : 65) * elem;
  cudaError_t e = cudaSuccess;
  if (cap == 0) {
    int dev = 0, sms = 0, per = 0;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel,
                                                        THREADS, smem);
    if (e == cudaSuccess && per < 1) e = cudaErrorInvalidConfiguration;
    if (e == cudaSuccess) cap = sms;
  }
  if (e == cudaSuccess) {
    const int grid = tiles < cap ? (tiles > 0 ? tiles : 1) : cap;
    e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                    dim3(THREADS), args, smem, stream);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();   // clear it: the error is returned instead
    return (int)e;
  }
  return ip_status();
}

// Factor tril(src[:n,:n]) + delta I, identity-padded to np x np, into A
// (np x np, not aliasing src): L in its lower triangle, zeros above, Dinv
// (np x BLK) the inverted diagonal blocks, *bad set when one is not
// finite.  A jitter ladder on the device: with `after` (the previous
// rung's flag, zeroed before that rung) nothing runs unless *after is set,
// so a rung skips itself once an earlier rung's factor was finite (a
// skipped rung leaves its own zeroed flag, and the rungs after it skip
// too).  One cooperative launch.
template <typename T>
static int chol_factor(const T* src, int n, int lds, double delta, T* A,
                       int np, T* Dinv, int* bad, const int* after,
                       cudaStream_t stream) {
  const int nb = np / BLK;
  T d = (T)delta;
  void* args[] = {&src, &n, &lds, &d, &A, &np, &Dinv, &bad, &after};
  return coop_launch(chol_factor_kernel<T>, nb * nb, args, 4, sizeof(T),
                     stream);
}

IP_API int ip_chol_factor(const float* src, int n, int lds, double delta,
                          float* A, int np, float* Dinv, int* bad,
                          const int* after, cudaStream_t stream) {
  return chol_factor<float>(src, n, lds, delta, A, np, Dinv, bad, after,
                            stream);
}

IP_API int ip_chol_factor64(const double* src, int n, int lds, double delta,
                            double* A, int np, double* Dinv, int* bad,
                            const int* after, cudaStream_t stream) {
  return chol_factor<double>(src, n, lds, delta, A, np, Dinv, bad, after,
                             stream);
}

// W = L^-1 (np x np, lower) from the factor and Dinv; acc is an np x np
// scratch of the same type.  One cooperative launch.
template <typename T>
static int chol_invert(const T* L, const T* Dinv, T* W, T* acc, int np,
                       cudaStream_t stream) {
  const int nb = np / BLK;
  void* args[] = {&L, &Dinv, &W, &acc, &np};
  return coop_launch(chol_invert_kernel<T>, nb * nb, args, 3, sizeof(T),
                     stream);
}

IP_API int ip_chol_invert(const float* L, const float* Dinv, float* W,
                          float* acc, int np, cudaStream_t stream) {
  return chol_invert<float>(L, Dinv, W, acc, np, stream);
}

IP_API int ip_chol_invert64(const double* L, const double* Dinv, double* W,
                            double* acc, int np, cudaStream_t stream) {
  return chol_invert<double>(L, Dinv, W, acc, np, stream);
}

// x = W^T (W b) on the leading n entries: (L L^T)^-1 b with W = L^-1.
template <typename T>
static int w_solve(const T* W, int ld, int n, const T* b, T* u, T* x,
                   cudaStream_t stream) {
  w_lower_mv_kernel<T><<<(n + 7) / 8, 256, 0, stream>>>(W, ld, n, b, u);
  w_lower_tmv_kernel<T><<<(n + 31) / 32, dim3(32, 8), 0, stream>>>(W, ld, n,
                                                                   u, x);
  return ip_status();
}

IP_API int ip_w_solve(const float* W, int ld, int n, const float* b,
                      float* u, float* x, cudaStream_t stream) {
  return w_solve<float>(W, ld, n, b, u, x, stream);
}

IP_API int ip_w_solve64(const double* W, int ld, int n, const double* b,
                        double* u, double* x, cudaStream_t stream) {
  return w_solve<double>(W, ld, n, b, u, x, stream);
}

// Flags of ip_block_solve for n rows, p right-hand sides, tile edge te.
static int solve_pc(int p) { return p == 1 ? 1 : 8; }
IP_API size_t ip_block_solve_flags(int n, int p, int te) {
  const size_t nb = (n + te - 1) / te, nch = (p + solve_pc(p) - 1) / solve_pc(p);
  return 2 * nb * nch;
}

template <int TE, int PC>
static int block_solve(const float* L, int ldl, int n, const float* F,
                       const float* M, const float* G, const float* B,
                       float* X, int p, int* flags, cudaStream_t stream) {
  static int cap = 0;   // blocks that may co-reside, per instance
  auto kernel = block_solve_kernel<TE, PC>;
  cudaError_t e = cudaSuccess;
  if (cap == 0) {
    int dev = 0, sms = 0, per = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, 4 * TE,
                                                        0);
    if (e == cudaSuccess && per < 1) e = cudaErrorInvalidConfiguration;
    if (e == cudaSuccess) cap = sms * per;
  }
  if (e == cudaSuccess) {
    const int tasks = ((n + TE - 1) / TE) * ((p + PC - 1) / PC);
    const int grid = tasks < cap ? tasks : cap;
    void* args[] = {&L, &ldl, &n, &F, &M, &G, &B, &X, &p, &flags};
    e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                    dim3(4 * TE), args, 0, stream);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return ip_status();
}

// The blocked two-triangle solve (see block_solve_kernel) of B (n x p,
// row-major) into X; flags: ip_block_solve_flags ints, zeroed.
IP_API int ip_block_solve(const float* L, int ldl, int n, int te,
                          const float* F, const float* M, const float* G,
                          const float* B, float* X, int p, int* flags,
                          cudaStream_t stream) {
  if (n <= 0 || p <= 0) return 0;
  if (te == BLK)
    return p == 1 ? block_solve<BLK, 1>(L, ldl, n, F, M, G, B, X, p, flags,
                                        stream)
                  : block_solve<BLK, 8>(L, ldl, n, F, M, G, B, X, p, flags,
                                        stream);
  if (te == 2 * BLK)
    return p == 1 ? block_solve<2 * BLK, 1>(L, ldl, n, F, M, G, B, X, p,
                                            flags, stream)
                  : block_solve<2 * BLK, 8>(L, ldl, n, F, M, G, B, X, p,
                                            flags, stream);
  return (int)cudaErrorInvalidValue;
}
