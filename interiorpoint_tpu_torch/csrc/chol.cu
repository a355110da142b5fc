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
//    (grid <= one block per SM), instead of a launch per stage.
//  * The factor is right-looking and ordered by dataflow, not by grid
//    barriers: block 0 (the owner) walks the diagonal; its stage s forms
//    the panel L_{s,s-1} = A_{s,s-1} inv(L_{s-1,s-1})^T, applies it to
//    tile (s, s), factors and inverts that tile once and hands Dinv_s on.
//    The other blocks (workers) take the rest of the panels and the
//    trailing updates, tile by tile in a fixed list order (block column
//    by block column), each as soon as its inputs are final: one flag
//    word per tile in global memory counts the block columns applied to
//    it (release store, acquire spin), from a per-call base, so the
//    caller zeroes the words once.  Tiles (s, s-1) and (s, s) receive
//    column s - 2 while the owner is still in stage s - 1, so the chain
//    is nb diagonal stages of two tile products and one diagonal factor
//    each, with no wait for the slowest tile of a stage (a grid barrier
//    per stage would add one, and so would a diagonal tile factored
//    again by every block of its column).
//  * The 64 x 64 diagonal block is four 16-wide leaves, each one warp
//    (a row per lane factoring, a column of the leaf's inverse per lane
//    beside it, fed by the same pivot column), the panel below each leaf
//    solved by substitution (a row per thread), the trailing update
//    spread over all eight warps, and the inverse's off-diagonal blocks
//    (2 x 2 block inversion) formed by the warps the leaf leaves idle
//    (factor_diag).
//  * W = L^-1 works by block columns in parallel, right-looking: stage s
//    finishes W_{k+s,k} = -Dinv_{k+s} Acc_{k+s,k} for every k and adds
//    L_{i,k+s} W_{k+s,k} to the accumulators of the rows below, so its
//    chain is nb stages of two tile products.
//  * Tile products: fp64 on the tensor cores (DMMA,
//    mma.sync.aligned.m8n8k4.row.col.f64), fp32 on FFMA in true fp32
//    (never TF32: the factor preconditions an fp64-refined solve, and
//    refinement converges only when kappa * (factor error) < 1,
//    interiorpoint_tpu/ops/pallas_chol.py:_dot).  Tiles are staged in
//    shared memory with cp.async; what other blocks of the factor wrote
//    is read through L2.
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

// Shared-memory row stride of a 64 x 64 tile: a row is a whole number of
// 16-byte chunks (cp.async, 16-byte loads), and 16 rows 16 bytes each
// take the minimum two wavefronts (fp32: 68 floats, 17 chunks) or the
// DMMA fragments are conflict-free (fp64: 68 = 4 mod 16 doubles).
template <typename T> struct Ld;
template <> struct Ld<float> { static constexpr int v = 68; };
template <> struct Ld<double> { static constexpr int v = 68; };
template <typename T>
__host__ __device__ constexpr int tile_elems() { return BLK * Ld<T>::v; }

// 16 bytes global -> shared through L2 (what other blocks of a launch
// wrote is never read from a stale line of the SM's L1).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Start copying the 64 x 64 tile at G (row stride ldg, rows 16-byte
// aligned) into S.
template <typename T>
__device__ void tile_load(T* S, const T* G, int ldg) {
  constexpr int LD = Ld<T>::v;
  constexpr int per = 16 / sizeof(T);   // elements per copy
  for (int e = threadIdx.x; e < BLK * BLK / per; e += THREADS) {
    const int r = e / (BLK / per), c = (e % (BLK / per)) * per;
    cp_async16(S + r * LD + c, G + (size_t)r * ldg + c);
  }
}

// ---------------------------------------------------------------------------
// 64 x 64 x 64 tile products, C (registers) += A op(B), A and B tiles in
// shared memory (stride Ld<T>); NT: op(B) = B^T, NN: op(B) = B.
// ---------------------------------------------------------------------------

template <typename T> struct Acc;

// fp32: a 4 x 4 register block per thread (rows 4ty+p, columns tx+16q),
// the k loop in steps of 4 with 16-byte loads of A's rows (and B's rows
// for NT), the sum over k in increasing order.
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
#pragma unroll 2
    for (int k = 0; k < BLK; k += 4) {
      float4 a[4], b[4];   // a[p]: A[4ty+p][k..k+3]; b[q]: op(B)[k..k+3][tx+16q]
#pragma unroll
      for (int p = 0; p < 4; ++p)
        a[p] = *reinterpret_cast<const float4*>(A + (ty * 4 + p) * LD + k);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = tx + 16 * q;
        b[q] = NT ? *reinterpret_cast<const float4*>(B + c * LD + k)
                  : make_float4(B[k * LD + c], B[(k + 1) * LD + c],
                                B[(k + 2) * LD + c], B[(k + 3) * LD + c]);
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float t = fmaf(a[p].x, b[q].x, v[p][q]);
          t = fmaf(a[p].y, b[q].y, t);
          t = fmaf(a[p].z, b[q].z, t);
          v[p][q] = fmaf(a[p].w, b[q].w, t);
        }
    }
  }
  __device__ void mma_nt(const float* A, const float* B) { mma<true>(A, B); }
  __device__ void mma_nn(const float* A, const float* B) { mma<false>(A, B); }
  template <class F> __device__ void each(F f) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) f(ty * 4 + p, tx + 16 * q, v[p][q]);
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

// The diagonal block is factored in four 16-wide panels (a right-looking
// 2 x 2 recursion cut at 16-wide leaves).  A leaf is one warp: lanes 0-15
// hold a row of the leaf each and factor it, lanes 16-31 a column of its
// inverse each, and every pivot's column reaches both halves by
// shuffles.  The pivot loop is unrolled (16 pivots: constant register
// indices, no shared-memory round trip and no warp barrier per pivot;
// 32-pivot loops would be too long to unroll, their instruction fetch
// would set the time).  Between leaves the panel below the leaf is
// solved row by row (leaf_panel), all eight warps form the trailing
// update in 2 x 2 register blocks (in the order of two 32-wide unblocked
// factors joined by a TRSM, whose L the block reproduces), and the warps
// the leaf leaves idle build the inverse's off-diagonal blocks (2 x 2
// block inversion) as soon as their inputs are final.

// The 16 x 16 leaf at (o, o) of Ts (lower triangle read), one warp: L into
// Ts's lower triangle, its inverse (zeros above the diagonal) into the
// same place of Xs.
template <typename T>
__device__ void leaf16(T* Ts, T* Xs, int o, int lane) {
  constexpr int LD = Ld<T>::v;
  const bool fac = lane < 16;
  const int me = lane & 15;
  // fac: v[c] = A[o + me][o + c], updated by the pivots before c;
  // inverse: v[c] = R[c][me], R = I - (the rows of L so far) X.  An entry
  // right of a factor lane's diagonal is never read again, so every lane
  // updates every entry (one warp alone: per-entry predicates would cost
  // more than the updates); a lane past its row takes s = 0, so its dead
  // entries stay as they are.
  T v[16];
#pragma unroll
  for (int u = 0; u < 16; ++u)
    v[u] = fac ? (u <= me ? Ts[(o + me) * LD + o + u] : T(0))
               : (u == me ? T(1) : T(0));
  T* const row = fac ? Ts + (o + me) * LD + o : Xs + o * LD + o + me;
  const int step = fac ? 1 : LD;   // row[j * step]: L[me][j] or X[j][me]
  // correctly rounded sqrt and division, as LAPACK's: near-singular pivots
  // amplify the error of rsqrt's approximation, and the fp32 factor's
  // preconditioning of the deep K1 states does not tolerate it
  T d = sqrt(__shfl_sync(FULL, v[0], 0));   // NaN if not positive
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const T q = v[j] / d;   // L[me][j] (fac, me > j) or X[j][me]
    const T s = !fac || me > j ? q : (me == j ? d : T(0));
    if (j < 15) {
      // the next pivot from lane j + 1's own a - l^2 (the value its
      // v[j + 1] takes below, bit for bit), ahead of the other entries
      d = sqrt(__shfl_sync(FULL, fma(-s, s, v[j + 1]), j + 1));
      // column j's entries L[c][j] from lanes c, all shuffles in flight
      // before the updates (one register for all of them would pay each
      // shuffle's latency in turn)
      T lc[16];
#pragma unroll
      for (int c = j + 1; c < 16; ++c) lc[c] = __shfl_sync(FULL, s, c);
#pragma unroll
      for (int c = j + 1; c < 16; ++c) v[c] = fma(-s, lc[c], v[c]);
    }
    if (!fac || me >= j) row[j * step] = s;
  }
}

// Row r of the panel below the leaf at (o, o): L[r][o:o+16] = A[r][o:o+16]
// inv(L_pp)^T by substitution, the columns in order, each entry divided
// by its pivot and applied at once to the entries right of it (as the
// reference's unblocked factor and LAPACK's trsm): backward stable, where
// a product with the leaf's computed inverse, A W_pp^T, carries W_pp's
// rounding amplified by cond(L_pp).
template <typename T>
__device__ __forceinline__ void leaf_panel(T* Ts, int o, int r) {
  constexpr int LD = Ld<T>::v;
  T* const row = Ts + r * LD + o;
  const T* const L = Ts + o * LD + o;
  T v[16];
#pragma unroll
  for (int u = 0; u < 16; ++u) v[u] = row[u];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    v[j] = v[j] / L[j * LD + j];
#pragma unroll
    for (int c = j + 1; c < 16; ++c) v[c] = fma(-v[j], L[c * LD + j], v[c]);
  }
#pragma unroll
  for (int u = 0; u < 16; ++u) row[u] = v[u];
}

// c (an R x C register block) += A op(B) over K, from shared-memory tiles
// of row stride Ld<T>: c[p][j] += A[ar + p][ac + q] * op(B)[q][j] with
// op(B)[q][j] = B[br + j][bc + q] (NT) or B[br + q][bc + j] (NN), q in
// increasing order.
template <typename T, bool NT, int R, int C>
__device__ __forceinline__ void blk(T (&c)[R][C], const T* A, int ar, int ac,
                                    const T* B, int br, int bc, int K) {
  constexpr int LD = Ld<T>::v;
#pragma unroll 4
  for (int q = 0; q < K; ++q) {
    T a[R], b[C];
#pragma unroll
    for (int p = 0; p < R; ++p) a[p] = A[(ar + p) * LD + ac + q];
#pragma unroll
    for (int j = 0; j < C; ++j)
      b[j] = NT ? B[(br + j) * LD + bc + q] : B[(br + q) * LD + bc + j];
#pragma unroll
    for (int p = 0; p < R; ++p)
#pragma unroll
      for (int j = 0; j < C; ++j) c[p][j] = fma(a[p], b[j], c[p][j]);
  }
}

template <typename T, int R, int C>
__device__ __forceinline__ void blk_zero(T (&c)[R][C]) {
#pragma unroll
  for (int p = 0; p < R; ++p)
#pragma unroll
    for (int j = 0; j < C; ++j) c[p][j] = T(0);
}

// S[r0 + p][c0 + j] = sign * c[p][j]
template <typename T, int R, int C>
__device__ __forceinline__ void blk_store(T* S, int r0, int c0,
                                          const T (&c)[R][C], T sign) {
  constexpr int LD = Ld<T>::v;
#pragma unroll
  for (int p = 0; p < R; ++p)
#pragma unroll
    for (int j = 0; j < C; ++j) S[(r0 + p) * LD + c0 + j] = sign * c[p][j];
}

// Lower tile index t -> (ii, jj), jj <= ii.
__device__ __forceinline__ void lower_tile(int t, int* ii, int* jj) {
  int i = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  while (i * (i + 1) / 2 > t) --i;
  *ii = i;
  *jj = t - i * (i + 1) / 2;
}

// Warps 1-7 alone (the leaf runs on warp 0 meanwhile).
__device__ __forceinline__ void bar_side() {
  asm volatile("bar.sync 1, 224;\n" ::: "memory");
}

// Factor the diagonal tile Ts (lower triangle read) in place and write its
// inverse, lower with zeros above, to Xs.  Ends synchronised.  16-blocks: L_pq, W_pq of the
// inverse; W_pp from the leaves, W10 = -W11 (L10 W00), W32 = -W33 (L32
// W22), and the lower-left 32 x 32 block -W_B (L_BA W_A).
template <typename T>
__device__ void factor_diag(T* Ts, T* Xs) {
  constexpr int LD = Ld<T>::v;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int st = tid - 32;   // a side warp's thread (warps 1-7)
  T c[2][2];
#pragma unroll 1
  for (int p = 0; p < 4; ++p) {
    const int o = 16 * p;
    if (warp == 0) {
      leaf16(Ts, Xs, o, lane);
    } else if (p == 0) {
      // the inverse's 16-blocks above the diagonal
      for (int e = st; e < BLK * BLK; e += THREADS - 32) {
        const int r = e / BLK, cc = e % BLK;
        if (cc / 16 > r / 16) Xs[r * LD + cc] = T(0);
      }
    } else if (p == 2) {
      // W10 = -W11 (L10 W00), beside leaf 2
      const int rb = 16 + 2 * ((st >> 3) & 7), cb = 2 * (st & 7);
      if (st < 64) {
        blk_zero(c);
        blk<T, false>(c, Ts, rb, 0, Xs, 0, cb, 16);
        blk_store(Xs, rb, cb, c, T(1));
      }
      bar_side();
      if (st < 64) {
        blk_zero(c);
        blk<T, false>(c, Xs, rb, 16, Xs, 16, cb, 16);
      }
      bar_side();
      if (st < 64) blk_store(Xs, rb, cb, c, T(-1));
    } else if (p == 3) {
      if (st < 128) {
        // P = L_BA W_A into the lower-left 32 x 32 block, beside leaf 3
        T c4[2][4];
        const int rb = 32 + 2 * (st >> 3), cb = 4 * (st & 7);
        blk_zero(c4);
        blk<T, false>(c4, Ts, rb, 0, Xs, 0, cb, 32);
        blk_store(Xs, rb, cb, c4, T(1));
      } else if (st < 192) {
        // L32 W22 into W32's place
        const int rb = 48 + 2 * ((st >> 3) & 7), cb = 32 + 2 * (st & 7);
        blk_zero(c);
        blk<T, false>(c, Ts, rb, 32, Xs, 32, cb, 16);
        blk_store(Xs, rb, cb, c, T(1));
      }
    }
    __syncthreads();
    if (p == 3) break;
    // the panel below the leaf by substitution, one row per thread
    const int nr = 48 - o;
    if (tid < nr) leaf_panel(Ts, o, o + 16 + tid);
    __syncthreads();
    // the trailing update, 2 x 2 blocks, in the order of two 32-wide
    // unblocked factors joined by a TRSM and a 32-deep update: after
    // leaves 0 and 2 the next leaf's columns, each entry updated in turn
    // by the leaf's 16 columns as a pivot updates it; after leaf 1 the
    // lower right 32 x 32 block, the sum over columns 0-31 from zero, then
    // subtracted.  The block's L is that order's bit for bit: the order
    // decides which matrices at the fp32 floor the factor accepts, and
    // blocked 16-wide updates refused some that it and cuSOLVER accept.
    if (p != 1) {
      for (int t = tid; t < 4 * nr; t += THREADS) {
        const int tr = o + 16 + 2 * (t >> 3), tc = o + 16 + 2 * (t & 7);
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < 2; ++b) c[a][b] = Ts[(tr + a) * LD + tc + b];
#pragma unroll 4
        for (int q = 0; q < 16; ++q)
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int b = 0; b < 2; ++b)
              c[a][b] = fma(-Ts[(tr + a) * LD + o + q],
                            Ts[(tc + b) * LD + o + q], c[a][b]);
        blk_store(Ts, tr, tc, c, T(1));
      }
    } else {
      for (int t = tid; t < 16 * 17 / 2; t += THREADS) {
        int bi, bj;
        lower_tile(t, &bi, &bj);
        const int tr = 32 + 2 * bi, tc = 32 + 2 * bj;
        blk_zero(c);
        blk<T, true>(c, Ts, tr, 0, Ts, tc, 0, 32);
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < 2; ++b) Ts[(tr + a) * LD + tc + b] -= c[a][b];
      }
    }
    __syncthreads();
  }
  // W32 = -W33 (L32 W22)
  const int rb = 48 + 2 * ((tid >> 3) & 7), cb = 32 + 2 * (tid & 7);
  if (tid < 64) {
    blk_zero(c);
    blk<T, false>(c, Xs, rb, 48, Xs, 48, cb, 16);
  }
  __syncthreads();
  if (tid < 64) blk_store(Xs, rb, cb, c, T(-1));
  __syncthreads();
  // the lower-left 32 x 32 block: -W_B P
  const int rl = 32 + 2 * (tid >> 4), cl = 2 * (tid & 15);
  blk_zero(c);
  blk<T, false>(c, Xs, rl, 32, Xs, 32, cl, 32);
  __syncthreads();
  blk_store(Xs, rl, cl, c, T(-1));
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The factor: one cooperative launch, ordered by flags
// ---------------------------------------------------------------------------

template <typename T>
struct FactorArgs {
  const T* src;   // the source, row stride lds; tril(src[:n, :n]) is read
  T* A;           // np x np: the working matrix, then L
  T* Dinv;        // np x BLK: the inverted diagonal blocks
  int* bad;
  const int* after;
  u64* fl;        // ip_chol_flag_words(np) flag words
  u64 base;       // this call's flag base
  T delta;
  int n, lds, np;
};

// Tile (i, j)'s flag (j <= i): base + the block columns whose update it
// has received; base + j + 1 once it holds L_ij (j < i) or, on the
// diagonal, once Dinv_j is written.
template <typename T>
__device__ __forceinline__ u64* tflag(const FactorArgs<T>& a, int i, int j) {
  return a.fl + (size_t)i * (a.np / BLK) + j;
}

// Thread 0 waits until tile (i, j)'s flag reaches base + v (at v = 0 there
// is nothing to wait for: the word may hold an earlier call's count); the
// caller's barrier then lets the block on.  A wait past 2 s can only be a
// fault of the schedule: it traps (the launch fails) instead of hanging.
template <typename T>
__device__ void wait_count(const FactorArgs<T>& a, int i, int j, int v) {
  if (threadIdx.x != 0 || v == 0) return;
  const u64* f = tflag(a, i, j);
  const u64 target = a.base + v;
  if (ld_acquire64(f) >= target) return;
  const u64 t0 = globaltimer();
  while (ld_acquire64(f) < target) {
    if (globaltimer() - t0 > 2000000000ull) __trap();
    __nanosleep(20);
  }
}

// The block's stores are done; tile (i, j)'s flag becomes base + v (the
// barrier orders every thread's stores before thread 0's release, which
// is cumulative).
template <typename T>
__device__ void publish(const FactorArgs<T>& a, int i, int j, int v) {
  __syncthreads();
  if (threadIdx.x == 0) st_release64(tflag(a, i, j), a.base + v);
}

// tril(src[:n, :n]) + delta I with identity padding, entry (i, j).
template <typename T>
__device__ __forceinline__ T src_at(const FactorArgs<T>& a, int i, int j) {
  if (j > i) return T(0);
  if (i < a.n && j < a.n)
    return a.src[(size_t)i * a.lds + j] + (i == j ? a.delta : T(0));
  return i == j ? T(1) : T(0);
}

// Source tile (ib, jb) into S (all loads in flight before the stores).
template <typename T>
__device__ void src_tile(T* S, const FactorArgs<T>& a, int ib, int jb) {
  constexpr int LD = Ld<T>::v, PER = BLK * BLK / THREADS;
  T v[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int e = threadIdx.x + q * THREADS;
    v[q] = src_at(a, ib * BLK + e / BLK, jb * BLK + e % BLK);
  }
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int e = threadIdx.x + q * THREADS;
    S[(e / BLK) * LD + e % BLK] = v[q];
  }
}

// Tiles G0 (row stride l0) and, unless null, G1 (l1), written by other
// blocks of this launch, into S0 and S1 through L2; each thread's own
// copies are done on return.
template <typename T>
__device__ void load_l2(T* S0, const T* G0, int l0, T* S1, const T* G1,
                        int l1) {
  tile_load(S0, G0, l0);
  if (G1) tile_load(S1, G1, l1);
  cp_async_wait();
}

// The workers' tasks of block column c (nb block columns): the panels
// L_ic, i >= c + 2, then the update of the trailing tiles (i, j),
// c < j <= i, all but (c + 1, c + 1) (the owner's).
__host__ __device__ __forceinline__ int column_tasks(int nb, int c) {
  const int m = nb - c - 1;
  return m < 1 ? 0 : (m - 1) + m * (m + 1) / 2 - 1;
}
__host__ __device__ __forceinline__ int worker_tasks(int nb) {
  int t = 0;
  for (int c = 0; c + 1 < nb; ++c) t += column_tasks(nb, c);
  return t;
}

// Block 0 walks the diagonal: stage s forms the panel L_{s,s-1} (its
// tile has columns < s - 1 applied by the workers), applies it to tile
// (s, s), factors and inverts that tile, and hands Dinv_s on.
template <typename T>
__device__ void factor_owner(const FactorArgs<T>& a, T* sm) {
  constexpr int LD = Ld<T>::v;
  T* Ts = sm;
  T* Xs = sm + tile_elems<T>();   // inv(L_ss), kept for the next panel
  T* Ps = sm + 2 * tile_elems<T>();
  const int np = a.np, nb = np / BLK;
  auto at = [&](int ib, int jb) {
    return a.A + (size_t)ib * BLK * np + jb * BLK;
  };
  for (int s = 0; s < nb; ++s) {
    if (s == 0) {
      src_tile(Ts, a, 0, 0);
      __syncthreads();
    } else {
      wait_count(a, s, s - 1, s - 1);
      wait_count(a, s, s, s - 1);
      __syncthreads();
      if (s == 1) {
        src_tile(Ps, a, 1, 0);
        src_tile(Ts, a, 1, 1);
      } else {
        load_l2(Ps, at(s, s - 1), np, Ts, at(s, s), np);
      }
      __syncthreads();
      Acc<T> acc;
      acc.zero();
      acc.mma_nt(Ps, Xs);   // L_{s,s-1} = A_{s,s-1} inv(L_{s-1,s-1})^T
      __syncthreads();
      T* dst = at(s, s - 1);
      acc.each([&](int r, int c, T v) {
        Ps[r * LD + c] = v;
        dst[(size_t)r * np + c] = v;
      });
      publish(a, s, s - 1, s);
      acc.zero();
      acc.mma_nt(Ps, Ps);
      acc.each([&](int r, int c, T v) { Ts[r * LD + c] -= v; });
      __syncthreads();
    }
    factor_diag(Ts, Xs);
    // Dinv_s, then its flag, then L_ss (read by no other block), 16
    // bytes a store
    constexpr int V = 16 / sizeof(T);
    int local_bad = 0;
    for (int e = threadIdx.x * V; e < BLK * BLK; e += THREADS * V) {
      const int r = e / BLK, c = e % BLK;
      const int4 x = *reinterpret_cast<const int4*>(Xs + r * LD + c);
      *reinterpret_cast<int4*>(a.Dinv + (size_t)(s * BLK + r) * BLK + c) = x;
#pragma unroll
      for (int u = 0; u < V; ++u)
        if (!isfinite(Xs[r * LD + c + u])) local_bad = 1;
    }
    if (local_bad) atomicExch(a.bad, 1);   // only ever set: order-free
    publish(a, s, s, s + 1);
    T* dst = at(s, s);
    for (int e = threadIdx.x * V; e < BLK * BLK; e += THREADS * V) {
      const int r = e / BLK, c = e % BLK;
      union {
        T t[V];
        int4 v;
      } x;
#pragma unroll
      for (int u = 0; u < V; ++u)
        x.t[u] = c + u <= r ? Ts[r * LD + c + u] : T(0);
      *reinterpret_cast<int4*>(dst + (size_t)r * np + c) = x.v;
    }
  }
}

// Worker w of W: the tasks t = w, w + W, ... of the list column by column
// (column_tasks), then the zero tiles above the diagonal.  Every task
// waits only for the owner's earlier stages and for tasks earlier in the
// list, and every block is resident, so the waits cannot deadlock.
template <typename T>
__device__ void factor_worker(const FactorArgs<T>& a, T* sm, int w, int W) {
  T* S0 = sm;
  T* S1 = sm + tile_elems<T>();
  const int np = a.np, nb = np / BLK;
  auto at = [&](int ib, int jb) {
    return a.A + (size_t)ib * BLK * np + jb * BLK;
  };
  const int ntask = worker_tasks(nb), nzero = nb * (nb - 1) / 2;
  int k = 0, k0 = 0, kn = column_tasks(nb, 0);   // the task's column
  for (int t = w; t < ntask + nzero; t += W) {
    if (t >= ntask) {
      int ii, jj;
      lower_tile(t - ntask, &ii, &jj);
      T* dst = at(jj, ii + 1);
      for (int e = threadIdx.x; e < BLK * BLK; e += THREADS)
        dst[(size_t)(e / BLK) * np + e % BLK] = T(0);
      continue;
    }
    while (t >= k0 + kn) {
      k0 += kn;
      kn = column_tasks(nb, ++k);
    }
    const int u = t - k0, m = nb - k - 1;
    Acc<T> acc;
    acc.zero();
    if (u < m - 1) {
      // the panel L_ik = A_ik inv(L_kk)^T
      const int i = k + 2 + u;
      wait_count(a, k, k, k + 1);
      wait_count(a, i, k, k);
      __syncthreads();
      if (k == 0) {
        src_tile(S0, a, i, 0);
        load_l2<T>(S1, a.Dinv, BLK, S1, nullptr, 0);
      } else {
        load_l2(S0, at(i, k), np, S1, a.Dinv + (size_t)k * BLK * BLK, BLK);
      }
      __syncthreads();
      acc.mma_nt(S0, S1);
      T* dst = at(i, k);
      acc.each([&](int r, int c, T v) { dst[(size_t)r * np + c] = v; });
      publish(a, i, k, k + 1);
    } else {
      // A_ij -= L_ik L_jk^T
      int ii, jj;
      lower_tile(u - (m - 1) + 1, &ii, &jj);
      const int i = k + 1 + ii, j = k + 1 + jj;
      wait_count(a, i, k, k + 1);
      wait_count(a, j, k, k + 1);
      wait_count(a, i, j, k);
      __syncthreads();
      load_l2(S0, at(i, k), np, S1, at(j, k), np);
      __syncthreads();
      acc.mma_nt(S0, S1);
      T* dst = at(i, j);
      acc.each([&](int r, int c, T v) {
        T* p = dst + (size_t)r * np + c;
        const T old = k == 0 ? src_at(a, i * BLK + r, j * BLK + c)
                             : __ldcg(p);
        *p = old - v;
      });
      publish(a, i, j, k + 1);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
chol_factor_kernel(const FactorArgs<T> a) {
  if (a.after && *a.after == 0) return;   // every block, before any flag
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  if (blockIdx.x == 0)
    factor_owner(a, sm);
  else
    factor_worker(a, sm, blockIdx.x - 1, gridDim.x - 1);
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
                   T* __restrict__ W, T* __restrict__ Acc_, int np,
                   const int* after) {
  if (after && *after == 0) return;   // every block, before any barrier
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
// barrier step's LDL solve, where the faster kernels cannot take it:
// csrc/csolve.cu at p = 1 and csrc/wsolve.cu at p > 1 hold the factor in
// one cluster's shared memory).  TE-row tiles (TE = 64 for K3b's factor,
// 128 for the LDL's); task (i, c) owns block row i for the c-th chunk of
// PC right-hand sides.
//   forward:  y_i = F_i (b_i - sum_{j<i} L_ij y_j)        (F = I if null)
//   middle:   u_i = M_i^T y_i                              (M = I if null)
//   backward: x_i = G_i^T (u_i - sum_{j>i} L_ji^T x_j)     (G = I if null)
// K3b: F = G = Dinv (so L L^T X = B); the LDL solve: M = the tile
// inverses.  Each task publishes its tile (y_i, then x_i, in place in X)
// with a release store of a flag in global memory (the call's number
// `epoch`: the flag words are zeroed once and counted from call to call,
// so nothing is zeroed per call); a task waits for the
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
// One thread spins until the flag reaches this call's number; the block
// then goes on.  A wait longer than 2 s traps rather than hanging.
__device__ __forceinline__ void wait_flag(const u64* f, u64 epoch) {
  if (threadIdx.x == 0) {
    const u64 t0 = globaltimer();
    while (ld_acquire64(f) < epoch) {
      __nanosleep(20);
      if (globaltimer() - t0 > 2000000000ull) __trap();
    }
  }
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
                   u64* flags, u64 epoch) {
  constexpr int SEG = TE / 4;
  __shared__ float ts[TE * PC];   // a published tile, y_j or x_j
  __shared__ float rs[TE * PC];   // a tile through a diagonal product
  const int tid = threadIdx.x, a = tid >> 2, q = tid & 3;
  const int nb = (n + TE - 1) / TE, nch = (p + PC - 1) / PC;
  const int tasks = nb * nch;
  u64* fwd = flags;
  u64* bwd = flags + tasks;

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
  auto publish = [&](int i, int c0, const float* v, u64* flag) {
    const int row = i * TE + a;
    if (q == 0 && row < n)
#pragma unroll
      for (int cc = 0; cc < PC; ++cc)
        if (c0 + cc < p) X[(size_t)row * p + c0 + cc] = v[cc];
    __threadfence();
    __syncthreads();
    if (tid == 0) st_release64(flag, epoch);
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
      wait_flag(fwd + j * nch + t % nch, epoch);
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
    wait_flag(fwd + i * nch + c, epoch);
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
      wait_flag(bwd + j * nch + c, epoch);
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
  const size_t smem = (size_t)ntiles_smem * BLK *
                      (elem == 8 ? Ld<double>::v : Ld<float>::v) * elem;
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

// Flag words of ip_chol_factor at np: one per tile (i, j) of the np / BLK
// block grid.
IP_API size_t ip_chol_flag_words(int np) {
  const size_t nb = np / BLK;
  return nb * nb;
}

// Factor tril(src[:n,:n]) + delta I, identity-padded to np x np, into A
// (np x np, not aliasing src): L in its lower triangle, zeros above, Dinv
// (np x BLK) the inverted diagonal blocks, *bad set when one is not
// finite.  A jitter ladder on the device: with `after` (the previous
// rung's flag, zeroed before that rung) nothing runs unless *after is set,
// so a rung skips itself once an earlier rung's factor was finite (a
// skipped rung leaves its own zeroed flag, and the rungs after it skip
// too).  flags: ip_chol_flag_words(np) u64 words, zero when first used,
// and epoch > 0 larger than at any earlier call on them (the flags count
// from epoch << 16).  One cooperative launch.
template <typename T>
static int chol_factor(const T* src, int n, int lds, double delta, T* A,
                       int np, T* Dinv, int* bad, const int* after,
                       u64* flags, int epoch, cudaStream_t stream) {
  if (np <= 0 || np % BLK || n < 0 || n > np || epoch <= 0 || !flags)
    return (int)cudaErrorInvalidValue;
  const int nb = np / BLK;
  FactorArgs<T> a = {src,   A,    Dinv,           bad,     after, flags,
                     (u64)epoch << 16, (T)delta, n, lds,   np};
  void* args[] = {&a};
  return coop_launch(chol_factor_kernel<T>,
                     1 + worker_tasks(nb) + nb * (nb - 1) / 2, args, 3,
                     sizeof(T), stream);
}

IP_API int ip_chol_factor(const float* src, int n, int lds, double delta,
                          float* A, int np, float* Dinv, int* bad,
                          const int* after, u64* flags, int epoch,
                          cudaStream_t stream) {
  return chol_factor<float>(src, n, lds, delta, A, np, Dinv, bad, after,
                            flags, epoch, stream);
}

IP_API int ip_chol_factor64(const double* src, int n, int lds, double delta,
                            double* A, int np, double* Dinv, int* bad,
                            const int* after, u64* flags, int epoch,
                            cudaStream_t stream) {
  return chol_factor<double>(src, n, lds, delta, A, np, Dinv, bad, after,
                             flags, epoch, stream);
}

// W = L^-1 (np x np, lower) from the factor and Dinv; acc is an np x np
// scratch of the same type.  With `after` (a device flag, or null) nothing
// runs unless *after is set (K2's Cholesky fallback, taken on the device:
// W is then left as it was).  One cooperative launch.
template <typename T>
static int chol_invert(const T* L, const T* Dinv, T* W, T* acc, int np,
                       const int* after, cudaStream_t stream) {
  const int nb = np / BLK;
  void* args[] = {&L, &Dinv, &W, &acc, &np, &after};
  return coop_launch(chol_invert_kernel<T>, nb * nb, args, 3, sizeof(T),
                     stream);
}

IP_API int ip_chol_invert(const float* L, const float* Dinv, float* W,
                          float* acc, int np, const int* after,
                          cudaStream_t stream) {
  return chol_invert<float>(L, Dinv, W, acc, np, after, stream);
}

IP_API int ip_chol_invert64(const double* L, const double* Dinv, double* W,
                            double* acc, int np, const int* after,
                            cudaStream_t stream) {
  return chol_invert<double>(L, Dinv, W, acc, np, after, stream);
}

// K2's pivot floor on the first rung of its Cholesky fallback
// (ops/refine.py factor_jittered_device(pivot_floor=True)): *bad |= 1 when
// the smallest L_ii^2 of the leading n is at or below floor2 or is not
// finite.  One block; with `after` nothing runs unless *after is set (the
// rung itself was skipped).  Replaces the host read of the TPU kernel's
// own test, which ops/refine.py factor_jittered takes on the host.
__global__ void __launch_bounds__(256)
pivot_floor_kernel(const float* __restrict__ L, int ld, int n, float floor2,
                   const int* after, int* bad) {
  __shared__ int hit;
  if (after && *after == 0) return;
  if (threadIdx.x == 0) hit = 0;
  __syncthreads();
  int h = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float p = L[(size_t)i * ld + i];
    const float p2 = p * p;
    if (!(p2 > floor2)) h = 1;   // a NaN pivot too
  }
  if (h) atomicOr(&hit, 1);
  __syncthreads();
  if (threadIdx.x == 0 && hit) *bad = 1;
}

IP_API int ip_pivot_floor(const float* L, int ld, int n, double floor2,
                          const int* after, int* bad, cudaStream_t stream) {
  if (n <= 0 || ld < n) return (int)cudaErrorInvalidValue;
  pivot_floor_kernel<<<1, 256, 0, stream>>>(L, ld, n, (float)floor2, after,
                                            bad);
  return ip_status();
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

// Columns a task of ip_block_solve: one at p = 1 (a single right-hand
// side past csolve.cu's rows), else 8.
static int solve_pc(int p) { return p == 1 ? 1 : 8; }
// Flag words of ip_block_solve for n rows, p right-hand sides, tile edge
// te: two per task.
IP_API size_t ip_block_solve_flags(int n, int p, int te) {
  const size_t pc = solve_pc(p), nb = (n + te - 1) / te,
               nch = (p + pc - 1) / pc;
  return 2 * nb * nch;
}

template <int TE, int PC>
static int block_solve(const float* L, int ldl, int n, const float* F,
                       const float* M, const float* G, const float* B,
                       float* X, int p, u64* flags, u64 epoch,
                       cudaStream_t stream) {
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
    void* args[] = {&L, &ldl, &n, &F, &M, &G, &B, &X, &p, &flags, &epoch};
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
// row-major) into X, solve_pc(p) columns a task: the route where
// csolve.cu's and wsolve.cu's kernels cannot hold the factor.  flags:
// ip_block_solve_flags u64 words, zero when first used, and call > 0
// larger than at any earlier call on them.
IP_API int ip_block_solve(const float* L, int ldl, int n, int te,
                          const float* F, const float* M, const float* G,
                          const float* B, float* X, int p, u64* flags,
                          int call, cudaStream_t stream) {
  if (n <= 0 || p <= 0) return 0;
  if (call <= 0 || !flags) return (int)cudaErrorInvalidValue;
  const u64 epoch = (u64)call;
  if (te == BLK)
    return p == 1 ? block_solve<BLK, 1>(L, ldl, n, F, M, G, B, X, p, flags,
                                        epoch, stream)
                  : block_solve<BLK, 8>(L, ldl, n, F, M, G, B, X, p, flags,
                                        epoch, stream);
  if (te == 2 * BLK)
    return p == 1 ? block_solve<2 * BLK, 1>(L, ldl, n, F, M, G, B, X, p,
                                            flags, epoch, stream)
                  : block_solve<2 * BLK, 8>(L, ldl, n, F, M, G, B, X, p,
                                            flags, epoch, stream);
  return (int)cudaErrorInvalidValue;
}
