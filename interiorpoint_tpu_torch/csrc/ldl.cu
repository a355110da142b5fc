// The barrier Newton step's preconditioner (K2, ops/hybrid.py): the
// block-LDL factor with Newton-Schulz tile inverses, the cross-step carry
// trial, X^T v and W^T W.  All fp32 on FFMA (never TF32: the factor and
// the carry precondition an fp64-refined solve, for the reason
// interiorpoint_tpu/ops/pallas_chol.py:_dot gives).
//
// Replaces, from interiorpoint_tpu/ops/pallas_newton.py:
//   _ns_tile_inv (:334) and _ldl_ns_stages (:445): ip_ldl_factor;
//   the carry branch of _direction_core (:649-700): ip_ns_refresh;
//   _w_solve(eye), the carry's re-seed after the fallback: ip_gram_tn;
//   the branch of _direction_core (:681-701): ip_k2_decide.
// The carry's v . X runs inside csrc/hop.cu's refined solve.
// The LDL solve (_ldl_solve) is chol.cu's block_solve_kernel.
//
// Bound: latency.  The factor is a chain of nb = np / 128 tile inverses,
// each up to 40 dependent Newton-Schulz iterations of two 128^3 products;
// its bulk, the panels and trailing updates (np^3 / 3 flops), is small.
// The carry trial is a chain of 3 power iterations and up to 12
// iterations of three np^3 products.  Design of ip_ldl_factor, one launch
// per call (a set skip returns at once, bad written 0):
//  * the grid is thread-block clusters of LDL_CS = 16 blocks (the
//    non-portable size; 1.12-1.14x faster than 8 on the main path's
//    shapes, PERF.md); cluster 0 walks the nb stages, the blocks of the
//    other clusters (workers) take the trailing updates;
//  * a tile inverse runs on cluster 0, block b owning rows bR..bR+R-1
//    (R = 128 / LDL_CS = 8) of X and of T = X Ds; per iteration each
//    block forms its rows of X' = 2X - T X and of T' = X' Ds with
//    register-blocked FFMA products (a thread an 8 x 4 block, the k split
//    over the warps and the slices summed in a fixed order), writes its
//    rows of X' and its share of ||I - X' Ds||^2 to a double-buffered
//    exchange in L2, crosses one cluster barrier (hardware, no grid
//    barrier), sums the shares in rank order (every block takes the same
//    branch) and reads all of X' back with cp.async.  An exchange through
//    distributed shared memory was slower: 64 KB a block took ~6.5k
//    cycles from the 15 other blocks' shared memory (generic loads,
//    ld.shared::cluster, or bulk copies alike) against ~1.1k through L2
//    (NVIDIA H100 80GB HBM3; PERF.md, PR 11);
//  * look-ahead: after tile k's inverse, cluster 0 writes the panel
//    L_{k+1,k} = A_{k+1,k} X_k and updates tile (k+1, k+1) itself (the
//    same row split), then starts tile k+1's inverse while the workers
//    apply stage k to the other trailing tiles, a quarter tile (32 rows)
//    per task, the tasks in stage order and column k+1 first;
//  * the stages are ordered through flags in global memory (release and
//    acquire): per quarter tile the stages applied to it, per tile
//    inverse that X_k is in Dinv, and one that a tile failed (every later
//    stage then stops).  The flags count from a base of (call << 16), so
//    the caller's flag words are zeroed once, when allocated;
//  * the grid is at most the clusters the card holds at once, so every
//    block is resident and no wait can starve (a wait past 2 s traps).
// The carry trial works on np <= 512 (ns_carry_supported): one cooperative
// launch over the SMs; each pass a set of 32 x 32 (32 x 16 at np <= 256)
// output tiles, both operands staged row-major by cp.async (a block that
// keeps one tile of the residual-and-T pass keeps its Hs part staged), a
// thread a 4 x 4 block of FFMAs, the k split over thread groups and summed
// in a fixed order, the epilogue (2X - T X, the residual's shares) fused.
// Per iteration two grid barriers: R = I - Hs X and T = X Hs in one pass,
// then X' = 2X - T X; each power-iteration matvec is one pass.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int TB = 128;            // the LDL tile edge (the TPU's BLK)
constexpr int TLD = TB + 4;        // shared row stride (16-byte rows)
constexpr int NT = 256;            // threads of every block here
constexpr int QR = 32;             // rows of a worker's task
constexpr int RED = 8192;          // floats of the split-k scratch
constexpr int LDL_CS = 16;         // blocks of a cluster of the factor
constexpr int LDL_R = TB / LDL_CS; // rows of a tile inverse per block
constexpr int NS_ITERS = 40;       // _ns_tile_inv: iteration cap,
constexpr float NS_TOL2 = 1e-6f;   //   convergence target,
constexpr float NS_GATE2 = 1e-4f;  //   acceptance gate
// dynamic shared memory of ip_ldl_factor (floats): the larger of cluster
// 0's (Ds, X, the scratch, a product's rows and the block's rows,
// vectors) and a worker's (X_k, A_jk^T, the rows of A_ik and of the
// panel, a product's rows, the scratch)
constexpr int cl_floats(int R) {
  return 2 * TB * TLD + RED + 2 * R * TLD + 3 * TB + 32 + 32;
}
constexpr int WK_FLOATS = 2 * TB * TLD + 3 * QR * TLD + RED;
constexpr int LDL_SMEM =
    4 * (cl_floats(LDL_R) > WK_FLOATS ? cl_floats(LDL_R) : WK_FLOATS);
constexpr int CARRY_ITERS = 12;      // _NS_ITERS
constexpr float CARRY_GATE2 = 1e-4f; // _NS_GATE2
constexpr int CARRY_MAX_NP = 512;    // _NS_MAX_RP
constexpr int CT = 32;               // carry tile rows (and X^T v, W^T W)
constexpr int CLD = CT + 4;
constexpr int CRED = 4096;           // floats of the carry's split-k scratch
// dynamic shared memory of the carry trial: a tile's rows of A and
// columns of B over the whole k, the scratch, the tile, u
constexpr int CARRY_SMEM = (CT * (CARRY_MAX_NP + 4) + CARRY_MAX_NP * CLD +
                            CRED + CT * CT + CARRY_MAX_NP) * 4;
// where every block has at most one tile of the residual-and-T pass (np
// <= 256), it keeps that tile's Hs operand staged across iterations: rows
// (CT x (np + 4)) or columns (np x CLD)
constexpr int CARRY_RES = 256 * CLD;
constexpr int CARRY_SMEM_ALL = CARRY_SMEM + CARRY_RES * 4;

IP_API size_t ip_ldl_block() { return TB; }

// u64 flag words of ip_ldl_factor at np: four per tile (i, j) (its
// quarters), one per tile inverse, one for a failure
IP_API size_t ip_ldl_flag_words(int np) {
  const size_t nb = np / TB;
  return 4 * nb * nb + nb + 1;
}

// fp32 scratch of ip_ldl_factor: the tile inverse's exchange, two copies
// of X' and of the blocks' shares of its residual
IP_API size_t ip_ldl_ws_floats() { return 2 * TB * TB + 2 * 32; }

// Sum of v over the block (NT threads), every thread gets it; red: 32
// floats of shared scratch.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = ip_warp_sumf(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
  return s;
}

// Sum of the n floats at g (written by other blocks before a grid
// barrier), by the whole block: the loads in parallel through L2, then
// block_sum's fixed tree, so every block gets the same value.
__device__ float gsum(const float* g, int n, float* red) {
  float v = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) v += __ldcg(g + i);
  return block_sum(v, red);
}

// ---------------------------------------------------------------------------
// The block-LDL factor (_ldl_ns_stages with _ns_tile_inv)
// ---------------------------------------------------------------------------

struct LdlArgs {
  const float* src;  // Hs, np x np
  float* A;          // the working copy
  float* Lt;         // the panels (strictly lower tiles)
  float* Dinv;       // the tile inverses, np x TB
  u64* fl;           // ip_ldl_flag_words(np) flag words
  float* xg;         // ip_ldl_ws_floats() of exchange scratch
  int* bad;
  const int* skip;
  float* stats;
  int np;
  float delta;
  u64 base;          // this call's flag base
};

__device__ __forceinline__ u64* qflag(const LdlArgs& a, int i, int j,
                                      int q) {
  const int nb = a.np / TB;
  return a.fl + ((size_t)(i * nb + j) * 4 + q);
}
__device__ __forceinline__ u64* xflag(const LdlArgs& a, int k) {
  const size_t nb = a.np / TB;
  return a.fl + 4 * nb * nb + k;
}
__device__ __forceinline__ u64* fflag(const LdlArgs& a) {
  const size_t nb = a.np / TB;
  return a.fl + 4 * nb * nb + nb;
}

// Thread 0 waits until *f >= target or a tile has failed; every thread of
// the block gets false in the second case.  sh: an int of shared memory.
// A wait of more than 2 s can only be a fault of the schedule: it traps
// (the launch fails) instead of hanging the card.
__device__ bool wait_ge(const LdlArgs& a, const u64* f, u64 target,
                        int* sh) {
  if (threadIdx.x == 0) {
    int ok = 1;
    const u64 t0 = globaltimer();
    while (ld_acquire64(f) < target) {
      if (ld_acquire64(fflag(a)) > a.base) {
        ok = 0;
        break;
      }
      if (globaltimer() - t0 > 2000000000ull) __trap();
      __nanosleep(32);
    }
    *sh = ok;
  }
  __syncthreads();
  const bool ok = *sh != 0;
  __syncthreads();
  return ok;
}

// Loads in flight per thread when staging through registers: the loads
// of a round are all issued before its stores, so a round pays one L2
// latency, not LD of them.
constexpr int LD = 8;

// 16 bytes global -> shared, through L2 (cp.async.cg), and the wait for
// this thread's copies
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// dst[r * TLD + c] = M[(row0 + r) * ld + col0 + c] (+ delta on the
// diagonal), r < rows, c < TB, by cp.async through L2 (other blocks wrote
// M); the rows from row rot on (mod rows), so that blocks loading one
// tile at once start on different lines.  Ends synchronised.
__device__ void load_rows(float* dst, const float* M, int ld, int row0,
                          int col0, int rows, float delta, int rot) {
  const int n = rows * (TB / 4);
  for (int e = threadIdx.x; e < n; e += NT) {
    const int c = (e % (TB / 4)) * 4, r = (e / (TB / 4) + rot) % rows;
    cp_async16(dst + r * TLD + c, M + (size_t)(row0 + r) * ld + col0 + c);
  }
  cp_async_wait();
  __syncthreads();
  if (delta != 0.f) {
    for (int r = threadIdx.x; r < rows; r += NT) {
      const int c = row0 + r - col0;
      if (c >= 0 && c < TB) dst[r * TLD + c] += delta;
    }
    __syncthreads();
  }
}

// The transpose of a tile: dst[kk * TLD + r] = M[(row0 + r) * ld + col0 +
// kk], r, kk < TB (the lanes on consecutive rows: no bank conflict on the
// stores); rows from rot on.
__device__ void load_transposed(float* dst, const float* M, int ld,
                                int row0, int col0, int rot) {
  constexpr int n = TB * (TB / 4);
  for (int e0 = threadIdx.x; e0 < n; e0 += LD * NT) {
    float4 v[LD];
#pragma unroll
    for (int u = 0; u < LD; ++u) {
      const int e = e0 + u * NT, r = (e + rot) % TB, kk = (e / TB) * 4;
      v[u] = __ldcg(reinterpret_cast<const float4*>(
          M + (size_t)(row0 + r) * ld + col0 + kk));
    }
#pragma unroll
    for (int u = 0; u < LD; ++u) {
      const int e = e0 + u * NT, r = (e + rot) % TB, kk = (e / TB) * 4;
      dst[(kk + 0) * TLD + r] = v[u].x;
      dst[(kk + 1) * TLD + r] = v[u].y;
      dst[(kk + 2) * TLD + r] = v[u].z;
      dst[(kk + 3) * TLD + r] = v[u].w;
    }
  }
}

// O (R x TB) = A B over a k of TB, A (R x TB) and B (TB x TB) row-major in
// shared memory, every row stride TLD.  Warp w takes rows 8 (w % G)..+7
// (G = R / 8 row groups) over k-slice w / G of KS = 8 / G; lane l columns
// 4l..4l+3.  Per 4 k a thread loads 8 float4 of A (one address for the
// whole warp) and 4 of B, and does 128 FFMAs in k order.  The slices are
// summed in slice order through red (RED floats).  Ends synchronised.
template <int R>
__device__ __forceinline__ void prod(const float* Ar, const float* B,
                                     float* O, float* red) {
  constexpr int G = R / 8, KS = 8 / G, KL = TB / KS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = warp % G, s = warp / G;
  float acc[8][4];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;
  const float* a = Ar + g * 8 * TLD;
  const float* b = B + lane * 4;
#pragma unroll 1
  for (int kk = s * KL; kk < (s + 1) * KL; kk += 4) {
    float4 av[8], bv[4];
#pragma unroll
    for (int p = 0; p < 8; ++p)
      av[p] = *reinterpret_cast<const float4*>(a + p * TLD + kk);
#pragma unroll
    for (int t = 0; t < 4; ++t)
      bv[t] = *reinterpret_cast<const float4*>(b + (kk + t) * TLD);
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const float x[4] = {av[p].x, av[p].y, av[p].z, av[p].w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        acc[p][0] = fmaf(x[t], bv[t].x, acc[p][0]);
        acc[p][1] = fmaf(x[t], bv[t].y, acc[p][1]);
        acc[p][2] = fmaf(x[t], bv[t].z, acc[p][2]);
        acc[p][3] = fmaf(x[t], bv[t].w, acc[p][3]);
      }
    }
  }
  float* rs = red + s * (R * TB);
#pragma unroll
  for (int p = 0; p < 8; ++p)
    *reinterpret_cast<float4*>(rs + (g * 8 + p) * TB + lane * 4) =
        make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
  __syncthreads();
  for (int e = threadIdx.x; e < R * TB / 4; e += NT) {
    float4 v = reinterpret_cast<const float4*>(red)[e];
#pragma unroll
    for (int t = 1; t < KS; ++t) {
      const float4 w = reinterpret_cast<const float4*>(red + t * (R * TB))[e];
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    const int r = e / (TB / 4), c = (e % (TB / 4)) * 4;
    *reinterpret_cast<float4*>(O + r * TLD + c) = v;
  }
  __syncthreads();
}

// Cluster 0: the tile inverses X_k ~ D_k^-1 and the look-ahead, block
// rank b owning rows bR..bR+R-1.
__device__ void ldl_cluster(const LdlArgs& a, float* sm, int* sh) {
  cg::cluster_group cl = cg::this_cluster();
  constexpr int R = LDL_R, CS = LDL_CS;
  const int rank = (int)cl.block_rank(), r0 = rank * R;
  const int tid = threadIdx.x;
  float* Ds = sm;                 // [TB][TLD] the scaled tile; A_{k+1,k}^T
  float* Xf = Ds + TB * TLD;      // [TB][TLD] X, every row
  float* red = Xf + TB * TLD;     // [RED]
  float* O = red + RED;           // [R][TLD] a product's rows
  float* Ar = O + R * TLD;        // [R][TLD] this block's rows of T or X'
  float* dsc = Ar + R * TLD;      // [TB]
  float* u = dsc + TB;            // [TB]
  float* v = u + TB;              // [TB]
  float* r32 = v + TB;            // [32]
  float* pall = r32 + 32;         // [32] every block's share, in rank order
  const int np = a.np, nb = np / TB;
  // the exchange goes through L2, double-buffered (parity ph): every
  // block's rows of X' (xg) and share of ||I - X Ds||^2 (pg)
  int ph = 0;
  auto xg = [&]() { return a.xg + ph * TB * TB; };
  auto pg = [&]() { return a.xg + 2 * TB * TB + ph * 32; };
  // every block's share (written before a cluster barrier), summed in
  // rank order: the same value in every block
  auto shares = [&]() {
    if (tid < CS) pall[tid] = __ldcg(pg() + tid);
    __syncthreads();
    float f2 = 0.f;
#pragma unroll
    for (int b = 0; b < CS; ++b) f2 += pall[b];
    return f2;
  };
  for (int k = 0; k < nb; ++k) {
    const int k0 = k * TB;
    // the Schur tile S_k: the source at stage 0, else A (its last update
    // is this cluster's own look-ahead of stage k - 1)
    load_rows(Ds, k == 0 ? a.src : a.A, np, k0, k0, TB, k == 0 ? a.delta : 0.f,
              r0);
    __syncthreads();
    // the local Jacobi pre-scale (IEEE sqrt and division)
    if (tid < TB) dsc[tid] = 1.f / sqrtf(fmaxf(Ds[tid * TLD + tid], 1e-30f));
    __syncthreads();
    for (int e = tid; e < TB * TB / 4; e += NT) {
      const int i = e / (TB / 4), j = (e % (TB / 4)) * 4;
      float4 d = *reinterpret_cast<float4*>(Ds + i * TLD + j);
      d.x *= dsc[i] * dsc[j];
      d.y *= dsc[i] * dsc[j + 1];
      d.z *= dsc[i] * dsc[j + 2];
      d.w *= dsc[i] * dsc[j + 3];
      *reinterpret_cast<float4*>(Ds + i * TLD + j) = d;
    }
    if (tid < TB) u[tid] = 1.f / sqrtf((float)TB);
    __syncthreads();
    // lambda_max of Ds by 3 power iterations (every block the same): warp
    // w forms rows 16w..16w+15 of Ds u, a float4 of each row a lane, the
    // 16 warp sums in flight together
    float lam = 1.f;
    for (int it = 0; it < 3; ++it) {
      const int lane = tid & 31, w16 = (tid >> 5) * (TB / 8);
      const float4 uw = *reinterpret_cast<const float4*>(u + lane * 4);
      float s[TB / 8];
#pragma unroll
      for (int q = 0; q < TB / 8; ++q) {
        const float4 d =
            *reinterpret_cast<const float4*>(Ds + (w16 + q) * TLD + lane * 4);
        s[q] = fmaf(d.w, uw.w, fmaf(d.z, uw.z, fmaf(d.y, uw.y, d.x * uw.x)));
      }
#pragma unroll
      for (int q = 0; q < TB / 8; ++q) {
        s[q] = ip_warp_sumf(s[q]);
        if (lane == q) v[w16 + q] = s[q];
      }
      __syncthreads();
      const float vi = tid < TB ? v[tid] : 0.f;
      lam = sqrtf(block_sum(vi * vi, r32));
      if (tid < TB) u[tid] = vi / fmaxf(lam, 1e-30f);
      __syncthreads();
    }
    const float x0 = 1.f / fmaxf(lam, 1e-30f);
    for (int e = tid; e < TB * TB / 4; e += NT) {
      const int i = e / (TB / 4), j = (e % (TB / 4)) * 4;
      *reinterpret_cast<float4*>(Xf + i * TLD + j) =
          make_float4(i == j ? x0 : 0.f, i == j + 1 ? x0 : 0.f,
                      i == j + 2 ? x0 : 0.f, i == j + 3 ? x0 : 0.f);
    }
    // T = X0 Ds (x0 Ds exactly) on this block's rows, and their share of
    // ||I - T||^2
    float f = 0.f;
    for (int e = tid; e < R * TB; e += NT) {
      const int r = e / TB, c = e % TB;
      const float t = x0 * Ds[(r0 + r) * TLD + c];
      Ar[r * TLD + c] = t;
      const float rv = (r0 + r == c ? 1.f : 0.f) - t;
      f = fmaf(rv, rv, f);
    }
    f = block_sum(f, r32);
    if (tid == 0) pg()[rank] = f;
    cl.sync();
    float f2 = shares();
    ph ^= 1;
    int it = 0;
    for (; it < NS_ITERS && f2 > NS_TOL2 && f2 < 1e10f && isfinite(f2);
         ++it) {
      // X' = 2X - T X on this block's rows (the symmetric form)
      prod<R>(Ar, Xf, O, red);
      float* xs = xg() + r0 * TB;
      for (int e = tid; e < R * TB / 4; e += NT) {
        const int r = e / (TB / 4), c = (e % (TB / 4)) * 4;
        const float4 x =
            *reinterpret_cast<const float4*>(Xf + (r0 + r) * TLD + c);
        const float4 o = *reinterpret_cast<const float4*>(O + r * TLD + c);
        const float4 xn = make_float4(2.f * x.x - o.x, 2.f * x.y - o.y,
                                      2.f * x.z - o.z, 2.f * x.w - o.w);
        *reinterpret_cast<float4*>(xs + r * TB + c) = xn;
        *reinterpret_cast<float4*>(Ar + r * TLD + c) = xn;
      }
      __syncthreads();
      // T' = X' Ds on them, and their share of ||I - T'||^2
      prod<R>(Ar, Ds, O, red);
      f = 0.f;
      for (int e = tid; e < R * TB; e += NT) {
        const int r = e / TB, c = e % TB;
        const float t = O[r * TLD + c];
        Ar[r * TLD + c] = t;
        const float rv = (r0 + r == c ? 1.f : 0.f) - t;
        f = fmaf(rv, rv, f);
      }
      f = block_sum(f, r32);
      if (tid == 0) pg()[rank] = f;
      // the exchange: every block's share, then every row of X' (from
      // the next block's rows on)
      cl.sync();
      f2 = shares();
      load_rows(Xf, xg(), TB, 0, 0, TB, 0.f, r0 + R);
      ph ^= 1;
    }
    // undo the pre-scale: Xf becomes X_k as the panels use it; a tile
    // that missed the gate is poisoned
    const bool miss = !(f2 <= NS_GATE2);   // NaN misses too
    for (int e = tid; e < TB * TB / 4; e += NT) {
      const int i = e / (TB / 4), j = (e % (TB / 4)) * 4;
      float4 x = *reinterpret_cast<float4*>(Xf + i * TLD + j);
      x.x = dsc[i] * x.x * dsc[j];
      x.y = dsc[i] * x.y * dsc[j + 1];
      x.z = dsc[i] * x.z * dsc[j + 2];
      x.w = dsc[i] * x.w * dsc[j + 3];
      *reinterpret_cast<float4*>(Xf + i * TLD + j) = x;
    }
    __syncthreads();
    for (int e = tid; e < R * TB / 4; e += NT) {
      const int r = e / (TB / 4), c = (e % (TB / 4)) * 4;
      const float nan = __int_as_float(0x7fc00000);
      *reinterpret_cast<float4*>(a.Dinv + (size_t)(k0 + r0 + r) * TB + c) =
          miss ? make_float4(nan, nan, nan, nan)
               : *reinterpret_cast<const float4*>(Xf + (r0 + r) * TLD + c);
    }
    if (a.stats && rank == 0 && tid == 0) {
      a.stats[2 * k] = f2;             // the gate's own quantity, and
      a.stats[2 * k + 1] = (float)it;  // the iterations it took
    }
    __threadfence();
    // every block's rows of X_k are in Dinv
    cl.sync();
    if (miss) {
      if (rank == 0 && tid == 0) {
        atomicExch(a.bad, 1);
        __threadfence();
        st_release64(fflag(a), a.base + 1);
      }
      return;
    }
    if (rank == 0 && tid == 0) st_release64(xflag(a, k), a.base + 1);
    if (k + 1 == nb) return;
    // look-ahead: the panel L_{k+1,k} = A_{k+1,k} X_k and tile (k+1, k+1)
    // -= L_{k+1,k} A_{k+1,k}^T on this block's rows; stage k - 1 (the
    // workers') must have landed on both tiles
    const int i = k + 1, i0 = i * TB;
    if (k > 0)
      for (int q = 0; q < 4; ++q) {
        wait_ge(a, qflag(a, i, k, q), a.base + k, sh);
        wait_ge(a, qflag(a, i, i, q), a.base + k, sh);
      }
    const float* S = k == 0 ? a.src : a.A;
    load_transposed(Ds, S, np, i0, k0, r0);            // A_{k+1,k}^T
    load_rows(Ar, S, np, i0 + r0, k0, R, 0.f, 0);      // its rows
    // this thread's entries of the tile, read while the products run
    constexpr int PT = R * TB / NT;
    float cur[PT];
#pragma unroll
    for (int u = 0; u < PT; ++u) {
      const int e = tid + u * NT, r = e / TB, c = e % TB;
      const size_t g = (size_t)(i0 + r0 + r) * np + i0 + c;
      cur[u] = k == 0 ? a.src[g] + (r0 + r == c ? a.delta : 0.f)
                      : __ldcg(a.A + g);
    }
    __syncthreads();
    prod<R>(Ar, Xf, O, red);
    int nonfinite = 0;
    for (int e = tid; e < R * TB; e += NT) {
      const int r = e / TB, c = e % TB;
      const float b = O[r * TLD + c];
      a.Lt[(size_t)(i0 + r0 + r) * np + k0 + c] = b;
      Ar[r * TLD + c] = b;
      if (!isfinite(b)) nonfinite = 1;
    }
    if (nonfinite) atomicExch(a.bad, 1);
    __syncthreads();
    prod<R>(Ar, Ds, O, red);
#pragma unroll
    for (int u = 0; u < PT; ++u) {
      const int e = tid + u * NT, r = e / TB, c = e % TB;
      a.A[(size_t)(i0 + r0 + r) * np + i0 + c] = cur[u] - O[r * TLD + c];
    }
    __threadfence();
    // tile (k+1, k+1) has landed for every block of the cluster
    cl.sync();
  }
}

// A worker: the trailing tasks (k, i, j, q), k < j <= i, (i, j) not
// (k+1, k+1): rows 32q..32q+31 of A_ij -= (A_ik X_k) A_jk^T, the task
// (k, i, i, q) also writing those rows of the panel L_ik = A_ik X_k.  Task t
// of the stage-ordered list is worker t % W's.
__device__ void ldl_worker(const LdlArgs& a, float* sm, int w, int W,
                           int* sh) {
  float* M1 = sm;                 // [TB][TLD] X_k
  float* M2 = M1 + TB * TLD;      // [TB][TLD] A_jk^T
  float* Ar = M2 + TB * TLD;      // [QR][TLD] the rows of A_ik
  float* Br = Ar + QR * TLD;      // [QR][TLD] the rows of B_i
  float* O = Br + QR * TLD;       // [QR][TLD]
  float* red = O + QR * TLD;      // [RED]
  const int np = a.np, nb = np / TB, tid = threadIdx.x;
  const int rot = (w * 8) % TB;   // where this block starts a shared tile
  int t = 0, mk = -1;
  for (int k = 0; k + 1 < nb; ++k) {
    const int k0 = k * TB;
    for (int j = k + 1; j < nb; ++j)
      for (int i = j; i < nb; ++i) {
        if (i == k + 1) continue;   // (k+1, k+1): cluster 0's look-ahead
        for (int q = 0; q < 4; ++q, ++t) {
          if (t % W != w) continue;
          // X_k; then stage k - 1 on the rows read and written
          if (!wait_ge(a, xflag(a, k), a.base + 1, sh)) return;
          if (k > 0) {
            bool ok = wait_ge(a, qflag(a, i, k, q), a.base + k, sh);
            for (int p = 0; p < 4 && ok; ++p)
              ok = wait_ge(a, qflag(a, j, k, p), a.base + k, sh);
            if (ok) ok = wait_ge(a, qflag(a, i, j, q), a.base + k, sh);
            if (!ok) return;
          }
          if (mk != k) {
            load_rows(M1, a.Dinv, TB, k0, 0, TB, 0.f, rot);
            mk = k;
          }
          const float* S = k == 0 ? a.src : a.A;
          load_rows(Ar, S, np, i * TB + q * QR, k0, QR, 0.f, 0);
          load_transposed(M2, S, np, j * TB, k0, rot);
          // this thread's entries of the rows, read while the products run
          constexpr int PT = QR * TB / NT;
          float cur[PT];
#pragma unroll
          for (int u = 0; u < PT; ++u) {
            const int e = tid + u * NT;
            const int gi = i * TB + q * QR + e / TB, gj = j * TB + e % TB;
            const size_t g = (size_t)gi * np + gj;
            cur[u] = k == 0 ? a.src[g] + (gi == gj ? a.delta : 0.f)
                            : __ldcg(a.A + g);
          }
          __syncthreads();
          prod<QR>(Ar, M1, O, red);
          int nonfinite = 0;
          for (int e = tid; e < QR * TB; e += NT) {
            const int r = e / TB, c = e % TB;
            const float b = O[r * TLD + c];
            Br[r * TLD + c] = b;
            if (i == j) {
              a.Lt[(size_t)(i * TB + q * QR + r) * np + k0 + c] = b;
              if (!isfinite(b)) nonfinite = 1;
            }
          }
          if (nonfinite) atomicExch(a.bad, 1);
          __syncthreads();
          prod<QR>(Br, M2, O, red);
#pragma unroll
          for (int u = 0; u < PT; ++u) {
            const int e = tid + u * NT;
            const int gi = i * TB + q * QR + e / TB, gj = j * TB + e % TB;
            a.A[(size_t)gi * np + gj] = cur[u] - O[(e / TB) * TLD + e % TB];
          }
          __threadfence();
          __syncthreads();
          if (tid == 0) st_release64(qflag(a, i, j, q), a.base + k + 1);
        }
      }
  }
}

__global__ void __launch_bounds__(NT, 1) ldl_kernel(const LdlArgs a) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int sh;
  // bad is this kernel's: block 0 clears it before any block can set it
  // (every setter follows block 0's release of X_0 or a cluster barrier)
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.bad = 0;
  if (a.skip && *a.skip) return;   // a carry hit or an earlier rung
  if ((int)blockIdx.x < LDL_CS)
    ldl_cluster(a, sm, &sh);
  else
    ldl_worker(a, sm, blockIdx.x - LDL_CS, gridDim.x - LDL_CS, &sh);
}

// Factor Hs + delta I (np x np, np a multiple of TB; Hs full, symmetric)
// into the panels of Lt (its strictly lower tiles) and the tile inverses
// Dinv (np x TB); A is an np x np working copy; flags
// ip_ldl_flag_words(np) u64 words, zero when first used, and epoch > 0
// larger than at any earlier call on them; ws ip_ldl_ws_floats() floats;
// *bad is set when a tile misses its gate or a panel is not finite;
// nothing runs when skip is not null and *skip != 0 (bad is then 0);
// stats, when not null, gets each tile's final ||I - X Ds||_F^2 and
// iterations (np / TB pairs; a tile after a failed one is left as it
// was).  One launch.
IP_API int ip_ldl_factor(const float* Hs, int np, double delta, float* A,
                         float* Lt, float* Dinv, u64* flags, int epoch,
                         float* ws, int* bad, const int* skip, float* stats,
                         cudaStream_t stream) {
  static bool attr = false;
  static int held = 0;   // clusters the card holds at once
  if (np <= 0 || np % TB || epoch <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
  if (!attr) {
    e = cudaFuncSetAttribute(ldl_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             LDL_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          ldl_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return (int)e;
    }
    attr = true;
  }
  const int nb = np / TB;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = LDL_CS;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = LDL_SMEM;
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  if (held == 0) {
    cfg.gridDim = dim3(LDL_CS);
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, ldl_kernel, &cfg);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return (int)e;
    }
    if (n < 1) return (int)cudaErrorInvalidConfiguration;
    held = n;
  }
  // workers for stage 0's tasks, within what the card holds
  const int tasks = nb > 2 ? 4 * ((nb - 1) * nb / 2 - 1) : 0;
  int wc = (tasks + LDL_CS - 1) / LDL_CS;
  if (wc > held - 1) wc = held - 1;
  if (tasks > 0 && wc < 1) return (int)cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3(LDL_CS * (1 + wc));
  const LdlArgs args = {Hs,   A,    Lt,    Dinv, flags,
                        ws,   bad,  skip,  stats, np,
                        (float)delta, (u64)epoch << 16};
  e = cudaLaunchKernelEx(&cfg, ldl_kernel, args);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return ip_status();
}

// ---------------------------------------------------------------------------
// The carry trial (the Minv branch of _direction_core)
// ---------------------------------------------------------------------------

// O (CT x CW, row-major) = (sa A)(sb B) over the k of np: rows i0.. of A
// and columns j0.. of B (np x np, row-major, read through L2), staged
// row-major in shared memory (Ak, row stride np + 4; Bk, row stride
// CW + 4), each scaled as it is staged.  The threads form groups of
// (CT / 4)(CW / 4), a thread a 4 x 4 block over its group's k-slice: per
// 4 k it loads 4 float4 of A and 4 of B and does 64 FFMAs in k order; the
// slices are summed in slice order through red.  Ends synchronised.
template <int CW>
__device__ void carry_tile(const float* A, float sa, const float* B,
                           float sb, int np, int i0, int j0, float* Ak,
                           float* Bk, float* red, float* O,
                           bool stage_a = true, bool stage_b = true) {
  constexpr int BLD = CW + 4, TPS = (CT / 4) * (CW / 4), KS = NT / TPS;
  const int tid = threadIdx.x, ald = np + 4;
  const int na = CT * np / 4, nbk = np * CW / 4;
  if (stage_a)
    for (int e = tid; e < na; e += NT) {
      const int r = e / (np / 4), kk = (e % (np / 4)) * 4;
      cp_async16(Ak + r * ald + kk, A + (size_t)(i0 + r) * np + kk);
    }
  if (stage_b)
    for (int e = tid; e < nbk; e += NT) {
      const int kk = e / (CW / 4), c = (e % (CW / 4)) * 4;
      cp_async16(Bk + kk * BLD + c, B + (size_t)kk * np + j0 + c);
    }
  cp_async_wait();
  __syncthreads();
  // the seed's scale, applied as staged (the same rounding as scaling it
  // in place first)
  if (sa != 1.f) {
    for (int e = tid; e < na; e += NT) {
      float4* x = reinterpret_cast<float4*>(Ak + (e / (np / 4)) * ald +
                                            (e % (np / 4)) * 4);
      *x = make_float4(sa * x->x, sa * x->y, sa * x->z, sa * x->w);
    }
    __syncthreads();
  }
  if (sb != 1.f) {
    for (int e = tid; e < nbk; e += NT) {
      float4* x = reinterpret_cast<float4*>(Bk + (e / (CW / 4)) * BLD +
                                            (e % (CW / 4)) * 4);
      *x = make_float4(sb * x->x, sb * x->y, sb * x->z, sb * x->w);
    }
    __syncthreads();
  }
  const int s = tid / TPS, l = tid % TPS;
  const int rr = (l / (CW / 4)) * 4, cc = (l % (CW / 4)) * 4;
  const int kl = np / KS;
  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;
#pragma unroll 1
  for (int kk = s * kl; kk < (s + 1) * kl; kk += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
      av[p] = *reinterpret_cast<const float4*>(Ak + (rr + p) * ald + kk);
#pragma unroll
    for (int t = 0; t < 4; ++t)
      bv[t] = *reinterpret_cast<const float4*>(Bk + (kk + t) * BLD + cc);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float x[4] = {av[p].x, av[p].y, av[p].z, av[p].w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        acc[p][0] = fmaf(x[t], bv[t].x, acc[p][0]);
        acc[p][1] = fmaf(x[t], bv[t].y, acc[p][1]);
        acc[p][2] = fmaf(x[t], bv[t].z, acc[p][2]);
        acc[p][3] = fmaf(x[t], bv[t].w, acc[p][3]);
      }
    }
  }
  float* rs = red + s * (CT * CW);
#pragma unroll
  for (int p = 0; p < 4; ++p)
    *reinterpret_cast<float4*>(rs + (rr + p) * CW + cc) =
        make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
  __syncthreads();
  for (int e = tid; e < CT * CW; e += NT) {
    float v = red[e];
#pragma unroll
    for (int t = 1; t < KS; ++t) v += red[t * (CT * CW) + e];
    O[e] = v;
  }
  __syncthreads();
}

// Xn = 2 (sx Xc) - T (sx Xc), CT x CW tiles over the grid
template <int CW>
__device__ void carry_update(const float* T, const float* Xc, float sx,
                             float* Xn, int np, float* Ak, float* Bk,
                             float* red, float* O) {
  constexpr int PT = CT * CW / NT;   // outputs per thread
  const int nc = np / CW, tiles = (np / CT) * nc;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int i0 = (t / nc) * CT, j0 = (t % nc) * CW;
    // this thread's entries of X, read while the product runs
    float xv[PT];
#pragma unroll
    for (int u = 0; u < PT; ++u) {
      const int e = threadIdx.x + u * NT;
      xv[u] = __ldcg(Xc + (size_t)(i0 + e / CW) * np + j0 + e % CW);
    }
    carry_tile<CW>(T, 1.f, Xc, sx, np, i0, j0, Ak, Bk, red, O);
#pragma unroll
    for (int u = 0; u < PT; ++u) {
      const int e = threadIdx.x + u * NT;
      Xn[(size_t)(i0 + e / CW) * np + j0 + e % CW] =
          2.f * (sx * xv[u]) - O[e];
    }
  }
}

// ws: T (np^2), two copies of X (2 np^2), v1, v2 (2 np), tile partials
__global__ void __launch_bounds__(NT, 1)
ns_refresh_kernel(const float* __restrict__ Hs, const float* __restrict__ X0,
                  int np, float* __restrict__ Xo, float* __restrict__ ws,
                  int* __restrict__ hit, float* __restrict__ rho2) {
  extern __shared__ __align__(16) float csm[];
  float* Ak = csm;                           // [CT][np + 4]
  float* Bk = Ak + CT * (CARRY_MAX_NP + 4);  // [np][CLD]
  float* red = Bk + CARRY_MAX_NP * CLD;      // [CRED]
  float* O = red + CRED;                     // [CT * CT]
  float* u = O + CT * CT;                    // [np]
  float* Hr = u + CARRY_MAX_NP;              // [CARRY_RES] a resident Hs
  __shared__ float r32[32];
  cg::grid_group grid = cg::this_grid();
  const size_t nn = (size_t)np * np;
  float* T = ws;
  float* Xb = ws + nn;
  float* v1 = ws + 3 * nn;
  float* v2 = v1 + np;
  float* part = v2 + np;
  const int tid = threadIdx.x, lane = tid & 31;
  const int nt = np / CT, tiles = nt * nt;
  const int w0 = blockIdx.x * (NT / 32) + (tid >> 5);
  const int nw = gridDim.x * (NT / 32);
  // lambda_max(Hs X) by 3 power iterations: v = Hs (X u), u = v / ||v||
  // (u in every block's shared memory, the same in each)
  for (int i = tid; i < np; i += NT) u[i] = 1.f / sqrtf((float)np);
  __syncthreads();
  float lam = 1.f;
  for (int it = 0; it < 3; ++it) {
    for (int i = w0; i < np; i += nw) {
      float s = 0.f;
      for (int j = lane; j < np; j += 32)
        s = fmaf(__ldcg(X0 + (size_t)i * np + j), u[j], s);
      s = ip_warp_sumf(s);
      if (lane == 0) v1[i] = s;
    }
    grid.sync();
    for (int i = w0; i < np; i += nw) {
      float s = 0.f;
      for (int j = lane; j < np; j += 32)
        s = fmaf(__ldcg(Hs + (size_t)i * np + j), __ldcg(v1 + j), s);
      s = ip_warp_sumf(s);
      if (lane == 0) v2[i] = s;
    }
    grid.sync();
    float s = 0.f;
    for (int i = tid; i < np; i += NT) {
      const float vi = __ldcg(v2 + i);
      s = fmaf(vi, vi, s);
    }
    lam = sqrtf(block_sum(s, r32));
    for (int i = tid; i < np; i += NT)
      u[i] = __ldcg(v2 + i) / fmaxf(lam, 1e-30f);
    __syncthreads();
  }
  // X_it = sx Xc: the seed rescaled, then the iterates
  const float* Xc = X0;
  float sx = 1.f / fmaxf(lam, 1e-30f);
  int cur = 0, iters = 0;
  float f2;
  // a block with one tile of the first pass keeps its Hs part staged
  const bool res = 2 * tiles <= (int)gridDim.x && np <= 256;
  for (;;) {
    // the residual's shares of ||I - Hs X||^2 (tile by tile) and T = X Hs
    for (int t = blockIdx.x; t < 2 * tiles; t += gridDim.x) {
      const int tt = t < tiles ? t : t - tiles;
      const int i0 = (tt / nt) * CT, j0 = (tt % nt) * CT;
      const bool first = !res || iters == 0;
      if (t < tiles) {
        carry_tile<CT>(Hs, 1.f, Xc, sx, np, i0, j0, res ? Hr : Ak, Bk, red,
                       O, first, true);
        float f = 0.f;
        for (int e = tid; e < CT * CT; e += NT) {
          const float rv =
              (i0 + e / CT == j0 + e % CT ? 1.f : 0.f) - O[e];
          f = fmaf(rv, rv, f);
        }
        f = block_sum(f, r32);
        if (tid == 0) part[tt] = f;
      } else {
        carry_tile<CT>(Xc, sx, Hs, 1.f, np, i0, j0, Ak, res ? Hr : Bk, red,
                       O, true, first);
        for (int e = tid; e < CT * CT; e += NT)
          T[(size_t)(i0 + e / CT) * np + j0 + e % CT] = O[e];
      }
    }
    grid.sync();
    f2 = gsum(part, tiles, r32);
    if (!(iters < CARRY_ITERS && f2 > CARRY_GATE2 && f2 < 1e8f &&
          isfinite(f2)))
      break;
    // X' = 2X - T X (narrower tiles where the square ones leave SMs idle)
    float* Xn = Xb + cur * nn;
    if (np <= 256)
      carry_update<16>(T, Xc, sx, Xn, np, Ak, Bk, red, O);
    else
      carry_update<CT>(T, Xc, sx, Xn, np, Ak, Bk, red, O);
    grid.sync();
    Xc = Xn;
    sx = 1.f;
    cur = 1 - cur;
    ++iters;
  }
  for (size_t e = (size_t)blockIdx.x * NT + tid; e < nn;
       e += (size_t)gridDim.x * NT)
    Xo[e] = sx * __ldcg(Xc + e);
  if (blockIdx.x == 0 && tid == 0) {
    *rho2 = f2;
    hit[0] = (f2 < CARRY_GATE2 && isfinite(f2)) ? 1 : 0;
    hit[1] = iters;
  }
}

// fp32 floats of ip_ns_refresh's workspace for an np x np carry
IP_API size_t ip_ns_refresh_ws_floats(int np) {
  const size_t t = (size_t)(np / CT) * (np / CT);
  return 3 * (size_t)np * np + 2 * (size_t)np + t;
}

// The carry trial on X0 (np x np, np a multiple of 32 and at most 512):
// Xo the refreshed carry, hit[0] 1 when ||I - Hs Xo||_F^2 < 1e-4, hit[1]
// the Newton-Schulz iterations taken, *rho2 that value.  One cooperative
// launch.
IP_API int ip_ns_refresh(const float* Hs, const float* X0, int np, float* Xo,
                         float* ws, int* hit, float* rho2,
                         cudaStream_t stream) {
  static int cap = 0;
  cudaError_t e = cudaSuccess;
  if (np <= 0 || np % CT || np > CARRY_MAX_NP)
    return (int)cudaErrorInvalidValue;
  if (cap == 0) {
    int dev = 0, sms = 0, per = 0;
    e = cudaFuncSetAttribute(ns_refresh_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             CARRY_SMEM_ALL);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per, ns_refresh_kernel, NT, CARRY_SMEM_ALL);
    if (e == cudaSuccess && per < 1) e = cudaErrorInvalidConfiguration;
    if (e == cudaSuccess) cap = sms;
  }
  if (e == cudaSuccess) {
    const int tiles = (np / CT) * (np / CT);
    const int grid = 2 * tiles < cap ? 2 * tiles : cap;
    void* args[] = {&Hs, &X0, &np, &Xo, &ws, &hit, &rho2};
    e = cudaLaunchCooperativeKernel((const void*)ns_refresh_kernel,
                                    dim3(grid), dim3(NT), args,
                                    CARRY_SMEM_ALL,
                                    stream);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return ip_status();
}

// ---------------------------------------------------------------------------
// W^T W
// ---------------------------------------------------------------------------

// out = W^T W (n x n, n a multiple of 32), one CT x CT tile per block;
// nothing when `after` is not null and *after is 0
__global__ void __launch_bounds__(NT)
gram_tn_kernel(const float* __restrict__ W, int n, float* __restrict__ out,
               const int* after) {
  if (after && *after == 0) return;
  __shared__ __align__(16) float As[CT * CLD];
  __shared__ __align__(16) float Bs[CT * CLD];
  const int tid = threadIdx.x, r = tid >> 3, c4 = (tid & 7) * 4;
  const int i0 = blockIdx.y * CT, j0 = blockIdx.x * CT;
  float o[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < n; k0 += CT) {
    for (int e = tid; e < CT * CT; e += NT) {
      const int a = e / CT, c = e % CT;
      As[a * CLD + c] = W[(size_t)(k0 + a) * n + i0 + c];   // As[k][i]
      Bs[a * CLD + c] = W[(size_t)(k0 + a) * n + j0 + c];   // Bs[k][j]
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < CT; ++kk) {
      const float av = As[kk * CLD + r];
      const float4 bv = *reinterpret_cast<const float4*>(Bs + kk * CLD + c4);
      o[0] = fmaf(av, bv.x, o[0]);
      o[1] = fmaf(av, bv.y, o[1]);
      o[2] = fmaf(av, bv.z, o[2]);
      o[3] = fmaf(av, bv.w, o[3]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) out[(size_t)(i0 + r) * n + j0 + c4 + c] = o[c];
}

// W^T W into out; with `after` (a device flag, or null) nothing runs
// unless *after is set (K2's re-seed after its Cholesky fallback, a branch
// taken on the device: out is then left as it was).
IP_API int ip_gram_tn(const float* W, int n, float* out, const int* after,
                      cudaStream_t stream) {
  if (n <= 0 || n % CT) return (int)cudaErrorInvalidValue;
  gram_tn_kernel<<<dim3(n / CT, n / CT), NT, 0, stream>>>(W, n, out, after);
  return ip_status();
}

// ---------------------------------------------------------------------------
// K2's preconditioner branch, decided on the device
// ---------------------------------------------------------------------------

// The flags of ops/newton_step.py `preconditioner` from the carry trial's
// hit (null: no trial) and the LDL rungs' flags (bad1 null: only rung 0
// has run), as _direction_core takes them (pallas_newton.py:681-701):
//   dec[0] = rung 1 skips itself: a hit, or rung 0 passed;
// with bad1 also
//   dec[1] = the Cholesky fallback runs: no hit and both rungs refused;
//   dec[2] = the LDL re-seed of the carry runs: a carry, no hit and a rung
//            passed;
//   dec[3] = the solve's form (csrc/hop.cu): 1 (the carry's X) with a
//            carry; without one 2 (the LDL factor's sweeps) after an LDL
//            rung, 0 (the W-solve) after the fallback;
//   dec[4] = the branch: 0 hit, 1 LDL rung 0, 2 LDL rung 1, 3 fallback.
// One thread.
__global__ void k2_decide_kernel(const int* hit, const int* bad0,
                                 const int* bad1, int carry, int* dec) {
  const int h = hit ? (*hit != 0) : 0;
  const int b0 = *bad0 != 0;
  dec[0] = h || !b0;
  if (!bad1) return;
  const int b1 = *bad1 != 0;
  const int need = !h && b0 && b1;
  dec[1] = need;
  dec[2] = carry && !h && !need;
  dec[3] = carry ? 1 : need ? 0 : 2;
  dec[4] = h ? 0 : !b0 ? 1 : !b1 ? 2 : 3;
}

IP_API int ip_k2_decide(const int* hit, const int* bad0, const int* bad1,
                        int carry, int* dec, cudaStream_t stream) {
  if (!bad0 || !dec) return (int)cudaErrorInvalidValue;
  k2_decide_kernel<<<1, 1, 0, stream>>>(hit, bad0, bad1, carry, dec);
  return ip_status();
}
