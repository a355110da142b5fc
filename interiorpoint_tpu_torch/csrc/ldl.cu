// The barrier Newton step's preconditioner (K2, ops/hybrid.py): the
// block-LDL factor with Newton-Schulz tile inverses, the cross-step carry
// trial, X^T v and W^T W.  All fp32 on FFMA (never TF32: the factor and
// the carry precondition an fp64-refined solve, for the reason
// interiorpoint_tpu/ops/pallas_chol.py:_dot gives).
//
// Replaces, from interiorpoint_tpu/ops/pallas_newton.py:
//   _ns_tile_inv (:334) and _ldl_ns_stages (:445): ip_ldl_factor;
//   the carry branch of _direction_core (:649-700): ip_ns_refresh;
//   its v . X application and _w_solve(eye): ip_xt_matvec, ip_gram_tn.
// The LDL solve (_ldl_solve) is chol.cu's block_solve_kernel.
//
// Bound.  The factor is a chain of nb = np / 128 tile inverses, each a
// sequence of up to 40 dependent Newton-Schulz iterations of two
// 128 x 128 x 128 products (8.4 MFLOP, 17 us of one SM's FFMA rate), so
// it is latency-bound; its bulk (the trailing updates, np^3/3 flops) is
// small.  Design:
//  * one tile inverse is one cooperative launch of NSB = 32 blocks of 512
//    threads, block b owning rows 4b..4b+3 of X and of T = X Ds (a
//    thread an entry): per iteration each
//    block forms its rows of X' = 2X - T X and of X' Ds, then all blocks
//    exchange X' through L2 behind one grid barrier; ||I - X Ds||^2 is
//    summed from the blocks' partials in a fixed order, so every block
//    takes the same branch (one thread-block cluster of 8 blocks
//    exchanging X' through distributed shared memory was slower);
//  * the trailing updates of a stage are one launch of a block per
//    trailing tile, A_ij -= (A_ik X_k) A_jk^T with 8 x 8 register blocks
//    on 128 x 128 tiles in shared memory (the panel L_ik = A_ik X_k is
//    written by the tile (i, i));
//  * ip_ldl_factor launches the 2 nb - 1 kernels from the host without a
//    synchronisation; every kernel returns at once when the carry's hit
//    flag (skip) is set, or when an earlier tile has already failed (the
//    factor is then refused whatever the later tiles hold).
// The carry trial works on np <= 512 (ns_carry_supported): one
// cooperative launch, every product a 32 x 32-tiled pass over the grid
// with a grid barrier between dependent products.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int TB = 128;            // the LDL tile edge (the TPU's BLK)
constexpr int TLD = TB + 4;        // shared row stride (16-byte rows)
constexpr int NSB = 32;            // blocks of one tile inverse
constexpr int NSR = TB / NSB;      // rows of X per block
constexpr int NST = NSR * TB;      // its threads: one entry of X each
constexpr int NT = 256;            // threads of the other LDL kernels
constexpr int NS_ITERS = 40;       // _ns_tile_inv: iteration cap,
constexpr float NS_TOL2 = 1e-6f;   //   convergence target,
constexpr float NS_GATE2 = 1e-4f;  //   acceptance gate
constexpr int NS_SMEM = (2 * TB * TLD + 2 * NSR * TLD + 3 * TB + 32) * 4;
constexpr int UPD_SMEM = 2 * TB * TLD * 4;
constexpr int CARRY_ITERS = 12;      // _NS_ITERS
constexpr float CARRY_GATE2 = 1e-4f; // _NS_GATE2
constexpr int CT = 32;               // carry product tile edge
constexpr int CLD = CT + 4;
constexpr int CARRY_MAX_NP = 512;    // _NS_MAX_RP
// dynamic shared memory of the carry trial: a tile's rows of A and
// columns of B over the whole k
static int carry_smem(int np) { return (CT * (np + 4) + np * CLD) * 4; }

IP_API size_t ip_ldl_block() { return TB; }
// fp32 scratch of ip_ldl_factor: two exchange copies of X and the
// blocks' partial sums (two sets)
IP_API size_t ip_ldl_ws_floats() { return 2 * TB * TB + 2 * NSB; }

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
// block_sum's fixed tree, so every block gets the same value (a loop of
// dependent loads is a chain of L2 latencies).
__device__ float gsum(const float* g, int n, float* red) {
  float v = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) v += __ldcg(g + i);
  return block_sum(v, red);
}

// Tile (ti, tj) of Hs + delta I (from src, np x np) or of A, whichever
// holds the current values (stage k == 0 reads the source).
__device__ __forceinline__ float a_at(const float* src, const float* A,
                                      int np, float delta, bool from_src,
                                      int i, int j) {
  if (from_src) return src[(size_t)i * np + j] + (i == j ? delta : 0.f);
  return A[(size_t)i * np + j];
}

// ---------------------------------------------------------------------------
// The tile inverse: X ~ D^-1 of the diagonal tile k (_ns_tile_inv)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NST, 1)
ns_tile_kernel(const float* __restrict__ src, int np, float delta,
               const float* __restrict__ A, int k, float* __restrict__ Dinv,
               float* __restrict__ Xg, float* __restrict__ part,
               int* __restrict__ bad, const int* __restrict__ skip,
               float* __restrict__ stats) {
  // a carry hit, or an earlier tile or panel that failed: nothing to do
  // (every block reads the same flags)
  if ((skip && *skip) || *bad) return;
  extern __shared__ __align__(16) float nsm[];
  float* Ds = nsm;                   // [TB][TLD] the scaled tile
  float* Xf = Ds + TB * TLD;         // [TB][TLD] X, every row
  float* Tr = Xf + TB * TLD;         // [NSR][TLD] this block's rows of T
  float* Xr = Tr + NSR * TLD;        // [NSR][TLD] this block's rows of X'
  float* dsc = Xr + NSR * TLD;       // [TB]
  float* u = dsc + TB;               // [TB]
  float* v = u + TB;                 // [TB]
  float* red = v + TB;               // [32]
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x, r0 = b * NSR;
  const int k0 = k * TB;
  for (int e = tid; e < TB * TB; e += NST) {
    const int i = e / TB, j = e % TB;
    Ds[i * TLD + j] = a_at(src, A, np, delta, k == 0, k0 + i, k0 + j);
  }
  __syncthreads();
  // the local Jacobi pre-scale (IEEE sqrt and division)
  if (tid < TB) dsc[tid] = 1.f / sqrtf(fmaxf(Ds[tid * TLD + tid], 1e-30f));
  __syncthreads();
  for (int e = tid; e < TB * TB; e += NST) {
    const int i = e / TB, j = e % TB;
    Ds[i * TLD + j] *= dsc[i] * dsc[j];
  }
  if (tid < TB) u[tid] = 1.f / sqrtf((float)TB);
  __syncthreads();
  // lambda_max of Ds by 3 power iterations (every block the same)
  float lam = 1.f;
  for (int it = 0; it < 3; ++it) {
    for (int i = warp; i < TB; i += NST / 32) {
      float s = 0.f;
      for (int j = lane; j < TB; j += 32) s = fmaf(Ds[i * TLD + j], u[j], s);
      s = ip_warp_sumf(s);
      if (lane == 0) v[i] = s;
    }
    __syncthreads();
    const float vi = tid < TB ? v[tid] : 0.f;
    lam = sqrtf(block_sum(vi * vi, red));
    if (tid < TB) u[tid] = vi / fmaxf(lam, 1e-30f);
    __syncthreads();
  }
  const float x0 = 1.f / fmaxf(lam, 1e-30f);
  for (int e = tid; e < TB * TB; e += NST) {
    const int i = e / TB, j = e % TB;
    Xf[i * TLD + j] = i == j ? x0 : 0.f;
  }
  __syncthreads();
  // thread (rr, c): entry (rr, c) of the block's rows
  const int rr = tid / TB, c = tid % TB;
  // (row rr of S) M at column c, over a full k of 128 (four sums)
  auto dot = [&](const float* S, const float* M) {
    float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int kk = 0; kk < TB; ++kk)
      o[kk & 3] = fmaf(S[rr * TLD + kk], M[kk * TLD + c], o[kk & 3]);
    return (o[0] + o[1]) + (o[2] + o[3]);
  };
  // Tr = (rows of S) Ds, and this thread's share of ||I - Tr||^2
  auto times_ds = [&](const float* S) {
    const float o = dot(S, Ds);
    Tr[rr * TLD + c] = o;
    const float rv = (r0 + rr == c ? 1.f : 0.f) - o;
    return rv * rv;
  };
  Xr[rr * TLD + c] = Xf[(r0 + rr) * TLD + c];
  __syncthreads();
  float f = block_sum(times_ds(Xr), red);
  if (tid == 0) part[b] = f;
  grid.sync();
  float f2 = gsum(part, NSB, red);
  int it = 0;
  for (; it < NS_ITERS && f2 > NS_TOL2 && f2 < 1e10f && isfinite(f2);
       ++it) {
    // X' = 2X - T X on this block's rows (the symmetric form)
    const float o = dot(Tr, Xf);
    float* xg = Xg + (it & 1) * TB * TB;
    __syncthreads();   // every read of Tr is done
    const float xn = 2.f * Xf[(r0 + rr) * TLD + c] - o;
    Xr[rr * TLD + c] = xn;
    xg[(r0 + rr) * TB + c] = xn;
    __syncthreads();
    f = block_sum(times_ds(Xr), red);
    float* pt = part + ((it + 1) & 1) * NSB;
    if (tid == 0) pt[b] = f;
    grid.sync();
    for (int e = tid; e < TB * TB / 4; e += NST) {
      const int i = e / (TB / 4), j = (e % (TB / 4)) * 4;
      const float4 x = __ldcg(reinterpret_cast<const float4*>(xg + i * TB + j));
      *reinterpret_cast<float4*>(Xf + i * TLD + j) = x;
    }
    f2 = gsum(pt, NSB, red);
  }
  // poison a tile that missed the gate; undo the pre-scale
  const bool miss = !(f2 <= NS_GATE2);   // NaN misses too
  Dinv[(size_t)(k0 + r0 + rr) * TB + c] =
      miss ? __int_as_float(0x7fc00000)
           : dsc[r0 + rr] * Xf[(r0 + rr) * TLD + c] * dsc[c];
  if (miss && b == 0 && tid == 0) atomicExch(bad, 1);
  if (stats && b == 0 && tid == 0) {
    stats[2 * k] = f2;              // the gate's own quantity, and
    stats[2 * k + 1] = (float)it;   // the iterations it took
  }
}

// ---------------------------------------------------------------------------
// The trailing updates of stage k
// ---------------------------------------------------------------------------

// C (8 x 8 per thread: rows 4ty+p and 64+4ty+p, columns likewise) +=
// At^T Bk over 128, both operands k-major in shared memory (stride TLD).
__device__ __forceinline__ void mma128(float (&acc)[8][8], const float* At,
                                       const float* Bk) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int kk = 0; kk < TB; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(At + kk * TLD + ty * 4);
    const float4 a1 =
        *reinterpret_cast<const float4*>(At + kk * TLD + 64 + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(Bk + kk * TLD + tx * 4);
    const float4 b1 =
        *reinterpret_cast<const float4*>(Bk + kk * TLD + 64 + tx * 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(av[p], bv[q], acc[p][q]);
  }
}
__device__ __forceinline__ int mrow(int p) {
  return p < 4 ? (threadIdx.x / 16) * 4 + p : 64 + (threadIdx.x / 16) * 4 + p - 4;
}
__device__ __forceinline__ int mcol(int q) {
  return q < 4 ? (threadIdx.x % 16) * 4 + q : 64 + (threadIdx.x % 16) * 4 + q - 4;
}

// Task (i, j), k < j <= i: A_ij -= B_i A_jk^T with B_i = A_ik X_k; the task
// (i, i) also writes the panel L_ik = B_i.  Stage 0 reads the source.
__global__ void __launch_bounds__(NT, 1)
ldl_update_kernel(const float* __restrict__ src, int np, float delta,
                  float* __restrict__ A, float* __restrict__ Lt,
                  const float* __restrict__ Dinv, int k,
                  int* __restrict__ bad, const int* __restrict__ skip) {
  if ((skip && *skip) || *bad) return;
  extern __shared__ __align__(16) float usm[];
  float* S0 = usm;
  float* S1 = usm + TB * TLD;
  const int t = blockIdx.x;
  int ii = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while ((ii + 1) * (ii + 2) / 2 <= t) ++ii;
  while (ii * (ii + 1) / 2 > t) --ii;
  const int i = k + 1 + ii, j = k + 1 + (t - ii * (ii + 1) / 2);
  const bool s0 = k == 0;
  const int tid = threadIdx.x;
  // S0 = A_ik^T (k-major), S1 = X_k
  for (int e = tid; e < TB * TB; e += NT) {
    const int r = e / TB, c = e % TB;
    S0[c * TLD + r] = a_at(src, A, np, delta, s0, i * TB + r, k * TB + c);
    S1[r * TLD + c] = Dinv[(size_t)(k * TB + r) * TB + c];
  }
  __syncthreads();
  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;
  mma128(acc, S0, S1);
  __syncthreads();
  // S0 = B_i^T, S1 = A_jk^T
  int nonfinite = 0;
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      S0[mcol(q) * TLD + mrow(p)] = acc[p][q];
      if (i == j) {
        Lt[(size_t)(i * TB + mrow(p)) * np + k * TB + mcol(q)] = acc[p][q];
        if (!isfinite(acc[p][q])) nonfinite = 1;
      }
    }
  if (nonfinite) atomicExch(bad, 1);
  for (int e = tid; e < TB * TB; e += NT) {
    const int r = e / TB, c = e % TB;
    S1[c * TLD + r] = a_at(src, A, np, delta, s0, j * TB + r, k * TB + c);
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;
  mma128(acc, S0, S1);
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int gi = i * TB + mrow(p), gj = j * TB + mcol(q);
      A[(size_t)gi * np + gj] =
          a_at(src, A, np, delta, s0, gi, gj) - acc[p][q];
    }
}

template <typename K>
static cudaError_t set_smem(K kernel, int bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *done = true;
  return e;
}

// Factor Hs + delta I (np x np, np a multiple of TB; Hs full, symmetric)
// into the panels of Lt (its strictly lower tiles) and the tile inverses
// Dinv (np x TB); A is an np x np working copy, ws ip_ldl_ws_floats
// floats; *bad is set when a tile misses its gate or a panel is not
// finite; nothing runs when skip is not null and *skip != 0; stats, when
// not null, gets each tile's final ||I - X Ds||_F^2 and iterations
// (np / TB pairs; a tile after a failed one is left as it was).
IP_API int ip_ldl_factor(const float* Hs, int np, double delta, float* A,
                         float* Lt, float* Dinv, float* ws, int* bad,
                         const int* skip, float* stats, cudaStream_t stream) {
  static bool ns_attr = false, upd_attr = false;
  cudaError_t e = set_smem(ns_tile_kernel, NS_SMEM, &ns_attr);
  if (e == cudaSuccess) e = set_smem(ldl_update_kernel, UPD_SMEM, &upd_attr);
  if (e != cudaSuccess) return (int)e;
  const int nb = np / TB;
  float d = (float)delta;
  float* Xg = ws;
  float* part = ws + 2 * TB * TB;
  for (int k = 0; k < nb && e == cudaSuccess; ++k) {
    void* args[] = {&Hs, &np, &d,   &A,   &k,    &Dinv,
                    &Xg, &part, &bad, &skip, &stats};
    e = cudaLaunchCooperativeKernel((const void*)ns_tile_kernel, dim3(NSB),
                                    dim3(NST), args, NS_SMEM, stream);
    const int m = nb - k - 1;
    if (e == cudaSuccess && m > 0) {
      ldl_update_kernel<<<m * (m + 1) / 2, NT, UPD_SMEM, stream>>>(
          Hs, np, d, A, Lt, Dinv, k, bad, skip);
      e = cudaGetLastError();
    }
  }
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return ip_status();
}

// ---------------------------------------------------------------------------
// The carry trial (the Minv branch of _direction_core)
// ---------------------------------------------------------------------------

// out (np x np) = A B, tiled CT x CT over the grid; mode 0: out = A B,
// mode 1: out = 2 B - A B, mode 2: no output, part[t] = the tile's share
// of ||I - A B||^2.  A block stages its tile's CT rows of A and CT
// columns of B whole (the k of np <= 512 in one pass: one barrier pair
// per tile); thread (r, c4): row r of the tile, columns 4c4..4c4+3.
__device__ void carry_prod(const float* A, const float* B, float* out,
                           float* part, int np, int mode, float* As,
                           float* Bs, float* red) {
  const int tid = threadIdx.x, r = tid >> 3, c4 = (tid & 7) * 4;
  const int lda = np + 4;
  const int nt = np / CT, tiles = nt * nt;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int i0 = (t / nt) * CT, j0 = (t % nt) * CT;
    for (int e = tid; e < CT * np / 4; e += NT) {
      const int a = e / (np / 4), kk = (e % (np / 4)) * 4;
      *reinterpret_cast<float4*>(As + a * lda + kk) = __ldcg(
          reinterpret_cast<const float4*>(A + (size_t)(i0 + a) * np + kk));
    }
    for (int e = tid; e < np * CT / 4; e += NT) {
      const int kk = e / (CT / 4), cc = (e % (CT / 4)) * 4;
      *reinterpret_cast<float4*>(Bs + kk * CLD + cc) = __ldcg(
          reinterpret_cast<const float4*>(B + (size_t)kk * np + j0 + cc));
    }
    __syncthreads();
    float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int kk = 0; kk < np; ++kk) {
      const float av = As[r * lda + kk];
      const float4 bv = *reinterpret_cast<const float4*>(Bs + kk * CLD + c4);
      o[0] = fmaf(av, bv.x, o[0]);
      o[1] = fmaf(av, bv.y, o[1]);
      o[2] = fmaf(av, bv.z, o[2]);
      o[3] = fmaf(av, bv.w, o[3]);
    }
    __syncthreads();   // the next tile reuses As and Bs
    float f = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gi = i0 + r, gj = j0 + c4 + c;
      if (mode == 0) {
        out[(size_t)gi * np + gj] = o[c];
      } else if (mode == 1) {
        out[(size_t)gi * np + gj] =
            2.f * __ldcg(B + (size_t)gi * np + gj) - o[c];
      } else {
        const float rv = (gi == gj ? 1.f : 0.f) - o[c];
        f = fmaf(rv, rv, f);
      }
    }
    if (mode == 2) {
      f = block_sum(f, red);
      if (tid == 0) part[t] = f;
    }
  }
}

// y = M x (np), rows over the grid's warps
__device__ void carry_matvec(const float* M, const float* x, float* y,
                             int np) {
  const int lane = threadIdx.x & 31;
  const int w0 = blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  for (int i = w0; i < np; i += gridDim.x * (NT / 32)) {
    float s = 0.f;
    for (int j = lane; j < np; j += 32)
      s = fmaf(__ldcg(M + (size_t)i * np + j), __ldcg(x + j), s);
    s = ip_warp_sumf(s);
    if (lane == 0) y[i] = s;
  }
}

// ws: T (np^2), two copies of X (2 np^2), u, v1, v2 (3 np), tile partials
__global__ void __launch_bounds__(NT, 1)
ns_refresh_kernel(const float* __restrict__ Hs, const float* __restrict__ X0,
                  int np, float* __restrict__ Xo, float* __restrict__ ws,
                  int* __restrict__ hit, float* __restrict__ rho2) {
  extern __shared__ __align__(16) float csm[];
  float* As = csm;                        // [CT][np + 4]
  float* Bs = csm + CT * (np + 4);        // [np][CLD]
  __shared__ float red[32];
  cg::grid_group grid = cg::this_grid();
  const size_t nn = (size_t)np * np;
  float* T = ws;
  float* Xb = ws + nn;
  float* u = ws + 3 * nn;
  float* v1 = u + np;
  float* v2 = v1 + np;
  float* part = v2 + np;
  const int tiles = (np / CT) * (np / CT);
  const int gt = blockIdx.x * NT + threadIdx.x, gn = gridDim.x * NT;
  for (int i = gt; i < np; i += gn) u[i] = 1.f / sqrtf((float)np);
  grid.sync();
  // lambda_max(Hs X) by 3 power iterations: v = Hs (X u), u = v / ||v||
  float lam = 1.f;
  for (int it = 0; it < 3; ++it) {
    carry_matvec(X0, u, v1, np);
    grid.sync();
    carry_matvec(Hs, v1, v2, np);
    grid.sync();
    float s = 0.f;
    for (int i = threadIdx.x; i < np; i += NT) {
      const float vi = __ldcg(v2 + i);
      s = fmaf(vi, vi, s);
    }
    lam = sqrtf(block_sum(s, red));
    for (int i = gt; i < np; i += gn) u[i] = __ldcg(v2 + i) / fmaxf(lam, 1e-30f);
    grid.sync();
  }
  const float sc = 1.f / fmaxf(lam, 1e-30f);
  for (size_t e = gt; e < nn; e += gn) Xb[e] = X0[e] * sc;
  grid.sync();
  carry_prod(Hs, Xb, nullptr, part, np, 2, As, Bs, red);
  grid.sync();
  float f2 = gsum(part, tiles, red);
  int cur = 0, iters = 0;
  for (; iters < CARRY_ITERS && f2 > CARRY_GATE2 && f2 < 1e8f &&
         isfinite(f2);
       ++iters) {
    float* Xc = Xb + cur * nn;
    float* Xn = Xb + (1 - cur) * nn;
    carry_prod(Xc, Hs, T, nullptr, np, 0, As, Bs, red);    // T = X Hs
    grid.sync();
    carry_prod(T, Xc, Xn, nullptr, np, 1, As, Bs, red);    // X' = 2X - T X
    grid.sync();
    carry_prod(Hs, Xn, nullptr, part, np, 2, As, Bs, red);  // ||I - Hs X'||
    grid.sync();
    f2 = gsum(part, tiles, red);
    cur = 1 - cur;
  }
  const float* Xc = Xb + cur * nn;
  for (size_t e = gt; e < nn; e += gn) Xo[e] = __ldcg(Xc + e);
  if (gt == 0) {
    *rho2 = f2;
    hit[0] = (f2 < CARRY_GATE2 && isfinite(f2)) ? 1 : 0;
    hit[1] = iters;
  }
}

// fp32 floats of ip_ns_refresh's workspace for an np x np carry
IP_API size_t ip_ns_refresh_ws_floats(int np) {
  const size_t t = (size_t)(np / CT) * (np / CT);
  return 3 * (size_t)np * np + 3 * (size_t)np + t;
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
                             carry_smem(CARRY_MAX_NP));
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per, ns_refresh_kernel, NT, carry_smem(CARRY_MAX_NP));
    if (e == cudaSuccess && per < 1) e = cudaErrorInvalidConfiguration;
    if (e == cudaSuccess) cap = sms;
  }
  if (e == cudaSuccess) {
    const int tiles = (np / CT) * (np / CT);
    const int grid = tiles < cap ? tiles : cap;
    void* args[] = {&Hs, &X0, &np, &Xo, &ws, &hit, &rho2};
    e = cudaLaunchCooperativeKernel((const void*)ns_refresh_kernel,
                                    dim3(grid), dim3(NT), args,
                                    carry_smem(np), stream);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return ip_status();
}

// ---------------------------------------------------------------------------
// X^T v and W^T W
// ---------------------------------------------------------------------------

// y_j = sum_i X[i][j] v[i] over the leading n (32 columns per block, 8
// row phases, coalesced rows)
__global__ void xt_matvec_kernel(const float* __restrict__ X, int ld, int n,
                                 const float* __restrict__ v,
                                 float* __restrict__ y) {
  __shared__ float red[8][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * 32 + tx;
  float acc = 0.f;
  if (j < n)
    for (int i = ty; i < n; i += 8) acc = fmaf(X[(size_t)i * ld + j], v[i], acc);
  red[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && j < n) {
    float s = 0.f;
    for (int q = 0; q < 8; ++q) s += red[q][tx];
    y[j] = s;
  }
}

IP_API int ip_xt_matvec(const float* X, int ld, int n, const float* v,
                        float* y, cudaStream_t stream) {
  if (n <= 0) return 0;
  xt_matvec_kernel<<<(n + 31) / 32, dim3(32, 8), 0, stream>>>(X, ld, n, v,
                                                              y);
  return ip_status();
}

// out = W^T W (n x n, n a multiple of 32), one CT x CT tile per block
__global__ void __launch_bounds__(NT)
gram_tn_kernel(const float* __restrict__ W, int n, float* __restrict__ out) {
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

IP_API int ip_gram_tn(const float* W, int n, float* out,
                      cudaStream_t stream) {
  if (n <= 0 || n % CT) return (int)cudaErrorInvalidValue;
  gram_tn_kernel<<<dim3(n / CT, n / CT), NT, 0, stream>>>(W, n, out);
  return ip_status();
}
