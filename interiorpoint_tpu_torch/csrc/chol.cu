// Blocked fp32 Cholesky, triangular inverse and triangular solves, shared
// by the primal-dual step (ops/pd_step.py, K1) and the standalone factor
// and solve (ops/chol.py, K3a and K3b).
//
// Replaces
//   interiorpoint_tpu/ops/pallas_chol.py:_chol_kernel (K3a) with its
//     diagonal-block factor and inverse _factor_diag_block,
//   interiorpoint_tpu/ops/pallas_chol.py:_solve_kernel (K3b),
//   interiorpoint_tpu/ops/pallas_newton.py:_chol_factor_ref,
//     _chol_invert_ref and _w_solve, which the TPU step kernel runs.
//
// The factor and the inverse work on np x np row-major matrices, np a
// multiple of BLK = 64, padded with the identity by the loader; the fused
// solve reads an n x n factor in place with that padding implicit.  Only
// the lower triangle is read; the loader zeroes the strict upper triangle,
// so the factor comes out exactly lower.
//
// Bound: latency, at the reduced widths of the main path (r <= 1024, at
// most 16 block columns).  The factor is a chain of nb dependent diagonal
// blocks, each a 64-pivot sequence of shared-memory steps, and the bulk
// (panel solve and trailing update, n^3/3 flops) is small.  Design: one
// launch per stage (diagonal block on one SM, then the panel and the
// trailing update spread over one block per 64 x 64 tile), so the chain is
// 3*nb short launches; the diagonal blocks are inverted by substitution
// in the same launch (the TPU's nilpotent-doubling inverse is a latency
// trick for its matrix unit).  A non-finite pivot sets a device flag
// instead of stopping: NaN propagates as in jnp.linalg.cholesky, and the
// caller's jitter ladder reads the flag.
#include "common.cuh"

constexpr int BLK = 64;

// The block edge: callers pad to a multiple of it and size Dinv (np x BLK).
IP_API size_t ip_chol_block() { return BLK; }

// A = tril(src[:n,:n]) + delta*I on the leading block, identity padding.
__global__ void chol_load_kernel(const float* __restrict__ src, int n,
                                 int lds, float* __restrict__ A, int np,
                                 float delta) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;
  if (j >= np) return;
  float v = 0.f;
  if (j <= i) {
    if (i < n && j < n)
      v = src[(size_t)i * lds + j] + (i == j ? delta : 0.f);
    else if (i == j)
      v = 1.f;
  }
  A[(size_t)i * np + j] = v;
}

// Factor diagonal block kb in place and write its inverse to Dinv rows.
__global__ void __launch_bounds__(256)
chol_diag_kernel(float* __restrict__ A, int np, int kb,
                 float* __restrict__ Dinv, int* __restrict__ bad) {
  __shared__ float T[BLK][BLK + 1];
  __shared__ float Inv[BLK][BLK + 1];
  __shared__ float piv[BLK];
  const int tid = threadIdx.x;
  const int k0 = kb * BLK;
  for (int e = tid; e < BLK * BLK; e += 256) {
    const int i = e / BLK, j = e % BLK;
    T[i][j] = (j <= i) ? A[(size_t)(k0 + i) * np + k0 + j] : 0.f;
  }
  __syncthreads();
  // Unscaled right-looking elimination, one barrier per pivot: after
  // pivot j, T holds the Schur complement S, updated as
  // S_il -= S_ij S_lj / S_jj; the columns are scaled by sqrt(S_jj) at the
  // end.  Thread t owns column t % 64 and rows t / 64 + 4q of the tile.
  const int col = tid % BLK, row0 = tid / BLK;
  for (int j = 0; j < BLK; ++j) {
    const float pj = T[j][j];
    if (tid == 0) piv[j] = pj;
    if (col > j) {
      const float f = T[col][j] / pj;
      for (int i = col + ((row0 - col) & 3); i < BLK; i += 4)
        T[i][col] -= T[i][j] * f;
    }
    __syncthreads();
  }
  for (int e = tid; e < BLK * BLK; e += 256) {
    const int i = e / BLK, j = e % BLK;
    const float dj = sqrtf(piv[j]);  // NaN for a negative pivot
    if (i > j)
      T[i][j] = T[i][j] / dj;
    else if (i == j)
      T[j][j] = dj;
  }
  __syncthreads();
  for (int e = tid; e < BLK * BLK; e += 256) {
    const int i = e / BLK, j = e % BLK;
    A[(size_t)(k0 + i) * np + k0 + j] = (j <= i) ? T[i][j] : 0.f;
  }
  if (tid < BLK) {
    const int c = tid;
    for (int i = 0; i < c; ++i) Inv[i][c] = 0.f;
    Inv[c][c] = 1.f / T[c][c];
    for (int i = c + 1; i < BLK; ++i) {
      float acc = 0.f;
      for (int l = c; l < i; ++l) acc = fmaf(T[i][l], Inv[l][c], acc);
      Inv[i][c] = -acc / T[i][i];
    }
  }
  __syncthreads();
  int local_bad = 0;
  for (int e = tid; e < BLK * BLK; e += 256) {
    const int i = e / BLK, j = e % BLK;
    const float v = Inv[i][j];
    Dinv[(size_t)(k0 + i) * BLK + j] = v;
    if (!isfinite(v)) local_bad = 1;
  }
  if (local_bad) atomicExch(bad, 1);  // only ever set: order-free
}

// L_ik = A_ik * inv(L_kk)^T for every row block i > kb.
__global__ void __launch_bounds__(256)
chol_panel_kernel(float* __restrict__ A, int np, int kb,
                  const float* __restrict__ Dinv) {
  __shared__ float Ps[BLK][BLK + 1];
  __shared__ float Ls[BLK][BLK + 1];
  const int tid = threadIdx.x;
  const int k0 = kb * BLK, i0 = (kb + 1 + blockIdx.x) * BLK;
  for (int e = tid; e < BLK * BLK; e += 256) {
    const int a = e / BLK, c = e % BLK;
    Ps[a][c] = A[(size_t)(i0 + a) * np + k0 + c];
    Ls[a][c] = Dinv[(size_t)(k0 + a) * BLK + c];
  }
  __syncthreads();
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (int c = 0; c < BLK; ++c) {
    float pa[4], lb[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      pa[q] = Ps[ty * 4 + q][c];
      lb[q] = Ls[tx * 4 + q][c];
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(pa[p], lb[q], acc[p][q]);
  }
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      A[(size_t)(i0 + ty * 4 + p) * np + k0 + tx * 4 + q] = acc[p][q];
}

// A_ij -= L_ik L_jk^T for kb < j <= i (one block per lower tile).
__global__ void __launch_bounds__(256)
chol_syrk_kernel(float* __restrict__ A, int np, int kb) {
  __shared__ float Li[BLK][BLK + 1];
  __shared__ float Lj[BLK][BLK + 1];
  int ii = 0;
  const int t = blockIdx.x;
  while ((ii + 1) * (ii + 2) / 2 <= t) ++ii;
  const int jj = t - ii * (ii + 1) / 2;
  const int tid = threadIdx.x;
  const int k0 = kb * BLK;
  const int i0 = (kb + 1 + ii) * BLK, j0 = (kb + 1 + jj) * BLK;
  for (int e = tid; e < BLK * BLK; e += 256) {
    const int a = e / BLK, c = e % BLK;
    Li[a][c] = A[(size_t)(i0 + a) * np + k0 + c];
    Lj[a][c] = A[(size_t)(j0 + a) * np + k0 + c];
  }
  __syncthreads();
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (int c = 0; c < BLK; ++c) {
    float la[4], lb[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      la[q] = Li[ty * 4 + q][c];
      lb[q] = Lj[tx * 4 + q][c];
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(la[p], lb[q], acc[p][q]);
  }
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      A[(size_t)(i0 + ty * 4 + p) * np + j0 + tx * 4 + q] -= acc[p][q];
}

// W = 0 with the inverted diagonal blocks on its block diagonal.
__global__ void chol_inv_init_kernel(const float* __restrict__ Dinv,
                                     float* __restrict__ W, int np) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;
  if (j >= np) return;
  const int bi = i / BLK, bj = j / BLK;
  W[(size_t)i * np + j] =
      (bi == bj) ? Dinv[(size_t)i * BLK + (j - bj * BLK)] : 0.f;
}

// Row block ib of W = L^-1:  W_ik = -inv(L_ii) * sum_{j=k}^{i-1} L_ij W_jk
// for every k < ib (one block per k).  Rows above ib are final.
__global__ void __launch_bounds__(256)
chol_inv_row_kernel(const float* __restrict__ L,
                    const float* __restrict__ Dinv, float* __restrict__ W,
                    int np, int ib) {
  __shared__ float Ls[BLK][BLK + 1];
  __shared__ float Ws[BLK][BLK + 1];
  const int kb = blockIdx.x;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int i0 = ib * BLK, c0 = kb * BLK;
  float acc[4][4] = {};
  for (int jb = kb; jb < ib; ++jb) {
    const int j0 = jb * BLK;
    for (int e = tid; e < BLK * BLK; e += 256) {
      const int a = e / BLK, c = e % BLK;
      Ls[a][c] = L[(size_t)(i0 + a) * np + j0 + c];
      Ws[a][c] = W[(size_t)(j0 + a) * np + c0 + c];
    }
    __syncthreads();
    for (int c = 0; c < BLK; ++c) {
      float la[4], wb[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        la[q] = Ls[ty * 4 + q][c];
        wb[q] = Ws[c][tx * 4 + q];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(la[p], wb[q], acc[p][q]);
    }
    __syncthreads();
  }
  // Ws := acc, Ls := inv(L_ii); then W_ik = -Ls * Ws
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) Ws[ty * 4 + p][tx * 4 + q] = acc[p][q];
  for (int e = tid; e < BLK * BLK; e += 256) {
    const int a = e / BLK, c = e % BLK;
    Ls[a][c] = Dinv[(size_t)(i0 + a) * BLK + c];
  }
  __syncthreads();
  float out[4][4] = {};
  for (int c = 0; c < BLK; ++c) {
    float la[4], wb[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      la[q] = Ls[ty * 4 + q][c];
      wb[q] = Ws[c][tx * 4 + q];
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) out[p][q] = fmaf(la[p], wb[q], out[p][q]);
  }
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      W[(size_t)(i0 + ty * 4 + p) * np + c0 + tx * 4 + q] = -out[p][q];
}

// u = W[:n,:n] b  (W lower; one warp per row)
__global__ void w_lower_mv_kernel(const float* __restrict__ W, int ld,
                                  int n, const float* __restrict__ b,
                                  float* __restrict__ u) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * 8 + warp;
  if (i >= n) return;
  float acc = 0.f;
  for (int j = lane; j <= i; j += 32)
    acc = fmaf(W[(size_t)i * ld + j], b[j], acc);
  acc = ip_warp_sumf(acc);
  if (lane == 0) u[i] = acc;
}

// x = W[:n,:n]^T u  (32 columns per block, 8 row phases, coalesced rows;
// rows above the column tile hold zeros of the lower triangle)
__global__ void w_lower_tmv_kernel(const float* __restrict__ W, int ld,
                                   int n, const float* __restrict__ u,
                                   float* __restrict__ x) {
  __shared__ float red[8][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * 32 + tx;
  float acc = 0.f;
  if (j < n)
    for (int i = blockIdx.x * 32 + ty; i < n; i += 8)
      acc = fmaf(W[(size_t)i * ld + j], u[i], acc);
  red[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && j < n) {
    float s = 0.f;
    for (int q = 0; q < 8; ++q) s += red[q][tx];
    x[j] = s;
  }
}

// (L L^T) X = B, one block per right-hand side (column c of the row-major
// n x p matrices B and X).  Forward then backward block substitution with
// Dinv.  L is read in place (row stride ldl, lower triangle only); its
// identity padding to a multiple of BLK is implicit: the padded entries
// of b and x are zero, and so are Dinv's entries that couple them to the
// leading n.  X carries y between the passes (a __syncthreads makes the
// block's global writes visible to the block).
constexpr int SOLVE_THREADS = 512;
__global__ void __launch_bounds__(SOLVE_THREADS)
chol_solve_kernel(const float* __restrict__ L, int ldl, int n,
                  const float* __restrict__ Dinv,
                  const float* __restrict__ B, float* X, int p) {
  constexpr int NWARP = SOLVE_THREADS / 32;
  constexpr int NPHASE = SOLVE_THREADS / BLK;
  __shared__ float acc[BLK];
  __shared__ float part[NPHASE][BLK];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int c = blockIdx.x;
  const int nb = (n + BLK - 1) / BLK;
  for (int kb = 0; kb < nb; ++kb) {
    const int k0 = kb * BLK;
    for (int a = warp; a < BLK; a += NWARP) {
      const int i = k0 + a;
      float s = 0.f;
      if (i < n)
        for (int j = lane; j < k0; j += 32)
          s = fmaf(L[(size_t)i * ldl + j], X[(size_t)j * p + c], s);
      s = ip_warp_sumf(s);
      if (lane == 0) acc[a] = (i < n) ? B[(size_t)i * p + c] - s : 0.f;
    }
    __syncthreads();
    if (tid < BLK && k0 + tid < n) {
      float y = 0.f;
      for (int q = 0; q < BLK; ++q)
        y = fmaf(Dinv[(size_t)(k0 + tid) * BLK + q], acc[q], y);
      X[(size_t)(k0 + tid) * p + c] = y;
    }
    __syncthreads();
  }
  for (int kb = nb - 1; kb >= 0; --kb) {
    const int k0 = kb * BLK;
    const int a = tid % BLK, ph = tid / BLK;
    float s = 0.f;
    if (k0 + a < n)
      for (int j = k0 + BLK + ph; j < n; j += NPHASE)
        s = fmaf(L[(size_t)j * ldl + k0 + a], X[(size_t)j * p + c], s);
    part[ph][a] = s;
    __syncthreads();
    if (tid < BLK) {
      float t = 0.f;
      for (int u = 0; u < NPHASE; ++u) t += part[u][tid];
      acc[tid] = (k0 + tid < n) ? X[(size_t)(k0 + tid) * p + c] - t : 0.f;
    }
    __syncthreads();
    if (tid < BLK && k0 + tid < n) {
      float v = 0.f;
      for (int q = 0; q < BLK; ++q)
        v = fmaf(Dinv[(size_t)(k0 + q) * BLK + tid], acc[q], v);
      X[(size_t)(k0 + tid) * p + c] = v;
    }
    __syncthreads();
  }
}

IP_API int ip_chol_load(const float* src, int n, int lds, float* A, int np,
                        float delta, cudaStream_t stream) {
  dim3 grid((np + 127) / 128, np);
  chol_load_kernel<<<grid, 128, 0, stream>>>(src, n, lds, A, np, delta);
  return ip_status();
}

// In-place blocked factor of A (loaded by ip_chol_load): 3*nb - 2 launches.
IP_API int ip_chol_factor(float* A, int np, float* Dinv, int* bad,
                          cudaStream_t stream) {
  const int nb = np / BLK;
  for (int kb = 0; kb < nb; ++kb) {
    chol_diag_kernel<<<1, 256, 0, stream>>>(A, np, kb, Dinv, bad);
    const int m = nb - kb - 1;
    if (m > 0) {
      chol_panel_kernel<<<m, 256, 0, stream>>>(A, np, kb, Dinv);
      chol_syrk_kernel<<<m * (m + 1) / 2, 256, 0, stream>>>(A, np, kb);
    }
  }
  return ip_status();
}

// W = L^-1 (separate buffer): 1 + (nb - 1) launches.
IP_API int ip_chol_invert(const float* L, const float* Dinv, float* W,
                          int np, cudaStream_t stream) {
  dim3 grid((np + 127) / 128, np);
  chol_inv_init_kernel<<<grid, 128, 0, stream>>>(Dinv, W, np);
  for (int ib = 1; ib < np / BLK; ++ib)
    chol_inv_row_kernel<<<ib, 256, 0, stream>>>(L, Dinv, W, np, ib);
  return ip_status();
}

// x = W^T (W b) on the leading n entries: (L L^T)^-1 b with W = L^-1.
IP_API int ip_w_solve(const float* W, int ld, int n, const float* b,
                      float* u, float* x, cudaStream_t stream) {
  w_lower_mv_kernel<<<(n + 7) / 8, 256, 0, stream>>>(W, ld, n, b, u);
  w_lower_tmv_kernel<<<(n + 31) / 32, dim3(32, 8), 0, stream>>>(W, ld, n,
                                                                u, x);
  return ip_status();
}

IP_API int ip_chol_solve(const float* L, int ldl, int n, const float* Dinv,
                         const float* B, float* X, int p,
                         cudaStream_t stream) {
  if (n <= 0 || p <= 0) return 0;
  chol_solve_kernel<<<p, SOLVE_THREADS, 0, stream>>>(L, ldl, n, Dinv, B, X,
                                                     p);
  return ip_status();
}
