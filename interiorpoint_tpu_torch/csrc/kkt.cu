// Schur-preconditioner build of the dense-KKT direction (K5,
// ops/kkt_step.py): Y = W * diag(dsc) * F^T, the (r x pe) fp32 factor of
// S~ = Y^T Y ~ F H^-1 F^T, with W = L^-1 the inverse of H's equilibrated
// fp32 factor.
//
// Replaces the in-body products of the TPU kernel
// interiorpoint_tpu/ops/pallas_kkt.py:_kkt_dir_kernel
// (Zt = _dot_nt(Fhi * dsc_r, W) at :167, the transpose of Y here).  The
// second product S = Y^T Y is K1's weighted Gram (csrc/gram.cu ip_gram) on
// Y with unit weights, whose lower-triangle tiles and fixed-order split
// sums already fit an (r x pe) panel; S is then equilibrated and factored
// by csrc/gram.cu and csrc/chol.cu like H, at any pe (the TPU held S as
// one 128 x 128 tile, so pe <= 128 there).
//
// Precision: true fp32 FFMA, never TF32: S~ preconditions a Schur-CG whose
// rate depends on kappa * (its error), as H's factor does (csrc/gram.cu).
//
// Bound: fp32 arithmetic, r^2 * pe flops on the lower triangle of W (W is
// lower-triangular, so a row tile of Y stops at its own diagonal), reading
// W once per column tile of Y.  Design: 64 x 64 output tiles of Y, 256
// threads with a 4 x 4 register block each, 16-column stages of W and of
// diag(dsc) F^T in shared memory, as gram.cu's tiles.  At pe <= 64 the
// grid has only ceil(r / 64) blocks; the build is a small share of a
// direction (one per direction against ~3 + 3 * rounds refined solves).
#include "common.cuh"

constexpr int KT = 64;   // output tile edge
constexpr int KK = 16;   // columns of W per shared-memory stage

__global__ void __launch_bounds__(256)
kkt_schur_kernel(const float* __restrict__ W, int ldw,
                 const float* __restrict__ dsc, const float* __restrict__ F32,
                 float* __restrict__ Y, int r, int pe) {
  const int ti = blockIdx.x, ta = blockIdx.y;
  __shared__ float Ws[KK][KT];   // Ws[j][i] = W[i][j] (j <= i)
  __shared__ float Fs[KK][KT];   // Fs[j][a] = dsc[j] * F[a][j]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;
  const int i_base = ti * KT, a_base = ta * KT;
  // W is lower-triangular: row tile ti needs columns j < (ti + 1) * KT
  const int jmax = min(r, i_base + KT);
  for (int j0 = 0; j0 < jmax; j0 += KK) {
    for (int e = threadIdx.x; e < KK * KT; e += 256) {
      const int jj = e % KK, ii = e / KK;
      const int i = i_base + ii, j = j0 + jj;
      Ws[jj][ii] = (i < r && j < r && j <= i) ? W[(size_t)i * ldw + j] : 0.f;
      const int a = a_base + ii;
      Fs[jj][ii] = (a < pe && j < r) ? dsc[j] * F32[(size_t)a * r + j] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      float w[4], f[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        w[q] = Ws[kk][ty * 4 + q];
        f[q] = Fs[kk][tx * 4 + q];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(w[p], f[q], acc[p][q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int i = i_base + ty * 4 + p;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int a = a_base + tx * 4 + q;
      if (i < r && a < pe) Y[(size_t)i * pe + a] = acc[p][q];
    }
  }
}

// Y (r x pe, row-major) = tril(W[:r, :r]) * diag(dsc[:r]) * F32^T, W with
// row stride ldw, F32 (pe x r) row-major.
IP_API int ip_kkt_schur(const float* W, int ldw, const float* dsc,
                        const float* F32, float* Y, int r, int pe,
                        cudaStream_t stream) {
  if (r <= 0 || pe <= 0) return 0;
  dim3 grid((r + KT - 1) / KT, (pe + KT - 1) / KT);
  kkt_schur_kernel<<<grid, 256, 0, stream>>>(W, ldw, dsc, F32, Y, r, pe);
  return ip_status();
}
