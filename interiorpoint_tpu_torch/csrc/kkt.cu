// Schur-preconditioner build of the dense-KKT direction (K5,
// ops/kkt_step.py), in fp64:
//   Y = W * diag(dsc) * F^T (r x pe), with W = L^-1 the inverse of H's
//     equilibrated fp64 factor (csrc/chol.cu), and
//   S = Y^T Y (pe x pe) ~ F H^-1 F^T, whose equilibrated factor
//     preconditions the Schur-CG.
//
// Replaces the in-body products of the TPU kernel
// interiorpoint_tpu/ops/pallas_kkt.py:_kkt_dir_kernel
// (Zt = _dot_nt(Fhi * dsc_r, W) at :167, the transpose of Y here, and
// S = Zt Zt^T), which the TPU formed in fp32 from an fp32 factor (it has
// no fp64).  Here both are fp64, so that near an LP vertex (kappa of the
// equilibrated H to 1e12) the preconditioner still contracts the
// refinement: an fp32 one does not (6e-8 * 1e12 >> 1).  S is then
// equilibrated and factored by csrc/gram.cu and csrc/chol.cu like H, at
// any pe (the TPU held S as one 128 x 128 tile, so pe <= 128 there).
//
// Bound: fp64 arithmetic.  Y: r^2 * pe flops on the lower triangle of W
// (a row tile of Y stops at its own diagonal), on DFMA: 64 x 64 output
// tiles, 256 threads with a 4 x 4 register block each, 16-column stages
// of W and of diag(dsc) F^T in shared memory.  S: r * pe^2 flops on the
// lower tiles, on the tensor cores (DMMA), with the rows of Y split across
// blocks so that a narrow pe (50: one tile) still fills the card; the
// per-split partial tiles (the caller's workspace, ip_kkt_gram64_ws_bytes)
// are summed in a fixed order by a second kernel, which also mirrors S.
#include "common.cuh"

constexpr int KT = 64;   // output tile edge
constexpr int KK = 16;   // columns of W (rows of Y) per shared stage

template <typename T>
__global__ void __launch_bounds__(256)
kkt_schur_kernel(const T* __restrict__ W, int ldw, const T* __restrict__ dsc,
                 const T* __restrict__ F, T* __restrict__ Y, int r, int pe) {
  const int ti = blockIdx.x, ta = blockIdx.y;
  __shared__ T Ws[KK][KT];   // Ws[j][i] = W[i][j] (j <= i)
  __shared__ T Fs[KK][KT];   // Fs[j][a] = dsc[j] * F[a][j]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  T acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0;
  const int i_base = ti * KT, a_base = ta * KT;
  // W is lower-triangular: row tile ti needs columns j < (ti + 1) * KT
  const int jmax = min(r, i_base + KT);
  for (int j0 = 0; j0 < jmax; j0 += KK) {
    for (int e = threadIdx.x; e < KK * KT; e += 256) {
      const int jj = e % KK, ii = e / KK;
      const int i = i_base + ii, j = j0 + jj;
      Ws[jj][ii] = (i < r && j < r && j <= i) ? W[(size_t)i * ldw + j] : T(0);
      const int a = a_base + ii;
      Fs[jj][ii] = (a < pe && j < r) ? dsc[j] * F[(size_t)a * r + j] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      T w[4], f[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        w[q] = Ws[kk][ty * 4 + q];
        f[q] = Fs[kk][tx * 4 + q];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fma(w[p], f[q], acc[p][q]);
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

// ---------------------------------------------------------------------------
// S = Y^T Y on DMMA
// ---------------------------------------------------------------------------

constexpr int SLD = 68;                 // shared row stride (4 mod 16)
constexpr int GRAM_MIN_BLOCKS = 264;    // two blocks per SM of an H100

// Row split of Y: enough splits to give the lower tiles GRAM_MIN_BLOCKS
// blocks, each split a whole number of KK-row stages.
static void schur_gram_split(int r, int pe, int* nsplit, int* rows) {
  const int nt = (pe + KT - 1) / KT;
  const int lower = nt * (nt + 1) / 2;
  int ns = (GRAM_MIN_BLOCKS + lower - 1) / lower;
  const int stages = (r + KK - 1) / KK;
  ns = ns < stages ? ns : stages;
  ns = ns > 1 ? ns : 1;
  const int per = (r + ns - 1) / ns;
  *rows = (per + KK - 1) / KK * KK;
  *nsplit = (r + *rows - 1) / *rows;
}

// part[sp] tile (ta, tb), ta >= tb: sum over this split's rows i of
// Y[i][a] Y[i][b].  Warp w owns rows 8w..8w+7 of the tile as eight 8 x 8
// DMMA tiles (ip_dmma's fragment layout).
__global__ void __launch_bounds__(256)
schur_gram_kernel(const double* __restrict__ Y, double* __restrict__ part,
                  int r, int pe, int rows_per_split) {
  const int ta = blockIdx.x, tb = blockIdx.y, sp = blockIdx.z;
  if (tb > ta) return;
  __shared__ double Ya[KK][SLD];
  __shared__ double Yb[KK][SLD];
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m0 = (threadIdx.x >> 5) * 8;
  double acc[8][2];
#pragma unroll
  for (int cb = 0; cb < 8; ++cb) acc[cb][0] = acc[cb][1] = 0.0;
  const int i0 = sp * rows_per_split;
  const int i1 = min(r, i0 + rows_per_split);
  for (int base = i0; base < i1; base += KK) {
    for (int e = threadIdx.x; e < KK * KT; e += 256) {
      const int rr = e / KT, cc = e % KT;
      const int i = base + rr, a = ta * KT + cc, b = tb * KT + cc;
      const bool live = i < i1;
      Ya[rr][cc] = (live && a < pe) ? Y[(size_t)i * pe + a] : 0.0;
      Yb[rr][cc] = (live && b < pe) ? Y[(size_t)i * pe + b] : 0.0;
    }
    __syncthreads();
#pragma unroll
    for (int k0 = 0; k0 < KK; k0 += 4) {
      const double av = Ya[k0 + t][m0 + g];
#pragma unroll
      for (int cb = 0; cb < 8; ++cb)
        ip_dmma(acc[cb], av, Yb[k0 + t][cb * 8 + g]);
    }
    __syncthreads();
  }
  double* out = part + (size_t)sp * pe * pe;
  const int a = ta * KT + m0 + g;
#pragma unroll
  for (int cb = 0; cb < 8; ++cb)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int b = tb * KT + cb * 8 + 2 * t + e;
      if (a < pe && b < pe) out[(size_t)a * pe + b] = acc[cb][e];
    }
}

// S[a][b] = S[b][a] = sum_s part[s][a][b] for a >= b
__global__ void schur_gram_finish_kernel(const double* __restrict__ part,
                                         int nsplit, double* __restrict__ S,
                                         int pe) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int a = blockIdx.y;
  if (b > a || a >= pe) return;
  const size_t off = (size_t)a * pe + b;
  double acc = 0.0;
  for (int s = 0; s < nsplit; ++s) acc += part[(size_t)s * pe * pe + off];
  S[off] = acc;
  S[(size_t)b * pe + a] = acc;
}

// Y (r x pe, row-major) = tril(W[:r, :r]) * diag(dsc[:r]) * F^T, W with
// row stride ldw, F (pe x r) row-major, all fp64.
IP_API int ip_kkt_schur64(const double* W, int ldw, const double* dsc,
                          const double* F, double* Y, int r, int pe,
                          cudaStream_t stream) {
  if (r <= 0 || pe <= 0) return 0;
  dim3 grid((r + KT - 1) / KT, (pe + KT - 1) / KT);
  kkt_schur_kernel<double><<<grid, 256, 0, stream>>>(W, ldw, dsc, F, Y, r,
                                                     pe);
  return ip_status();
}

// Workspace bytes of ip_kkt_gram64 for an r x pe matrix Y.
IP_API size_t ip_kkt_gram64_ws_bytes(int r, int pe) {
  int nsplit, rows;
  schur_gram_split(r, pe, &nsplit, &rows);
  return (size_t)nsplit * pe * pe * sizeof(double);
}

// S (pe x pe) = Y^T Y, fp64 on the tensor cores.
IP_API int ip_kkt_gram64(const double* Y, double* ws, double* S, int r,
                         int pe, cudaStream_t stream) {
  if (r <= 0 || pe <= 0) return 0;
  int nsplit, rows;
  schur_gram_split(r, pe, &nsplit, &rows);
  const int nt = (pe + KT - 1) / KT;
  schur_gram_kernel<<<dim3(nt, nt, nsplit), 256, 0, stream>>>(Y, ws, r, pe,
                                                              rows);
  dim3 g2((pe + 127) / 128, pe);
  schur_gram_finish_kernel<<<g2, 128, 0, stream>>>(ws, nsplit, S, pe);
  return ip_status();
}
