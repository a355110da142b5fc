// fp32 preconditioner Gram H32 = C^T diag(w) C (+ P) and the Jacobi
// equilibration (fp32 and, for K5's factors, fp64), for the step kernels
// (ops/pd_step.py and the orchestrations that share its pieces).
//
// Replaces pass 2 of the TPU step kernel
// (interiorpoint_tpu/ops/pallas_pd.py:_pd_step_core, the p2_body Gram
// accumulated over CH-row slabs on the MXU) and
// interiorpoint_tpu/ops/pallas_newton.py:_equilibrate.
//
// Precision: true fp32 FFMA, never TF32.  The factor of this matrix
// preconditions an fp64-refined solve, and refinement converges only when
// kappa * (factor error) < 1; a TF32 product (10-bit mantissa) is too
// coarse, for the reason interiorpoint_tpu/ops/pallas_chol.py:_dot gives.
//
// Bound: fp32 arithmetic, 2*k*r^2 flops on the lower triangle's tiles (the
// upper triangle is mirrored), reading an fp32 copy of C that the caller
// makes once per solve.  Design: 64 x 64 output tiles, 256 threads with a
// 4 x 4 register block each, 16-row stages of both column panels in shared
// memory.  Rows are split across blocks (split-K) so that narrow problems
// (r = 200: ten lower tiles) still fill the card; the per-split partial
// tiles (in the caller's workspace, ip_gram_ws_bytes) are summed by a
// second kernel in a fixed order (deterministic, no atomics), which also
// adds P and mirrors the result.
#include "common.cuh"

constexpr int GT = 64;   // output tile edge
constexpr int GK = 16;   // rows per shared-memory stage
constexpr int GRAM_MIN_BLOCKS = 264;  // two blocks per SM of an H100

// Row split: enough splits to give the lower tiles GRAM_MIN_BLOCKS blocks,
// each split a whole number of GK-row stages.
static void gram_split(int k, int r, int* nsplit, int* rows) {
  const int nt = (r + GT - 1) / GT;
  const int lower = nt * (nt + 1) / 2;
  int ns = (GRAM_MIN_BLOCKS + lower - 1) / lower;
  const int stages = (k + GK - 1) / GK;
  ns = ns < stages ? ns : stages;
  ns = ns > 1 ? ns : 1;
  const int per = (k + ns - 1) / ns;
  *rows = (per + GK - 1) / GK * GK;
  *nsplit = (k + *rows - 1) / *rows;
}

__global__ void __launch_bounds__(256)
gram_partial_kernel(const float* __restrict__ C32,
                    const double* __restrict__ w, float* __restrict__ part,
                    int k, int r, int rows_per_split) {
  const int ti = blockIdx.x, tj = blockIdx.y, sp = blockIdx.z;
  if (tj > ti) return;
  __shared__ float As[GK][GT];
  __shared__ float Bs[GK][GT];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;
  const int i0 = sp * rows_per_split;
  const int i1 = min(k, i0 + rows_per_split);
  for (int base = i0; base < i1; base += GK) {
    for (int e = threadIdx.x; e < GK * GT; e += 256) {
      const int rr = e / GT, cc = e % GT;
      const int row = base + rr;
      const int ca = ti * GT + cc, cb = tj * GT + cc;
      const bool live = row < i1;
      const float wr = live ? (float)w[row] : 0.f;
      As[rr][cc] = (live && ca < r) ? C32[(size_t)row * r + ca] * wr : 0.f;
      Bs[rr][cc] = (live && cb < r) ? C32[(size_t)row * r + cb] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = As[kk][ty * 4 + q];
        b[q] = Bs[kk][tx * 4 + q];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
    }
    __syncthreads();
  }
  float* out = part + (size_t)sp * r * r;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int gi = ti * GT + ty * 4 + p;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int gj = tj * GT + tx * 4 + q;
      if (gi < r && gj < r) out[(size_t)gi * r + gj] = acc[p][q];
    }
  }
}

// H[i][j] = H[j][i] = sum_s part[s][i][j] (+ P[i][j]) for i >= j
__global__ void gram_finish_kernel(const float* __restrict__ part,
                                   int nsplit, const float* __restrict__ P32,
                                   float* __restrict__ H, int r) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;
  if (j > i || i >= r) return;
  const size_t off = (size_t)i * r + j;
  float acc = 0.f;
  for (int s = 0; s < nsplit; ++s) acc += part[(size_t)s * r * r + off];
  if (P32) acc += P32[off];
  H[off] = acc;
  H[(size_t)j * r + i] = acc;
}

// Hs (np x np) = D H D on the leading r x r block, identity on the padding;
// dsc = diag(H)^(-1/2), 1 on the padding.  fp32 for the step kernels'
// preconditioners, fp64 for K5's factors (ops/kkt_step.py).
template <typename T>
__global__ void equilibrate_kernel(const T* __restrict__ H, int r,
                                   T* __restrict__ Hs, T* __restrict__ dsc,
                                   int np) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;
  if (j >= np) return;
  const T tiny = (T)1e-30;
  T v;
  if (i < r && j < r) {
    const T di = T(1) / sqrt(fmax(H[(size_t)i * r + i], tiny));
    const T dj = T(1) / sqrt(fmax(H[(size_t)j * r + j], tiny));
    v = H[(size_t)i * r + j] * di * dj;
  } else {
    v = (i == j) ? T(1) : T(0);
  }
  Hs[(size_t)i * np + j] = v;
  if (j == 0)
    dsc[i] = (i < r) ? T(1) / sqrt(fmax(H[(size_t)i * r + i], tiny)) : T(1);
}

// Workspace bytes of ip_gram for a k x r matrix C.
IP_API size_t ip_gram_ws_bytes(int k, int r) {
  int nsplit, rows;
  gram_split(k, r, &nsplit, &rows);
  return (size_t)nsplit * r * r * sizeof(float);
}

IP_API int ip_gram(const float* C32, const double* w, const float* P32,
                   float* ws, float* H, int k, int r, cudaStream_t stream) {
  int nsplit, rows;
  gram_split(k, r, &nsplit, &rows);
  const int nt = (r + GT - 1) / GT;
  dim3 grid(nt, nt, nsplit);
  gram_partial_kernel<<<grid, 256, 0, stream>>>(C32, w, ws, k, r, rows);
  dim3 g2((r + 127) / 128, r);
  gram_finish_kernel<<<g2, 128, 0, stream>>>(ws, nsplit, P32, H, r);
  return ip_status();
}

IP_API int ip_equilibrate(const float* H, int r, float* Hs, float* dsc,
                          int np, cudaStream_t stream) {
  dim3 grid((np + 127) / 128, np);
  equilibrate_kernel<float><<<grid, 128, 0, stream>>>(H, r, Hs, dsc, np);
  return ip_status();
}

IP_API int ip_equilibrate64(const double* H, int r, double* Hs, double* dsc,
                            int np, cudaStream_t stream) {
  dim3 grid((np + 127) / 128, np);
  equilibrate_kernel<double><<<grid, 128, 0, stream>>>(H, r, Hs, dsc, np);
  return ip_status();
}
