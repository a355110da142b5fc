// fp32 preconditioner Gram H32 = C^T diag(w) C (+ P) and the Jacobi
// equilibration (fp32 and, for K5's factors, fp64), for the step kernels
// (ops/pd_step.py and the orchestrations that share its pieces: K1, K2,
// K4).
//
// Replaces pass 2 of the TPU step kernel
// (interiorpoint_tpu/ops/pallas_pd.py:_pd_step_core, the p2_body Gram
// accumulated over CH-row slabs on the MXU), the Gram half of the barrier
// kernel's fused pass 1 (interiorpoint_tpu/ops/pallas_newton.py:
// _direction_core, p1_body) and interiorpoint_tpu/ops/pallas_newton.py:
// _equilibrate.  The barrier step keeps pass 1 (ip_nt_pass1) a pass of
// its own: each w_i = 1/s_i^2 needs the whole row's fp64 dot C_i . z, which
// a column tile of the Gram does not see (the TPU fused the two because
// its slab spanned all of C's columns).
//
// Precision: true fp32 FFMA, never TF32.  The factor of this matrix
// preconditions an fp64-refined solve, and refinement converges only when
// kappa * (factor error) < 1; a TF32 product (10-bit mantissa) is too
// coarse, for the reason interiorpoint_tpu/ops/pallas_chol.py:_dot gives.
//
// Bound: fp32 arithmetic, k*r*(r+1) flops for the lower half, reading an
// fp32 copy of C that the caller makes once per solve (67 TFLOP/s on FFMA:
// 0.164 ms at 11000 x 1001).  Design:
//  * 128 x 128 output tiles, lower-triangle tiles only (the finish kernel
//    mirrors them), 256 threads with an 8 x 8 register block each (rows
//    4ty..4ty+3 and 64+4ty.., columns likewise), fed by 16-byte shared
//    loads: 4 loads per 64 FFMA;
//  * a 3-stage ring of 32-row slabs of both column panels in shared
//    memory, filled by cp.async while the previous slab is multiplied:
//    16-byte copies when C's rows are 16-byte aligned (the barrier step
//    pads its fp32 copy of C to a row stride that is a multiple of 4,
//    with zero columns), else 4-byte ones; ragged rows and columns
//    zero-filled;
//  * w applied once per staged row: the A panel is scaled in shared
//    memory by the row's weight (cast from fp64 once per row), so the
//    product is fl(C_ik w_k) C_jk, as the plain version's;
//  * split-K over rows so that the lower tiles fill two blocks per SM
//    (r = 200: three lower tiles), the per-split partial tiles (in the
//    caller's workspace, ip_gram_ws_bytes) summed by a second kernel in a
//    fixed order (deterministic, no atomics), which also adds P and
//    mirrors the result.
#include "common.cuh"

constexpr int GT = 128;             // output tile edge
constexpr int GK = 32;              // rows per shared-memory slab
constexpr int GSTAGES = 3;          // slabs in flight
constexpr int GTHREADS = 256;
constexpr int GRAM_SLOTS = 264;     // two blocks per SM of an H100
constexpr int GRAM_MIN_ROWS = 4 * GK;
constexpr int GRAM_SMEM = 2 * GSTAGES * GK * GT * 4 + GSTAGES * GK * 4;

// Lower tile index t -> (ii, jj), jj <= ii.
__device__ __forceinline__ void gram_lower_tile(int t, int* ii, int* jj) {
  int i = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  while (i * (i + 1) / 2 > t) --i;
  *ii = i;
  *jj = t - i * (i + 1) / 2;
}

// Row split: at most GRAM_SLOTS blocks over the lower tiles, each split a
// whole number of GK-row slabs and at least GRAM_MIN_ROWS rows.
static void gram_split(int k, int r, int* nsplit, int* rows) {
  const int nt = (r + GT - 1) / GT;
  const int lower = nt * (nt + 1) / 2;
  int ns = GRAM_SLOTS / lower;
  const int most = (k + GRAM_MIN_ROWS - 1) / GRAM_MIN_ROWS;
  ns = ns < most ? ns : most;
  ns = ns > 1 ? ns : 1;
  const int per = (k + ns - 1) / ns;
  *rows = (per + GK - 1) / GK * GK;
  *nsplit = k > 0 ? (k + *rows - 1) / *rows : 1;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool live) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = live ? 4 : 0;   // 0: zero-fill, nothing read
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool live) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = live ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__global__ void __launch_bounds__(GTHREADS, 2)
gram_tile_kernel(const float* __restrict__ C32, int ldc,
                 const double* __restrict__ w, float* __restrict__ part,
                 int k, int r, int rows) {
  extern __shared__ __align__(16) float gsm[];
  float* As = gsm;                              // [GSTAGES][GK][GT]
  float* Bs = gsm + GSTAGES * GK * GT;          // [GSTAGES][GK][GT]
  float* ws = gsm + 2 * GSTAGES * GK * GT;      // [GSTAGES][GK]
  int ti, tj;
  gram_lower_tile(blockIdx.x, &ti, &tj);
  const int i0 = blockIdx.y * rows;
  const int i1 = min(k, i0 + rows);
  const int nst = (i1 - i0 + GK - 1) / GK;
  const int ca0 = ti * GT, cb0 = tj * GT;
  const int tid = threadIdx.x;

  // rows 16-byte aligned (ldc a multiple of 4, the columns past r up to
  // ldc zero): 16-byte copies, else 4-byte ones
  const bool wide = (ldc % 4 == 0) &&
                    ((reinterpret_cast<size_t>(C32) & 15) == 0);
  const int cols = wide ? ldc : r;
  auto issue = [&](int st) {
    if (st < nst) {
      const int base = i0 + st * GK;
      const int buf = st % GSTAGES;
      float* a = As + buf * GK * GT;
      float* b = Bs + buf * GK * GT;
      if (wide) {
        for (int e = tid * 4; e < GK * GT; e += GTHREADS * 4) {
          const int rr = e / GT, cc = e % GT;
          const int row = base + rr;
          const bool la = row < i1 && ca0 + cc < cols;
          const bool lb = row < i1 && cb0 + cc < cols;
          cp_async16(a + e, la ? C32 + (size_t)row * ldc + ca0 + cc : C32,
                     la);
          cp_async16(b + e, lb ? C32 + (size_t)row * ldc + cb0 + cc : C32,
                     lb);
        }
      } else {
        for (int e = tid; e < GK * GT; e += GTHREADS) {
          const int rr = e / GT, cc = e % GT;
          const int row = base + rr;
          const bool la = row < i1 && ca0 + cc < r;
          const bool lb = row < i1 && cb0 + cc < r;
          cp_async4(a + e, la ? C32 + (size_t)row * ldc + ca0 + cc : C32, la);
          cp_async4(b + e, lb ? C32 + (size_t)row * ldc + cb0 + cc : C32, lb);
        }
      }
      if (tid < GK) {
        const int row = base + tid;
        ws[buf * GK + tid] = row < i1 ? (float)w[row] : 0.f;
      }
    }
    // one group per slab, empty ones too: the wait below counts them
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  issue(0);
  issue(1);
  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;
  const int tx = tid % 16, ty = tid / 16;
  for (int st = 0; st < nst; ++st) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const int buf = st % GSTAGES;
    float* a = As + buf * GK * GT;
    const float* b = Bs + buf * GK * GT;
    for (int e = tid; e < GK * GT; e += GTHREADS) a[e] *= ws[buf * GK + e / GT];
    __syncthreads();
    issue(st + 2);   // into the slab multiplied at st - 1
    // fully unrolled, a few registers spilled notwithstanding
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(a + kk * GT + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(a + kk * GT + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(b + kk * GT + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(b + kk * GT + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(av[p], bv[q], acc[p][q]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  float* out = part + (size_t)blockIdx.y * r * r;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int gi = ca0 + (p < 4 ? ty * 4 + p : 64 + ty * 4 + p - 4);
    if (gi >= r) continue;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int gj = cb0 + (q < 4 ? tx * 4 + q : 64 + tx * 4 + q - 4);
      if (gj < r) out[(size_t)gi * r + gj] = acc[p][q];
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

// H = C^T diag(w) C (+ P) for C32 k x r with row stride ldc >= r (when
// ldc is a multiple of 4, columns r..ldc-1 must hold zeros)
IP_API int ip_gram(const float* C32, int ldc, const double* w,
                   const float* P32, float* ws, float* H, int k, int r,
                   cudaStream_t stream) {
  if (r <= 0) return 0;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        gram_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        GRAM_SMEM);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  int nsplit, rows;
  gram_split(k, r, &nsplit, &rows);
  const int nt = (r + GT - 1) / GT;
  if (k > 0) {
    dim3 grid(nt * (nt + 1) / 2, nsplit);
    gram_tile_kernel<<<grid, GTHREADS, GRAM_SMEM, stream>>>(C32, ldc, w, ws,
                                                            k, r, rows);
  } else {
    cudaMemsetAsync(ws, 0, (size_t)r * r * sizeof(float), stream);
  }
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
