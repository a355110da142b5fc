// Cone passes of the fused SOCP barrier Newton step (ops/socp_step.py, K4).
//
// Replaces the per-cone passes of the TPU kernel
// interiorpoint_tpu/ops/pallas_socp.py (_socp_step_kernel and _socp_core):
// pass 1 (lhs = A z + b, the per-cone sum of squares, rhs, the squared-cone
// slack and its weights), the per-cone G_k = A_k^T lhs_k - rhs_k c_k that
// the TPU builds in f32 for its Gram (p3_body) and whose weighted sum is
// the gradient's cone term (p2_body), the line-search coefficients
// (ls_body) and the closed-form cone sweep with the step's selection.  The
// TPU carries them as double-float32 pairs because it has no f64; here
// they are fp64.
//
// Cones are contiguous M-row blocks of the stacked (K*M) x r fp64 matrix A
// (row-major), so the cone of row i is i / M: the TPU's 0/1 membership
// matrix E and its matmuls (the segment sums, the weight scatter
// w_row = E w) are not needed.  A segment sum is a loop over the cone's
// own rows, and w_row is a gather.
//
// Bound: device-memory bandwidth.  Pass 1 and the G pass each stream A
// once in fp64 (30.4 MB at K=5, M=800, r=950) with two flops per element;
// the line-search pass reads A dx from the refined solve (hop.cu), not A;
// the per-cone reductions read K*M-vectors.  Design: one
// warp per row for A.x (as rows.cu), column tiles over 64-row chunks that
// never straddle a cone for the segmented A^T lhs, one block per cone for
// the segment sums, one thread per candidate for the sweep.  Every
// reduction runs in a fixed order (per-block partials, then a finishing
// pass): no atomics, so every result is deterministic.
#include "common.cuh"

namespace {

constexpr double SOCP_SLACK_EPS = 1e-12;  // ops/barrier.py SOCP_SLACK_EPS
constexpr double DOMAIN_MARGIN = 1e-6;    // sweep: 1 + u > 1e-6, 1 + sv > 1e-6
constexpr int CONE_ROWS = 8;        // warps (rows) per block of the row pass
constexpr int CONE_THREADS = 256;   // threads of a per-cone reduction block
constexpr int G_CHUNK = 64;         // rows per partial of the G pass
constexpr int G_COLS = 128;         // columns per block of the G pass
constexpr int SW_CONES = 128;       // cones per sweep block (= its threads)
constexpr int ELEM = 256;           // threads per block, elementwise passes

__device__ __forceinline__ double cone_row_dot(
    const double* __restrict__ row, const double* __restrict__ x, int r,
    int lane) {
  double acc = 0.0;
  for (int j = lane; j < r; j += 32) acc = fma(row[j], x[j], acc);
  return ip_warp_sum(acc);
}

// Sum of every thread's v over a CONE_THREADS block, in a fixed tree.
__device__ double cone_block_sum(double v, double* sh) {
  const int t = threadIdx.x;
  sh[t] = v;
  __syncthreads();
  for (int h = CONE_THREADS / 2; h > 0; h >>= 1) {
    if (t < h) sh[t] += sh[t + h];
    __syncthreads();
  }
  const double out = sh[0];
  __syncthreads();
  return out;
}

// phi(y) = -log(1 - y) - y without cancellation (rows.cu ip_phi): the
// series y^2 * sum_{m=0..15} y^m / (m + 2) for |y| < 0.1, else the direct
// form (y >= 1 gives inf or NaN: the candidate leaves the domain).
__device__ __forceinline__ double cone_phi(double y) {
  if (fabs(y) < 0.1) {
    double p = 1.0 / 17.0;
#pragma unroll
    for (int m = 14; m >= 0; --m) p = p * y + 1.0 / (m + 2);
    return y * y * p;
  }
  return -log1p(-y) - y;
}

// y_i = A_i . x (+ b_i; b may be null), one warp per row
__global__ void cone_rows_kernel(const double* __restrict__ A,
                                 const double* __restrict__ x,
                                 const double* __restrict__ b,
                                 double* __restrict__ y, int km, int r) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * CONE_ROWS + warp;
  if (i >= km) return;
  const double v = cone_row_dot(A + (size_t)i * r, x, r, lane);
  if (lane == 0) y[i] = b ? v + b[i] : v;
}

// pass 1, one block per cone k: ssq = sum_m lhs^2, rhs = c_k . z + d_k,
// s = rhs^2 - ssq, w = 2 / (s + eps)
__global__ void __launch_bounds__(CONE_THREADS)
socp_cone_kernel(const double* __restrict__ lhs,
                 const double* __restrict__ c,
                 const double* __restrict__ z,
                 const double* __restrict__ d, double* __restrict__ rhs,
                 double* __restrict__ s, double* __restrict__ w, int M,
                 int r) {
  __shared__ double sh[CONE_THREADS];
  const int k = blockIdx.x;
  const double* l = lhs + (size_t)k * M;
  double acc = 0.0;
  for (int m = threadIdx.x; m < M; m += CONE_THREADS)
    acc = fma(l[m], l[m], acc);
  const double ssq = cone_block_sum(acc, sh);
  const double* ck = c + (size_t)k * r;
  acc = 0.0;
  for (int j = threadIdx.x; j < r; j += CONE_THREADS)
    acc = fma(ck[j], z[j], acc);
  const double rk = cone_block_sum(acc, sh) + d[k];
  if (threadIdx.x == 0) {
    const double sk = rk * rk - ssq;
    rhs[k] = rk;
    s[k] = sk;
    w[k] = 2.0 / (sk + SOCP_SLACK_EPS);
  }
}

// w_row_i = w_{i / M}; block 0 also writes smin = min_k s_k (k in order)
__global__ void socp_wrow_kernel(const double* __restrict__ w,
                                 const double* __restrict__ s,
                                 double* __restrict__ w_row,
                                 double* __restrict__ smin, int K, int M) {
  const int i = blockIdx.x * ELEM + threadIdx.x;
  if (i < K * M) w_row[i] = w[i / M];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    double m = INFINITY;
    for (int k = 0; k < K; ++k) m = ip_nanmin(m, s[k]);
    smin[0] = m;
  }
}

// part[(k * nch + ch) * r + j] = sum of A[kM + m][j] * lhs[kM + m] over the
// rows m of chunk ch of cone k (blockIdx.x = k * nch + ch)
__global__ void socp_g_partial_kernel(const double* __restrict__ A,
                                      const double* __restrict__ lhs,
                                      double* __restrict__ part, int M,
                                      int r, int nch) {
  const int j = blockIdx.y * G_COLS + threadIdx.x;
  if (j >= r) return;
  const int k = blockIdx.x / nch, ch = blockIdx.x % nch;
  const int m0 = ch * G_CHUNK, m1 = min(M, m0 + G_CHUNK);
  const size_t base = (size_t)k * M;
  double acc = 0.0;
  for (int m = m0; m < m1; ++m)
    acc = fma(A[(base + m) * r + j], lhs[base + m], acc);
  part[(size_t)blockIdx.x * r + j] = acc;
}

// G[k][j] = sum_ch part - rhs_k c[k][j];  wG[j] = sum_k w_k G[k][j]
__global__ void socp_g_finish_kernel(const double* __restrict__ part,
                                     const double* __restrict__ c,
                                     const double* __restrict__ rhs,
                                     const double* __restrict__ w,
                                     double* __restrict__ G,
                                     double* __restrict__ wG, int K,
                                     int nch, int r) {
  const int j = blockIdx.x * G_COLS + threadIdx.x;
  if (j >= r) return;
  double acc_w = 0.0;
  for (int k = 0; k < K; ++k) {
    double a = 0.0;
    for (int ch = 0; ch < nch; ++ch)
      a += part[((size_t)k * nch + ch) * r + j];
    const double gk = a - rhs[k] * c[(size_t)k * r + j];
    G[(size_t)k * r + j] = gk;
    acc_w = fma(w[k], gk, acc_w);
  }
  wG[j] = acc_w;
}

// line-search coefficients, one block per cone k: ip1 = sum_m lhs * adx,
// ip2 = sum_m adx^2 (adx = A dx)
__global__ void __launch_bounds__(CONE_THREADS)
socp_ls_cone_kernel(const double* __restrict__ lhs,
                    const double* __restrict__ adx, double* __restrict__ ip1,
                    double* __restrict__ ip2, int M) {
  __shared__ double sh[CONE_THREADS];
  const int k = blockIdx.x;
  const double* l = lhs + (size_t)k * M;
  const double* a = adx + (size_t)k * M;
  double p = 0.0, q = 0.0;
  for (int m = threadIdx.x; m < M; m += CONE_THREADS) {
    p = fma(l[m], a[m], p);
    q = fma(a[m], a[m], q);
  }
  const double P = cone_block_sum(p, sh);
  const double Q = cone_block_sum(q, sh);
  if (threadIdx.x == 0) {
    ip1[k] = P;
    ip2[k] = Q;
  }
}

// The sweep over SW_CONES cones per block.  Per cone: a = p1 / (s + eps),
// b = p2 / (s + eps), v = cdx / rhs with p1 = 2 (rhs cdx - ip1),
// p2 = cdx^2 - ip2; per candidate j (one thread each), over the block's
// cones in order: the partial sum of phi(-u), u = sig_j a + sig_j^2 b, and
// the minima of u and of sig_j v; and the partial sum of b.
__global__ void __launch_bounds__(SW_CONES)
socp_sweep_partial_kernel(const double* __restrict__ ip1,
                          const double* __restrict__ ip2,
                          const double* __restrict__ cdx,
                          const double* __restrict__ rhs,
                          const double* __restrict__ s,
                          const double* __restrict__ sig, int J,
                          double* __restrict__ phi_part,
                          double* __restrict__ umin_part,
                          double* __restrict__ vmin_part,
                          double* __restrict__ bsum_part, int K) {
  __shared__ double sa[SW_CONES], sb[SW_CONES], sv[SW_CONES];
  const int t = threadIdx.x, k0 = blockIdx.x * SW_CONES;
  const int n = min(SW_CONES, K - k0);
  if (t < n) {
    const int k = k0 + t;
    const double ise = 1.0 / (s[k] + SOCP_SLACK_EPS);
    const double p1 = 2.0 * (rhs[k] * cdx[k] - ip1[k]);
    const double p2 = cdx[k] * cdx[k] - ip2[k];
    sa[t] = p1 * ise;
    sb[t] = p2 * ise;
    sv[t] = cdx[k] / rhs[k];
  }
  __syncthreads();
  for (int j = t; j < J; j += SW_CONES) {
    const double sj = sig[j];
    double ph = 0.0, um = INFINITY, vm = INFINITY;
    for (int q = 0; q < n; ++q) {
      const double u = sj * sa[q] + sj * sj * sb[q];
      ph += cone_phi(-u);
      um = ip_nanmin(um, u);
      vm = ip_nanmin(vm, sj * sv[q]);
    }
    const size_t o = (size_t)blockIdx.x * J + j;
    phi_part[o] = ph;
    umin_part[o] = um;
    vmin_part[o] = vm;
  }
  if (t == 0) {
    double B = 0.0;
    for (int q = 0; q < n; ++q) B += sb[q];
    bsum_part[blockIdx.x] = B;
  }
}

// One block: the candidates' Σphi, min u and min sig v over the nb sweep
// blocks (in order), then the selection: the first (largest) sig_j with
// min u > 1e-6 - 1, min sig v > 1e-6 - 1, Σphi finite and
// sig_j (1 - alpha) g.dx + sig_j^2 (q2 - sum b) + Σphi <= 0;
// sel = [sigma, index, any] (sigma = index = 0 when none passes).
__global__ void __launch_bounds__(SW_CONES)
socp_select_kernel(const double* __restrict__ phi_part,
                   const double* __restrict__ umin_part,
                   const double* __restrict__ vmin_part,
                   const double* __restrict__ bsum_part, int nb,
                   const double* __restrict__ sig, int J,
                   const double* __restrict__ gdx,
                   const double* __restrict__ q2, double alpha,
                   double* __restrict__ phisum, double* __restrict__ umin,
                   double* __restrict__ vmin, double* __restrict__ sel) {
  const int t = threadIdx.x;
  for (int j = t; j < J; j += SW_CONES) {
    double ph = 0.0, um = INFINITY, vm = INFINITY;
    for (int b = 0; b < nb; ++b) {
      const size_t o = (size_t)b * J + j;
      ph += phi_part[o];
      um = ip_nanmin(um, umin_part[o]);
      vm = ip_nanmin(vm, vmin_part[o]);
    }
    phisum[j] = ph;
    umin[j] = um;
    vmin[j] = vm;
  }
  __syncthreads();
  if (t == 0) {
    double B = 0.0;
    for (int b = 0; b < nb; ++b) B += bsum_part[b];
    const double g = (1.0 - alpha) * gdx[0], q = q2[0] - B;
    int idx = -1;
    for (int j = 0; j < J; ++j) {
      const double sj = sig[j];
      if (umin[j] > DOMAIN_MARGIN - 1.0 &&
          vmin[j] > DOMAIN_MARGIN - 1.0 &&
          isfinite(phisum[j]) && sj * g + sj * sj * q + phisum[j] <= 0.0) {
        idx = j;
        break;
      }
    }
    sel[0] = idx >= 0 ? sig[idx] : 0.0;
    sel[1] = idx >= 0 ? (double)idx : 0.0;
    sel[2] = idx >= 0 ? 1.0 : 0.0;
  }
}

// x' = z + sigma dx
__global__ void socp_xnew_kernel(const double* __restrict__ z,
                                 const double* __restrict__ dx,
                                 const double* __restrict__ sel,
                                 double* __restrict__ xnew, int r) {
  const int i = blockIdx.x * ELEM + threadIdx.x;
  if (i < r) xnew[i] = z[i] + sel[0] * dx[i];
}

// gdx = g . dx and q2 = dx . (tP dx) / 2 (0 without tP), one block
__global__ void __launch_bounds__(CONE_THREADS)
socp_dots_kernel(const double* __restrict__ g, const double* __restrict__ dx,
                 const double* __restrict__ tpdx, double* __restrict__ gdx,
                 double* __restrict__ q2, int r) {
  __shared__ double sh[CONE_THREADS];
  double a = 0.0, b = 0.0;
  for (int j = threadIdx.x; j < r; j += CONE_THREADS) {
    a = fma(g[j], dx[j], a);
    if (tpdx) b = fma(dx[j], tpdx[j], b);
  }
  const double A = cone_block_sum(a, sh);
  const double B = cone_block_sum(b, sh);
  if (threadIdx.x == 0) {
    gdx[0] = A;
    q2[0] = 0.5 * B;
  }
}

// the step's stats row (11, the ST_* of ops/newton_step.py): [-gdx/2,
// sigma, any accepted, rn2, gdx, bn2, q2, 0, dir_ok, index, min s], dir_ok
// = rn2 <= 1e-4 bn2 + 1e-30
__global__ void socp_stats_kernel(const double* __restrict__ gdx,
                                  const double* __restrict__ q2,
                                  const double* __restrict__ rn2,
                                  const double* __restrict__ bn2,
                                  const double* __restrict__ sel,
                                  const double* __restrict__ smin,
                                  double* __restrict__ st) {
  if (threadIdx.x != 0) return;
  st[0] = -0.5 * gdx[0];
  st[1] = sel[0];
  st[2] = sel[2];
  st[3] = rn2[0];
  st[4] = gdx[0];
  st[5] = bn2[0];
  st[6] = q2[0];
  st[7] = 0.0;
  st[8] = rn2[0] <= 1e-4 * bn2[0] + 1e-30 ? 1.0 : 0.0;
  st[9] = sel[1];
  st[10] = smin[0];
}

inline int g_chunks(int M) { return (M + G_CHUNK - 1) / G_CHUNK; }
inline int sweep_blocks(int K) { return (K + SW_CONES - 1) / SW_CONES; }
inline int blocks(int n, int per) { return (n + per - 1) / per; }

}  // namespace

// Workspace bytes of ip_socp_gcone for K cones of M rows over r columns:
// the G pass's partials.
IP_API size_t ip_socp_ws_bytes(int K, int M, int r) {
  return (size_t)K * g_chunks(M) * r * sizeof(double);
}

// Workspace bytes of ip_socp_sweep for K cones and J candidates.
IP_API size_t ip_socp_sweep_ws_bytes(int K, int J) {
  return (size_t)sweep_blocks(K) * (3 * (size_t)J + 1) * sizeof(double);
}

// Cones per block of ip_socp_sweep.
IP_API size_t ip_socp_sweep_cones() { return SW_CONES; }

// pass 1: lhs = A z + b (K*M), rhs, s, w (K), w_row (K*M), smin (0-d)
IP_API int ip_socp_pass1(const double* A, const double* z, const double* b,
                         const double* c, const double* d, double* lhs,
                         double* rhs, double* s, double* w, double* w_row,
                         double* smin, int K, int M, int r,
                         cudaStream_t stream) {
  if (K <= 0) return 0;
  const int km = K * M;
  cone_rows_kernel<<<blocks(km, CONE_ROWS), 32 * CONE_ROWS, 0, stream>>>(
      A, z, b, lhs, km, r);
  socp_cone_kernel<<<K, CONE_THREADS, 0, stream>>>(lhs, c, z, d, rhs, s, w,
                                                   M, r);
  socp_wrow_kernel<<<blocks(km, ELEM), ELEM, 0, stream>>>(w, s, w_row, smin,
                                                          K, M);
  return ip_status();
}

// G (K x r) and wG = sum_k w_k G_k (r); ws is ip_socp_ws_bytes(K, M, r)
IP_API int ip_socp_gcone(const double* A, const double* lhs, const double* c,
                         const double* rhs, const double* w, double* ws,
                         double* G, double* wG, int K, int M, int r,
                         cudaStream_t stream) {
  if (K <= 0 || r <= 0) return 0;
  const int nch = g_chunks(M);
  dim3 grid(K * nch, blocks(r, G_COLS));
  socp_g_partial_kernel<<<grid, G_COLS, 0, stream>>>(A, lhs, ws, M, r, nch);
  socp_g_finish_kernel<<<blocks(r, G_COLS), G_COLS, 0, stream>>>(
      ws, c, rhs, w, G, wG, K, nch, r);
  return ip_status();
}

// the line-search coefficients from A dx (the refined solve's last
// operator pass, ops/socp_step.py): ip1_k = sum lhs . A dx and
// ip2_k = sum (A dx)^2 over cone k's rows; reads no A
IP_API int ip_socp_lscoef(const double* adx, const double* lhs, double* ip1,
                          double* ip2, int K, int M, cudaStream_t stream) {
  if (K <= 0) return 0;
  socp_ls_cone_kernel<<<K, CONE_THREADS, 0, stream>>>(lhs, adx, ip1, ip2, M);
  return ip_status();
}

// phisum, umin, vmin (J), sel (3) and x' (r) from the coefficients and the
// candidates sig (J, fp64); ws is ip_socp_sweep_ws_bytes(K, J)
IP_API int ip_socp_sweep(const double* ip1, const double* ip2,
                         const double* cdx, const double* rhs,
                         const double* s, const double* sig, int J,
                         const double* gdx, const double* q2, double alpha,
                         const double* z, const double* dx, int r,
                         double* ws, double* phisum, double* umin,
                         double* vmin, double* sel, double* xnew, int K,
                         cudaStream_t stream) {
  if (K <= 0 || J <= 0) return 0;
  const int nb = sweep_blocks(K);
  double* phi_part = ws;
  double* umin_part = phi_part + (size_t)nb * J;
  double* vmin_part = umin_part + (size_t)nb * J;
  double* bsum_part = vmin_part + (size_t)nb * J;
  socp_sweep_partial_kernel<<<nb, SW_CONES, 0, stream>>>(
      ip1, ip2, cdx, rhs, s, sig, J, phi_part, umin_part, vmin_part,
      bsum_part, K);
  socp_select_kernel<<<1, SW_CONES, 0, stream>>>(
      phi_part, umin_part, vmin_part, bsum_part, nb, sig, J, gdx, q2, alpha,
      phisum, umin, vmin, sel);
  socp_xnew_kernel<<<blocks(r, ELEM), ELEM, 0, stream>>>(z, dx, sel, xnew,
                                                         r);
  return ip_status();
}

// gdx = g . dx and q2 = dx . tpdx / 2 (0-d; tpdx = tP dx, or null)
IP_API int ip_socp_dots(const double* g, const double* dx, const double* tpdx,
                        double* gdx, double* q2, int r, cudaStream_t stream) {
  socp_dots_kernel<<<1, CONE_THREADS, 0, stream>>>(g, dx, tpdx, gdx, q2, r);
  return ip_status();
}

// the step's stats row (11) from gdx, q2, the solve's rn2, bn2, the
// sweep's sel and pass 1's min s
IP_API int ip_socp_stats(const double* gdx, const double* q2,
                         const double* rn2, const double* bn2,
                         const double* sel, const double* smin, double* st,
                         cudaStream_t stream) {
  socp_stats_kernel<<<1, 32, 0, stream>>>(gdx, q2, rn2, bn2, sel, smin, st);
  return ip_status();
}
