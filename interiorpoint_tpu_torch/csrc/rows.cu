// fp64 passes over the rows of the reduced constraint matrix C (k x r,
// row-major) for the primal-dual step (ops/pd_step.py) and the barrier
// Newton step (ops/newton_step.py).
//
// Replaces the chunked dd passes over C inside the TPU step kernel
// (interiorpoint_tpu/ops/pallas_pd.py:_pd_step_core, pass 1, rhs, ds and
// update bodies) and the resident/stream foreach helpers they run on
// (interiorpoint_tpu/ops/pallas_newton.py:_make_foreach_resident,
// _make_foreach_stream).  Hopper has native fp64, so the double-float
// pairs become plain doubles and the resident/stream split (a VMEM limit)
// becomes one path.
//
// Bound: device-memory bandwidth.  Each pass streams C once in fp64
// (88 MB at 11000 x 1000) and does two flops per element.  Design: one
// warp per row for C.x (lanes stride the row, so a warp reads contiguous
// 256-byte segments), and column tiles of 128 threads over 64-row chunks
// for C^T.v (neighbouring threads read neighbouring columns).  Reductions
// are per-block partials in the caller's workspace (ip_rows_ws_bytes),
// finished by a second kernel in a fixed order into 0-d outputs: no
// atomics, so every result is deterministic.
#include "common.cuh"

constexpr int ROWS_PER_BLOCK = 8;   // warps (rows) per block
constexpr int ELEM_BLOCK = 256;     // threads per block, elementwise passes
constexpr int CT_CHUNK = 64;        // rows per C^T.v partial
constexpr int CT_COLS = 128;        // columns per C^T.v block

__device__ __forceinline__ double row_dot(const double* __restrict__ row,
                                          const double* __restrict__ x,
                                          int r, int lane) {
  double acc = 0.0;
  for (int j = lane; j < r; j += 32) acc = fma(row[j], x[j], acc);
  return ip_warp_sum(acc);
}

// y_i = w_i * (C_i . x)   (w may be null: y = C x); cx, when not null,
// keeps C_i . x itself (the barrier step's sweep reads C dx from the last
// operator application of its refinement, as the TPU kernel's side
// channel, interiorpoint_tpu/ops/pallas_newton.py:703-737)
__global__ void c_matvec_kernel(const double* __restrict__ C,
                                const double* __restrict__ x,
                                const double* __restrict__ w,
                                double* __restrict__ y,
                                double* __restrict__ cx, int k, int r) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * ROWS_PER_BLOCK + warp;
  if (i >= k) return;
  const double v = row_dot(C + (size_t)i * r, x, r, lane);
  if (lane == 0) {
    y[i] = w ? w[i] * v : v;
    if (cx) cx[i] = v;
  }
}

__global__ void ct_partial_kernel(const double* __restrict__ C,
                                  const double* __restrict__ v,
                                  double* __restrict__ part, int k, int r) {
  const int j = blockIdx.x * CT_COLS + threadIdx.x;
  if (j >= r) return;
  const int i0 = blockIdx.y * CT_CHUNK;
  const int i1 = min(k, i0 + CT_CHUNK);
  double acc = 0.0;
  for (int i = i0; i < i1; ++i) acc = fma(C[(size_t)i * r + j], v[i], acc);
  part[(size_t)blockIdx.y * r + j] = acc;
}

__global__ void ct_finish_kernel(const double* __restrict__ part,
                                 double* __restrict__ out, int nchunk,
                                 int r) {
  const int j = blockIdx.x * CT_COLS + threadIdx.x;
  if (j >= r) return;
  double acc = 0.0;
  for (int c = 0; c < nchunk; ++c) acc += part[(size_t)c * r + j];
  out[j] = acc;
}

// pass 1: rp = Cz + s - d, 1/s, w = lam/s; partials of sum(s*lam), max|rp|
__global__ void pd_pass1_kernel(const double* __restrict__ C,
                                const double* __restrict__ z,
                                const double* __restrict__ s,
                                const double* __restrict__ lam,
                                const double* __restrict__ d,
                                double* __restrict__ rp,
                                double* __restrict__ inv_s,
                                double* __restrict__ w,
                                double* __restrict__ gap_part,
                                double* __restrict__ rpmax_part,
                                int k, int r) {
  __shared__ double sg[ROWS_PER_BLOCK], sm[ROWS_PER_BLOCK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * ROWS_PER_BLOCK + warp;
  double g = 0.0, m = 0.0;
  if (i < k) {
    const double cz = row_dot(C + (size_t)i * r, z, r, lane);
    const double si = s[i], li = lam[i];
    const double rpi = cz + si - d[i];
    const double isi = 1.0 / si;
    if (lane == 0) {
      rp[i] = rpi;
      inv_s[i] = isi;
      w[i] = li * isi;
    }
    g = si * li;
    m = fabs(rpi);
  }
  if (lane == 0) {
    sg[warp] = g;
    sm[warp] = m;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double G = 0.0, M = 0.0;
    for (int q = 0; q < ROWS_PER_BLOCK; ++q) {
      G += sg[q];
      M = ip_nanmax(M, sm[q]);
    }
    gap_part[blockIdx.x] = G;
    rpmax_part[blockIdx.x] = M;
  }
}

// rc = s*lam - sig_mu (+ ds*dl), t = (rc - lam*rp) / s
__global__ void pd_rhs_kernel(const double* __restrict__ s,
                              const double* __restrict__ lam,
                              const double* __restrict__ rp,
                              const double* __restrict__ inv_s,
                              const double* __restrict__ ds,
                              const double* __restrict__ dl,
                              const double* __restrict__ sig_mu,
                              int use_corr, double* __restrict__ rc,
                              double* __restrict__ t, int k) {
  const int i = blockIdx.x * ELEM_BLOCK + threadIdx.x;
  if (i >= k) return;
  double rci = s[i] * lam[i] - sig_mu[0];
  if (use_corr) rci += ds[i] * dl[i];
  rc[i] = rci;
  t[i] = (rci - lam[i] * rp[i]) * inv_s[i];
}

// ds = -rp - C dz, dl = (-rc - lam*ds)/s; partial minima of the step ratios
__global__ void pd_ds_kernel(const double* __restrict__ C,
                             const double* __restrict__ dz,
                             const double* __restrict__ rp,
                             const double* __restrict__ rc,
                             const double* __restrict__ lam,
                             const double* __restrict__ s,
                             const double* __restrict__ inv_s,
                             double* __restrict__ ds,
                             double* __restrict__ dl,
                             double* __restrict__ ap_part,
                             double* __restrict__ ad_part, int k, int r) {
  __shared__ double sp[ROWS_PER_BLOCK], sd[ROWS_PER_BLOCK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * ROWS_PER_BLOCK + warp;
  double ap = INFINITY, ad = INFINITY;
  if (i < k) {
    const double y = row_dot(C + (size_t)i * r, dz, r, lane);
    const double dsi = -rp[i] - y;
    const double dli = (-rc[i] - lam[i] * dsi) * inv_s[i];
    if (lane == 0) {
      ds[i] = dsi;
      dl[i] = dli;
    }
    if (dsi < 0.0) ap = -s[i] / dsi;
    if (dli < 0.0) ad = -lam[i] / dli;
  }
  if (lane == 0) {
    sp[warp] = ap;
    sd[warp] = ad;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double P = INFINITY, D = INFINITY;
    for (int q = 0; q < ROWS_PER_BLOCK; ++q) {
      P = ip_nanmin(P, sp[q]);
      D = ip_nanmin(D, sd[q]);
    }
    ap_part[blockIdx.x] = P;
    ad_part[blockIdx.x] = D;
  }
}

// s' = s + ap*ds, lam' = lam + ad*dl; partial sums of s'*lam'
__global__ void pd_update_kernel(const double* __restrict__ s,
                                 const double* __restrict__ lam,
                                 const double* __restrict__ ds,
                                 const double* __restrict__ dl,
                                 const double* __restrict__ ap,
                                 const double* __restrict__ ad,
                                 double* __restrict__ s2,
                                 double* __restrict__ lam2,
                                 double* __restrict__ gap_part, int k) {
  __shared__ double sh[ELEM_BLOCK / 32];
  const int i = blockIdx.x * ELEM_BLOCK + threadIdx.x;
  double g = 0.0;
  if (i < k) {
    const double a = s[i] + ap[0] * ds[i];
    const double b = lam[i] + ad[0] * dl[i];
    s2[i] = a;
    lam2[i] = b;
    g = a * b;
  }
  g = ip_warp_sum(g);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = g;
  __syncthreads();
  if (threadIdx.x == 0) {
    double G = 0.0;
    for (int q = 0; q < ELEM_BLOCK / 32; ++q) G += sh[q];
    gap_part[blockIdx.x] = G;
  }
}

enum { IP_SUM = 0, IP_MAX = 1, IP_MIN = 2 };

__device__ __forceinline__ double ip_combine(int op, double a, double b) {
  return op == IP_SUM ? a + b : op == IP_MAX ? ip_nanmax(a, b)
                                             : ip_nanmin(a, b);
}

// out_b[0] = reduce(op_b, part_b[0:n]) for b = blockIdx.x (one or two
// reductions per launch), each in a fixed order.
constexpr int FINISH_THREADS = 256;
__global__ void __launch_bounds__(FINISH_THREADS)
finish_kernel(const double* __restrict__ part0, int op0,
              double* __restrict__ out0, const double* __restrict__ part1,
              int op1, double* __restrict__ out1, int n) {
  __shared__ double sh[FINISH_THREADS];
  const int t = threadIdx.x;
  const double* part = blockIdx.x ? part1 : part0;
  const int op = blockIdx.x ? op1 : op0;
  double acc = op == IP_SUM ? 0.0 : op == IP_MAX ? -INFINITY : INFINITY;
  for (int i = t; i < n; i += FINISH_THREADS)
    acc = ip_combine(op, acc, part[i]);
  sh[t] = acc;
  __syncthreads();
  for (int h = FINISH_THREADS / 2; h > 0; h >>= 1) {
    if (t < h) sh[t] = ip_combine(op, sh[t], sh[t + h]);
    __syncthreads();
  }
  if (t == 0) (blockIdx.x ? out1 : out0)[0] = sh[0];
}

static inline int row_blocks(int k) {
  return (k + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
}
static inline int elem_blocks(int k) {
  return (k + ELEM_BLOCK - 1) / ELEM_BLOCK;
}
static inline int ct_chunks(int k) { return (k + CT_CHUNK - 1) / CT_CHUNK; }

// Workspace bytes that every entry below needs for a k x r matrix C.
IP_API size_t ip_rows_ws_bytes(int k, int r) {
  size_t n = (size_t)ct_chunks(k) * r;
  n = n > (size_t)2 * row_blocks(k) ? n : (size_t)2 * row_blocks(k);
  n = n > (size_t)elem_blocks(k) ? n : (size_t)elem_blocks(k);
  return n * sizeof(double);
}

IP_API int ip_c_matvec(const double* C, const double* x, const double* w,
                       double* y, int k, int r, cudaStream_t stream) {
  if (k <= 0) return 0;
  c_matvec_kernel<<<row_blocks(k), 32 * ROWS_PER_BLOCK, 0, stream>>>(
      C, x, w, y, nullptr, k, r);
  return ip_status();
}

// y = w * (C x) and cx = C x in one pass
IP_API int ip_c_matvec_keep(const double* C, const double* x,
                            const double* w, double* y, double* cx, int k,
                            int r, cudaStream_t stream) {
  if (k <= 0) return 0;
  c_matvec_kernel<<<row_blocks(k), 32 * ROWS_PER_BLOCK, 0, stream>>>(
      C, x, w, y, cx, k, r);
  return ip_status();
}

IP_API int ip_ct_matvec(const double* C, const double* v, double* ws,
                        double* out, int k, int r, cudaStream_t stream) {
  if (k <= 0 || r <= 0) return 0;
  const int nchunk = ct_chunks(k);
  dim3 grid((r + CT_COLS - 1) / CT_COLS, nchunk);
  ct_partial_kernel<<<grid, CT_COLS, 0, stream>>>(C, v, ws, k, r);
  ct_finish_kernel<<<(r + CT_COLS - 1) / CT_COLS, CT_COLS, 0, stream>>>(
      ws, out, nchunk, r);
  return ip_status();
}

// ... and gap = sum(s*lam), rpmax = max|rp| (0-d)
IP_API int ip_pd_pass1(const double* C, const double* z, const double* s,
                       const double* lam, const double* d, double* rp,
                       double* inv_s, double* w, double* ws, double* gap,
                       double* rpmax, int k, int r, cudaStream_t stream) {
  const int nb = row_blocks(k);
  pd_pass1_kernel<<<nb, 32 * ROWS_PER_BLOCK, 0, stream>>>(
      C, z, s, lam, d, rp, inv_s, w, ws, ws + nb, k, r);
  finish_kernel<<<2, FINISH_THREADS, 0, stream>>>(ws, IP_SUM, gap, ws + nb,
                                                  IP_MAX, rpmax, nb);
  return ip_status();
}

IP_API int ip_pd_rhs(const double* s, const double* lam, const double* rp,
                     const double* inv_s, const double* ds,
                     const double* dl, const double* sig_mu, int use_corr,
                     double* rc, double* t, int k, cudaStream_t stream) {
  pd_rhs_kernel<<<elem_blocks(k), ELEM_BLOCK, 0, stream>>>(
      s, lam, rp, inv_s, ds, dl, sig_mu, use_corr, rc, t, k);
  return ip_status();
}

// ... and the step-ratio minima ap, ad (0-d, +inf when none binds)
IP_API int ip_pd_ds(const double* C, const double* dz, const double* rp,
                    const double* rc, const double* lam, const double* s,
                    const double* inv_s, double* ds, double* dl, double* ws,
                    double* ap, double* ad, int k, int r,
                    cudaStream_t stream) {
  const int nb = row_blocks(k);
  pd_ds_kernel<<<nb, 32 * ROWS_PER_BLOCK, 0, stream>>>(
      C, dz, rp, rc, lam, s, inv_s, ds, dl, ws, ws + nb, k, r);
  finish_kernel<<<2, FINISH_THREADS, 0, stream>>>(ws, IP_MIN, ap, ws + nb,
                                                  IP_MIN, ad, nb);
  return ip_status();
}

// ---------------------------------------------------------------------------
// Barrier Newton step (K2): replaces pass 1 and the closed-form line-search
// sweep of the TPU kernel interiorpoint_tpu/ops/pallas_newton.py
// (_direction_core p1_body, _newton_step_kernel sw_body and selection).
// The TPU sweeps in f32 because it has no f64; here the sweep is fp64, the
// rule of the fp64 reference (interiorpoint_tpu/ops/barrier.py ls_objs).
// Bound: pass 1 streams C once (bandwidth); the sweep reads two k-vectors
// and evaluates k*J values of phi (a few microseconds at k = 11000).
// ---------------------------------------------------------------------------

// pass 1: s = d - Cz, 1/s, w = 1/s^2; partial minima of s
__global__ void nt_pass1_kernel(const double* __restrict__ C,
                                const double* __restrict__ z,
                                const double* __restrict__ d,
                                double* __restrict__ s,
                                double* __restrict__ inv_s,
                                double* __restrict__ w,
                                double* __restrict__ smin_part, int k,
                                int r) {
  __shared__ double sm[ROWS_PER_BLOCK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * ROWS_PER_BLOCK + warp;
  double m = INFINITY;
  if (i < k) {
    const double si = d[i] - row_dot(C + (size_t)i * r, z, r, lane);
    const double isi = 1.0 / si;
    if (lane == 0) {
      s[i] = si;
      inv_s[i] = isi;
      w[i] = isi * isi;
    }
    m = si;
  }
  if (lane == 0) sm[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    double M = INFINITY;
    for (int q = 0; q < ROWS_PER_BLOCK; ++q) M = ip_nanmin(M, sm[q]);
    smin_part[blockIdx.x] = M;
  }
}

// phi(y) = -log(1 - y) - y without cancellation: for |y| < 0.1 the series
// y^2 * sum_{m=0..15} y^m / (m + 2) (truncation < 1e-16 relative), else the
// direct form (y >= 1 gives inf or NaN: the candidate leaves the domain).
// The fp64 counterpart of pallas_newton.py:_phi_stable.
__device__ __forceinline__ double ip_phi(double y) {
  if (fabs(y) < 0.1) {
    double p = 1.0 / 17.0;
#pragma unroll
    for (int m = 14; m >= 0; --m) p = p * y + 1.0 / (m + 2);
    return y * y * p;
  }
  return -log1p(-y) - y;
}

constexpr int SW_ROWS = 128;   // rows per sweep block (= threads)

// u_i = (C dx)_i / s_i; per block: partial sum over its rows of
// phi(sig_j * u_i) for every candidate j (rows in order), and max u
__global__ void __launch_bounds__(SW_ROWS)
nt_sweep_kernel(const double* __restrict__ cdx,
                const double* __restrict__ inv_s,
                const double* __restrict__ sig, int J,
                double* __restrict__ phi_part,
                double* __restrict__ umax_part, int k) {
  __shared__ double su[SW_ROWS];
  const int t = threadIdx.x;
  const int i0 = blockIdx.x * SW_ROWS;
  const int n = min(SW_ROWS, k - i0);
  su[t] = t < n ? cdx[i0 + t] * inv_s[i0 + t] : 0.0;
  __syncthreads();
  for (int j = t; j < J; j += SW_ROWS) {
    const double sj = sig[j];
    double acc = 0.0;
    for (int q = 0; q < n; ++q) acc += ip_phi(sj * su[q]);
    phi_part[(size_t)blockIdx.x * J + j] = acc;
  }
  if (t == 0) {
    double M = -INFINITY;
    for (int q = 0; q < n; ++q) M = ip_nanmax(M, su[q]);
    umax_part[blockIdx.x] = M;
  }
}

// Selection: the first (largest) candidate with sig_j * umax < 1 - 1e-6 and
// sig_j (1 - alpha) g.dx + sig_j^2 q2 + phisum_j <= 0 (phisum_j finite);
// sel = [sigma, index, any_acc] (sigma = index = 0 when none passes), and
// x' = z + sigma * dx.  Every block repeats the J tests; block 0 writes sel.
__global__ void nt_select_kernel(const double* __restrict__ phisum,
                                 const double* __restrict__ umax,
                                 const double* __restrict__ sig, int J,
                                 const double* __restrict__ gdx,
                                 const double* __restrict__ q2,
                                 double alpha, const double* __restrict__ z,
                                 const double* __restrict__ dx, int r,
                                 double* __restrict__ sel,
                                 double* __restrict__ xnew) {
  __shared__ double s_sigma;
  if (threadIdx.x == 0) {
    const double g = (1.0 - alpha) * gdx[0], q = q2[0], um = umax[0];
    int idx = -1;
    for (int j = 0; j < J; ++j) {
      const double sj = sig[j], ph = phisum[j];
      if (sj * um < 1.0 - 1e-6 && isfinite(ph) &&
          sj * g + sj * sj * q + ph <= 0.0) {
        idx = j;
        break;
      }
    }
    s_sigma = idx >= 0 ? sig[idx] : 0.0;
    if (blockIdx.x == 0) {
      sel[0] = s_sigma;
      sel[1] = idx >= 0 ? (double)idx : 0.0;
      sel[2] = idx >= 0 ? 1.0 : 0.0;
    }
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < r) xnew[i] = z[i] + s_sigma * dx[i];
}

static inline int sweep_blocks(int k) { return (k + SW_ROWS - 1) / SW_ROWS; }

// Workspace bytes of ip_nt_sweep for k rows and J candidates.
IP_API size_t ip_sweep_ws_bytes(int k, int J) {
  return (size_t)sweep_blocks(k) * (J + 1) * sizeof(double);
}

// Rows per block of ip_nt_sweep (each block's partial sums and maximum).
IP_API size_t ip_sweep_rows() { return SW_ROWS; }

// ... and smin = min(s) (0-d); ws is ip_rows_ws_bytes(k, r)
IP_API int ip_nt_pass1(const double* C, const double* z, const double* d,
                       double* s, double* inv_s, double* w, double* ws,
                       double* smin, int k, int r, cudaStream_t stream) {
  const int nb = row_blocks(k);
  nt_pass1_kernel<<<nb, 32 * ROWS_PER_BLOCK, 0, stream>>>(C, z, d, s, inv_s,
                                                          w, ws, k, r);
  finish_kernel<<<1, FINISH_THREADS, 0, stream>>>(ws, IP_MIN, smin, ws,
                                                  IP_MIN, smin, nb);
  return ip_status();
}

// phisum (J), umax (0-d), sel (3) and x' (r) from C dx, 1/s and the
// candidates sig (J, fp64); ws is ip_sweep_ws_bytes(k, J)
IP_API int ip_nt_sweep(const double* cdx, const double* inv_s,
                       const double* sig, int J, const double* gdx,
                       const double* q2, double alpha, const double* z,
                       const double* dx, int r, double* ws, double* phisum,
                       double* umax, double* sel, double* xnew, int k,
                       cudaStream_t stream) {
  const int nb = sweep_blocks(k);
  double* phi_part = ws;
  double* umax_part = ws + (size_t)nb * J;
  nt_sweep_kernel<<<nb, SW_ROWS, 0, stream>>>(cdx, inv_s, sig, J, phi_part,
                                              umax_part, k);
  ct_finish_kernel<<<(J + CT_COLS - 1) / CT_COLS, CT_COLS, 0, stream>>>(
      phi_part, phisum, nb, J);
  finish_kernel<<<1, FINISH_THREADS, 0, stream>>>(umax_part, IP_MAX, umax,
                                                  umax_part, IP_MAX, umax,
                                                  nb);
  nt_select_kernel<<<(r + ELEM_BLOCK - 1) / ELEM_BLOCK, ELEM_BLOCK, 0,
                     stream>>>(phisum, umax, sig, J, gdx, q2, alpha, z, dx,
                               r, sel, xnew);
  return ip_status();
}

// ... and the new gap = sum(s'*lam') (0-d)
IP_API int ip_pd_update(const double* s, const double* lam,
                        const double* ds, const double* dl,
                        const double* ap, const double* ad, double* s2,
                        double* lam2, double* ws, double* gap, int k,
                        cudaStream_t stream) {
  const int nb = elem_blocks(k);
  pd_update_kernel<<<nb, ELEM_BLOCK, 0, stream>>>(s, lam, ds, dl, ap, ad,
                                                  s2, lam2, ws, k);
  finish_kernel<<<1, FINISH_THREADS, 0, stream>>>(ws, IP_SUM, gap, ws,
                                                  IP_SUM, gap, nb);
  return ip_status();
}
