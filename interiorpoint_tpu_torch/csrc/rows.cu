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
// for C^T.v (neighbouring threads read neighbouring columns).  K1's pass 1
// and right-hand side are strip passes (strip.cuh): one read of C gives
// both C z and C^T lam, or t and C^T t; its ds pass reads C dz from the
// refined solve (hop.cu) and no C.  Reductions are per-block partials in
// the caller's workspace (ip_rows_ws_bytes, ip_pd_ws_bytes), finished by
// a second kernel in a fixed order into 0-d outputs: no atomics, so every
// result is deterministic.
#include "strip.cuh"

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

// y_i = w_i * (C_i . x)   (w may be null: y = C x)
__global__ void c_matvec_kernel(const double* __restrict__ C,
                                const double* __restrict__ x,
                                const double* __restrict__ w,
                                double* __restrict__ y, int k, int r) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * ROWS_PER_BLOCK + warp;
  if (i >= k) return;
  const double v = row_dot(C + (size_t)i * r, x, r, lane);
  if (lane == 0) y[i] = w ? w[i] * v : v;
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

// pass 1, one strip pass over C (strip.cuh): rp = Cz + s - d, 1/s,
// w = lam/s, per-block partials of sum(s*lam) and max|rp|, the column
// partials of C^T lam and (QP) P z
template <bool XG>
__global__ void __launch_bounds__(SP_THREADS, 1)
pd_pass1_kernel(const double* __restrict__ C, const double* __restrict__ z,
                const double* __restrict__ s, const double* __restrict__ lam,
                const double* __restrict__ d, const double* __restrict__ P,
                double* __restrict__ rp, double* __restrict__ inv_s,
                double* __restrict__ w, double* part, double* pz,
                double* __restrict__ gap_part,
                double* __restrict__ rpmax_part, int k, int r, SpGeom g) {
  __shared__ double sg[SP_WARPS], sm[SP_WARPS];
  const SpSmem sh = sp_smem(g, r);
  const double* zs;
  double* acc;
  sp_begin<XG>(sh, z, part, r, &zs, &acc);
  double G = 0.0, Mx = 0.0;   // lane 0 of each warp: its rows'
  sp_loop<true, XG>(C, k, r, g, zs, acc, sh.tiles, sh.ys,
                    [&](int i, double cz) {
                      const double si = s[i], li = lam[i];
                      const double rpi = cz + si - d[i];
                      const double isi = 1.0 / si;
                      rp[i] = rpi;
                      inv_s[i] = isi;
                      w[i] = li * isi;
                      G += si * li;
                      Mx = ip_nanmax(Mx, fabs(rpi));
                      return li;
                    });
  sp_end<XG>(sh, part, r);
  if (P) sp_prows<XG>(P, r, zs, pz);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sg[warp] = G;
    sm[warp] = Mx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double Gs = 0.0, Ms = 0.0;
    for (int q = 0; q < SP_WARPS; ++q) {
      Gs += sg[q];
      Ms = ip_nanmax(Ms, sm[q]);
    }
    gap_part[blockIdx.x] = Gs;
    rpmax_part[blockIdx.x] = Ms;
  }
}

// rd = q + C^T lam (+ P z) from pass 1's partials; per 32-column chunk,
// max |rd|
__global__ void __launch_bounds__(SP_THREADS)
pd_rd_kernel(const double* part, int nb, const double* __restrict__ q,
             const double* pz, double* __restrict__ rd,
             double* __restrict__ rdmax_part, int r) {
  const int c = blockIdx.x;
  const double v = sp_chunk_sum(part, nb, r, c);
  if (threadIdx.x < SP_CHUNK) {
    const int j = c * SP_CHUNK + threadIdx.x;
    double m = 0.0;
    if (j < r) {
      double t = q[j] + v;
      if (pz) t += pz[j];
      rd[j] = t;
      m = fabs(t);
    }
    for (int o = 16; o > 0; o >>= 1)
      m = ip_nanmax(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (threadIdx.x == 0) rdmax_part[c] = m;
  }
}

// the right-hand side, one strip pass over C that reads no row twice:
// rc = s*lam - sig_mu (+ ds*dl), t = (rc - lam*rp) / s, the column
// partials of C^T t
template <bool XG>
__global__ void __launch_bounds__(SP_THREADS, 1)
pd_rhs_kernel(const double* __restrict__ C, const double* __restrict__ s,
              const double* __restrict__ lam, const double* __restrict__ rp,
              const double* __restrict__ inv_s,
              const double* __restrict__ ds, const double* __restrict__ dl,
              const double* __restrict__ sig_mu, int use_corr,
              double* __restrict__ rc, double* __restrict__ t, double* part,
              int k, int r, SpGeom g) {
  const SpSmem sh = sp_smem(g, r);
  const double* unused;
  double* acc;
  sp_begin<XG>(sh, nullptr, part, r, &unused, &acc);
  sp_loop<false, XG>(C, k, r, g, nullptr, acc, sh.tiles, sh.ys,
                        [&](int i, double) {
                          double rci = s[i] * lam[i] - (sig_mu ? sig_mu[0] : 0.0);
                          if (use_corr) rci += ds[i] * dl[i];
                          const double ti = (rci - lam[i] * rp[i]) * inv_s[i];
                          rc[i] = rci;
                          t[i] = ti;
                          return ti;
                        });
  sp_end<XG>(sh, part, r);
}

// b = -rd + C^T t from the right-hand side's partials
__global__ void __launch_bounds__(SP_THREADS)
pd_b_kernel(const double* part, int nb, const double* __restrict__ rd,
            double* __restrict__ b, int r) {
  const int c = blockIdx.x;
  const double v = sp_chunk_sum(part, nb, r, c);
  const int j = c * SP_CHUNK + threadIdx.x;
  if (threadIdx.x < SP_CHUNK && j < r) b[j] = -rd[j] + v;
}

// ds = -rp - C dz from C dz (the refined solve's last operator pass),
// dl = (-rc - lam*ds)/s; partial minima of the step ratios
__global__ void pd_ds_kernel(const double* __restrict__ cdz,
                             const double* __restrict__ rp,
                             const double* __restrict__ rc,
                             const double* __restrict__ lam,
                             const double* __restrict__ s,
                             const double* __restrict__ inv_s,
                             double* __restrict__ ds,
                             double* __restrict__ dl,
                             double* __restrict__ ap_part,
                             double* __restrict__ ad_part, int k) {
  __shared__ double sp[ELEM_BLOCK / 32], sd[ELEM_BLOCK / 32];
  const int i = blockIdx.x * ELEM_BLOCK + threadIdx.x;
  double ap = INFINITY, ad = INFINITY;
  if (i < k) {
    const double dsi = -rp[i] - cdz[i];
    const double dli = (-rc[i] - lam[i] * dsi) * inv_s[i];
    ds[i] = dsi;
    dl[i] = dli;
    if (dsi < 0.0) ap = -s[i] / dsi;
    if (dli < 0.0) ad = -lam[i] / dli;
  }
  for (int o = 16; o > 0; o >>= 1) {
    ap = ip_nanmin(ap, __shfl_xor_sync(0xffffffffu, ap, o));
    ad = ip_nanmin(ad, __shfl_xor_sync(0xffffffffu, ad, o));
  }
  if ((threadIdx.x & 31) == 0) {
    sp[threadIdx.x >> 5] = ap;
    sd[threadIdx.x >> 5] = ad;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double P = INFINITY, D = INFINITY;
    for (int q = 0; q < ELEM_BLOCK / 32; ++q) {
      P = ip_nanmin(P, sp[q]);
      D = ip_nanmin(D, sd[q]);
    }
    ap_part[blockIdx.x] = P;
    ad_part[blockIdx.x] = D;
  }
}

constexpr double PD_GAMMA = 0.99995;   // ops/pd_step.py _GAMMA

// the step lengths min(gamma * a, 1) of the step-ratio minima a (<= 1)
__device__ __forceinline__ double pd_step_len(double a) {
  const double v = PD_GAMMA * a;
  return v > 1.0 ? 1.0 : v;
}

// the predictor's (s + ap*ds)(lam + ad*dl): partial sums per block
__global__ void pd_muaff_kernel(const double* __restrict__ s,
                                const double* __restrict__ lam,
                                const double* __restrict__ ds,
                                const double* __restrict__ dl,
                                const double* __restrict__ ap,
                                const double* __restrict__ ad,
                                double* __restrict__ part, int k) {
  __shared__ double sh[ELEM_BLOCK / 32];
  const int i = blockIdx.x * ELEM_BLOCK + threadIdx.x;
  double g = 0.0;
  if (i < k) g = (s[i] + ap[0] * ds[i]) * (lam[i] + ad[0] * dl[i]);
  g = ip_warp_sum(g);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = g;
  __syncthreads();
  if (threadIdx.x == 0) {
    double G = 0.0;
    for (int q = 0; q < ELEM_BLOCK / 32; ++q) G += sh[q];
    part[blockIdx.x] = G;
  }
}

// s' = s + ap*ds, lam' = lam + ad*dl (k), z' = z + ap*dz (r), with the
// step lengths ap = min(gamma ap_r, 1), ad = min(gamma ad_r, 1); partial
// sums of s'*lam'
__global__ void pd_update_kernel(const double* __restrict__ s,
                                 const double* __restrict__ lam,
                                 const double* __restrict__ ds,
                                 const double* __restrict__ dl,
                                 const double* __restrict__ ap_r,
                                 const double* __restrict__ ad_r,
                                 const double* __restrict__ z,
                                 const double* __restrict__ dz,
                                 double* __restrict__ s2,
                                 double* __restrict__ lam2,
                                 double* __restrict__ z2,
                                 double* __restrict__ gap_part, int k,
                                 int r) {
  __shared__ double sh[ELEM_BLOCK / 32];
  const int i = blockIdx.x * ELEM_BLOCK + threadIdx.x;
  const double ap = pd_step_len(ap_r[0]), ad = pd_step_len(ad_r[0]);
  double g = 0.0;
  if (i < k) {
    const double a = s[i] + ap * ds[i];
    const double b = lam[i] + ad * dl[i];
    s2[i] = a;
    lam2[i] = b;
    g = a * b;
  }
  if (i < r) z2[i] = z[i] + ap * dz[i];
  g = ip_warp_sum(g);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = g;
  __syncthreads();
  if (threadIdx.x == 0) {
    double G = 0.0;
    for (int q = 0; q < ELEM_BLOCK / 32; ++q) G += sh[q];
    gap_part[blockIdx.x] = G;
  }
}

enum { IP_SUM = 0, IP_MAX = 1, IP_MIN = 2, IP_MIN1 = 3 };

// IP_MIN1: the minimum, then clamped to at most 1 (NaN stays NaN)
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
  if (t == 0) {
    const double v = sh[0];
    (blockIdx.x ? out1 : out0)[0] = op == IP_MIN1 && v > 1.0 ? 1.0 : v;
  }
}

// One block's fixed-order reduction of v over its FINISH_THREADS threads.
__device__ double finish_block(double v, int op, double* sh) {
  const int t = threadIdx.x;
  sh[t] = v;
  __syncthreads();
  for (int h = FINISH_THREADS / 2; h > 0; h >>= 1) {
    if (t < h) sh[t] = ip_combine(op, sh[t], sh[t + h]);
    __syncthreads();
  }
  const double out = sh[0];
  __syncthreads();
  return out;
}

// sigma = clamp((max(mu_aff, 0) / max(mu, 1e-30))^3, 0, 1) and sig_mu =
// sigma mu, with mu = gap / k and mu_aff the predictor's partials summed /
// k (NaN stays NaN, as in torch.clamp)
__global__ void __launch_bounds__(FINISH_THREADS)
pd_sigma_kernel(const double* __restrict__ part, int nb,
                const double* __restrict__ gap, int k,
                double* __restrict__ sigma, double* __restrict__ sig_mu) {
  __shared__ double sh[FINISH_THREADS];
  double acc = 0.0;
  for (int i = threadIdx.x; i < nb; i += FINISH_THREADS) acc += part[i];
  const double mu_aff = finish_block(acc, IP_SUM, sh) / k;
  if (threadIdx.x == 0) {
    const double mu = gap[0] / k;
    const double a = mu_aff < 0.0 ? 0.0 : mu_aff;
    const double b = mu < 1e-30 ? 1e-30 : mu;
    const double ratio = a / b;
    double sg = ratio * ratio * ratio;
    sg = sg < 0.0 ? 0.0 : (sg > 1.0 ? 1.0 : sg);
    sigma[0] = sg;
    sig_mu[0] = sg * mu;
  }
}

// The step's stats row (12): [gap', (1 - ap) rp_inf, (1 - ad) rd_inf
// (+ |ap - ad| max|P dz|), ap, ad, sigma, srn2, sbn2, gap, rp_inf, rd_inf,
// 0], gap' the update's partials summed
__global__ void __launch_bounds__(FINISH_THREADS)
pd_stats_kernel(const double* __restrict__ gap_part, int nb,
                const double* __restrict__ pdz, int r,
                const double* __restrict__ ap_r,
                const double* __restrict__ ad_r,
                const double* __restrict__ sigma,
                const double* __restrict__ srn2,
                const double* __restrict__ sbn2,
                const double* __restrict__ gap,
                const double* __restrict__ rpn,
                const double* __restrict__ rdn, double* __restrict__ st) {
  __shared__ double sh[FINISH_THREADS];
  double acc = 0.0;
  for (int i = threadIdx.x; i < nb; i += FINISH_THREADS) acc += gap_part[i];
  const double gap2 = finish_block(acc, IP_SUM, sh);
  double pm = -INFINITY;
  if (pdz)
    for (int i = threadIdx.x; i < r; i += FINISH_THREADS)
      pm = ip_nanmax(pm, fabs(pdz[i]));
  pm = finish_block(pm, IP_MAX, sh);
  if (threadIdx.x == 0) {
    const double ap = pd_step_len(ap_r[0]), ad = pd_step_len(ad_r[0]);
    double rd2 = (1.0 - ad) * rdn[0];
    if (pdz) rd2 = rd2 + fabs(ap - ad) * pm;
    st[0] = gap2;
    st[1] = (1.0 - ap) * rpn[0];
    st[2] = rd2;
    st[3] = ap;
    st[4] = ad;
    st[5] = sigma[0];
    st[6] = srn2[0];
    st[7] = sbn2[0];
    st[8] = gap[0];
    st[9] = rpn[0];
    st[10] = rdn[0];
    st[11] = 0.0;
  }
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
      C, x, w, y, k, r);
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

// Workspace bytes of ip_pd_pass1, ip_pd_rhs and ip_pd_ds for k x r.
IP_API size_t ip_pd_ws_bytes(int k, int r) {
  const SpGeom g = sp_geom(r, nullptr);
  const size_t n = (size_t)g.nblk * r + r + 2 * (size_t)g.nblk + sp_chunks(r);
  const size_t e = 2 * (size_t)elem_blocks(k);
  return (n > e ? n : e) * sizeof(double);
}

// Launch a strip kernel in its x-in-shared-memory (XG false) or x-in-global
// (XG true) form; *set_* remember the shared memory allowed to each.
#define IP_STRIP_LAUNCH(kernel, g, set_s, set_g, stream, ...)              \
  do {                                                                     \
    cudaError_t e_ = (g).xsm ? sp_allow(kernel<false>, (g).smem, &set_s)   \
                             : sp_allow(kernel<true>, (g).smem, &set_g);   \
    if (e_ != cudaSuccess) {                                               \
      cudaGetLastError();                                                  \
      return (int)e_;                                                      \
    }                                                                      \
    if ((g).xsm)                                                           \
      kernel<false><<<(g).nblk, SP_THREADS, (g).smem, stream>>>(__VA_ARGS__); \
    else                                                                   \
      kernel<true><<<(g).nblk, SP_THREADS, (g).smem, stream>>>(__VA_ARGS__);  \
  } while (0)

// pass 1, one read of C: rp, 1/s, w (k), gap = sum(s*lam), rpmax = max|rp|,
// rd = q + C^T lam (+ P z) (r, P null for an LP), rdmax = max|rd| (0-d);
// ws is ip_pd_ws_bytes(k, r)
IP_API int ip_pd_pass1(const double* C, const double* z, const double* s,
                       const double* lam, const double* d, const double* q,
                       const double* P, double* rp, double* inv_s, double* w,
                       double* rd, double* ws, double* gap, double* rpmax,
                       double* rdmax, int k, int r, cudaStream_t stream) {
  const SpGeom g = sp_geom(r, C);
  static int set_s = -1, set_g = -1;
  double* part = ws;
  double* pz = part + (size_t)g.nblk * r;
  double* gp = pz + r;
  double* mp = gp + g.nblk;
  double* dp = mp + g.nblk;
  IP_STRIP_LAUNCH(pd_pass1_kernel, g, set_s, set_g, stream, C, z, s, lam, d,
                  P, rp, inv_s, w, part, pz, gp, mp, k, r, g);
  pd_rd_kernel<<<sp_chunks(r), SP_THREADS, 0, stream>>>(
      part, g.nblk, q, P ? pz : nullptr, rd, dp, r);
  finish_kernel<<<2, FINISH_THREADS, 0, stream>>>(gp, IP_SUM, gap, mp,
                                                  IP_MAX, rpmax, g.nblk);
  finish_kernel<<<1, FINISH_THREADS, 0, stream>>>(dp, IP_MAX, rdmax, dp,
                                                  IP_MAX, rdmax, sp_chunks(r));
  return ip_status();
}

// the right-hand side: rc, t (k) and b = -rd + C^T t (r), one read of C
IP_API int ip_pd_rhs(const double* C, const double* s, const double* lam,
                     const double* rp, const double* inv_s, const double* ds,
                     const double* dl, const double* sig_mu, int use_corr,
                     const double* rd, double* rc, double* t, double* ws,
                     double* b, int k, int r, cudaStream_t stream) {
  const SpGeom g = sp_geom(r, C);
  static int set_s = -1, set_g = -1;
  IP_STRIP_LAUNCH(pd_rhs_kernel, g, set_s, set_g, stream, C, s, lam, rp,
                  inv_s, ds, dl, sig_mu, use_corr, rc, t, ws, k, r, g);
  pd_b_kernel<<<sp_chunks(r), SP_THREADS, 0, stream>>>(ws, g.nblk, rd, b, r);
  return ip_status();
}

// ds, dl (k) from C dz and the step-ratio minima clamped to 1, ap, ad
// (0-d); reads no C
IP_API int ip_pd_ds(const double* cdz, const double* rp, const double* rc,
                    const double* lam, const double* s, const double* inv_s,
                    double* ds, double* dl, double* ws, double* ap,
                    double* ad, int k, cudaStream_t stream) {
  const int nb = elem_blocks(k);
  pd_ds_kernel<<<nb, ELEM_BLOCK, 0, stream>>>(cdz, rp, rc, lam, s, inv_s, ds,
                                              dl, ws, ws + nb, k);
  finish_kernel<<<2, FINISH_THREADS, 0, stream>>>(ws, IP_MIN1, ap, ws + nb,
                                                  IP_MIN1, ad, nb);
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

// sigma and sig_mu (0-d) of the corrector from the predictor's ds, dl and
// step lengths ap, ad (<= 1) and the gap (0-d); ws is ip_pd_ws_bytes(k, 1)
IP_API int ip_pd_sigma(const double* s, const double* lam, const double* ds,
                       const double* dl, const double* ap, const double* ad,
                       const double* gap, double* ws, double* sigma,
                       double* sig_mu, int k, cudaStream_t stream) {
  const int nb = elem_blocks(k);
  pd_muaff_kernel<<<nb, ELEM_BLOCK, 0, stream>>>(s, lam, ds, dl, ap, ad, ws,
                                                 k);
  pd_sigma_kernel<<<1, FINISH_THREADS, 0, stream>>>(ws, nb, gap, k, sigma,
                                                    sig_mu);
  return ip_status();
}

// the update: s', lam' (k), z' (r) with the step lengths min(gamma a, 1) of
// the corrector's ap_r, ad_r, and the step's stats row (12; pdz = P dz for
// a QP, else null); ws is ip_pd_ws_bytes(k, r)
IP_API int ip_pd_update(const double* s, const double* lam, const double* ds,
                        const double* dl, const double* ap_r,
                        const double* ad_r, const double* z,
                        const double* dz, const double* pdz,
                        const double* sigma, const double* srn2,
                        const double* sbn2, const double* gap,
                        const double* rpn, const double* rdn, double* s2,
                        double* lam2, double* z2, double* ws, double* stats,
                        int k, int r, cudaStream_t stream) {
  const int nb = elem_blocks(k > r ? k : r);
  pd_update_kernel<<<nb, ELEM_BLOCK, 0, stream>>>(s, lam, ds, dl, ap_r, ad_r,
                                                  z, dz, s2, lam2, z2, ws, k,
                                                  r);
  pd_stats_kernel<<<1, FINISH_THREADS, 0, stream>>>(
      ws, nb, pdz, r, ap_r, ad_r, sigma, srn2, sbn2, gap, rpn, rdn, stats);
  return ip_status();
}
