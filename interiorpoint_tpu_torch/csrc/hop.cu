// The fused operator H x = M^T (wt . (M x)) (+ P x) and the whole refined
// solve of H x = b in one cooperative launch, for the primal-dual step K1
// (M = C, wt = lambda / s, ops/pd_step.py) and the SOCP Newton step K4
// (M = [A; c; G], wt = [w_row; w; w^2], P = tP, ops/socp_step.py).
//
// Replaces the refinement and PCG loops the TPU step kernels run inside
// themselves (interiorpoint_tpu/ops/pallas_newton.py:_refined_solve with
// its _dd_pcg, applying _apply_h of interiorpoint_tpu/ops/pallas_pd.py
// :186-201 and the SOCP kernel's operator), with the rules of
// ops/refine.py refined_solve: up to `refine` rounds of
// x += D W^T W D res, res = b - H x, each after the exit test
// ||D res||^2 > exit2 ||D b||^2; the stall test; the PCG in the
// equilibrated metric (at most PCG_MAX rounds, kept only if it lowered the
// residual).  The preconditioner is the fp32 W = L^-1 of the Jacobi-scaled
// fp32 Gram (csrc/chol.cu), the residuals fp64.
//
// Bound: device-memory bandwidth, one read of M per operator application
// (88 MB at 11000 x 1000).  The operator is strip.cuh's strip pass; the
// W-solve is two passes over the fp32 W (one warp per row for W v, 32-
// column tasks for W^T u, each with four partial sums in flight).  In the
// solve every loop decision is taken on the device: after each grid
// barrier every block reads the same vectors and forms the same reductions
// in the same order, so every block takes the same branch and no host read
// is needed.  Every reduction has a fixed order: the solve is
// deterministic.
#include <cooperative_groups.h>

#include "strip.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int PCG_MAX = 48;   // ops/refine.py PCG_MAX

// ---------------------------------------------------------------------------
// The operator
// ---------------------------------------------------------------------------

// The block's share of the operator's strip pass: the column partial of
// M^T (wt . (M x)) into part, M x into mx (when not null), and P x into px
// (when P is not null).
template <bool XG>
__device__ void h_strip(const double* __restrict__ M,
                        const double* __restrict__ wt, const double* x,
                        const double* __restrict__ P, double* mx,
                        double* part, double* px, int m, int r,
                        const SpGeom& g) {
  const SpSmem s = sp_smem(g, r);
  const double* xs;
  double* acc;
  sp_begin<XG>(s, x, part, r, &xs, &acc);
  sp_loop<true, XG>(M, m, r, g, xs, acc, s.tiles, s.ys,
                    [&](int i, double d) {
                      if (mx) mx[i] = d;
                      return wt[i] * d;
                    });
  sp_end<XG>(s, part, r);
  if (P) sp_prows<XG>(P, r, xs, px);
}

template <bool XG>
__global__ void __launch_bounds__(SP_THREADS, 1)
h_strip_kernel(const double* __restrict__ M, const double* __restrict__ wt,
               const double* x, const double* __restrict__ P, double* mx,
               double* part, double* px, int m, int r, SpGeom g) {
  h_strip<XG>(M, wt, x, P, mx, part, px, m, r, g);
}

// out = the partials summed in block order (+ P x)
__global__ void __launch_bounds__(SP_THREADS)
h_finish_kernel(const double* part, int nb, const double* px, double* out,
                int r) {
  const int c = blockIdx.x;
  const double v = sp_chunk_sum(part, nb, r, c);
  const int j = c * SP_CHUNK + threadIdx.x;
  if (threadIdx.x < SP_CHUNK && j < r) out[j] = px ? v + px[j] : v;
}

// ---------------------------------------------------------------------------
// The refined solve
// ---------------------------------------------------------------------------

struct RSArgs {
  const double* M;     // m x r, row-major
  const double* wt;    // m
  const double* P;     // r x r or null
  const float* W;      // the fp32 W = L^-1 (lower), row stride ldw
  const float* dsc;    // the equilibration D (fp32, >= r)
  const double* b;     // r
  double stall2, exit2;
  double* x;           // out: r
  double* mx;          // out: M x of the returned x (m)
  double* rn2;         // out: ||D (b - H x)||^2
  double* bn2;         // out: ||D b||^2
  int* counts;         // out: rounds, stalled, PCG rounds, PCG kept
  int* tally;          // optional: += operator passes, rounds, PCG rounds,
                       //             solves
  double* ws;          // ip_refined_solve_ws_bytes(m, r)
  int m, r, ldw, refine;
  SpGeom g;
};

// The block's reduction scratch (one array however many instances of the
// helpers below a kernel holds: each would have its own static array).
__device__ __forceinline__ double* rs_scratch() {
  __shared__ double red[SP_THREADS];
  return red;
}

// sum_{j<r} f(j) in one fixed order: every block forms the same value.
template <class F>
__device__ double rs_sum(int r, F f) {
  double* red = rs_scratch();
  double a = 0.0;
  for (int j = threadIdx.x; j < r; j += SP_THREADS) a += f(j);
  red[threadIdx.x] = a;
  __syncthreads();
  for (int h = SP_THREADS / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  const double v = red[0];
  __syncthreads();
  return v;
}

// A vector of r floats staged in the block's shared memory (the strip
// tiles or x's copy, whichever is free), or read in place through L2.
struct RsVec {
  const float* p;
  bool shared;
  __device__ float operator[](int j) const {
    return shared ? p[j] : __ldcg(p + j);
  }
};

__device__ RsVec rs_stage(const RSArgs& a, const float* v) {
  const SpSmem s = sp_smem(a.g, a.r);
  float* dst = a.g.rows ? reinterpret_cast<float*>(s.tiles)
               : a.g.xsm ? reinterpret_cast<float*>(s.xs)
                         : nullptr;
  if (dst) {
    for (int j = threadIdx.x; j < a.r; j += SP_THREADS) dst[j] = __ldcg(v + j);
    __syncthreads();
    return {dst, true};
  }
  return {v, false};
}

// u = W v on the leading r entries (fp32; one warp per row, four
// interleaved partial sums per lane so that four loads are in flight)
__device__ void rs_wv(const RSArgs& a, const float* v32, float* u32) {
  const RsVec v = rs_stage(a, v32);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = blockIdx.x * SP_WARPS + warp; i < a.r;
       i += gridDim.x * SP_WARPS) {
    const float* row = a.W + (size_t)i * a.ldw;
    float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
    int j = lane;
    for (; j + 96 <= i; j += 128) {
      c0 = fmaf(row[j], v[j], c0);
      c1 = fmaf(row[j + 32], v[j + 32], c1);
      c2 = fmaf(row[j + 64], v[j + 64], c2);
      c3 = fmaf(row[j + 96], v[j + 96], c3);
    }
    for (; j <= i; j += 32) c0 = fmaf(row[j], v[j], c0);
    const float acc = ip_warp_sumf((c0 + c1) + (c2 + c3));
    if (lane == 0) u32[i] = acc;
  }
}

// t = W^T u on the leading r entries (fp32; 32-column tasks of SP_PHASES
// row phases, four interleaved partial sums per thread), out(j, (double)
// t_j)
template <class OUT>
__device__ void rs_wtu(const RSArgs& a, const float* u32, OUT out) {
  static_assert(SP_PHASES * (SP_CHUNK + 1) <= 2 * SP_THREADS,
                "the scratch holds the phases' sums");
  float(*red)[SP_CHUNK + 1] =
      reinterpret_cast<float(*)[SP_CHUNK + 1]>(rs_scratch());
  const RsVec u = rs_stage(a, u32);
  const int tx = threadIdx.x % SP_CHUNK, ty = threadIdx.x / SP_CHUNK;
  constexpr int ST = SP_PHASES;
  for (int c = blockIdx.x; c < sp_chunks(a.r); c += gridDim.x) {
    const int j = c * SP_CHUNK + tx;
    float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
    if (j < a.r) {
      const float* col = a.W + j;
      int i = c * SP_CHUNK + ty;
      for (; i + 3 * ST < a.r; i += 4 * ST) {
        if (i >= j) c0 = fmaf(col[(size_t)i * a.ldw], u[i], c0);
        if (i + ST >= j) c1 = fmaf(col[(size_t)(i + ST) * a.ldw], u[i + ST], c1);
        if (i + 2 * ST >= j)
          c2 = fmaf(col[(size_t)(i + 2 * ST) * a.ldw], u[i + 2 * ST], c2);
        if (i + 3 * ST >= j)
          c3 = fmaf(col[(size_t)(i + 3 * ST) * a.ldw], u[i + 3 * ST], c3);
      }
      for (; i < a.r; i += ST)
        if (i >= j) c0 = fmaf(col[(size_t)i * a.ldw], u[i], c0);
    }
    red[ty][tx] = (c0 + c1) + (c2 + c3);
    __syncthreads();
    if (ty == 0 && j < a.r) {
      float t = 0.f;
      for (int p = 0; p < SP_PHASES; ++p) t += red[p][tx];
      out(j, (double)t);
    }
    __syncthreads();
  }
}

// The operator's column sums, out(j, (H x)_j): partials in block order,
// then + (P x)_j
template <class OUT>
__device__ void rs_finish(const RSArgs& a, const double* part,
                          const double* px, OUT out) {
  for (int c = blockIdx.x; c < sp_chunks(a.r); c += gridDim.x) {
    const double v = sp_chunk_sum(part, gridDim.x, a.r, c);
    const int j = c * SP_CHUNK + threadIdx.x;
    if (threadIdx.x < SP_CHUNK && j < a.r)
      out(j, a.P ? v + __ldcg(px + j) : v);
  }
}

template <bool XG>
__global__ void __launch_bounds__(SP_THREADS, 1)
refined_solve_kernel(RSArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int r = a.r, m = a.m;
  double* part = a.ws;
  double* px = part + (size_t)gridDim.x * r;
  double* res = px + r;
  double* re = res + r;
  double* p = re + r;
  double* cx = p + r;
  double* zz = cx + r;
  double* hp = zz + r;
  double* xin = hp + r;
  double* x2 = xin + r;
  double* r2 = x2 + r;
  double* mx2 = r2 + r;
  float* v32 = reinterpret_cast<float*>(mx2 + m);
  float* u32 = v32 + r;
  const int g0 = blockIdx.x * SP_THREADS + threadIdx.x;
  const int gs = gridDim.x * SP_THREADS;
  auto ds = [&](int j) { return (double)a.dsc[j]; };
  // ||D v||^2, v written by this launch (read through L2)
  auto sq = [&](const double* v) {
    return rs_sum(r, [&](int j) {
      const double t = __dmul_rn(__ldcg(v + j), ds(j));
      return t * t;
    });
  };
  auto dot = [&](const double* u, const double* v) {
    return rs_sum(r, [&](int j) { return __dmul_rn(__ldcg(u + j), __ldcg(v + j)); });
  };
  auto op = [&](const double* xv, double* mxv) {
    h_strip<XG>(a.M, a.wt, xv, a.P, mxv, part, px, m, r, a.g);
  };

  // x = 0, res = b; v32 = float(D res) is the next W-solve's input
  for (int j = g0; j < r; j += gs) {
    a.x[j] = 0.0;
    res[j] = a.b[j];
    v32[j] = __double2float_rn(__dmul_rn(a.b[j], ds(j)));
  }
  const double bn2 = rs_sum(r, [&](int j) {
    const double t = __dmul_rn(a.b[j], ds(j));
    return t * t;
  });
  grid.sync();

  int rounds = 0;
  bool exited = false;
  for (int it = 0; it < a.refine; ++it) {
    const double s = sq(res);
    if (!(s > a.exit2 * bn2)) {
      exited = true;
      break;
    }
    rs_wv(a, v32, u32);
    grid.sync();
    rs_wtu(a, u32, [&](int j, double t) {
      a.x[j] = __dadd_rn(__ldcg(a.x + j), __dmul_rn(ds(j), t));
    });
    grid.sync();
    op(a.x, a.mx);
    grid.sync();
    rs_finish(a, part, px, [&](int j, double hx) {
      const double rj = __dsub_rn(a.b[j], hx);
      res[j] = rj;
      v32[j] = __double2float_rn(__dmul_rn(rj, ds(j)));
    });
    grid.sync();
    ++rounds;
  }
  // a residual at or below the exit is below the stall gate too when
  // exit2 <= stall2
  const double s0 = sq(res);
  const bool stalled = !(exited && a.exit2 <= a.stall2) && s0 > a.stall2 * bn2;
  bool kept = false;
  int pcg = 0;
  double s2 = 0.0;
  if (stalled) {
    // re = D r0 (v32 holds float(re)), zz = p = M^-1 re, cx = 0
    rs_wv(a, v32, u32);
    for (int j = g0; j < r; j += gs) {
      re[j] = __dmul_rn(__ldcg(res + j), ds(j));
      cx[j] = 0.0;
    }
    grid.sync();
    rs_wtu(a, u32, [&](int j, double t) {
      zz[j] = t;
      p[j] = t;
      xin[j] = __dmul_rn(ds(j), t);
    });
    grid.sync();
    double rz = dot(re, zz);
    const double thr = fmax(a.exit2, 1e-26) * bn2;
    for (int it = 0; it < PCG_MAX; ++it) {
      const double rn2c = dot(re, re);
      if (!(rn2c > thr && isfinite(rn2c) && isfinite(rz))) break;
      op(xin, nullptr);
      grid.sync();
      rs_finish(a, part, px, [&](int j, double hx) { hp[j] = __dmul_rn(ds(j), hx); });
      grid.sync();
      const double den = dot(p, hp);
      const double al = rz / (fabs(den) > 1e-30 ? den : 1e-30);
      for (int j = g0; j < r; j += gs) {
        cx[j] = __dadd_rn(__ldcg(cx + j), __dmul_rn(al, __ldcg(p + j)));
        const double rj = __dsub_rn(__ldcg(re + j), __dmul_rn(al, __ldcg(hp + j)));
        re[j] = rj;
        v32[j] = __double2float_rn(rj);
      }
      grid.sync();
      rs_wv(a, v32, u32);
      grid.sync();
      rs_wtu(a, u32, [&](int j, double t) { zz[j] = t; });
      grid.sync();
      const double rz2 = dot(re, zz);
      const double be = rz2 / (fabs(rz) > 1e-30 ? rz : 1e-30);
      for (int j = g0; j < r; j += gs) {
        const double pj = __dadd_rn(__ldcg(zz + j), __dmul_rn(be, __ldcg(p + j)));
        p[j] = pj;
        xin[j] = __dmul_rn(ds(j), pj);
      }
      grid.sync();
      rz = rz2;
      ++pcg;
    }
    for (int j = g0; j < r; j += gs)
      x2[j] = __dadd_rn(__ldcg(a.x + j), __dmul_rn(ds(j), __ldcg(cx + j)));
    grid.sync();
    op(x2, mx2);
    grid.sync();
    rs_finish(a, part, px, [&](int j, double hx) { r2[j] = __dsub_rn(a.b[j], hx); });
    grid.sync();
    s2 = sq(r2);
    kept = s2 < s0;
    if (kept) {
      for (int j = g0; j < r; j += gs) a.x[j] = __ldcg(x2 + j);
      for (int i = g0; i < m; i += gs) a.mx[i] = __ldcg(mx2 + i);
    }
  }
  // x = 0 was never applied: M x = 0
  if (!kept && rounds == 0)
    for (int i = g0; i < m; i += gs) a.mx[i] = 0.0;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *a.rn2 = kept ? s2 : s0;
    *a.bn2 = bn2;
    a.counts[0] = rounds;
    a.counts[1] = stalled;
    a.counts[2] = pcg;
    a.counts[3] = kept;
    if (a.tally) {
      atomicAdd(a.tally + 0, rounds + pcg + (stalled ? 1 : 0));
      atomicAdd(a.tally + 1, rounds);
      atomicAdd(a.tally + 2, pcg);
      atomicAdd(a.tally + 3, 1);
    }
  }
}

size_t solve_ws_doubles(int m, int r, int nblk) {
  // partials, 10 r-vectors, M x2, two r-vectors of floats
  return (size_t)nblk * r + 10 * (size_t)r + m + r + 1;
}

}  // namespace

// Workspace bytes of ip_h_apply for an m x r matrix.
IP_API size_t ip_h_ws_bytes(int m, int r) {
  (void)m;
  const SpGeom g = sp_geom(r, nullptr);
  return ((size_t)g.nblk + 1) * r * sizeof(double);
}

// out = M^T (wt . (M x)) (+ P x) (P r x r row-major, or null); mx, when
// not null, receives M x.  Two launches: the strip pass, then the column
// sums in block order.
IP_API int ip_h_apply(const double* M, const double* wt, const double* x,
                      const double* P, double* mx, double* ws, double* out,
                      int m, int r, cudaStream_t stream) {
  if (r <= 0) return 0;
  const SpGeom g = sp_geom(r, M);
  static int set_s = -1, set_g = -1;
  double* part = ws;
  double* px = ws + (size_t)g.nblk * r;
  cudaError_t e;
  if (g.xsm) {
    e = sp_allow(h_strip_kernel<false>, g.smem, &set_s);
    if (e == cudaSuccess)
      h_strip_kernel<false><<<g.nblk, SP_THREADS, g.smem, stream>>>(
          M, wt, x, P, mx, part, px, m, r, g);
  } else {
    e = sp_allow(h_strip_kernel<true>, g.smem, &set_g);
    if (e == cudaSuccess)
      h_strip_kernel<true><<<g.nblk, SP_THREADS, g.smem, stream>>>(
          M, wt, x, P, mx, part, px, m, r, g);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  h_finish_kernel<<<sp_chunks(r), SP_THREADS, 0, stream>>>(
      part, g.nblk, P ? px : nullptr, out, r);
  return ip_status();
}

// Workspace bytes of ip_refined_solve for an m x r matrix.
IP_API size_t ip_refined_solve_ws_bytes(int m, int r) {
  const SpGeom g = sp_geom(r, nullptr);
  return solve_ws_doubles(m, r, g.nblk) * sizeof(double);
}

// The refined solve of H x = b, H = M^T diag(wt) M (+ P), preconditioned by
// D W^T W D (W fp32 lower, row stride ldw; D = dsc): x, M x of the returned
// x, rn2 = ||D (b - H x)||^2 and bn2 = ||D b||^2 (0-d), counts (4 ints:
// rounds, stalled, PCG rounds, PCG kept); tally (4 ints, or null) adds the
// operator passes, rounds, PCG rounds and one solve.  One cooperative
// launch of one block per SM; an error when the grid cannot be resident.
IP_API int ip_refined_solve(const double* M, const double* wt,
                            const double* P, const float* W, int ldw,
                            const float* dsc, const double* b, int refine,
                            double stall2, double exit2, double* x,
                            double* mx, double* rn2, double* bn2,
                            int* counts, int* tally, double* ws, int m, int r,
                            cudaStream_t stream) {
  if (r <= 0) return (int)cudaErrorInvalidValue;
  RSArgs a{M, wt, P, W, dsc, b, stall2, exit2, x, mx, rn2, bn2, counts,
           tally, ws, m, r, ldw, refine, sp_geom(r, M)};
  static int set_s = -1, set_g = -1;
  void* args[] = {&a};
  const void* kernel = a.g.xsm ? (const void*)refined_solve_kernel<false>
                               : (const void*)refined_solve_kernel<true>;
  cudaError_t e = a.g.xsm ? sp_allow(refined_solve_kernel<false>, a.g.smem, &set_s)
                          : sp_allow(refined_solve_kernel<true>, a.g.smem, &set_g);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
  if (e == cudaSuccess && fa.sharedSizeBytes > (size_t)SP_STATIC)
    e = cudaErrorInvalidConfiguration;   // SP_STATIC is too small
  int per = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, SP_THREADS,
                                                      a.g.smem);
  if (e == cudaSuccess && per < 1) e = cudaErrorCooperativeLaunchTooLarge;
  if (e == cudaSuccess)
    e = cudaLaunchCooperativeKernel(kernel, dim3(a.g.nblk), dim3(SP_THREADS),
                                    args, a.g.smem, stream);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return ip_status();
}
