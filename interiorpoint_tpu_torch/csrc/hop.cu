// The fused operator H x = M^T (wt . (M x)) (+ P x) (two launches) and
// the whole refined solve of H x = b (one cooperative launch), for the
// primal-dual step K1 (M = C, wt = lambda / s, ops/pd_step.py), the
// barrier Newton step K2 (M = C, wt = 1 / s^2, P = tP,
// ops/newton_step.py) and the SOCP Newton step K4 (M = [A; c; G],
// wt = [w_row; w; w^2], P = tP, ops/socp_step.py).
//
// Replaces the refinement and PCG loops the TPU step kernels run inside
// themselves (interiorpoint_tpu/ops/pallas_newton.py:_refined_solve with
// its _dd_pcg, applying _apply_h of interiorpoint_tpu/ops/pallas_pd.py
// :186-201 and the SOCP kernel's operator), with the rules of
// ops/refine.py refined_solve: up to `refine` rounds of
// x += D W^T W D res, res = b - H x, each after the exit test
// ||D res||^2 > exit2 ||D b||^2; the stall test; the PCG in the
// equilibrated metric (at most PCG_MAX rounds, kept only if it lowered the
// residual).  The preconditioner is fp32, the residuals fp64.  It takes one
// of three forms, picked on the device by an int that the launches before
// the solve wrote (K2's branch: ops/newton_step.py `preconditioner`),
// read by every block at launch so that all take the same branch:
// 0: D W^T W D with W = L^-1 of the Jacobi-scaled fp32 Gram (csrc/chol.cu;
// K1, K4 and K2's Cholesky fallback without a carry); 1: D X^T D with a
// dense fp32 X ~ Hs^-1 (K2's carry: its refreshed X or its re-seed; the
// TPU kernel's v . minvout, pallas_newton.py:697-701); 2: D M^-1 D with
// M = Lt D Lt^T K2's block-LDL factor, applied by its two tile sweeps
// (the TPU kernel's _hybrid_solve, pallas_newton.py:479, where it keeps
// no carry).
//
// Bound: device-memory bandwidth, one read of M per operator application
// (88 MB at 11000 x 1000); where M stays in L2 across applications (2200 x
// 200, 4010 x 950), latency and the grid barriers.  The design:
//
// * The operator's pass.  A grid of one block per SM (384 threads), each
//   with the same ceil(m / nblk) rows of M.  Rows of up to 1024 entries
//   (every shape of the main path) take the register form (hp_pass_reg):
//   warp w reads rows w, w + 12, ... of its block once into registers
//   (lane l holds entries l + 32 u: a row's loads all in flight), forms
//   the row dot from them (lanes stride the row, then a butterfly sum:
//   the order of strip.cuh's sp_dot, so M x is bitwise the same wherever
//   it is formed, rows.cu's passes included) and adds y_i M_ij to the
//   warp's own column partial in shared memory, in its row order; the
//   warps' partials are summed in warp order.  Wider rows are read in
//   place (hp_pass): a warp's row dot, then the column pass re-reads the
//   block's group of rows from L2; where x and the partial do not fit in
//   shared memory, they stay in global memory.
// * Column sums (hp_cols): column j is owned by one warp of the grid, whose
//   lanes stride the blocks' partials in block order before a butterfly
//   sum.  No atomics: every result is deterministic, and a batch instance
//   is bitwise its single call.
// * The W-solve u = W v, t = W^T u over the whole grid: block b holds the
//   rows [R_b, R_b+1) of W's lower triangle (bands of equal area) in shared
//   memory for the launch, forms u on its band and its band's partial of
//   W^T u; the partials are summed by the column owners, in block order.
// * X^T v: block b holds the columns [Q_b, Q_b+1) of X (an even split) in
//   shared memory for the launch and forms their dots with v whole (one
//   warp a column: lanes stride the rows, then a butterfly sum), so each
//   entry of X^T v is written once, by one warp; no partials, no atomics.
// * M^-1 v of the LDL factor (hp_ldl_apply): its 128-wide tiles are a
//   chain (the forward sweep, X_k^T on each tile, the backward sweep), so
//   the grid takes one tile a stage, one row (forward) or column
//   (backward) of the tile a block, with a grid barrier between stages:
//   2 np / 128 - 1 barriers an application (15 at np = 1024); Lt and the
//   tile inverses stay in L2.
// * Barriers: a refinement round makes 4 grid barriers (the W partials,
//   x, the operator's partials, the residual), a PCG round 4.  The dot
//   products and exit tests are formed by every block from per-column
//   terms that the column owners wrote, in one fixed order, so every block
//   takes the same branch and no host read is needed; vector updates that
//   every block needs (v, the PCG's x_in) are formed by every block from
//   the same inputs, so they need no barrier of their own.
#include <cooperative_groups.h>

#include "strip.cuh"   // sp_device

namespace cg = cooperative_groups;

namespace {

constexpr int PCG_MAX = 48;       // ops/refine.py PCG_MAX
constexpr int HP_THREADS = 384;   // threads of a block (170 registers each)
constexpr int HP_WARPS = HP_THREADS / 32;
constexpr int HP_REG_MAX = 1024;  // widths of the register form, at most
constexpr int HP_MAX_BLK = 256;   // blocks (SMs), at most
constexpr int HP_STATIC = 4096;   // shared bytes kept for static arrays
constexpr int HP_LT = 128;        // the LDL factor's tile (hybrid.LDL_BLK)
constexpr int HP_INSTANCES = 16;  // kernel instances: 5 forms of the pass
                                  // each for ip_h_apply and both solves,
                                  // and ip_precond_apply's

// First row of W's band b of nblk (bands of equal area of the lower
// triangle); the same on the host and the device (IEEE sqrt).
__host__ __device__ inline int hp_band(int b, int nblk, int r) {
  return b >= nblk ? r : (int)((double)r * sqrt((double)b / (double)nblk));
}

// Launch geometry of the pass and the solve (computed on the host).
struct HpGeom {
  int nblk;    // blocks, one per SM
  int rpb;     // rows of M per block
  int prb;     // rows of P per block
  int xsm;     // x, the partial, v and u in shared memory
  int wres;    // the W band in shared memory (solve)
  int wband;   // floats of the largest W band
  int urows;   // rows of the largest W band
  int xcols;   // columns of X a block holds, at most (the X form)
  int npl;     // the register form's entries a lane (0: rows in place)
  int smem;    // dynamic shared bytes
};

static inline HpGeom hp_geom(int m, int r, bool solve, bool xform) {
  int sms = 0, cap = 0;
  sp_device(&sms, &cap);
  HpGeom g{};
  g.nblk = sms < HP_MAX_BLK ? sms : HP_MAX_BLK;
  g.rpb = (m + g.nblk - 1) / g.nblk;
  g.prb = (r + g.nblk - 1) / g.nblk;
  if (solve)
    for (int b = 0; b < g.nblk; ++b) {
      const long r0 = hp_band(b, g.nblk, r), r1 = hp_band(b + 1, g.nblk, r);
      const int fl = (int)((r1 * (r1 + 1) - r0 * (r0 + 1)) / 2);
      if (fl > g.wband) g.wband = fl;
      if (r1 - r0 > g.urows) g.urows = (int)(r1 - r0);
    }
  if (xform) {
    // the X form's columns share the W band's place
    g.xcols = (r + g.nblk - 1) / g.nblk;
    if ((long)g.xcols * r > g.wband) g.wband = g.xcols * r;
  }
  g.wband = (g.wband + 3) & ~3;
  const long sv = solve ? 4L * (r + g.urows) + 16 : 0;   // v and u
  const long avail = (long)cap - HP_STATIC;
  g.npl = r <= 256 ? 8 : r <= 512 ? 16 : r <= HP_REG_MAX ? 32 : 0;
  if (g.npl) {
    // the register form: the warps' partials and x (and v, u, W's band)
    g.xsm = 1;
    const long base = 8L * HP_WARPS * r + 8L * r + sv;
    g.wres = solve && base + 4L * g.wband <= avail;
    g.smem = (int)(base + (g.wres ? 4L * g.wband : 0));
    return g;
  }
  // rows read in place: a group's row weights, then x and the partial
  // (and v, u) where they fit, then the W band where it fits
  const long ys = 8L * HP_WARPS, vec = 16L * r + sv;
  g.xsm = ys + vec <= avail;
  const long used = ys + (g.xsm ? vec : 0);
  g.wres = solve && used + 4L * g.wband <= avail;
  g.smem = (int)(used + (g.wres ? 4L * g.wband : 0));
  return g;
}

// hp_geom, remembered for the last few shapes (the host's cost per call).
static inline HpGeom hp_geom_of(int m, int r, bool solve,
                                bool xform = false) {
  struct Seen {
    int m, r, kind;
    HpGeom g;
  };
  static Seen seen[16];
  static int n = 0, next = 0;
  const int kind = (int)solve | (int)xform << 1;
  for (int i = 0; i < n; ++i)
    if (seen[i].m == m && seen[i].r == r && seen[i].kind == kind)
      return seen[i].g;
  const HpGeom g = hp_geom(m, r, solve, xform);
  seen[next] = {m, r, kind, g};
  next = (next + 1) % 16;
  if (n < 16) ++n;
  return g;
}

// The dynamic shared memory of a block: the register form's warp
// partials, or a group's row weights; then (in shared or in global
// memory) x, the column partial, v and u; then the W band.
struct HpSmem {
  double* accw;   // the register form: the warps' partials
  double* ys;
  double* xs;
  double* acc;
  float* v;
  float* u;
  float* wb;
};

extern __shared__ __align__(16) unsigned char hp_raw[];

// The register form's warp partials and x, taken straight from the
// shared array (so that the compiler knows them shared: LDS, not generic
// loads).
__device__ __forceinline__ double* hp_reg_accw() {
  return reinterpret_cast<double*>(hp_raw);
}
__device__ __forceinline__ double* hp_reg_xs(int r) {
  return reinterpret_cast<double*>(hp_raw) + HP_WARPS * r;
}

// gv: the block's global slice for x, v and u when they do not fit
// (solve), gacc the block's partial in global memory.  NPL: the form
// (known at compile time, so that the register form's pointers are known
// shared).
template <int NPL>
__device__ __forceinline__ HpSmem hp_smem(const HpGeom& g, int r, double* gv,
                                          double* gacc) {
  HpSmem s;
  double* p = reinterpret_cast<double*>(hp_raw);
  if constexpr (NPL > 0) {
    s.accw = p;
    s.ys = s.acc = nullptr;
    s.xs = p + HP_WARPS * r;
    s.v = reinterpret_cast<float*>(s.xs + r);
    s.u = s.v + r;
    s.wb = s.u + g.urows + ((4 - (r + g.urows) % 4) % 4);
    return s;
  }
  s.accw = nullptr;
  s.ys = p;
  p += HP_WARPS;
  if (g.xsm) {
    s.xs = p;
    s.acc = p + r;
    s.v = reinterpret_cast<float*>(p + 2 * r);
  } else {
    s.xs = gv;
    s.acc = gacc;
    s.v = reinterpret_cast<float*>(gv + r);
  }
  s.u = s.v + r;
  s.wb = g.xsm ? s.u + g.urows + ((4 - (r + g.urows) % 4) % 4)
               : reinterpret_cast<float*>(p);
  return s;
}

// Static shared arrays, one instance per kernel (kept out of templates).
__device__ __forceinline__ int* hp_bandtab() {
  __shared__ int band[HP_MAX_BLK + 1];
  return band;
}
__device__ __forceinline__ double* hp_red() {
  __shared__ double red[HP_WARPS];
  return red;
}

// Block set-up: the W bands' first rows.
__device__ void hp_init(int r) {
  for (int b = threadIdx.x; b <= (int)gridDim.x; b += HP_THREADS)
    hp_bandtab()[b] = hp_band(b, gridDim.x, r);
  __syncthreads();
}

// sum_{j<r} f(j) in one fixed order (lanes stride j, butterfly, warps in
// order): every block forms the same value.  Every thread must call it.
template <class F>
__device__ double hp_bsum(int r, F f) {
  double* red = hp_red();
  double a = 0.0;
#pragma unroll 4
  for (int j = threadIdx.x; j < r; j += HP_THREADS) a += f(j);
  a = ip_warp_sum(a);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = a;
  __syncthreads();
  double v = 0.0;
  for (int w = 0; w < HP_WARPS; ++w) v += red[w];
  __syncthreads();
  return v;
}

// The grid's column owners: column j to one warp (j % nblk picks the
// block); f(j) runs in every lane of the owner, lane 0 writes.
template <class F>
__device__ __forceinline__ void hp_cols(int r, F f) {
  const int warp = threadIdx.x >> 5;
  for (int j = blockIdx.x + gridDim.x * warp; j < r;
       j += gridDim.x * HP_WARPS)
    f(j);
}

// Column j of the nb partials (rows of r doubles), lanes striding the
// blocks in order, then a butterfly sum (in every lane).
__device__ __forceinline__ double hp_colsum(const double* part, int nb, int r,
                                            int j) {
  const int lane = threadIdx.x & 31;
  double a = 0.0;
#pragma unroll
  for (int k = 0; k < HP_MAX_BLK / 32; ++k)
    if (lane + 32 * k < nb) a += __ldcg(part + (size_t)(lane + 32 * k) * r + j);
  return ip_warp_sum(a);
}

// ---------------------------------------------------------------------------
// The operator's pass
// ---------------------------------------------------------------------------

// row . x in strip.cuh's sp_dot order (lanes stride the row, one FMA
// chain each, then a butterfly sum), with U loads of each lane in flight
// (x in shared memory, or in global memory read through L2 when XG).
template <bool XG, int U>
__device__ __forceinline__ double hp_dot(const double* row, const double* x,
                                         int r, int lane) {
  double acc = 0.0;
  int j = lane;
  for (; j + 32 * (U - 1) < r; j += 32 * U) {
    double a[U], b[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      a[u] = row[j + 32 * u];
      b[u] = XG ? __ldcg(x + j + 32 * u) : x[j + 32 * u];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) acc = fma(a[u], b[u], acc);
  }
  for (; j < r; j += 32) acc = fma(row[j], XG ? __ldcg(x + j) : x[j], acc);
  return ip_warp_sum(acc);
}

// Rows [i0, i1) of M are the block's.
__device__ __forceinline__ void hp_rows(const HpGeom& g, int m, long* i0,
                                        long* i1) {
  *i0 = (long)blockIdx.x * g.rpb;
  *i1 = *i0 + g.rpb < m ? *i0 + g.rpb : m;
}

// The block's share of one pass with rows read in place (r past the
// register form): y_i = rw(i, M_i . x) (called by lane 0 of the row's
// warp) and acc[j] += sum_i y_i M_ij over the block's rows, in row order,
// a group of HP_WARPS rows at a time (the column pass re-reads the group
// from L2).  xs: x as the row dots read it; acc zeroed by the caller.
template <bool XG, class RW>
__device__ void hp_pass(const HpGeom& g, const HpSmem& s,
                        const double* __restrict__ M, int m, int r,
                        const double* xs, double* acc, RW rw) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  long i0, i1;
  hp_rows(g, m, &i0, &i1);
  for (long row0 = i0; row0 < i1; row0 += HP_WARPS) {
    const int h = (int)(i1 - row0 < HP_WARPS ? i1 - row0 : HP_WARPS);
    const double* T = M + (size_t)row0 * r;
    if (warp < h) {
      const double d = hp_dot<XG, 4>(T + (size_t)warp * r, xs, r, lane);
      if (lane == 0) s.ys[warp] = rw(row0 + warp, d);
    }
    __syncthreads();
    for (int j = tid; j < r; j += HP_THREADS) {
      double a = acc[j];
      for (int rr = 0; rr < h; ++rr)
        a = fma(s.ys[rr], T[(size_t)rr * r + j], a);
      acc[j] = a;
    }
    __syncthreads();
  }
}

// One row into registers: lane l holds entries l + 32 u (8-byte loads,
// NPL of them in flight a lane).
template <int NPL>
__device__ __forceinline__ void hp_row_load(const double* row, int r,
                                            int lane, double (&v)[NPL]) {
#pragma unroll
  for (int u = 0; u < NPL; ++u) {
    const int j = lane + 32 * u;
    v[u] = j < r ? __ldcg(row + j) : 0.0;
  }
}

// The row's dot with xs in sp_dot's order (each lane's entries in order,
// then a butterfly sum).
template <int NPL>
__device__ __forceinline__ double hp_row_dot(const double (&v)[NPL],
                                             const double* xs, int r,
                                             int lane) {
  double acc = 0.0;
#pragma unroll
  for (int u = 0; u < NPL; ++u)
    if (lane + 32 * u < r) acc = fma(v[u], xs[lane + 32 * u], acc);
  return ip_warp_sum(acc);
}

// The register form of the pass (r <= 32 NPL): warp w takes the block's
// rows i0 + w, i0 + w + HP_WARPS, ...; each row is read once into
// registers, its dot formed, then y_i M_ij is added to the warp's own
// partial in shared memory (the columns of its lanes, in the warp's row
// order); then the block's rows of P, one warp a row.  The warps'
// partials are summed in warp order into `own`.
template <int NPL>
__device__ __forceinline__ void hp_pass_reg(
    const HpGeom& g, const double* __restrict__ M,
    const double* __restrict__ wt, const double* __restrict__ P, int m,
    int r, double* own, double* mx, double* px) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  long i0, i1;
  hp_rows(g, m, &i0, &i1);
  const int nm = i0 < i1 ? (int)(i1 - i0) : 0;
  double* accw = hp_reg_accw();
  const double* xs = hp_reg_xs(r);
  double* aw = accw + (size_t)warp * r;
  for (int j = lane; j < r; j += 32) aw[j] = 0.0;
  for (int t = warp; t < nm; t += HP_WARPS) {
    double v[NPL];
    hp_row_load<NPL>(M + (size_t)(i0 + t) * r, r, lane, v);
    const double d = hp_row_dot<NPL>(v, xs, r, lane);
    const double y = wt[i0 + t] * d;
    if (mx && lane == 0) mx[i0 + t] = d;
#pragma unroll
    for (int u = 0; u < NPL; ++u) {
      const int j = lane + 32 * u;
      if (j < r) aw[j] = fma(y, v[u], aw[j]);
    }
  }
  if (P) {
    const int j0 = blockIdx.x * g.prb;
    const int j1 = j0 + g.prb < r ? j0 + g.prb : r;
    for (int j = j0 + warp; j < j1; j += HP_WARPS) {
      double v[NPL];
      hp_row_load<NPL>(P + (size_t)j * r, r, lane, v);
      const double d = hp_row_dot<NPL>(v, xs, r, lane);
      if (lane == 0) px[j] = d;
    }
  }
  __syncthreads();
  for (int j = tid; j < r; j += HP_THREADS) {
    double a = 0.0;
    for (int w = 0; w < HP_WARPS; ++w) a += accw[(size_t)w * r + j];
    own[j] = a;
  }
}

// One operator application's block share: x staged from xg (when not
// null; else xs holds it already), the partial of M^T (wt . (M x)) into
// part's row, M x into mx (when not null), P x into px (P rows split
// evenly over the blocks, one warp per row).
template <int NPL, bool XG>
__device__ __forceinline__ void hp_apply(
    const HpGeom& g, const HpSmem& s, const double* __restrict__ M, const double* __restrict__ wt,
    const double* __restrict__ P, const double* xg, double* mx,
    double* part, double* px, int m, int r) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  double* own = part + (size_t)blockIdx.x * r;
  if constexpr (NPL > 0) {
    if (xg)
      for (int j = tid; j < r; j += HP_THREADS)
        hp_reg_xs(r)[j] = __ldcg(xg + j);
    __syncthreads();
    hp_pass_reg<NPL>(g, M, wt, P, m, r, own, mx, px);
  } else {
    for (int j = tid; j < r; j += HP_THREADS) {
      if (xg) s.xs[j] = __ldcg(xg + j);
      s.acc[j] = 0.0;
    }
    __syncthreads();
    hp_pass<XG>(g, s, M, m, r, s.xs, s.acc, [&](long i, double d) {
      if (mx) mx[i] = d;
      return wt[i] * d;
    });
    if (g.xsm)
      for (int j = tid; j < r; j += HP_THREADS) own[j] = s.acc[j];
    if (P) {
      const int j0 = blockIdx.x * g.prb;
      const int j1 = j0 + g.prb < r ? j0 + g.prb : r;
      for (int j = j0 + warp; j < j1; j += HP_WARPS) {
        const double d = hp_dot<XG, 8>(P + (size_t)j * r, s.xs, r, lane);
        if (lane == 0) px[j] = d;
      }
    }
  }
}

struct HAArgs {
  const double* M;
  const double* wt;
  const double* x;
  const double* P;
  double* mx;
  double* part;   // nblk x r
  double* px;     // r
  double* out;
  int m, r;
  HpGeom g;
};

// The block's share of M^T (wt . (M x)) (+ P x): the pass, its partial
// into part's row (and P x into px).
template <int NPL, bool XG>
__global__ void __launch_bounds__(HP_THREADS, 1) h_apply_kernel(HAArgs a) {
  hp_init(a.r);
  HpSmem s = hp_smem<NPL>(a.g, a.r, nullptr,
                          a.part + (size_t)blockIdx.x * a.r);
  if (XG) s.xs = const_cast<double*>(a.x);
  hp_apply<NPL, XG>(a.g, s, a.M, a.wt, a.P, XG ? nullptr : a.x, a.mx,
                    a.part, a.px, a.m, a.r);
}

// out = the partials summed in block order (+ P x)
__global__ void __launch_bounds__(HP_THREADS) h_finish_kernel(HAArgs a) {
  const int lane = threadIdx.x & 31;
  hp_cols(a.r, [&](int j) {
    const double v = hp_colsum(a.part, a.g.nblk, a.r, j);
    if (lane == 0) a.out[j] = a.P ? v + __ldcg(a.px + j) : v;
  });
}

// ---------------------------------------------------------------------------
// The refined solve
// ---------------------------------------------------------------------------

struct RSArgs {
  const double* M;     // m x r, row-major
  const double* wt;    // m
  const double* P;     // r x r or null
  const float* W;      // the fp32 W = L^-1 (lower), row stride ldw
  const int* kind;     // null or 0: the W form; 1 the X form; 2 the LDL
  const float* X;      // the fp32 X (square, row stride ldx; X form)
  const float* Lt;     // the LDL factor's panels (np x np; LDL form)
  const float* Dinv;   // its tile inverses (np x 128; LDL form)
  float* lv;           // 3 np floats: the LDL sweeps' y, z, x
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
  int m, r, ldw, ldx, np, refine;
  HpGeom g;
};

// Doubles of the solve's workspace (layout in refined_solve_kernel).
size_t solve_ws_doubles(const HpGeom& g, int m, int r) {
  const size_t nr = (size_t)g.nblk * r;
  const size_t slice = r + ((size_t)r + g.urows + 1) / 2;
  return nr + (nr + 1) / 2 + 14 * (size_t)r + m +
         (g.xsm ? 0 : (size_t)g.nblk * slice) + 1;
}

// The block's columns [q0, q1) of X in the X form (an even split of r).
__device__ __forceinline__ void hp_xcols(int r, int* q0, int* q1) {
  *q0 = (int)((long)blockIdx.x * r / gridDim.x);
  *q1 = (int)((long)(blockIdx.x + 1) * r / gridDim.x);
}

// X^T v of the dense X on the block's columns: t_c = sum_i X_ic v_i, one
// warp a column (lanes stride i, four chains, a butterfly sum), into tx.
// xs: the block's columns in shared memory (column c at (c - q0) r), or
// null: X read in place (row stride ldx).  v: the whole vector (r).
__device__ __noinline__ void hp_x_apply(const float* __restrict__ X,
                                        int ldx, const float* xs, int r,
                                        const float* v, float* tx) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int q0, q1;
  hp_xcols(r, &q0, &q1);
  auto xat = [&](int c, int i) {
    return xs ? xs[(size_t)(c - q0) * r + i]
              : __ldg(X + (size_t)i * ldx + c);
  };
  for (int c = q0 + warp; c < q1; c += HP_WARPS) {
    float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
    int i = lane;
    for (; i + 96 < r; i += 128) {
      c0 = fmaf(xat(c, i), v[i], c0);
      c1 = fmaf(xat(c, i + 32), v[i + 32], c1);
      c2 = fmaf(xat(c, i + 64), v[i + 64], c2);
      c3 = fmaf(xat(c, i + 96), v[i + 96], c3);
    }
    for (; i < r; i += 32) c0 = fmaf(xat(c, i), v[i], c0);
    const float t = ip_warp_sumf((c0 + c1) + (c2 + c3));
    if (lane == 0) tx[c] = t;
  }
}

// M^-1 v of the block-LDL factor M = Lt D Lt^T (the TPU kernel's
// _ldl_solve and ops/hybrid.py ldl_solve_plain): the forward sweep
// y_k = v_k - sum_{j<k} Lt_kj y_j (tile 0: y = v), then z_k = X_k^T y_k
// (X_k the tile inverses, rows kb.. of Dinv), then the backward sweep
// x_k = z_k - sum_{j>k} Lt_jk^T x_j (the last tile: x = z).  v: the
// block's copy of the vector's leading r entries (zero past r, up to np);
// y, z, x: np floats each in global memory.  A forward stage gives each
// block one row of the tile (its threads stride the row, then the block's
// sum in warp order), the middle one warp 32 outputs of a tile (lanes
// over the outputs, so Dinv's rows are read whole), a backward stage each
// block one column.  A grid barrier ends every stage but the last (the
// caller's follows).  Every block runs it.
__device__ __noinline__ void hp_ldl_apply(const float* __restrict__ Lt,
                                          const float* __restrict__ Dinv,
                                          int np, int r, const float* v,
                                          float* y, float* z, float* x) {
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nb = gridDim.x, nt = np / HP_LT;
  double* red = hp_red();
  auto vin = [&](int i) { return i < r ? v[i] : 0.f; };
  auto yat = [&](int j) { return j < HP_LT ? vin(j) : __ldcg(y + j); };
  // the block's sum of its threads' a, in warp order (thread 0 has it)
  auto bsum = [&](float a) {
    a = ip_warp_sumf(a);
    if (lane == 0) red[warp] = a;
    __syncthreads();
    float t = 0.f;
    if (tid == 0)
      for (int w = 0; w < HP_WARPS; ++w) t += (float)red[w];
    __syncthreads();
    return t;
  };
  for (int k = 1; k < nt; ++k) {
    const int k0 = k * HP_LT;
    for (int q = blockIdx.x; q < HP_LT; q += nb) {
      const float* row = Lt + (size_t)(k0 + q) * np;
      float a = 0.f;
      for (int j = tid; j < k0; j += HP_THREADS)
        a = fmaf(__ldg(row + j), yat(j), a);
      a = bsum(a);
      if (tid == 0) y[k0 + q] = vin(k0 + q) - a;
    }
    grid.sync();
  }
  for (int t = blockIdx.x * HP_WARPS + warp; t < np / 32;
       t += nb * HP_WARPS) {
    const int i = t * 32 + lane, k0 = i / HP_LT * HP_LT;
    const float* d = Dinv + (size_t)k0 * HP_LT + (i - k0);
    float a = 0.f;
    for (int l = 0; l < HP_LT; ++l)
      a = fmaf(__ldg(d + (size_t)l * HP_LT), yat(k0 + l), a);
    z[i] = a;
    if (k0 == np - HP_LT) x[i] = a;
  }
  grid.sync();
  for (int k = nt - 2; k >= 0; --k) {
    const int k0 = k * HP_LT, k1 = k0 + HP_LT;
    for (int q = blockIdx.x; q < HP_LT; q += nb) {
      float a = 0.f;
      for (int l = k1 + tid; l < np; l += HP_THREADS)
        a = fmaf(__ldg(Lt + (size_t)l * np + k0 + q), __ldcg(x + l), a);
      a = bsum(a);
      if (tid == 0) x[k0 + q] = __ldcg(z + k0 + q) - a;
    }
    if (k > 0) grid.sync();
  }
}

// KF: the instance K2 launches, with the X and LDL forms; K1's and K4's
// (the W form alone) keep the registers of their pass (the calls of the
// other forms would spill there).
template <int NPL, bool XG, bool KF>
__global__ void __launch_bounds__(HP_THREADS, 1)
refined_solve_kernel(RSArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int r = a.r, m = a.m, nb = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const HpGeom& g = a.g;
  // the workspace: the operator's partials, the W-solve's (fp32), P x,
  // the residual, per-column terms of the reductions, the PCG's vectors
  // (re and p double-buffered: every block reads the old one while the
  // column owners write the new one), M x2, the blocks' slices
  double* part = a.ws;
  float* tp = reinterpret_cast<float*>(part + (size_t)nb * r);
  double* px = part + (size_t)nb * r + ((size_t)nb * r + 1) / 2;
  double* res = px + r;
  double* sqv = res + r;
  double* hp = sqv + r;
  double* zz = hp + r;
  double* dterm = zz + r;
  double* zterm = dterm + r;
  double* nterm = zterm + r;
  double* reb = nterm + r;      // 2 r
  double* pb = reb + 2 * r;     // 2 r
  double* cx = pb + 2 * r;
  double* mx2 = cx + r;
  double* slices = mx2 + m;
  const size_t slice = r + ((size_t)r + g.urows + 1) / 2;
  hp_init(r);
  const HpSmem s = hp_smem<NPL>(g, r, slices + (size_t)blockIdx.x * slice,
                           part + (size_t)blockIdx.x * r);
  const int* band = hp_bandtab();
  const int R0 = band[blockIdx.x], R1 = band[blockIdx.x + 1];
  // the preconditioner's form, the same in every block; the X form's
  // columns of this block; the entries of v that the form reads
  const int form = KF && a.kind ? *a.kind : 0;
  const bool xf = form == 1, lf = form == 2;
  const int VL = form ? r : R1;
  auto ds = [&](int j) { return (double)a.dsc[j]; };
  // row i of W's band: in shared memory (packed rows of i + 1 floats) or
  // in place
  auto wrow = [&](int i) -> const float* {
    return g.wres ? s.wb + (((long)i * (i + 1) - (long)R0 * (R0 + 1)) >> 1)
                  : a.W + (size_t)i * a.ldw;
  };
  // row i + 1 of the band from row i's
  auto wnext = [&](const float* p, int i) {
    return p + (g.wres ? i + 1 : a.ldw);
  };
  if (g.wres && xf) {
    // the block's columns [q0, q1) of X, column c at (c - q0) r
    int q0, q1;
    hp_xcols(r, &q0, &q1);
    const int nc = q1 - q0;
    for (int e = tid; e < nc * r; e += HP_THREADS) {
      const int i = e / nc, c = e - i * nc;
      s.wb[(size_t)c * r + i] = __ldg(a.X + (size_t)i * a.ldx + q0 + c);
    }
  } else if (g.wres && form == 0) {
    for (int i = R0 + warp; i < R1; i += HP_WARPS) {
      float* dst = const_cast<float*>(wrow(i));
      const float* src = a.W + (size_t)i * a.ldw;
      for (int k = lane; k <= i; k += 32) dst[k] = __ldg(src + k);
    }
  }
  // The W-solve's band share: s.v[k] (k < R1) written by the caller;
  // u = W v on the band, then the band's partial of W^T u into tp's row.
  auto wsolve = [&]() {
    __syncthreads();
    for (int i = R0 + warp; i < R1; i += HP_WARPS) {
      const float* row = wrow(i);
      float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
      int j = lane;
      for (; j + 96 <= i; j += 128) {
        c0 = fmaf(row[j], s.v[j], c0);
        c1 = fmaf(row[j + 32], s.v[j + 32], c1);
        c2 = fmaf(row[j + 64], s.v[j + 64], c2);
        c3 = fmaf(row[j + 96], s.v[j + 96], c3);
      }
      for (; j <= i; j += 32) c0 = fmaf(row[j], s.v[j], c0);
      const float acc = ip_warp_sumf((c0 + c1) + (c2 + c3));
      if (lane == 0) s.u[i - R0] = acc;
    }
    __syncthreads();
    float* own = tp + (size_t)blockIdx.x * r;
    for (int j = tid; j < R1; j += HP_THREADS) {
      float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
      int i = j > R0 ? j : R0;
      const float* p0 = wrow(i);
      for (; i + 3 < R1; i += 4) {
        const float* p1 = wnext(p0, i);
        const float* p2 = wnext(p1, i + 1);
        const float* p3 = wnext(p2, i + 2);
        c0 = fmaf(p0[j], s.u[i - R0], c0);
        c1 = fmaf(p1[j], s.u[i + 1 - R0], c1);
        c2 = fmaf(p2[j], s.u[i + 2 - R0], c2);
        c3 = fmaf(p3[j], s.u[i + 3 - R0], c3);
        p0 = wnext(p3, i + 3);
      }
      for (; i < R1; ++i, p0 = wnext(p0, i - 1))
        c0 = fmaf(p0[j], s.u[i - R0], c0);
      own[j] = (c0 + c1) + (c2 + c3);
    }
  };
  // X form: (X^T v)_c for the block's columns, v whole (written by the
  // caller), into tx (tp's first r floats)
  float* tx = tp;
  auto precond = [&]() {
    if (xf) {
      __syncthreads();
      hp_x_apply(a.X, a.ldx, g.wres ? s.wb : nullptr, r, s.v, tx);
    } else if (lf) {
      __syncthreads();
      hp_ldl_apply(a.Lt, a.Dinv, a.np, r, s.v, a.lv, a.lv + a.np,
                   a.lv + 2 * a.np);
    } else {
      wsolve();
    }
  };
  // t_j = (W^T u)_j: the bands' partials in block order (column owners)
  auto wsum = [&](int j) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < HP_MAX_BLK / 32; ++k) {
      const int bb = lane + 32 * k;
      if (bb < nb && band[bb + 1] > j) t += __ldcg(tp + (size_t)bb * r + j);
    }
    return (double)ip_warp_sumf(t);
  };
  // (M^-1 v)_j of the form (column owners)
  auto pre = [&](int j) {
    return xf   ? (double)__ldcg(tx + j)
           : lf ? (double)__ldcg(a.lv + 2 * a.np + j)
                : wsum(j);
  };
  // one operator application: x from xg (or s.xs), M x into mx
  auto op = [&](const double* xg, double* mxv) {
    hp_apply<NPL, XG>(g, s, a.M, a.wt, a.P, xg, mxv, part, px, m, r);
  };
  // (H x)_j from the partials (column owners)
  auto hx = [&](int j) {
    const double v = hp_colsum(part, nb, r, j);
    return a.P ? v + __ldcg(px + j) : v;
  };

  // x = 0 (its column owners, who update it); bn2 = ||D b||^2 in every
  // block; v = float(D b)
  hp_cols(r, [&](int j) {
    if (lane == 0) a.x[j] = 0.0;
  });
  const double bn2 = hp_bsum(r, [&](int j) {
    const double t = __dmul_rn(a.b[j], ds(j));
    return __dmul_rn(t, t);
  });

  int rounds = 0;
  bool exited = false;
  double s0 = bn2;
  for (int it = 0; it < a.refine; ++it) {
    // the exit test on ||D res||^2 (res = b before the first round)
    if (!(s0 > a.exit2 * bn2)) {
      exited = true;
      break;
    }
    for (int k = tid; k < VL; k += HP_THREADS)
      s.v[k] = __double2float_rn(
          __dmul_rn(rounds ? __ldcg(res + k) : a.b[k], ds(k)));
    precond();
    grid.sync();
    // x += D M^-1 v
    hp_cols(r, [&](int j) {
      const double t = pre(j);
      if (lane == 0) a.x[j] = __dadd_rn(a.x[j], __dmul_rn(ds(j), t));
    });
    grid.sync();
    op(a.x, a.mx);
    grid.sync();
    // res = b - H x and its terms ||D res_j||^2
    hp_cols(r, [&](int j) {
      const double v = hx(j);
      if (lane == 0) {
        const double rj = __dsub_rn(a.b[j], v);
        res[j] = rj;
        const double t = __dmul_rn(rj, ds(j));
        sqv[j] = __dmul_rn(t, t);
      }
    });
    grid.sync();
    ++rounds;
    s0 = hp_bsum(r, [&](int j) { return __ldcg(sqv + j); });
  }
  // a residual at or below the exit is below the stall gate too when
  // exit2 <= stall2
  const bool stalled = !(exited && a.exit2 <= a.stall2) && s0 > a.stall2 * bn2;
  bool kept = false;
  int pcg = 0;
  double s2 = 0.0;
  if (stalled) {
    // re = D r0, cx = 0, zz = p = M^-1 re (v = float(re))
    auto r0 = [&](int k) { return rounds ? __ldcg(res + k) : a.b[k]; };
    double* re = reb;
    double* rn = reb + r;
    double* pc = pb;
    double* pn = pb + r;
    hp_cols(r, [&](int j) {
      if (lane == 0) {
        const double e = __dmul_rn(r0(j), ds(j));
        re[j] = e;
        cx[j] = 0.0;
        nterm[j] = __dmul_rn(e, e);
      }
    });
    for (int k = tid; k < VL; k += HP_THREADS)
      s.v[k] = __double2float_rn(__dmul_rn(r0(k), ds(k)));
    precond();
    grid.sync();
    hp_cols(r, [&](int j) {
      const double t = pre(j);
      if (lane == 0) {
        pc[j] = t;
        zterm[j] = __dmul_rn(re[j], t);
      }
    });
    grid.sync();
    double rz = hp_bsum(r, [&](int j) { return __ldcg(zterm + j); });
    double rn2c = hp_bsum(r, [&](int j) { return __ldcg(nterm + j); });
    // x_in = D p, formed by every block
    for (int k = tid; k < r; k += HP_THREADS)
      s.xs[k] = __dmul_rn(ds(k), __ldcg(pc + k));
    const double thr = fmax(a.exit2, 1e-26) * bn2;
    for (int it = 0; it < PCG_MAX; ++it) {
      if (!(rn2c > thr && isfinite(rn2c) && isfinite(rz))) break;
      op(nullptr, nullptr);
      grid.sync();
      // hp = D H x_in, and the terms of p . hp
      hp_cols(r, [&](int j) {
        const double v = hx(j);
        if (lane == 0) {
          const double h = __dmul_rn(ds(j), v);
          hp[j] = h;
          dterm[j] = __dmul_rn(__ldcg(pc + j), h);
        }
      });
      grid.sync();
      const double den = hp_bsum(r, [&](int j) { return __ldcg(dterm + j); });
      const double al = rz / (fabs(den) > 1e-30 ? den : 1e-30);
      // re' = re - al hp: every block forms v = float(re') for its band;
      // the column owners write re', cx += al p and the terms of re'.re'
      for (int k = tid; k < VL; k += HP_THREADS)
        s.v[k] = __double2float_rn(
            __dsub_rn(__ldcg(re + k), __dmul_rn(al, __ldcg(hp + k))));
      hp_cols(r, [&](int j) {
        if (lane == 0) {
          const double e = __dsub_rn(__ldcg(re + j), __dmul_rn(al, __ldcg(hp + j)));
          rn[j] = e;
          cx[j] = __dadd_rn(cx[j], __dmul_rn(al, __ldcg(pc + j)));
          nterm[j] = __dmul_rn(e, e);
        }
      });
      precond();
      grid.sync();
      // zz = M^-1 re', and the terms of re'.zz
      hp_cols(r, [&](int j) {
        const double t = pre(j);
        if (lane == 0) {
          zz[j] = t;
          zterm[j] = __dmul_rn(rn[j], t);
        }
      });
      grid.sync();
      const double rz2 = hp_bsum(r, [&](int j) { return __ldcg(zterm + j); });
      rn2c = hp_bsum(r, [&](int j) { return __ldcg(nterm + j); });
      const double be = rz2 / (fabs(rz) > 1e-30 ? rz : 1e-30);
      // p' = zz + be p: every block forms x_in = D p'; the column owners
      // write p'
      for (int k = tid; k < r; k += HP_THREADS) {
        const double q = __dadd_rn(__ldcg(zz + k), __dmul_rn(be, __ldcg(pc + k)));
        s.xs[k] = __dmul_rn(ds(k), q);
      }
      hp_cols(r, [&](int j) {
        if (lane == 0)
          pn[j] = __dadd_rn(__ldcg(zz + j), __dmul_rn(be, __ldcg(pc + j)));
      });
      rz = rz2;
      ++pcg;
      double* t = re;
      re = rn;
      rn = t;
      t = pc;
      pc = pn;
      pn = t;
      __syncthreads();
    }
    // x2 = x + D cx, formed by every block; its residual
    for (int k = tid; k < r; k += HP_THREADS)
      s.xs[k] = __dadd_rn(__ldcg(a.x + k), __dmul_rn(ds(k), __ldcg(cx + k)));
    op(nullptr, mx2);
    grid.sync();
    hp_cols(r, [&](int j) {
      const double v = hx(j);
      if (lane == 0) {
        const double t = __dmul_rn(__dsub_rn(a.b[j], v), ds(j));
        sqv[j] = __dmul_rn(t, t);
      }
    });
    grid.sync();
    s2 = hp_bsum(r, [&](int j) { return __ldcg(sqv + j); });
    kept = s2 < s0;
    if (kept) {
      hp_cols(r, [&](int j) {
        if (lane == 0)
          a.x[j] = __dadd_rn(a.x[j], __dmul_rn(ds(j), __ldcg(cx + j)));
      });
      for (int i = blockIdx.x * HP_THREADS + tid; i < m; i += nb * HP_THREADS)
        a.mx[i] = __ldcg(mx2 + i);
    }
  }
  // x = 0 was never applied: M x = 0
  if (!kept && rounds == 0)
    for (int i = blockIdx.x * HP_THREADS + tid; i < m; i += nb * HP_THREADS)
      a.mx[i] = 0.0;
  if (blockIdx.x == 0 && tid == 0) {
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

// M^-1 v of the X form (1) or the LDL form (2) alone, by the device
// functions ip_refined_solve applies inside itself (hp_x_apply,
// hp_ldl_apply): their sums do not depend on the grid, so out is bitwise
// what the solve forms from the same v.  For checks that hold a plain
// solve on the CUDA preconditioner against the solve.
struct PAArgs {
  const float* X;
  const float* Lt;
  const float* Dinv;
  float* lv;
  const float* v;
  float* out;
  int form, ldx, np, r;
};

__global__ void __launch_bounds__(HP_THREADS, 1)
precond_apply_kernel(PAArgs a) {
  if (a.form == 1) {
    hp_x_apply(a.X, a.ldx, nullptr, a.r, a.v, a.out);
    return;
  }
  hp_ldl_apply(a.Lt, a.Dinv, a.np, a.r, a.v, a.lv, a.lv + a.np,
               a.lv + 2 * a.np);
  cg::this_grid().sync();
  for (int i = blockIdx.x * HP_THREADS + threadIdx.x; i < a.r;
       i += gridDim.x * HP_THREADS)
    a.out[i] = __ldcg(a.lv + 2 * a.np + i);
}

// Host side of a launch, checked once per kernel and dynamic shared size:
// the dynamic shared memory allowed (raised only), the static shared
// memory within HP_STATIC, one block per SM resident.
static cudaError_t hp_ready(const void* kernel, int smem) {
  struct Seen {
    const void* kernel;
    int smem;    // the largest size allowed so far
    int ok;      // sizes up to `ok` checked
  };
  static Seen seen[HP_INSTANCES];
  static int n = 0;
  int i = 0;
  while (i < n && seen[i].kernel != kernel) ++i;
  if (i < n && seen[i].ok >= smem) return cudaSuccess;
  if (i == n) {
    if (n == HP_INSTANCES) return cudaErrorInvalidValue;
    seen[n++] = {kernel, -1, -1};
  }
  cudaError_t e = cudaSuccess;
  if (seen[i].smem < smem) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e == cudaSuccess) seen[i].smem = smem;
  }
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
  if (e == cudaSuccess && fa.sharedSizeBytes > (size_t)HP_STATIC)
    e = cudaErrorInvalidConfiguration;   // HP_STATIC is too small
  int per = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel,
                                                      HP_THREADS, smem);
  if (e == cudaSuccess && per < 1) e = cudaErrorCooperativeLaunchTooLarge;
  if (e == cudaSuccess) seen[i].ok = smem;
  return e;
}

// One launch of g.nblk blocks: cooperative (the solve's grid barriers) or
// plain.
static int hp_launch(const void* kernel, const HpGeom& g, void* arg,
                     cudaStream_t stream, bool coop) {
  void* args[] = {arg};
  cudaError_t e = hp_ready(kernel, g.smem);
  if (e == cudaSuccess)
    e = coop ? cudaLaunchCooperativeKernel(kernel, dim3(g.nblk),
                                           dim3(HP_THREADS), args, g.smem,
                                           stream)
             : cudaLaunchKernel(kernel, dim3(g.nblk), dim3(HP_THREADS), args,
                                g.smem, stream);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return ip_status();
}

// The kernel instance of a geometry: the register form's width, or rows
// in place with x in shared or in global memory.
template <template <int, bool> class K>
static const void* hp_instance(const HpGeom& g) {
  switch (g.npl) {
    case 8: return K<8, false>::fn();
    case 16: return K<16, false>::fn();
    case 32: return K<32, false>::fn();
    default: return g.xsm ? K<0, false>::fn() : K<0, true>::fn();
  }
}
template <int NPL, bool XG>
struct HApplyK {
  static const void* fn() { return (const void*)h_apply_kernel<NPL, XG>; }
};
template <int NPL, bool XG>
struct SolveK {
  static const void* fn() {
    return (const void*)refined_solve_kernel<NPL, XG, false>;
  }
};
template <int NPL, bool XG>
struct SolveKF {
  static const void* fn() {
    return (const void*)refined_solve_kernel<NPL, XG, true>;
  }
};

}  // namespace

// Workspace bytes of ip_h_apply for an m x r matrix.
IP_API size_t ip_h_ws_bytes(int m, int r) {
  const HpGeom g = hp_geom_of(m, r, false);
  return ((size_t)g.nblk + 1) * r * sizeof(double);
}

// out = M^T (wt . (M x)) (+ P x) (P r x r row-major, or null); mx, when
// not null, receives M x.  Two plain launches (one cooperative launch
// took the host longer a call than two plain ones): the pass, then the
// column sums in block order.
IP_API int ip_h_apply(const double* M, const double* wt, const double* x,
                      const double* P, double* mx, double* ws, double* out,
                      int m, int r, cudaStream_t stream) {
  if (r <= 0) return 0;
  HAArgs a{M, wt, x, P, mx, ws, nullptr, out, m, r, hp_geom_of(m, r, false)};
  a.px = ws + (size_t)a.g.nblk * r;
  const int e = hp_launch(hp_instance<HApplyK>(a.g), a.g, &a, stream, false);
  if (e) return e;
  h_finish_kernel<<<a.g.nblk, HP_THREADS, 0, stream>>>(a);
  return ip_status();
}

// Workspace bytes of ip_refined_solve for an m x r matrix.
IP_API size_t ip_refined_solve_ws_bytes(int m, int r) {
  const HpGeom g = hp_geom_of(m, r, true);
  return solve_ws_doubles(g, m, r) * sizeof(double);
}

// The refined solve of H x = b, H = M^T diag(wt) M (+ P), preconditioned by
// D W^T W D (W fp32 lower, row stride ldw; D = dsc) or, where kind is not
// null, by the form *kind names on the device: 1, D X^T D (X fp32, row
// stride ldx, its leading r x r read); 2, D M^-1 D with M the block-LDL
// factor (Lt np x np, its strictly lower 128-wide tiles read; Dinv np x
// 128, the tile inverses; np a multiple of 128, at least r; lv 3 np floats
// of scratch).  Returns x, M x of the returned x, rn2 = ||D (b - H x)||^2
// and bn2 = ||D b||^2 (0-d), counts (4 ints: rounds, stalled, PCG rounds,
// PCG kept); tally (4 ints, or null) adds the operator passes, rounds, PCG
// rounds and one solve.  With kind, every form's buffers must be given
// (the forms not taken are not read).  One cooperative launch of one block
// per SM; an error when the grid cannot be resident.
IP_API int ip_refined_solve(const double* M, const double* wt,
                            const double* P, const float* W, int ldw,
                            const int* kind, const float* X, int ldx,
                            const float* Lt, const float* Dinv, int np,
                            float* lv, const float* dsc, const double* b,
                            int refine, double stall2, double exit2,
                            double* x, double* mx, double* rn2, double* bn2,
                            int* counts, int* tally, double* ws, int m, int r,
                            cudaStream_t stream) {
  if (r <= 0 || (kind && (!X || ldx < r || !Lt || !Dinv || !lv ||
                          np < r || np % HP_LT)))
    return (int)cudaErrorInvalidValue;
  RSArgs a{M,    wt,     P,     W,      kind, X,      Lt,  Dinv, lv,
           dsc,  b,      stall2, exit2, x,    mx,     rn2, bn2,  counts,
           tally, ws,    m,     r,      ldw,  ldx,    np,  refine,
           hp_geom_of(m, r, true, kind != nullptr)};
  return hp_launch(kind ? hp_instance<SolveKF>(a.g)
                        : hp_instance<SolveK>(a.g),
                   a.g, &a, stream, true);
}

// out = M^-1 v (r floats) of the preconditioner's form 1 (X^T v, X fp32
// with row stride ldx) or 2 (the block-LDL factor's tile sweeps, Lt and
// Dinv as ip_refined_solve takes them, lv 3 np floats of scratch), by the
// solve's own device functions: the same bits as the solve's application.
// One cooperative launch of one block per SM.
IP_API int ip_precond_apply(int form, const float* X, int ldx,
                            const float* Lt, const float* Dinv, int np,
                            float* lv, const float* v, float* out, int r,
                            cudaStream_t stream) {
  if (r <= 0) return 0;
  if (form == 1 ? !X || ldx < r
                : form != 2 || !Lt || !Dinv || !lv || np < r || np % HP_LT)
    return (int)cudaErrorInvalidValue;
  PAArgs a{X, Lt, Dinv, lv, v, out, form, ldx, np, r};
  HpGeom g{};
  int cap = 0;
  sp_device(&g.nblk, &cap);
  if (g.nblk > HP_MAX_BLK) g.nblk = HP_MAX_BLK;
  return hp_launch((const void*)precond_apply_kernel, g, &a, stream, true);
}
