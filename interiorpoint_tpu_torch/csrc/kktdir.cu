// One dense-KKT direction of K5 (ops/kkt_step.py), every decision on the
// device, in one cooperative launch:
//
//     [ H   F^T ] [dx]   [ r1  ]
//     [ F   0   ] [dy] = [ -rpe ]
//
// on the fp64 factors kkt_prepare built (H the augmented Newton matrix,
// W = L^-1 of its equilibrated jittered factor with the equilibration D,
// and for pe > 0 Ws = Ls^-1 of the equilibrated Schur preconditioner with
// its equilibration Ds).
//
// Replaces the control flow of the TPU kernel
// interiorpoint_tpu/ops/pallas_kkt.py:_kkt_dir_kernel (pallas_call at
// :348), which takes every decision of a direction inside one call: the
// refinement rounds and the PCG stall escalation of every H-solve
// (_refined_solve, :146-152), the Schur-CG and its exit (:236-258), the
// back-substitution and the residual norms; with the port's kkt_solve on
// top (the shift r1 - rho F^T rpe of the augmented form and up to
// kkt_refine more directions on the fp64 residual while
// rn2 > kkt2 bn2).  The rules and constants are those of the plain
// version, ops/kkt_step.py `_kkt_dir` and `kkt_solve` over ops/refine.py
// `refined_solve`/`pcg`: each H-solve makes up to `refine` rounds of
// x += D W^T W D res, res = b - H x, exits at ||D res||^2 <= exit2 ||D b||^2,
// escalates to the PCG in the equilibrated metric when the residual stays
// above stall2 (at most PCG_MAX rounds, kept only if it lowered the
// residual); the Schur-CG on Ds F H^-1 F^T Ds y = Ds (F t1 + rpe) takes
// at most `rounds` rounds, preconditioned by Ws^T Ws, and exits at
// ||r||^2 <= cg2 ||u||^2 or on a value that is not finite.  All in fp64:
// the TPU carried double-float32 pairs; the card has fp64.  The
// elementwise updates round as the plain version's separate PyTorch
// operations do (__dmul_rn, __dadd_rn: no contraction into FMA); only
// the order of the sums differs.
//
// Bound: at (r, pe) = (1000, 800) the operands of a direction are H
// (8 MB), W's lower triangle (4 MB), F (6.4 MB) and Ws's (2.6 MB).  A
// Schur-CG round applies H, W, F, F^T and Ws (each once per refinement
// round of its H-solve), about 30 MB of reads, a few microseconds from
// shared memory or L2; what bounds a round is the chain of grid barriers
// between its dependent passes (3 a refinement round, 4 a PCG round, 5 a
// Schur-CG round besides its H-solve) and the latency of each pass.  The
// design:
//
// * One block of 384 threads per SM, all resident (a cooperative
//   launch; an error when they cannot be).  At 512 threads (128
//   registers) the kernel spilled and a direction took 10-35% longer on
//   an H100 80GB HBM3 at 700 W.  Every block holds, in shared
//   memory for the whole launch, its rows of H and F (an even split:
//   block b owns rows [b rpb, (b + 1) rpb) of the r-space and
//   [b rpf, (b + 1) rpf) of the pe-space) and its band of W's and Ws's
//   lower triangles (bands of equal area, coop.cuh); where the four do
//   not fit (past the main path's shapes), all are read from global
//   memory.
// * H x and F x: one warp a row of the owning block, lanes striding the
//   row, then a butterfly sum (x staged whole in every block's shared
//   memory).  W^T (W v) and Ws^T (Ws v): each block forms u = W v on its
//   band and the band's partial of W^T u; F^T u: each block the partial
//   over its rows of F.  After a grid barrier the owner of column j (the
//   warp that owns element j) sums the partials in block order.
// * Every element of a vector is written by its owner alone; vectors that
//   every block needs are staged into shared memory after a barrier, or
//   formed by every block from the same inputs.  The dot products and
//   exit tests are summed by every block from per-element terms in one
//   fixed order, so every block takes the same branch; no sum uses an
//   atomic (only the integer tally does): the result and the counts are
//   the same from run to run.
#include <cooperative_groups.h>

#include "coop.cuh"    // coop_band, coop_launch
#include "strip.cuh"   // sp_device

namespace cg = cooperative_groups;

namespace {

constexpr int KD_THREADS = 384;   // 168 registers (no spill in SMEM)
constexpr int KD_WARPS = KD_THREADS / 32;
constexpr int KD_MAX_BLK = 256;   // blocks (SMs), at most
constexpr int KD_STATIC = 8192;   // shared bytes kept for static arrays
constexpr int KD_PCG_MAX = 48;    // ops/refine.py PCG_MAX
constexpr int KD_COUNTS = 7;      // ops/kkt_step.py COUNT_KEYS
// vectors of the workspace: r-space and pe-space
constexpr int KD_RVECS = 18;
constexpr int KD_PVECS = 13;

// Launch geometry (computed on the host).
struct KdGeom {
  int nblk;
  int rpb, rpf;     // rows of the r-space and the pe-space a block owns
  int xlen;         // doubles of the staged vector
  int urows;        // rows of the largest band of W or Ws
  int wband, sband; // doubles of the largest band of W and of Ws
  int res;          // the operands in shared memory (else all in global)
  int smem;         // dynamic shared bytes
};

__host__ __device__ inline int kd_even(int n) { return (n + 1) & ~1; }

static KdGeom kd_geom(int r, int pe) {
  int sms = 0, cap = 0;
  sp_device(&sms, &cap);
  KdGeom g{};
  g.nblk = sms < KD_MAX_BLK ? sms : KD_MAX_BLK;
  g.rpb = (r + g.nblk - 1) / g.nblk;
  g.rpf = (pe + g.nblk - 1) / g.nblk;
  g.xlen = kd_even(r > pe ? r : pe);
  for (int b = 0; b < g.nblk; ++b) {
    const long w0 = coop_band(b, g.nblk, r), w1 = coop_band(b + 1, g.nblk, r);
    const long s0 = coop_band(b, g.nblk, pe), s1 = coop_band(b + 1, g.nblk, pe);
    const long wa = (w1 * (w1 + 1) - w0 * (w0 + 1)) / 2;
    const long sa = (s1 * (s1 + 1) - s0 * (s0 + 1)) / 2;
    if (wa > g.wband) g.wband = (int)wa;
    if (sa > g.sband) g.sband = (int)sa;
    if (w1 - w0 > g.urows) g.urows = (int)(w1 - w0);
    if (s1 - s0 > g.urows) g.urows = (int)(s1 - s0);
  }
  g.urows = kd_even(g.urows);
  g.wband = kd_even(g.wband);
  g.sband = kd_even(g.sband);
  const long avail = (long)cap - KD_STATIC;
  const long base = 8L * (g.xlen + g.urows);
  const long all = base + 8L * (g.wband + (long)g.rpb * r +
                                (pe ? (long)g.rpf * r + g.sband : 0));
  g.res = all <= avail;
  g.smem = (int)(g.res ? all : base);
  return g;
}

// kd_geom, remembered for the last few shapes (the host's cost per call).
static KdGeom kd_geom_of(int r, int pe) {
  struct Seen {
    int r, pe;
    KdGeom g;
  };
  static Seen seen[8];
  static int n = 0, next = 0;
  for (int i = 0; i < n; ++i)
    if (seen[i].r == r && seen[i].pe == pe) return seen[i].g;
  const KdGeom g = kd_geom(r, pe);
  seen[next] = {r, pe, g};
  next = (next + 1) % 8;
  if (n < 8) ++n;
  return g;
}

static size_t kd_ws_doubles(const KdGeom& g, int r, int pe) {
  const int x = r > pe ? r : pe;
  return (size_t)KD_RVECS * kd_even(r) + (size_t)KD_PVECS * kd_even(pe) +
         (size_t)g.nblk * x;
}

struct KdArgs {
  const double* H;    // r x r, row-major
  const double* W;    // lower L^-1 of H's factor, row stride ldw
  const double* dsc;  // H's equilibration D (>= r)
  const double* F;    // pe x r, row-major (pe > 0)
  const double* Ws;   // lower Ls^-1 of S's factor, row stride ldws
  const double* ds;   // S's equilibration Ds (>= pe)
  const double* r1;   // r
  const double* rpe;  // pe
  const double* rho;  // the augmented form's rho (solve, pe > 0)
  double* dx;         // out: r
  double* dy;         // out: pe
  double* rn2;        // out
  double* bn2;        // out
  int* counts;        // out (or null): KD_COUNTS ints
  int* tally;         // += counts (or null)
  double* ws;         // kd_ws_doubles
  double stall2, exit2, cg2, kkt2;
  int r, pe, ldw, ldws, refine, rounds, solve, kkt_refine;
  KdGeom g;
};

extern __shared__ __align__(16) unsigned char kd_raw[];

// Static shared arrays, one instance per kernel.
__device__ __forceinline__ int* kd_wbands() {
  __shared__ int band[KD_MAX_BLK + 1];
  return band;
}
__device__ __forceinline__ int* kd_sbands() {
  __shared__ int band[KD_MAX_BLK + 1];
  return band;
}
__device__ __forceinline__ double* kd_red() {
  __shared__ double red[KD_WARPS];
  return red;
}

// row . x over n entries: lanes stride the row (4 loads of each lane in
// flight, one FMA chain a lane), then a butterfly sum.  Every lane of
// the warp must call it; every lane returns the sum.
__device__ __forceinline__ double kd_dot(const double* row, const double* x,
                                         int n, int lane) {
  double acc = 0.0;
  int j = lane;
  for (; j + 96 < n; j += 128) {
    const double a0 = row[j], a1 = row[j + 32], a2 = row[j + 64],
                 a3 = row[j + 96];
    acc = fma(a0, x[j], acc);
    acc = fma(a1, x[j + 32], acc);
    acc = fma(a2, x[j + 64], acc);
    acc = fma(a3, x[j + 96], acc);
  }
  for (; j < n; j += 32) acc = fma(row[j], x[j], acc);
  return ip_warp_sum(acc);
}

__device__ __forceinline__ double ld(const double* p) { return __ldcg(p); }

// SMEM: every block's rows of H and F and bands of W and Ws in shared
// memory (every shape the main path gives K5), their pointers visibly
// shared (a runtime choice between shared and global pointers makes
// generic loads); else all four read from global memory.
template <bool SMEM>
__global__ void __launch_bounds__(KD_THREADS, 1)
kkt_direction_kernel(KdArgs a) {
  cg::grid_group grid = cg::this_grid();
  const KdGeom& g = a.g;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nb = gridDim.x, b = blockIdx.x;
  const int r = a.r, pe = a.pe;
  const double* D = a.dsc;
  const double* Ds = a.ds;

  // shared memory: the staged vector, a band's u, then the residents
  double* sp = reinterpret_cast<double*>(kd_raw);
  double* xs = sp;
  sp += g.xlen;
  double* us = sp;
  sp += g.urows;
  double* const wsm = sp;
  double* const hsm = wsm + g.wband;
  double* const fsm = hsm + (size_t)g.rpb * r;
  double* const ssm = fsm + (size_t)g.rpf * r;

  // the workspace
  double* wp = a.ws;
  auto rvec = [&]() {
    double* p = wp;
    wp += kd_even(r);
    return p;
  };
  auto pvec = [&]() {
    double* p = wp;
    wp += kd_even(pe);
    return p;
  };
  double* X = rvec();     // an H-solve's iterate (its own output elsewhere)
  double* RES = rvec();   // its residual
  double* BV = rvec();    // a right-hand side formed in the launch
  double* CX = rvec();    // the PCG's correction
  double* RE0 = rvec();
  double* RE1 = rvec();   // the PCG's residual (two buffers)
  double* PC0 = rvec();
  double* PC1 = rvec();   // its direction (two buffers)
  double* ZZ = rvec();
  double* HPV = rvec();
  // per-element terms of the r-space sums, one array a role, so that a
  // block writes an array only after a grid barrier that followed every
  // block's last sum of it
  double* TA = rvec();    // ||D res||^2 and the KKT residual's e1.e1
  double* TB = rvec();    // the PCG's re.re
  double* TZ = rvec();    // its re.zz
  double* TD = rvec();    // its p.hp
  double* R1S = rvec();   // r1 - rho F^T rpe
  double* E1 = rvec();    // kkt_solve's residual, r-space
  double* CDX = rvec();   // a refinement direction's dx
  double* XS2 = rvec();   // the PCG's x2
  double* UE = pvec();
  double* Y = pvec();
  double* CR0 = pvec();
  double* CR1 = pvec();   // the Schur-CG's residual (two buffers)
  double* PP0 = pvec();
  double* PP1 = pvec();   // its direction (two buffers)
  double* Z = pvec();
  double* HPC = pvec();
  // per-element terms of the pe-space sums, as TA..TD
  double* PA = pvec();    // u.u, p.hp, e2.e2
  double* PB = pvec();    // res.z
  double* PCt = pvec();   // res.res
  double* E2N = pvec();   // -e2 of kkt_solve's residual
  double* CDY = pvec();   // a refinement direction's dy
  double* part = wp;      // nblk rows of partial sums

  int* wbt = kd_wbands();
  int* sbt = kd_sbands();
  for (int k = tid; k <= nb; k += KD_THREADS) {
    wbt[k] = coop_band(k, nb, r);
    sbt[k] = coop_band(k, nb, pe);
  }
  __syncthreads();
  const int WR0 = wbt[b], WR1 = wbt[b + 1], SR0 = sbt[b], SR1 = sbt[b + 1];
  const int h0 = b * g.rpb < r ? b * g.rpb : r;
  const int h1 = h0 + g.rpb < r ? h0 + g.rpb : r;
  const int f0 = b * g.rpf < pe ? b * g.rpf : pe;
  const int f1 = f0 + g.rpf < pe ? f0 + g.rpf : pe;
  const int nbf = g.rpf ? (pe + g.rpf - 1) / g.rpf : 0;   // blocks with F rows

  // row i of W's (Ws's) band, packed (row i holds i + 1 entries), and of
  // the block's rows of H (F)
  auto wrow = [&](int i) -> const double* {
    if constexpr (SMEM)
      return wsm + (((long)i * (i + 1) - (long)WR0 * (WR0 + 1)) >> 1);
    else
      return a.W + (size_t)i * a.ldw;
  };
  auto srow = [&](int i) -> const double* {
    if constexpr (SMEM)
      return ssm + (((long)i * (i + 1) - (long)SR0 * (SR0 + 1)) >> 1);
    else
      return a.Ws + (size_t)i * a.ldws;
  };
  auto hrow = [&](int i) -> const double* {
    if constexpr (SMEM)
      return hsm + (size_t)(i - h0) * r;
    else
      return a.H + (size_t)i * r;
  };
  auto frow = [&](int i) -> const double* {
    if constexpr (SMEM)
      return fsm + (size_t)(i - f0) * r;
    else
      return a.F + (size_t)i * r;
  };

  // the residents, once for the launch
  if constexpr (SMEM) {
    for (int i = WR0 + warp; i < WR1; i += KD_WARPS) {
      double* d = wsm + (((long)i * (i + 1) - (long)WR0 * (WR0 + 1)) >> 1);
      const double* s = a.W + (size_t)i * a.ldw;
      for (int k = lane; k <= i; k += 32) d[k] = s[k];
    }
    for (int i = SR0 + warp; i < SR1; i += KD_WARPS) {
      double* d = ssm + (((long)i * (i + 1) - (long)SR0 * (SR0 + 1)) >> 1);
      const double* s = a.Ws + (size_t)i * a.ldws;
      for (int k = lane; k <= i; k += 32) d[k] = s[k];
    }
    for (size_t k = tid; k < (size_t)(h1 - h0) * r; k += KD_THREADS)
      hsm[k] = a.H[(size_t)h0 * r + k];
    for (size_t k = tid; k < (size_t)(f1 - f0) * r; k += KD_THREADS)
      fsm[k] = a.F[(size_t)f0 * r + k];
  }
  __syncthreads();

  // ---- building blocks (every thread of every block calls them) ----

  // sum_{j<n} f(j) in one fixed order: lanes stride j, butterfly, warps
  // in order; every block forms the same value
  auto bsum = [&](int n, auto f) -> double {
    double* red = kd_red();
    double s = 0.0;
    for (int j = tid; j < n; j += KD_THREADS) s += f(j);
    s = ip_warp_sum(s);
    if (lane == 0) red[warp] = s;
    __syncthreads();
    double v = 0.0;
    for (int w = 0; w < KD_WARPS; ++w) v += red[w];
    __syncthreads();
    return v;
  };
  auto terms = [&](int n, const double* t) {
    return bsum(n, [&](int j) { return ld(t + j); });
  };
  // the owners: element i of the r-space (pe-space) belongs to warp
  // (i - h0) % KD_WARPS of the block that holds row i of H (of F); f runs
  // in every lane of the owner, lane 0 writes
  auto own_r = [&](auto f) {
    for (int i = h0 + warp; i < h1; i += KD_WARPS) f(i);
  };
  auto own_p = [&](auto f) {
    for (int i = f0 + warp; i < f1; i += KD_WARPS) f(i);
  };
  // column j of the partials (rows of n) of the blocks bb < np with
  // use(bb), lanes striding the blocks in order, then a butterfly sum
  auto colsum = [&](int j, int n, int np, auto use) -> double {
    double s = 0.0;
#pragma unroll
    for (int k = 0; k < KD_MAX_BLK / 32; ++k) {
      const int bb = lane + 32 * k;
      if (bb < np && use(bb)) s += ld(part + (size_t)bb * n + j);
    }
    return ip_warp_sum(s);
  };
  auto wsum = [&](int j) {
    return colsum(j, r, nb, [&](int bb) { return wbt[bb + 1] > j; });
  };
  auto ssum = [&](int j) {
    return colsum(j, pe, nb, [&](int bb) { return sbt[bb + 1] > j; });
  };
  auto fsum = [&](int j) {
    return colsum(j, r, nbf, [](int) { return true; });
  };
  // xs[k] = f(k), k < n, in every block
  auto stage = [&](int n, auto f) {
    __syncthreads();
    for (int k = tid; k < n; k += KD_THREADS) xs[k] = f(k);
    __syncthreads();
  };
  // the band's share of T^T (T v), T = W (Ws): u = T v on the band's rows
  // (v staged in xs), then the band's partial of T^T u into part's row b
  auto band_pass = [&](auto row, int R0, int R1, int n) {
    for (int i = R0 + warp; i < R1; i += KD_WARPS) {
      const double d = kd_dot(row(i), xs, i + 1, lane);
      if (lane == 0) us[i - R0] = d;
    }
    __syncthreads();
    double* own = part + (size_t)b * n;
    for (int j = tid; j < R1; j += KD_THREADS) {
      double c0 = 0.0, c1 = 0.0, c2 = 0.0, c3 = 0.0;
      int i = j > R0 ? j : R0;
      for (; i + 3 < R1; i += 4) {
        c0 = fma(row(i)[j], us[i - R0], c0);
        c1 = fma(row(i + 1)[j], us[i + 1 - R0], c1);
        c2 = fma(row(i + 2)[j], us[i + 2 - R0], c2);
        c3 = fma(row(i + 3)[j], us[i + 3 - R0], c3);
      }
      for (; i < R1; ++i) c0 = fma(row(i)[j], us[i - R0], c0);
      own[j] = (c0 + c1) + (c2 + c3);
    }
  };
  auto wpass = [&]() { band_pass(wrow, WR0, WR1, r); };
  auto spass = [&]() { band_pass(srow, SR0, SR1, pe); };
  // the block's partial of F^T u over its rows of F (u staged in xs)
  auto ftpass = [&]() {
    if (f0 >= f1) return;
    double* own = part + (size_t)b * r;
    for (int j = tid; j < r; j += KD_THREADS) {
      double c = 0.0;
      for (int i = f0; i < f1; ++i) c = fma(frow(i)[j], xs[i], c);
      own[j] = c;
    }
  };

  int cnt[KD_COUNTS] = {0, 0, 0, 0, 0, 0, 0};

  // ---- the refined H-solve of H x = bv into xo (ops/refine.py
  // refined_solve with exit_rel2 = exit2; its pcg); returns its
  // ||D res||^2 and ||D b||^2.  bv is visible to every block; xo is
  // written by its owners and visible to every block on return ----
  auto hsolve = [&](const double* bv, double* xo, double* rn2o,
                    double* bn2o) {
    const double bn2 = bsum(r, [&](int j) {
      const double t = __dmul_rn(ld(bv + j), D[j]);
      return __dmul_rn(t, t);
    });
    double s0 = bn2;
    int rounds = 0;
    bool exited = false;
    for (int it = 0; it < a.refine; ++it) {
      if (!(s0 > a.exit2 * bn2)) {
        exited = true;
        break;
      }
      const double* src = rounds ? RES : bv;
      stage(r, [&](int k) { return __dmul_rn(ld(src + k), D[k]); });
      wpass();
      grid.sync();
      // x += D W^T W D res
      own_r([&](int j) {
        const double t = wsum(j);
        if (lane == 0)
          xo[j] = __dadd_rn(rounds ? ld(xo + j) : 0.0, __dmul_rn(D[j], t));
      });
      grid.sync();
      // res = b - H x and the terms of ||D res||^2
      stage(r, [&](int k) { return ld(xo + k); });
      own_r([&](int i) {
        const double hx = kd_dot(hrow(i), xs, r, lane);
        if (lane == 0) {
          const double e = __dsub_rn(ld(bv + i), hx);
          RES[i] = e;
          const double t = __dmul_rn(e, D[i]);
          TA[i] = __dmul_rn(t, t);
        }
      });
      grid.sync();
      s0 = terms(r, TA);
      ++rounds;
    }
    // a residual at or below the exit is below the stall gate too when
    // exit2 <= stall2
    const bool stalled =
        !(exited && a.exit2 <= a.stall2) && s0 > a.stall2 * bn2;
    bool kept = false;
    int pcg = 0;
    double s2 = 0.0;
    if (stalled) {
      const double* r0 = rounds ? RES : bv;
      double* re = RE0;
      double* rn = RE1;
      double* pc = PC0;
      double* pn = PC1;
      // re = D r0, cx = 0; zz = p = W^T W re
      own_r([&](int j) {
        if (lane == 0) {
          const double e = __dmul_rn(ld(r0 + j), D[j]);
          re[j] = e;
          CX[j] = 0.0;
          TB[j] = __dmul_rn(e, e);
        }
      });
      stage(r, [&](int k) { return __dmul_rn(ld(r0 + k), D[k]); });
      wpass();
      grid.sync();
      own_r([&](int j) {
        const double t = wsum(j);
        if (lane == 0) {
          pc[j] = t;
          TZ[j] = __dmul_rn(ld(re + j), t);
        }
      });
      grid.sync();
      double rz = terms(r, TZ);
      double rn2c = terms(r, TB);
      const double thr = fmax(a.exit2, 1e-26) * bn2;
      for (int it = 0; it < KD_PCG_MAX; ++it) {
        if (!(rn2c > thr && isfinite(rn2c) && isfinite(rz))) break;
        // hp = D H D p and the terms of p . hp
        stage(r, [&](int k) { return __dmul_rn(D[k], ld(pc + k)); });
        own_r([&](int i) {
          const double hx = kd_dot(hrow(i), xs, r, lane);
          if (lane == 0) {
            const double h = __dmul_rn(D[i], hx);
            HPV[i] = h;
            TD[i] = __dmul_rn(ld(pc + i), h);
          }
        });
        grid.sync();
        const double den = terms(r, TD);
        const double al = rz / (fabs(den) > 1e-30 ? den : 1e-30);
        // cx += al p, re' = re - al hp; zz = W^T W re'
        own_r([&](int j) {
          if (lane == 0) {
            const double e = __dsub_rn(ld(re + j), __dmul_rn(al, ld(HPV + j)));
            rn[j] = e;
            CX[j] = __dadd_rn(ld(CX + j), __dmul_rn(al, ld(pc + j)));
            TB[j] = __dmul_rn(e, e);
          }
        });
        stage(r, [&](int k) {
          return __dsub_rn(ld(re + k), __dmul_rn(al, ld(HPV + k)));
        });
        wpass();
        grid.sync();
        own_r([&](int j) {
          const double t = wsum(j);
          if (lane == 0) {
            ZZ[j] = t;
            TZ[j] = __dmul_rn(ld(rn + j), t);
          }
        });
        grid.sync();
        const double rz2 = terms(r, TZ);
        rn2c = terms(r, TB);
        const double be = rz2 / (fabs(rz) > 1e-30 ? rz : 1e-30);
        own_r([&](int j) {
          if (lane == 0)
            pn[j] = __dadd_rn(ld(ZZ + j), __dmul_rn(be, ld(pc + j)));
        });
        grid.sync();
        rz = rz2;
        ++pcg;
        double* t = re;
        re = rn;
        rn = t;
        t = pc;
        pc = pn;
        pn = t;
      }
      // x2 = x + D cx and its residual
      own_r([&](int j) {
        if (lane == 0)
          XS2[j] = __dadd_rn(rounds ? ld(xo + j) : 0.0,
                             __dmul_rn(D[j], ld(CX + j)));
      });
      stage(r, [&](int k) {
        return __dadd_rn(rounds ? ld(xo + k) : 0.0,
                         __dmul_rn(D[k], ld(CX + k)));
      });
      own_r([&](int i) {
        const double hx = kd_dot(hrow(i), xs, r, lane);
        if (lane == 0) {
          const double t = __dmul_rn(__dsub_rn(ld(bv + i), hx), D[i]);
          TA[i] = __dmul_rn(t, t);
        }
      });
      grid.sync();
      s2 = terms(r, TA);
      kept = s2 < s0;
      if (kept)
        own_r([&](int j) {
          if (lane == 0) xo[j] = ld(XS2 + j);
        });
    }
    // x = 0 was never formed
    if (!kept && rounds == 0)
      own_r([&](int j) {
        if (lane == 0) xo[j] = 0.0;
      });
    // xo visible to every block, and the terms' last sums done before a
    // caller writes TA again; where xo was last written in a refinement
    // round (two barriers ago) and the caller's next writes follow a
    // barrier (pe > 0), none is needed
    if (kept || rounds == 0 || pe == 0) grid.sync();
    *rn2o = kept ? s2 : s0;
    *bn2o = bn2;
    cnt[2] += 1;
    cnt[3] += rounds;
    cnt[4] += stalled ? 1 : 0;
    cnt[5] += pcg;
    cnt[6] += kept ? 1 : 0;
  };

  // ---- one direction (ops/kkt_step.py _kkt_dir) on (q1, qp) into
  // (odx, ody); for pe = 0 returns the H-solve's (rn2, bn2).  Its
  // H-solves are one call site in a loop over the jobs that need them
  // (t1, a Schur-CG round's operator, the back-substitution), and the
  // direction one call site in the loop of kkt_solve's directions: the
  // compiler inlines both, so the kernel's variables stay in registers
  // (an outlined lambda reads them through generic loads from the
  // stack) ----
  auto direction = [&](const double* q1, const double* qp, double* odx,
                       double* ody, double* rn2o, double* bn2o) {
    cnt[0] += 1;
    double* cr = CR0;
    double* cn = CR1;
    double* pp = PP0;
    double* pn = PP1;
    double un2 = 0.0, rz = 0.0, be = 0.0;
    int it = 0;
    // 0: t1 = H^-1 q1 (pe = 0: the direction itself); 1: a Schur-CG
    // round's H^-1 F^T Ds p; 2: the back-substitution
    int job = 0;
    for (;;) {
      const double* bv = q1;
      double* xo = pe ? X : odx;
      if (job == 1) {
        bool go = it < a.rounds;
        if (go) {
          const double rn2c = terms(pe, PCt);
          go = rn2c > a.cg2 * un2 && isfinite(rn2c) && isfinite(rz);
        }
        if (go) {
          // p: the owners wrote it into pn last round; every block forms
          // it from z and the previous p (the same operations, the same
          // bits)
          if (it) {
            double* t = pp;
            pp = pn;
            pn = t;
          }
          // F^T Ds p
          stage(pe, [&](int k) {
            const double p =
                it ? __dadd_rn(ld(Z + k), __dmul_rn(be, ld(pn + k)))
                   : ld(pp + k);
            return __dmul_rn(Ds[k], p);
          });
          ftpass();
          grid.sync();
          own_r([&](int j) {
            const double t = fsum(j);
            if (lane == 0) BV[j] = t;
          });
          grid.sync();
          bv = BV;
        } else {
          cnt[1] += it;
          job = 2;
          // dy = Ds y; dx = H^-1 (q1 - F^T dy)
          own_p([&](int j) {
            if (lane == 0) ody[j] = __dmul_rn(Ds[j], ld(Y + j));
          });
          grid.sync();
          stage(pe, [&](int k) { return ld(ody + k); });
          ftpass();
          grid.sync();
          own_r([&](int j) {
            const double t = fsum(j);
            if (lane == 0) BV[j] = __dsub_rn(ld(q1 + j), t);
          });
          grid.sync();
          bv = BV;
          xo = odx;
        }
      }
      double sr, sb;
      hsolve(bv, xo, &sr, &sb);
      if (pe == 0 || job == 2) {
        *rn2o = sr;
        *bn2o = sb;
        return;
      }
      if (job == 0) {
        // u = Ds (F t1 + qp); res = u, p = Ws^T Ws u, rz = u . p
        stage(r, [&](int k) { return ld(X + k); });
        own_p([&](int i) {
          const double fx = kd_dot(frow(i), xs, r, lane);
          if (lane == 0) {
            const double u = __dmul_rn(Ds[i], __dadd_rn(fx, ld(qp + i)));
            UE[i] = u;
            PA[i] = __dmul_rn(u, u);
            Y[i] = 0.0;
          }
        });
        grid.sync();
        un2 = terms(pe, PA) + 1e-30;
        stage(pe, [&](int k) { return ld(UE + k); });
        spass();
        grid.sync();
        own_p([&](int j) {
          const double t = ssum(j);
          if (lane == 0) {
            const double u = ld(UE + j);
            pp[j] = t;
            cr[j] = u;
            PB[j] = __dmul_rn(u, t);
            PCt[j] = __dmul_rn(u, u);
          }
        });
        grid.sync();
        rz = terms(pe, PB);
        job = 1;
        continue;
      }
      // the round: hp = Ds F (H^-1 F^T Ds p), al = rz / p.hp
      stage(r, [&](int k) { return ld(X + k); });
      own_p([&](int i) {
        const double fx = kd_dot(frow(i), xs, r, lane);
        if (lane == 0) {
          const double h = __dmul_rn(Ds[i], fx);
          HPC[i] = h;
          PA[i] = __dmul_rn(ld(pp + i), h);
        }
      });
      grid.sync();
      const double den = terms(pe, PA);
      const double al = rz / (fabs(den) > 1e-30 ? den : 1e-30);
      // y += al p, res' = res - al hp; z = Ws^T Ws res'
      own_p([&](int j) {
        if (lane == 0) {
          Y[j] = __dadd_rn(ld(Y + j), __dmul_rn(al, ld(pp + j)));
          const double e = __dsub_rn(ld(cr + j), __dmul_rn(al, ld(HPC + j)));
          cn[j] = e;
          PCt[j] = __dmul_rn(e, e);
        }
      });
      stage(pe, [&](int k) {
        return __dsub_rn(ld(cr + k), __dmul_rn(al, ld(HPC + k)));
      });
      spass();
      grid.sync();
      own_p([&](int j) {
        const double t = ssum(j);
        if (lane == 0) {
          Z[j] = t;
          PB[j] = __dmul_rn(ld(cn + j), t);
        }
      });
      grid.sync();
      const double rz2 = terms(pe, PB);
      be = rz2 / (fabs(rz) > 1e-30 ? rz : 1e-30);
      own_p([&](int j) {
        if (lane == 0) pn[j] = __dadd_rn(ld(Z + j), __dmul_rn(be, ld(pp + j)));
      });
      rz = rz2;
      ++it;
      double* t = cr;
      cr = cn;
      cn = t;
    }
  };

  // ---- the KKT residual of (vx, vy) against (q1, qp): e1 = q1 - H vx
  // - F^T vy into E1, -e2 = -(-qp - F vx) into E2N; returns
  // rn2 = e1.e1 + e2.e2 ----
  auto residual = [&](const double* q1, const double* qp, const double* vx,
                      const double* vy) -> double {
    if (pe) {
      stage(pe, [&](int k) { return ld(vy + k); });
      ftpass();
      grid.sync();
    }
    stage(r, [&](int k) { return ld(vx + k); });
    own_r([&](int i) {
      const double hx = kd_dot(hrow(i), xs, r, lane);
      const double ft = pe ? fsum(i) : 0.0;
      if (lane == 0) {
        double e = __dsub_rn(ld(q1 + i), hx);
        if (pe) e = __dsub_rn(e, ft);
        E1[i] = e;
        TA[i] = __dmul_rn(e, e);
      }
    });
    own_p([&](int i) {
      const double fx = kd_dot(frow(i), xs, r, lane);
      if (lane == 0) {
        const double e = __dsub_rn(-ld(qp + i), fx);
        E2N[i] = -e;
        PA[i] = __dmul_rn(e, e);
      }
    });
    grid.sync();
    const double e1 = terms(r, TA);
    return pe ? e1 + terms(pe, PA) : e1;
  };

  // ---- kkt_solve (solve = 1) or one direction (solve = 0) ----
  const double* q1 = a.r1;
  if (a.solve && pe) {
    // r1 - rho F^T rpe
    stage(pe, [&](int k) { return ld(a.rpe + k); });
    ftpass();
    grid.sync();
    const double rho = ld(a.rho);
    own_r([&](int j) {
      const double t = fsum(j);
      if (lane == 0) R1S[j] = __dsub_rn(ld(a.r1 + j), __dmul_rn(rho, t));
    });
    grid.sync();
    q1 = R1S;
  }
  // the directions: the first on (q1, rpe) into (dx, dy); in kkt_solve
  // up to kkt_refine more on the residual (E1, E2N) while it stalls,
  // accumulated
  double rn2 = 0.0, bn2 = 0.0;
  for (int k = 0;; ++k) {
    double dr, db;
    direction(k ? E1 : q1, k ? E2N : a.rpe, k ? CDX : a.dx, k ? CDY : a.dy,
              &dr, &db);
    if (k) {
      own_r([&](int j) {
        if (lane == 0) a.dx[j] = __dadd_rn(ld(a.dx + j), ld(CDX + j));
      });
      own_p([&](int j) {
        if (lane == 0) a.dy[j] = __dadd_rn(ld(a.dy + j), ld(CDY + j));
      });
      grid.sync();
    } else {
      rn2 = dr;
      bn2 = db;
    }
    if (!a.solve && !pe) break;
    rn2 = residual(q1, a.rpe, a.dx, a.dy);
    if (!k) {
      const double b1 = bsum(r, [&](int j) {
        const double v = ld(q1 + j);
        return __dmul_rn(v, v);
      });
      const double b2 = pe ? bsum(pe, [&](int j) {
        const double v = ld(a.rpe + j);
        return __dmul_rn(v, v);
      }) : 0.0;
      bn2 = (b1 + b2) + 1e-30;
    }
    if (!a.solve || k >= a.kkt_refine || !(rn2 > a.kkt2 * bn2)) break;
  }
  if (b == 0 && tid == 0) {
    *a.rn2 = rn2;
    *a.bn2 = bn2;
    for (int k = 0; k < KD_COUNTS; ++k) {
      if (a.counts) a.counts[k] = cnt[k];
      if (a.tally) atomicAdd(a.tally + k, cnt[k]);
    }
  }
}

}  // namespace

// Workspace bytes of ip_kkt_direction at (r, pe).
IP_API size_t ip_kkt_direction_ws_bytes(int r, int pe) {
  return kd_ws_doubles(kd_geom_of(r, pe), r, pe) * sizeof(double);
}

// One dense-KKT direction (solve = 0: ops/kkt_step.py kkt_dir_prepared,
// rn2 and bn2 its own: for pe = 0 the H-solve's, in the equilibrated
// metric) or one kkt_solve (solve = 1: the shift r1 - rho F^T rpe, the
// direction, then up to kkt_refine more directions on the fp64 residual
// while rn2 > kkt2 bn2; rn2 and bn2 unscaled), on the fp64 factors (H,
// r x r; W, row stride ldw, and dsc; for pe > 0 F, pe x r, Ws, row stride
// ldws, and ds).  Writes dx (r), dy (pe), rn2, bn2; counts (7 ints, or
// null): directions, Schur-CG rounds, H-solves, refinement rounds,
// stalled H-solves, PCG rounds, PCG results kept; tally (7 ints, or null)
// adds them.  One cooperative launch of one block per SM; an error when
// the grid cannot be resident.
IP_API int ip_kkt_direction(const double* H, const double* W, int ldw,
                            const double* dsc, const double* F,
                            const double* Ws, int ldws, const double* ds,
                            const double* r1, const double* rpe,
                            const double* rho, double* dx, double* dy,
                            double* rn2, double* bn2, int* counts, int* tally,
                            double* ws, int r, int pe, int refine, int rounds,
                            int solve, int kkt_refine, double stall2,
                            double exit2, double cg2, double kkt2,
                            cudaStream_t stream) {
  if (r <= 0 || pe < 0 || ldw < r || refine < 0 || rounds < 0 ||
      kkt_refine < 0 || !H || !W || !dsc || !r1 || !dx || !rn2 || !bn2 ||
      !ws || (pe && (!F || !Ws || !ds || !rpe || !dy || ldws < pe ||
                     (solve && !rho))))
    return (int)cudaErrorInvalidValue;
  KdArgs a{H,  W,   dsc,    F,     Ws,    ds,   r1,   rpe,    rho,
           dx, dy,  rn2,    bn2,   counts, tally, ws,  stall2, exit2,
           cg2, kkt2, r,    pe,    ldw,   ldws, refine, rounds, solve,
           kkt_refine, kd_geom_of(r, pe)};
  return coop_launch(a.g.res ? (const void*)kkt_direction_kernel<true>
                             : (const void*)kkt_direction_kernel<false>,
                     a.g.nblk, KD_THREADS, a.g.smem, KD_STATIC, &a, stream,
                     true);
}
