// The blocked two-triangle solve for wide right-hand sides (p > 1): the
// forward sweep y_i = F_i (b_i - sum_{j<i} L_ij y_j), u_i = M_i^T y_i, the
// backward sweep x_i = G_i^T (u_i - sum_{j>i} L_ji^T x_j), over TE-row
// block rows of the leading n x n of a row-major L read in place (row
// stride ldl, only its strictly lower tiles; rows and columns past n read
// as the identity's).  F, M, G are (np, TE) stacks of TE x TE tiles (NULL
// is the identity).  K3b: TE = 64, F = G = Dinv; the LDL solve: TE = 128,
// M = the tile inverses.  chol.cu's block_solve_kernel keeps p = 1.
//
// Replaces, for p > 1,
//   interiorpoint_tpu/ops/pallas_chol.py:_solve_kernel (K3b; on the TPU
//     each block operation is one MXU product over the whole width p), and
//   interiorpoint_tpu/ops/pallas_newton.py:_ldl_solve (K2's LDL solve; the
//     carry reseed M^-1 I at p = np).
//
// Bound: operations.  2 n^2 p fp32 FMA-flops (the two triangles) plus
// 2 n TE p per diagonal stack, against ~n^2/2 + 2 n p floats moved: at
// (n, p) = (1001, 1001) 2.0 GFLOP, 0.030 ms at 67 TFLOP/s.  What held
// chol.cu's chunked kernel (8 columns a task, tasks handing tiles on
// through flags in global memory) at ~1 ms there: each L value read from
// L2 fed 8 FMAs, every tile step waited on a flag and reloaded X through
// L2, and later block rows queued behind tasks that spin.  Design:
//  * independent column chunks: one thread-block cluster of CS blocks
//    owns W columns through both sweeps (grid = chunks x CS, no flags and
//    no order between clusters, so no cooperative launch).  Its n x W
//    slice of Y, then U and X, stays in shared memory (in place, each
//    block holding the block rows it owns); X is written once;
//  * the blocks of a cluster split each block row's sum by block column:
//    block r owns block rows j = r (mod CS) and adds L_ij y_j over its
//    own j only; the partials meet in the owner of row i through
//    distributed shared memory (one remote store per partial, one
//    cluster barrier per block row, the landing buffer alternating
//    between barriers), and the owner alone applies the diagonal tile;
//  * look-ahead (Walk): between the barrier's arrive and its wait each
//    block already sums the tiles of the next block row that need nothing
//    of this one (and, backward, forms u = M^T y of the next row), so
//    the chain from one block row to the next is the owner's diagonal
//    tile and one tile of L: L_{i+1,i} y_i forward, L_{i,i-1}^T x_i
//    backward;
//  * L, F, M and G reach shared memory as KC-deep sub-tiles by TMA (one
//    thread starts a sub-tile's one or two box copies; reads past n land
//    as zeros) through a ring of WS_STAGES slots, each with an mbarrier
//    that counts its bytes, started WS_STAGES - 1 sub-tiles ahead of use
//    across block rows and sweeps (the sequence of sub-tiles a block
//    reads is fixed by (n, TE, CS, its rank): Walk), so each L value
//    fetched from L2 serves W columns; the backward sweep reads the same
//    row-major tiles as A^T.  (Copies by every thread, cp.async, took
//    longer to issue than the microkernel's FMAs: they queue behind its
//    shared-memory loads.);
//  * a register-tiled FFMA microkernel in true fp32 (never TF32, not
//    even 3xTF32: this solve is the fp32 stage of an fp64 refinement and
//    its error sets the rounds, interiorpoint_tpu/ops/pallas_chol.py:_dot):
//    a thread holds an 8 x 4 (W >= 16) or 4 x 4 block of the TE x W
//    result (Lanes), the sub-tile's k split over the thread groups and
//    summed in a fixed order, so results are deterministic.
#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"
#include "tma.cuh"   // tensor maps (the encoder fetched at run time) and
                     // the 2-d box copy

namespace cg = cooperative_groups;

namespace {

constexpr int WS_THREADS = 256;
constexpr int WS_STAGES = 3;
constexpr int WS_RED = 8192;             // floats of the split-k scratch
constexpr int WS_MAX_SMEM = 232448;      // a block's shared memory, bytes
constexpr int WS_ALIGN = 1024;           // a 128-byte swizzle's alignment

// A sub-tile is TE x KC of a tile: in row layout (forward: L_ij and F
// read as they are) KC / 32 boxes of TE rows x 32 floats, each row 128
// bytes with its 16-byte chunks swizzled (chunk c of row r at c ^ (r % 8),
// TMA's 128-byte swizzle), so that eight rows at one k sit in eight bank
// groups; in column layout (backward: L_ji, M and G read as A^T) KC rows
// of TE floats, dense.  Both are TE * KC floats.
template <int TE>
struct Geo {
  static constexpr int KC = TE == 64 ? 64 : 32;   // depth of a sub-tile
  static constexpr int SUBS = TE / KC;            // sub-tiles of a tile
  static constexpr int SLOT = TE * KC;
};

// Tensor maps (TMA) of L, of F and of M and G: a row-layout box of TE rows
// x 32 floats, a column-layout box of KC rows x TE floats.  Each map is
// 64-byte aligned.
struct WsArgs {
  CUtensorMap l_row, l_col, f_row, m_col, g_col;
  const float* F;
  const float* M;
  const float* G;
  const float* B;
  float* X;
  const int* run;   // null, or a device flag: nothing runs unless set
  int n, p, cs;
};

// What a block of the cluster is: its rank, the cluster size (a power of
// two) and its log2, the block rows.
struct Ctx {
  int rank, cs, lg, nb;
};

// The steps of a solve: step s < nb is forward block row s, step s >= nb
// backward block row 2 nb - 1 - s.  At step s a block reads, in this
// order, the sub-tiles of
//   phase 0, early: M_i' (i' the row of step s + 1, backward, its owner);
//   phase 1, early: its tiles of row i' that need no result of step s,
//     L_i'j for its own j < i' - 1 (forward), L_ji' for its own j > i' + 1
//     (backward);
//   phase 2: the diagonal tile of row i, F_i or G_i (row i's owner);
//   phase 3, late (row i's owner): the tile that needs row i's result,
//     L_i'i (forward) or L_ii' (backward); at the last forward step, M of
//     the same row instead.
// Each tile is SUBS sub-tiles of KC.  s == 2 nb: done.
template <int TE>
struct Walk {
  int s, ph, j, kc;

  __device__ __forceinline__ static int row(const Ctx& c, int t) {
    return t < c.nb ? t : 2 * c.nb - 1 - t;
  }
  __device__ __forceinline__ static bool own(const Ctx& c, int r) {
    return (r & (c.cs - 1)) == c.rank;
  }
  // a tile of L (else a diagonal tile of F, M or G)
  __device__ __forceinline__ bool is_l(const Ctx& c) const {
    return ph == 1 || (ph == 3 && s + 1 != c.nb);
  }
  // read as A^T (column layout): the backward sweep's tiles and M
  __device__ __forceinline__ bool col(const Ctx& c) const {
    return ph == 2 ? s >= c.nb : (ph == 0 || s + 1 >= c.nb);
  }
  __device__ __forceinline__ const float* diag(const WsArgs& a,
                                               const Ctx& c) const {
    return ph == 2 ? (s < c.nb ? a.F : a.G) : a.M;
  }
  // the row of the diagonal tile (phases 0, 2, 3 at the last forward step)
  __device__ __forceinline__ int diag_row(const Ctx& c) const {
    return row(c, ph == 2 ? s : s + 1);
  }
  // does phase ph of step s read anything (sets j for an L phase)
  __device__ __forceinline__ bool has(const WsArgs& a, const Ctx& c) {
    const int i = row(c, s);
    const bool last = s + 1 == 2 * c.nb, turn = s + 1 == c.nb;
    switch (ph) {
      case 0:
        return !last && s >= c.nb && a.M != nullptr && own(c, i - 1);
      case 1:
        if (last || turn) return false;
        if (s < c.nb) {
          j = c.rank;
          return j < i;
        }
        j = i + 1 + ((c.rank - i - 1) & (c.cs - 1));
        return j < c.nb;
      case 2:
        return diag(a, c) != nullptr && own(c, i);
      default:
        if (last || !own(c, i)) return false;
        j = i;
        return !turn || a.M != nullptr;
    }
  }
  // the first sub-tile at or after phase ph0 of step s
  __device__ __forceinline__ void enter(const WsArgs& a, const Ctx& c,
                                        int ph0) {
    for (ph = ph0;; ++ph) {
      kc = 0;
      if (ph == 4) {
        if (++s == 2 * c.nb) return;
        ph = -1;
        continue;
      }
      if (has(a, c)) return;
    }
  }
  __device__ __forceinline__ void start(const WsArgs& a, const Ctx& c) {
    s = 0;
    enter(a, c, 0);
  }
  __device__ __forceinline__ void next(const WsArgs& a, const Ctx& c) {
    if (++kc < Geo<TE>::SUBS) return;
    kc = 0;
    if (ph == 1) {
      j += c.cs;
      if (s < c.nb ? j < row(c, s) : j < c.nb) return;
    }
    enter(a, c, ph + 1);
  }
  __device__ __forceinline__ bool done(const Ctx& c) const {
    return s == 2 * c.nb;
  }
  __device__ __forceinline__ bool at(int t, int q) const {
    return s == t && ph == q;
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(u64* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
// The producer's arrival: the phase completes once `bytes` have landed.
__device__ __forceinline__ void mbar_expect(u64* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// Wait for the phase of the given parity to complete; a wait longer than
// 2 s traps (the launch fails) rather than hanging.
__device__ __forceinline__ void mbar_wait(u64* bar, unsigned parity) {
  unsigned done = 0;
  u64 t0 = 0;
  for (int spin = 0;; ++spin) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == 64) t0 = globaltimer();
    if (spin > 64 && globaltimer() - t0 > 2000000000ull) __trap();
  }
}
// Start the sub-tile at w's position into S (one thread): row layout, the
// KC / 32 boxes of TE rows from column c0 of row r0; column layout, one
// box of KC rows from row r0.  Forward tiles of L are L_i'j, backward ones
// L_ji'.  Entries past n (L's map is n x n) land as zeros.
template <int TE>
__device__ __forceinline__ void issue(const WsArgs& a, const Ctx& c,
                                      const Walk<TE>& w, float* S,
                                      u64* bar) {
  using Gm = Geo<TE>;
  const bool col = w.col(c);
  const CUtensorMap* map;
  int r0, c0;
  if (w.is_l(c)) {
    const int ip = Walk<TE>::row(c, w.s + 1);
    map = col ? &a.l_col : &a.l_row;
    r0 = col ? w.j * TE + w.kc * Gm::KC : ip * TE;
    c0 = col ? ip * TE : w.j * TE + w.kc * Gm::KC;
  } else {
    map = w.ph != 2 ? &a.m_col : (w.s < c.nb ? &a.f_row : &a.g_col);
    r0 = w.diag_row(c) * TE + (col ? w.kc * Gm::KC : 0);
    c0 = col ? 0 : w.kc * Gm::KC;
  }
  mbar_expect(bar, Gm::SLOT * 4);
  if (col) {
    ip_tma_2d(S, map, c0, r0, bar);
  } else {
#pragma unroll
    for (int h = 0; h < Gm::KC / 32; ++h)
      ip_tma_2d(S + h * TE * 32, map, c0 + 32 * h, r0, bar);
  }
}

// A thread's place in the microkernel: an R x 4 block of the TE x W
// result (R = 8 rows at W >= 16, else 4; columns 4 cg4 + c), for the g-th
// slice of KG of each sub-tile's k.  Forward its rows are a(r) = rg + RG r
// (RG = TE / R); backward, 4 rg + (TE / 2)(r / 4) + r % 4, so that each
// 16-byte load along a row of A^T covers four of them.  A warp's lanes
// take 4 (W >= 16) or 2 column blocks and 8 or 16 consecutive row groups:
// each of its 16-byte loads is one or two wavefronts.  An 8 x 4 block
// needs 12 such loads a 128 FMAs where a 4 x 4 one needs 8 a 64; the
// shared-memory loads, more than the FMAs, set the microkernel's pace.
// The offsets of a thread's loads are formed once.
template <int TE, int W>
struct Lanes {
  static constexpr int R = W >= 16 ? 8 : 4;
  static constexpr int RG = TE / R;
  static constexpr int SK = WS_THREADS * R * 4 / (TE * W);
  static constexpr int KG = Geo<TE>::KC / SK;
  static_assert(KG % 4 == 0, "a thread group takes whole 4-deep steps");
  int rg, cg4, g;
  int arow[KG / 4];   // row layout: box and swizzled chunk of rows a(r)
  int acol, bofs;     // column layout and Bs: the slice's first k

  __device__ __forceinline__ void init(int tid) {
    constexpr int CGN = W / 4, CGW = CGN < 4 ? CGN : 4;
    constexpr int RGW = 32 / CGW, tiles = RG * CGN;
    const int t = tid % tiles, lane = t % 32, wg = t / 32;
    g = tid / tiles;
    rg = lane / CGW + RGW * (wg % (RG / RGW));
    cg4 = lane % CGW + CGW * (wg / (RG / RGW));
#pragma unroll
    for (int s = 0; s < KG / 4; ++s) {
      const int k0 = g * KG + 4 * s;   // (a(r) & 7) == (rg & 7)
      arow[s] = (k0 >> 5) * TE * 32 + rg * 32 +
                ((((k0 & 31) >> 2) ^ (rg & 7)) << 2);
    }
    acol = g * KG * TE + 4 * rg;
    bofs = g * KG * W + 4 * cg4;
  }
  // the result row of register row r
  __device__ __forceinline__ int row(bool col, int r) const {
    return col ? 4 * rg + (TE / 2) * (r / 4) + r % 4 : rg + RG * r;
  }
};

// acc[r][c] += sum over the thread's slice of k of A[a(r)][k] Bs[k][4 cg4
// + c] for one staged sub-tile As (Geo): forward (COL false) A = As,
// backward A = As^T.  Bs: KC rows of W.
// (acc: R of its 8 rows used)
template <int TE, int W, bool COL>
__device__ __forceinline__ void mma_sub(const float* As, const float* Bs,
                                        float (&acc)[8][4],
                                        const Lanes<TE, W>& ln) {
  using Ln = Lanes<TE, W>;
  constexpr int R = Ln::R;
#pragma unroll
  for (int s = 0; s < Ln::KG / 4; ++s) {
    float av[R][4], bv[4][4];
    if (COL) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < R / 4; ++h) {
          const float4 t = *reinterpret_cast<const float4*>(
              As + ln.acol + (4 * s + kk) * TE + (TE / 2) * h);
          av[4 * h][kk] = t.x;
          av[4 * h + 1][kk] = t.y;
          av[4 * h + 2][kk] = t.z;
          av[4 * h + 3][kk] = t.w;
        }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 t = *reinterpret_cast<const float4*>(
            As + ln.arow[s] + Ln::RG * 32 * r);
        av[r][0] = t.x;
        av[r][1] = t.y;
        av[r][2] = t.z;
        av[r][3] = t.w;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 t = *reinterpret_cast<const float4*>(
          Bs + ln.bofs + (4 * s + kk) * W);
      bv[kk][0] = t.x;
      bv[kk][1] = t.y;
      bv[kk][2] = t.z;
      bv[kk][3] = t.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[r][c] = fmaf(av[r][kk], bv[kk][c], acc[r][c]);
  }
}

// The thread groups' partial results summed in group order: part[m] is
// output o = threadIdx.x + WS_THREADS m of the TE x W result (row o / W).
template <int TE, int W, bool COL>
__device__ __forceinline__ void reduce(float* red, const float (&acc)[8][4],
                                       float* part, const Lanes<TE, W>& ln) {
  using Ln = Lanes<TE, W>;
  constexpr int OPT = TE * W / WS_THREADS;
#pragma unroll
  for (int r = 0; r < Ln::R; ++r)
    *reinterpret_cast<float4*>(
        red + (ln.g * TE + ln.row(COL, r)) * W + 4 * ln.cg4) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
#pragma unroll
  for (int m = 0; m < OPT; ++m) {
    const int o = threadIdx.x + WS_THREADS * m;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < Ln::SK; ++q) s += red[q * TE * W + o];
    part[m] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int TE, int W>
__global__ void __launch_bounds__(WS_THREADS, 1)
    wide_solve_kernel(const __grid_constant__ WsArgs a) {
  using Gm = Geo<TE>;
  using Wk = Walk<TE>;
  constexpr int TW = TE * W;
  constexpr int OPT = TW / WS_THREADS;
  extern __shared__ __align__(16) float sm[];
  // every block, before any barrier: X is then left as it was
  if (a.run && *a.run == 0) return;
  cg::cluster_group cl = cg::this_cluster();
  const Ctx c = {(int)cl.block_rank(), a.cs, a.cs == 4 ? 2 : a.cs - 1,
                 (a.n + TE - 1) / TE};
  const int c0 = (blockIdx.x / a.cs) * W;   // this cluster's columns
  float* ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(sm) + WS_ALIGN - 1) &
      ~(uintptr_t)(WS_ALIGN - 1));
  float* red = ring + WS_STAGES * Gm::SLOT;
  float* vbuf = red + WS_RED;
  float* xbuf = vbuf + TW;                  // 2 x (cs - 1) partials
  float* Ys = xbuf + 2 * (c.cs - 1) * TW;   // the block rows it owns
  u64* full = reinterpret_cast<u64*>(Ys + ((c.nb + c.cs - 1) >> c.lg) * TW);
  const int tid = threadIdx.x;
  Lanes<TE, W> ln;
  ln.init(tid);
  auto slot = [&](int r) { return Ys + (r >> c.lg) * TW; };

  if (tid == 0) {
    for (int q = 0; q < WS_STAGES; ++q) mbar_init(full + q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // every block of the cluster has started before any remote store
  if (c.cs > 1) cl.sync();

  // thread 0 walks ahead and starts each sub-tile's copy (the producer);
  // every thread walks the sub-tiles it consumes
  Wk pw, cw;
  pw.start(a, c);
  cw.start(a, c);
  auto produce = [&](int q) {
    if (tid == 0 && !pw.done(c)) {
      issue<TE>(a, c, pw, ring + q * Gm::SLOT, full + q);
      pw.next(a, c);
    }
  };
#pragma unroll
  for (int q = 0; q < WS_STAGES - 1; ++q) produce(q);
  int stage = 0;
  // the next staged sub-tile, once it has landed and every thread is done
  // with the slot the producer refills
  auto consume = [&]() -> const float* {
    const int q = stage % WS_STAGES;
    mbar_wait(full + q, (stage / WS_STAGES) & 1);
    __syncthreads();
    produce((stage + WS_STAGES - 1) % WS_STAGES);
    ++stage;
    return ring + q * Gm::SLOT;
  };
  // acc += the sub-tiles of phase ph of step s against Bs(j) (the rows of
  // W that each sub-tile's k runs over)
  constexpr int R = Lanes<TE, W>::R;
  auto run = [&](int s, int ph, float (&acc)[8][4], auto bs) {
    bool any = false;
    while (cw.at(s, ph)) {
      const float* As = consume();
      const float* Bs = bs(cw.j) + cw.kc * Gm::KC * W;
      if (cw.col(c))
        mma_sub<TE, W, true>(As, Bs, acc, ln);
      else
        mma_sub<TE, W, false>(As, Bs, acc, ln);
      cw.next(a, c);
      any = true;
    }
    return any;
  };
  auto zero = [](float (&acc)[8][4]) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
  };
  auto sum = [&](bool col, const float (&acc)[8][4], float* out) {
    if (col)
      reduce<TE, W, true>(red, acc, out, ln);
    else
      reduce<TE, W, false>(red, acc, out, ln);
  };
  // (row, column) in the solve of output m of this thread
  auto rc = [&](int i, int m, int& row, int& col) {
    const int o = tid + WS_THREADS * m;
    row = i * TE + o / W;
    col = c0 + o % W;
  };

  float acc[8][4], dacc[8][4], part[OPT], bv[OPT], v[OPT];
#pragma unroll
  for (int m = 0; m < OPT; ++m) part[m] = 0.f;
  int ex = 0;   // exchanges made (the landing buffer alternates)
  for (int s = 0; s < 2 * c.nb; ++s) {
    const bool bwd = s >= c.nb;
    const int i = Wk::row(c, s), ip = Wk::row(c, s + 1);
    const bool own = Wk::own(c, i);
    if (!bwd && own) {   // b_i, read ahead of the early tiles
#pragma unroll
      for (int m = 0; m < OPT; ++m) {
        int row, col;
        rc(i, m, row, col);
        bv[m] = (row < a.n && col < a.p)
                    ? __ldg(a.B + (size_t)row * a.p + col)
                    : 0.f;
      }
    }
    // row i's partials (none in the first row of each sweep) go to its
    // owner; the barrier's wait comes after the early tiles
    const bool exch = c.cs > 1 && (bwd ? i < c.nb - 1 : i > 0);
    float* land = xbuf + (ex & 1) * (c.cs - 1) * TW;
    if (exch) {
      const int owner = i & (c.cs - 1);
      if (!own) {
        float* dst = cl.map_shared_rank(
            land + (((c.rank - owner) & (c.cs - 1)) - 1) * TW, owner);
#pragma unroll
        for (int m = 0; m < OPT; ++m) dst[tid + WS_THREADS * m] = part[m];
      }
      cluster_arrive();
    }
    // early: u_i' = M_i'^T y_i' in place, then the tiles of row i' that
    // need nothing of row i
    if (cw.at(s, 0)) {
      zero(dacc);
      run(s, 0, dacc, [&](int) { return slot(ip); });
      sum(true, dacc, v);
#pragma unroll
      for (int m = 0; m < OPT; ++m) slot(ip)[tid + WS_THREADS * m] = v[m];
      __syncthreads();
    }
    zero(acc);
    bool any = run(s, 1, acc, slot);
    if (exch) {
      cluster_wait();
      ++ex;
    }
    if (own) {
      // v = b_i (or u_i) - the sum; rows past n and columns past p zero
      float* Yi = slot(i);
#pragma unroll
      for (int m = 0; m < OPT; ++m) {
        float tot = part[m];
        if (exch)
          for (int q = 0; q < c.cs - 1; ++q)
            tot += land[q * TW + tid + WS_THREADS * m];
        int row, col;
        rc(i, m, row, col);
        v[m] = (row < a.n && col < a.p)
                   ? (bwd ? Yi[tid + WS_THREADS * m] : bv[m]) - tot
                   : 0.f;
      }
      if (cw.at(s, 2)) {   // y_i = F_i v, x_i = G_i^T v
#pragma unroll
        for (int m = 0; m < OPT; ++m) vbuf[tid + WS_THREADS * m] = v[m];
        __syncthreads();
        zero(dacc);
        run(s, 2, dacc, [&](int) { return vbuf; });
        sum(bwd, dacc, v);
      }
#pragma unroll
      for (int m = 0; m < OPT; ++m) {
        int row, col;
        rc(i, m, row, col);
        const bool in = row < a.n && col < a.p;
        Yi[tid + WS_THREADS * m] = in ? v[m] : 0.f;
        if (bwd && in) a.X[(size_t)row * a.p + col] = v[m];
      }
      __syncthreads();
    }
    // late: the tile of row i' that needs row i (or, at the turn, M)
    if (cw.at(s, 3)) {
      if (s + 1 == c.nb) {   // u = M^T y of the last row, in place
        zero(dacc);
        run(s, 3, dacc, [&](int) { return slot(i); });
        sum(true, dacc, v);
#pragma unroll
        for (int m = 0; m < OPT; ++m) slot(i)[tid + WS_THREADS * m] = v[m];
        __syncthreads();
      } else {
        any |= run(s, 3, acc, slot);
      }
    }
    // row i''s partial
    if (any) {
      sum(bwd || s + 1 == c.nb, acc, part);
    } else {
#pragma unroll
      for (int m = 0; m < OPT; ++m) part[m] = 0.f;
    }
  }
}

// Shared memory of a launch (bytes): the ring (aligned for the swizzle),
// the split-k scratch, the diagonal product's operand, the landing
// buffers, the owned block rows, the ring's barriers.
size_t wide_smem(int te, int w, int cs, int nb) {
  const size_t tw = (size_t)te * w;
  return WS_ALIGN + 4 * (WS_STAGES * (size_t)te * (te == 64 ? 64 : 32) +
                         WS_RED + tw + 2 * (cs - 1) * tw +
                         (size_t)((nb + cs - 1) / cs) * tw) +
         8 * WS_STAGES;
}

// One instance of the kernel: its shared-memory attribute (set once), the
// clusters of cs blocks with smem bytes each that the card holds at once
// (asked once per shape), and its launch.
template <int TE, int W>
struct Wide {
  static cudaError_t prepare() {
    static cudaError_t e = cudaFuncSetAttribute(
        wide_solve_kernel<TE, W>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, WS_MAX_SMEM);
    return e;
  }
  static cudaLaunchConfig_t config(int cs, size_t smem, int grid,
                                   cudaLaunchAttribute* at,
                                   cudaStream_t stream) {
    at->id = cudaLaunchAttributeClusterDimension;
    at->val.clusterDim.x = cs;
    at->val.clusterDim.y = 1;
    at->val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(WS_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    return cfg;
  }
  static int clusters(int cs, size_t smem) {
    static struct {
      int cs;
      size_t smem;
      int held;
    } seen[32];
    static int used = 0;
    for (int k = 0; k < used; ++k)
      if (seen[k].cs == cs && seen[k].smem == smem) return seen[k].held;
    int held = 0;
    cudaLaunchAttribute at;
    const cudaLaunchConfig_t cfg = config(cs, smem, cs, &at, 0);
    if (prepare() != cudaSuccess ||
        cudaOccupancyMaxActiveClusters(&held, wide_solve_kernel<TE, W>,
                                       &cfg) != cudaSuccess) {
      cudaGetLastError();
      return 0;
    }
    if (used < 32) seen[used++] = {cs, smem, held};
    return held;
  }
  static int launch(const WsArgs& a, int chunks, size_t smem,
                    cudaStream_t stream) {
    cudaError_t e = prepare();
    if (e == cudaSuccess) {
      cudaLaunchAttribute at;
      const cudaLaunchConfig_t cfg =
          config(a.cs, smem, chunks * a.cs, &at, stream);
      e = cudaLaunchKernelEx(&cfg, wide_solve_kernel<TE, W>, a);
    }
    if (e != cudaSuccess) {
      cudaGetLastError();
      return (int)e;
    }
    return ip_status();
  }
};

// Wide<te, w>::clusters(cs, smem) (launch == nullptr) or ::launch.
int wide(int te, int w, int cs, size_t smem, const WsArgs* launch,
         int chunks, cudaStream_t stream) {
#define WIDE_CASE(T, V)                                              \
  if (te == T && w == V)                                             \
    return launch ? Wide<T, V>::launch(*launch, chunks, smem, stream) \
                  : Wide<T, V>::clusters(cs, smem);
  WIDE_CASE(64, 8)
  WIDE_CASE(64, 16)
  WIDE_CASE(128, 8)
  WIDE_CASE(128, 16)
#undef WIDE_CASE
  return launch ? (int)cudaErrorInvalidValue : 0;
}

// The geometry of a launch: W = 16 columns a cluster past p = 512, else
// 8; the most blocks a cluster (4, 2, at most one a block row, and
// fitting their share of the block rows in shared memory) for which the
// card holds every cluster at once (cudaOccupancyMaxActiveClusters: a GPC
// fits whole clusters only, and a second wave of clusters costs more than
// the split saves), else the most that fit; cs = 0 where none fits.
// Chosen by timing every (W, CS) of 8/16 x 1/2/4 at the widths the port
// gives the solve on development builds (PERF.md, PR 13).
void wide_config(int n, int p, int te, int* w, int* cs) {
  const int nb = (n + te - 1) / te;
  *w = p > 512 ? 16 : 8;
  *cs = 0;
  const int chunks = (p + *w - 1) / *w;
  for (int c = 4; c >= 1; c /= 2) {
    const size_t smem = wide_smem(te, *w, c, nb);
    if (c > nb || smem > WS_MAX_SMEM) continue;
    if (*cs == 0) *cs = c;
    if (chunks <= wide(te, *w, c, smem, nullptr, 0, 0)) {
      *cs = c;
      return;
    }
  }
}

}  // namespace

// The wide solve of B (n x p, row-major) into X: one launch, no scratch;
// refused (cudaErrorInvalidValue) where a chunk's block rows do not fit
// in a cluster's shared memory.  With `run` (a device flag, or null)
// nothing runs unless *run is set (K2's re-seed after an LDL rung, a
// branch taken on the device: X is then left as it was).
IP_API int ip_block_solve_wide(const float* L, int ldl, int n, int te,
                               const float* F, const float* M,
                               const float* G, const float* B, float* X,
                               int p, const int* run, cudaStream_t stream) {
  if (n <= 0 || p <= 0) return 0;
  if ((te != 64 && te != 128) || ldl < n) return (int)cudaErrorInvalidValue;
  int w, cs;
  wide_config(n, p, te, &w, &cs);
  if (cs == 0) return (int)cudaErrorInvalidValue;
  const int nb = (n + te - 1) / te;
  const size_t smem = wide_smem(te, w, cs, nb);
  // TMA reads rows 16-byte aligned
  auto al = [](const float* q) { return ((uintptr_t)q & 15) == 0; };
  if (!al(L) || ldl % 4 || !al(F) || !al(M) || !al(G))
    return (int)cudaErrorInvalidValue;
  WsArgs a = {};
  const int kc = te == 64 ? 64 : 32;
  bool ok = ip_make_map(&a.l_row, L, n, n, ldl, 32, te, true) &&
            ip_make_map(&a.l_col, L, n, n, ldl, te, kc, false);
  if (F) ok = ok && ip_make_map(&a.f_row, F, nb * te, te, te, 32, te, true);
  if (M) ok = ok && ip_make_map(&a.m_col, M, nb * te, te, te, te, kc, false);
  if (G) ok = ok && ip_make_map(&a.g_col, G, nb * te, te, te, te, kc, false);
  if (!ok) return (int)cudaErrorInvalidValue;
  a.F = F;
  a.M = M;
  a.G = G;
  a.B = B;
  a.X = X;
  a.run = run;
  a.n = n;
  a.p = p;
  a.cs = cs;
  return wide(te, w, cs, smem, &a, (p + w - 1) / w, stream);
}
