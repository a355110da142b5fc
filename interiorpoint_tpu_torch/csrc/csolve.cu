// The blocked two-triangle solve for one right-hand side (p = 1): the
// forward sweep y_i = F_i (b_i - sum_{j<i} L_ij y_j), u_i = M_i^T y_i, the
// backward sweep x_i = G_i^T (u_i - sum_{j>i} L_ji^T x_j), over TE-row
// block rows of the leading n x n of a row-major L read in place (row
// stride ldl, only its strictly lower tiles; rows and columns past n read
// as the identity's).  F, M, G are (np, TE) stacks of TE x TE tiles (NULL
// is the identity).  K3b: TE = 64, F = G = Dinv; K2's LDL solve
// (M^-1 v, the preconditioner apply of every refinement round and PCG
// iteration): TE = 128, M = the tile inverses.
//
// Replaces, for p = 1,
//   interiorpoint_tpu/ops/pallas_chol.py:_solve_kernel (K3b's single
//     right-hand side: the warm start and the dual recovery), and
//   interiorpoint_tpu/ops/pallas_newton.py:_ldl_solve (K2's LDL apply).
//
// Bound: bytes.  The factor's lower triangle (n^2 / 2 floats) and one
// stack of diagonal tiles (n TE) are read once, 2 n^2 + 2 n TE FMA-flops:
// 0.0008 ms at np = 1024 against a chain of 2 nb dependent block rows,
// each a tile product, a diagonal product and a hand-off between SMs.
// What held chol.cu's kernel (one block per block row, flags in global
// memory) at ~6 us a block row: each step of the chain was an acquire spin
// on a flag, a block barrier, a reload of y_j through L2, a product of a
// tile read from L2 only after the flag, and a flag zeroed by a memset per
// call.  Design:
//  * one thread-block cluster (up to 16 blocks, the non-portable size)
//    holds the whole lower triangle and the diagonal tiles in shared
//    memory, copied by TMA at the start (one thread a tile, each tile on
//    its own mbarrier; boxes past n read as zeros) while the chain
//    begins;
//  * ownership by groups of R block rows (group_rows): the owner of group
//    g holds its diagonal tiles, the tile among its rows and the band of
//    tiles (i in g, j in g - 1), so the chain from one group to the next
//    is one hand-off: forward the y of group g - 1, backward the band's
//    partial sums for group g - 1; the tiles the chain multiplies sit in
//    the owner's registers (a shared-memory product at TE = 128 took
//    ~0.8 us: a 16-byte load costs a warp four wavefronts whatever its
//    addresses);
//  * the far tiles (group(j) <= group(i) - 2) are split in row-major runs
//    over helper blocks, which fold L_ij y_j into row i's partial as each
//    y_j lands (right-looking) and send the partial when their last tile
//    of the row is done, a group step before it is needed; backward the
//    same with L_ij^T x_i into column j's partial, the columns the owners
//    need first first;
//  * every hand-off is a push into the receiver's shared memory by
//    st.async, counted in bytes on a one-shot mbarrier of the receiver
//    (distributed shared memory, ~0.15 us a hand-off): no flags in global
//    memory, nothing to zero per call, one launch;
//  * the plan (who holds which tile, col_plan) is made once per (n, TE)
//    on the host and read by every block from shared memory;
//  * partials are summed in a fixed order (b less the helpers' partials by
//    rank, then the band and the group's own tiles), so results are
//    deterministic;
//  * a tile lies as TMA's 128-byte swizzle lays out its boxes (chunk c of
//    row a at c ^ (a & 7) within 32 floats), so the forward product
//    (eight rows per quarter-warp at one chunk) and the transposed one
//    (eight rows at one chunk, columns across lanes) read shared memory
//    without conflicts.
// A wait longer than 2 s traps (the launch fails) rather than hanging.
#include <stdint.h>

#include "common.cuh"
#include "tma.cuh"

namespace {

constexpr int CL_MAX_CS = 16;          // blocks of a cluster
constexpr int CL_MAX_NB = 16;          // block rows
constexpr int CL_MAX_SMEM = 231424;    // dynamic shared memory a block
                                       // takes, bytes (1 KB left static)
constexpr unsigned FULLM = 0xffffffffu;

// The plan of a launch (computed on the host by col_plan; every block reads
// the same).  Far tiles of row i: f(i) = fs[i + 1] - fs[i] = R (group(i) -
// 1) if positive, the row-major list of them split into the helpers' runs
// [hs[h], hs[h + 1]).  Offsets in floats of one shared-memory layout that
// every block of the cluster uses, so that a remote address is the local
// one mapped to the receiver's rank.
struct ColPlan {
  int nb, R, ng, H, cs, ndc;
  int fs[CL_MAX_NB + 1];
  int hs[CL_MAX_CS + 1];
  unsigned rowmask[CL_MAX_NB];   // helpers holding far tiles of row i
  unsigned colmask[CL_MAX_NB];   // helpers holding far tiles of column j
  int fr;                        // rows a helper's run spans, at most
  int ntb;                       // tiles a block holds, at most
  int o_xv, o_pf, o_pb, o_bar, o_work, o_tiles;
  size_t smem;
};

// The tensor maps of L (n x n, row stride ldl) and of the stack of
// diagonal tiles (np x TE), boxes of TE rows x 32 floats, 128-byte
// swizzled; D[0..2] = F, M, G, each NULL or the one stack.
struct ColArgs {
  CUtensorMap lmap, dmap;
  const float* D[3];
  const float* B;
  float* X;
  int n;
  ColPlan pl;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ unsigned cta_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// the address of the same shared-memory offset in block `rank`
__device__ __forceinline__ unsigned remote(const void* p, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_u32(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ void mbar_init(u64* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(u64* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// Wait for the first phase of a one-shot barrier, with acquire at cluster
// scope where the bytes come from other blocks (else at block scope: a
// tile's TMA copy); past 2 s, trap.
__device__ __forceinline__ void mbar_wait(u64* bar, bool cluster) {
  unsigned done = 0;
  u64 t0 = 0;
  for (int spin = 0;; ++spin) {
    if (cluster)
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
          "0;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(smem_u32(bar))
          : "memory");
    else
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(smem_u32(bar))
          : "memory");
    if (done) return;
    if (spin == 64) t0 = globaltimer();
    if (spin > 64 && globaltimer() - t0 > 2000000000ull) __trap();
  }
}
// 16 bytes into another block's shared memory, counted on its barrier
__device__ __forceinline__ void st_async(unsigned addr, float4 v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}
// (relaxed: what it publishes, the barriers' initialisation, is ordered by
// fence.mbarrier_init)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ int nth_bit(unsigned m, int k) {
  for (; k > 0; --k) m &= m - 1;
  return __ffs(m) - 1;
}
__device__ __forceinline__ float4 f4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void f4sub(float4& a, float4 b) {
  a.x -= b.x;
  a.y -= b.y;
  a.z -= b.z;
  a.w -= b.w;
}

// A tile's 16-byte chunk c of row a: TE / 32 boxes of TE rows x 32 floats
// as TMA lays them out, chunk c % 8 of a box row at (c % 8) ^ (a % 8)
template <int TE>
__device__ __forceinline__ int at(int a, int c) {
  return (c >> 3) * TE * 32 + a * 32 + (((c & 7) ^ (a & 7)) << 2);
}

// Forward product, thread (row a, quarter q): its quarter of row a of T
// (chunks 4k + q) against x.  Eight lanes of a quarter-warp read eight rows
// at one chunk; the four quarters of a warp read x's 64 bytes at once.
template <int TE>
__device__ __forceinline__ float dot_f(const float* T, const float* x, int a,
                                       int q) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < TE / 16; ++k) {
    const int c = 4 * k + q;
    const float4 t = f4(T + at<TE>(a, c)), v = f4(x + 4 * c);
    s = fmaf(t.x, v.x, s);
    s = fmaf(t.y, v.y, s);
    s = fmaf(t.z, v.z, s);
    s = fmaf(t.w, v.w, s);
  }
  return s;
}
// the sum over a row's four quarters (lane bits 3 and 4); every lane
// of the row ends with it
__device__ __forceinline__ float red_q(float s) {
  s += __shfl_xor_sync(FULLM, s, 8);
  return s + __shfl_xor_sync(FULLM, s, 16);
}
// Transposed product, thread (chunk c, row lane rl): acc += its rows
// rl + 16k of T^T's chunk c against x.
template <int TE>
__device__ __forceinline__ void dot_t(const float* T, const float* x, int c,
                                      int rl, float4& acc) {
#pragma unroll
  for (int k = 0; k < TE / 16; ++k) {
    const int a = rl + 16 * k;
    const float4 t = f4(T + at<TE>(a, c));
    const float v = x[a];
    acc.x = fmaf(t.x, v, acc.x);
    acc.y = fmaf(t.y, v, acc.y);
    acc.z = fmaf(t.z, v, acc.z);
    acc.w = fmaf(t.w, v, acc.w);
  }
}
// A thread's slice of a tile, held in registers for the owner's products on
// the chain (half the shared-memory reads of dot_f and dot_t): the forward
// layout's (row a, chunks 4k + q) or the transposed layout's (rows
// rl + 16k, chunk c).
template <int TE>
struct Slice {
  float v[TE / 4];
};
template <int TE>
__device__ __forceinline__ void slice_f(const float* T, int a, int q,
                                        Slice<TE>& s) {
#pragma unroll
  for (int k = 0; k < TE / 16; ++k)
    *reinterpret_cast<float4*>(s.v + 4 * k) = f4(T + at<TE>(a, 4 * k + q));
}
template <int TE>
__device__ __forceinline__ void slice_t(const float* T, int c, int rl,
                                        Slice<TE>& s) {
#pragma unroll
  for (int k = 0; k < TE / 16; ++k)
    *reinterpret_cast<float4*>(s.v + 4 * k) = f4(T + at<TE>(rl + 16 * k, c));
}
// dot_f and dot_t on a slice
template <int TE>
__device__ __forceinline__ float dot_fr(const Slice<TE>& t, const float* x,
                                        int q) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < TE / 16; ++k) {
    const float4 v = f4(x + 4 * (4 * k + q));
    s = fmaf(t.v[4 * k], v.x, s);
    s = fmaf(t.v[4 * k + 1], v.y, s);
    s = fmaf(t.v[4 * k + 2], v.z, s);
    s = fmaf(t.v[4 * k + 3], v.w, s);
  }
  return s;
}
template <int TE>
__device__ __forceinline__ void dot_tr(const Slice<TE>& t, const float* x,
                                       int rl, float4& acc) {
#pragma unroll
  for (int k = 0; k < TE / 16; ++k) {
    const float v = x[rl + 16 * k];
    acc.x = fmaf(t.v[4 * k], v, acc.x);
    acc.y = fmaf(t.v[4 * k + 1], v, acc.y);
    acc.z = fmaf(t.v[4 * k + 2], v, acc.z);
    acc.w = fmaf(t.v[4 * k + 3], v, acc.w);
  }
}
// the sum over a chunk's 16 row lanes (lane bits 0..3)
__device__ __forceinline__ float4 red_16(float4 v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) {
    v.x += __shfl_xor_sync(FULLM, v.x, o);
    v.y += __shfl_xor_sync(FULLM, v.y, o);
    v.z += __shfl_xor_sync(FULLM, v.z, o);
    v.w += __shfl_xor_sync(FULLM, v.w, o);
  }
  return v;
}

// Start the copy of tile (y0, x0) of a map into dst (one thread): TE / 32
// boxes, counted in bytes on bar (reads past the map land as zeros)
template <int TE>
__device__ __forceinline__ void load_tile(float* dst, const CUtensorMap* map,
                                          int y0, int x0, u64* bar) {
  mbar_expect(bar, TE * TE * 4);
#pragma unroll
  for (int h = 0; h < TE / 32; ++h)
    ip_tma_2d(dst + h * TE * 32, map, x0 + 32 * h, y0, bar);
}

// Block rows of a group: 2 at TE = 64, 1 at TE = 128 (an owner's tiles,
// the band's R^2, the diagonal's R and the R (R - 1) / 2 among its rows,
// then fill half a block's shared memory or less).
template <int TE>
__host__ __device__ constexpr int group_rows() {
  return TE == 64 ? 2 : 1;
}

template <int TE>
__global__ void __launch_bounds__(4 * TE, 1)
    col_solve_kernel(const __grid_constant__ ColArgs a) {
  constexpr int NT = 4 * TE, TT = TE * TE, NCH = TE / 4;
  constexpr int R = group_rows<TE>();
  extern __shared__ __align__(16) float sm_raw[];
  // 1024-byte aligned, as the 128-byte swizzle of the boxes wants (the
  // same offset in every block of the cluster)
  float* sm = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(sm_raw) + 1023) & ~(uintptr_t)1023);
  const int tid = threadIdx.x, w = tid >> 5, l = tid & 31;
  // the plan, copied from parameter space by one load a thread (its
  // arrays are then read at shared-memory latency)
  __shared__ ColPlan Ps;
  for (int k = tid; k < (int)(sizeof(ColPlan) / 4); k += NT)
    reinterpret_cast<int*>(&Ps)[k] = reinterpret_cast<const int*>(&a.pl)[k];
  __syncthreads();
  const ColPlan& P = Ps;
  const int nb = P.nb, H = P.H, n = a.n, ndc = P.ndc;
  const int rank = (int)cta_rank();
  const int fa = 8 * w + (l & 7), fq = l >> 3;   // forward layout
  const int tc = 2 * w + (l >> 4), rl = l & 15;  // transposed layout
  float* yv = sm;               // y_j: landed, or the owner's own
  float* xv = sm + P.o_xv;      // x_i likewise
  float* pf = sm + P.o_pf;      // owner: [R][H][TE] helpers' row partials
  float* pb = sm + P.o_pb;      // owner: [R][H + 1][TE] column partials
  // one-shot barriers: y_j landed, x_i landed, owner row r's forward
  // partials, its backward partials from helpers and from the band, and
  // tile k landed
  u64* yb = reinterpret_cast<u64*>(sm + P.o_bar);
  u64* xb = yb + nb;
  u64* pfb = xb + nb;
  u64* pbb = pfb + R;
  u64* pbh = pbb + R;
  u64* tb = pbh + R;
  float* work = sm + P.o_work;
  float* tiles = sm + P.o_tiles;
  const bool owner = rank < P.ng;
  const int g = rank, h = rank - P.ng;
  const int i0 = g * R;
  const int Rg = owner ? min(R, nb - i0) : 0;
  const bool up = owner && g + 1 < P.ng;   // a group below this one
  const int hs = owner ? 0 : P.hs[h], he = owner ? 0 : P.hs[h + 1];
  const unsigned hbit = owner ? 0u : 1u << h;
  auto row_of = [&](int t) {   // the row of far tile t
    int i = 0;
    while (P.fs[i + 1] <= t) ++i;
    return i;
  };
  const int ir0 = hs < he ? row_of(hs) : 0;
  const int ir1 = hs < he ? row_of(he - 1) : -1;
  // this helper's far columns of row i: [jlo, jhi]
  auto jlo = [&](int i) { return max(hs, P.fs[i]) - P.fs[i]; };
  auto jhi = [&](int i) { return min(he, P.fs[i + 1]) - P.fs[i] - 1; };
  // an owner's tiles: the diagonal ones, the band's L_{i0 + r, i0 - R + jj},
  // L_{i0 + 1, i0} (R = 2); a helper's: its run in order
  const int nband = g > 0 ? R * R : 0;
  auto kb = [&](int r, int jj) { return R * ndc + r * R + jj; };
  const int ki = R * ndc + nband;

  const int nbar = 2 * nb + 3 * R + P.ntb;
  for (int k = tid; k < nbar; k += NT) mbar_init(yb + k, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  // the bytes each one-shot barrier receives over the launch
  for (int k = tid; k < 2 * nb + 3 * R; k += NT) {
    int m = 0;
    if (k < nb)
      m = owner ? (g > 0 && k >= i0 - R && k < i0) : (P.colmask[k] & hbit) != 0;
    else if (k < 2 * nb)
      m = !owner && (P.rowmask[k - nb] & hbit);
    else if (owner && (k - 2 * nb) % R < Rg) {
      const int i = i0 + (k - 2 * nb) % R, kind = (k - 2 * nb) / R;
      m = kind == 0 ? __popc(P.rowmask[i])
                    : (kind == 1 ? __popc(P.colmask[i]) : (up ? 1 : 0));
    }
    if (m) mbar_expect(yb + k, TE * 4 * m);
  }
  // every block's barriers are set before any block pushes to them (the
  // wait comes just before this block's first push)
  cluster_arrive();
  // the tile copies, a thread each, all at once (TMA)
  if (tid < P.ntb) {
    const int k = tid;
    float* T = tiles + k * TT;
    if (!owner) {
      if (k < he - hs) {
        const int i = row_of(hs + k);
        load_tile<TE>(T, &a.lmap, i * TE, (hs + k - P.fs[i]) * TE, tb + k);
      }
    } else if (k < R * ndc) {
      if (k < Rg) load_tile<TE>(T, &a.dmap, (i0 + k) * TE, 0, tb + k);
    } else if (k < ki) {
      const int r = (k - R * ndc) / R, jj = (k - R * ndc) % R;
      if (r < Rg)
        load_tile<TE>(T, &a.lmap, (i0 + r) * TE, (i0 - R + jj) * TE, tb + k);
    } else if (R == 2 && k == ki && Rg == 2) {
      load_tile<TE>(T, &a.lmap, (i0 + 1) * TE, i0 * TE, tb + k);
    }
  }
  unsigned landed = 0;   // tiles known to have landed
  auto tile = [&](int k) -> const float* {
    if (!(landed >> k & 1)) {
      mbar_wait(tb + k, false);
      landed |= 1u << k;
    }
    return tiles + k * TT;
  };
  bool joined = false;
  auto join = [&]() {
    if (!joined) cluster_wait();
    joined = true;
  };
  // push the TE-vector v (this block's shared memory) to the same offset
  // in `nd` blocks, the k-th one dest(k), counted on their barrier `b`;
  // thread t carries chunk t % NCH of message t / NCH
  auto push = [&](const float* v, int nd, auto dest, u64* b) {
    join();
    const int m = tid / NCH, c = tid % NCH;
    if (m < nd) {
      const int r = dest(m);
      st_async(remote(v + 4 * c, r), f4(v + 4 * c), remote(b, r));
    }
  };

  if (owner) {
    const bool F = a.D[0] != nullptr;
    float pre[R], acc[R];
    float* vb = work + R * TE;   // the diagonal product's operand
    // b_i (loaded first: its latency is hidden behind the waits below)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = (i0 + r) * TE + fa;
      pre[r] = r < Rg && row < n ? __ldg(a.B + row) : 0.f;
      acc[r] = 0.f;
    }
    // the chain's tiles in registers (loaded as they land, before the
    // waits): the band's last column, the tile among the group's rows, the
    // diagonal
    Slice<TE> fb[R], fi, fd[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < Rg) {
        if (g > 0) slice_f<TE>(tile(kb(r, R - 1)), fa, fq, fb[r]);
        if (F) slice_f<TE>(tile(r), fa, fq, fd[r]);
      }
    if (R == 2 && Rg == 2) slice_f<TE>(tile(ki), fa, fq, fi);
    // forward: the band's first column as its y lands, then its last
#pragma unroll
    for (int jj = 0; jj < R - 1; ++jj)
      if (g > 0) {
        const int j = i0 - R + jj;
        mbar_wait(yb + j, true);
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (r < Rg)
            acc[r] += dot_f<TE>(tile(kb(r, jj)), yv + j * TE, fa, fq);
      }
    // less the helpers' partials (a group step ahead of the band's)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= Rg) continue;
      const unsigned hm = P.rowmask[i0 + r];
      if (hm) {
        mbar_wait(pfb + r, true);
        for (unsigned m = hm; m; m &= m - 1)
          pre[r] -= pf[(r * H + __ffs(m) - 1) * TE + fa];
      }
    }
    if (g > 0) mbar_wait(yb + i0 - 1, true);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= Rg) break;
      const int i = i0 + r, row = i * TE + fa;
      if (g > 0) acc[r] += dot_fr<TE>(fb[r], yv + (i0 - 1) * TE, fq);
      if (r == 1) acc[r] += dot_fr<TE>(fi, yv + i0 * TE, fq);
      const float v = pre[r] - red_q(acc[r]);
      if (fq == 0) {
        if (F)
          vb[fa] = v;
        else
          yv[i * TE + fa] = row < n ? v : 0.f;
      }
      __syncthreads();
      if (F) {
        const float y = red_q(dot_fr<TE>(fd[r], vb, fq));
        if (fq == 0) yv[i * TE + fa] = row < n ? y : 0.f;
        __syncthreads();
      }
      // y_i to the next group's owner and to the helpers of column i
      const unsigned cm = P.colmask[i];
      push(yv + i * TE, (up ? 1 : 0) + __popc(cm),
           [&](int k) {
             return up ? (k == 0 ? g + 1 : P.ng + nth_bit(cm, k - 1))
                       : P.ng + nth_bit(cm, k);
           },
           yb + i);
    }
    // middle: u_i = M_i^T y_i (into work), or u_i = y_i
    const float* U = yv + i0 * TE;
    if (a.D[1]) {
      for (int r = 0; r < Rg; ++r) {
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
        dot_t<TE>(tile(r), yv + (i0 + r) * TE, tc, rl, s);
        s = red_16(s);
        if (rl == 0) *reinterpret_cast<float4*>(work + r * TE + 4 * tc) = s;
      }
      U = work;
      __syncthreads();
    }
    // backward, rows in decreasing order; the chain's tiles in registers
    // (the diagonal, the tile among the group's rows, the band)
    const bool G = a.D[2] != nullptr;
    Slice<TE> gd[R], bi, bb[R][R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < Rg) {
        if (G) slice_t<TE>(tile(r), tc, rl, gd[r]);
#pragma unroll
        for (int jj = 0; jj < R; ++jj)
          if (g > 0) slice_t<TE>(tile(kb(r, jj)), tc, rl, bb[r][jj]);
      }
    if (R == 2 && Rg == 2) slice_t<TE>(tile(ki), tc, rl, bi);
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int r = R - 1 - rr;
      if (r >= Rg) continue;
      const int i = i0 + r;
      float* xi = xv + i * TE;
      // u_i less the helpers' partials, the tile among the group's rows,
      // then the band's partial
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      const unsigned hm = P.colmask[i];
      if (hm) mbar_wait(pbb + r, true);
      if (rl == 0) {
        v = f4(U + r * TE + 4 * tc);
        for (unsigned m = hm; m; m &= m - 1)
          f4sub(v, f4(pb + (r * (H + 1) + __ffs(m) - 1) * TE + 4 * tc));
      }
      if (R == 2 && r + 1 < Rg) {
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
        dot_tr<TE>(bi, xv + (i0 + 1) * TE, rl, s);
        f4sub(v, red_16(s));
      }
      if (up) {
        mbar_wait(pbh + r, true);
        if (rl == 0) f4sub(v, f4(pb + (r * (H + 1) + H) * TE + 4 * tc));
      }
      // write x's chunk tc (rows 4 tc .. 4 tc + 3 of block row i)
      auto put_x = [&](float4 x) {
        const int row = i * TE + 4 * tc;
        if (row + 3 >= n) {
          x.y = row + 1 < n ? x.y : 0.f;
          x.z = row + 2 < n ? x.z : 0.f;
          x.w = row + 3 < n ? x.w : 0.f;
          x.x = row < n ? x.x : 0.f;
        }
        *reinterpret_cast<float4*>(xi + 4 * tc) = x;
        if (row + 3 < n) {
          *reinterpret_cast<float4*>(a.X + row) = x;
        } else {
          const float e[4] = {x.x, x.y, x.z, x.w};
          for (int k = 0; k < 4 && row + k < n; ++k) a.X[row + k] = e[k];
        }
      };
      if (rl == 0) {
        if (G)
          *reinterpret_cast<float4*>(vb + 4 * tc) = v;
        else
          put_x(v);
      }
      __syncthreads();
      if (G) {
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        dot_tr<TE>(gd[r], vb, rl, x);
        x = red_16(x);
        if (rl == 0) put_x(x);
        __syncthreads();
      }
      const unsigned rm = P.rowmask[i];
      push(xi, __popc(rm), [&](int k) { return P.ng + nth_bit(rm, k); },
           xb + i);
    }
    // the band's partials of group g - 1, its last row first
#pragma unroll
    for (int jj = R - 1; jj >= 0; --jj)
      if (g > 0) {
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int k = 0; k < R; ++k)
          if (k < Rg) dot_tr<TE>(bb[k][jj], xv + (i0 + k) * TE, rl, s);
        s = red_16(s);
        join();
        if (rl == 0)
          st_async(remote(pb + (jj * (H + 1) + H) * TE + 4 * tc, g - 1), s,
                   remote(pbh + jj, g - 1));
      }
  } else if (hs < he) {
    // helper: forward, columns in increasing order as their y land
    float* fslot = work;   // [fr][NT]: each thread's partial of a row
    float* bacc = work + P.fr * NT;   // [nb][TE]: column partials
    for (int r = 0; r <= ir1 - ir0; ++r) fslot[r * NT + tid] = 0.f;
    for (int j = 0; j < nb; ++j) {
      if (!(P.colmask[j] & hbit)) continue;
      mbar_wait(yb + j, true);
      for (int i = ir0; i <= ir1; ++i) {
        if (j < jlo(i) || j > jhi(i)) continue;
        float* sl = fslot + (i - ir0) * NT + tid;
        *sl += dot_f<TE>(tile(P.fs[i] + j - hs), yv + j * TE, fa, fq);
        if (j == jhi(i)) {   // row i's partial to its owner
          const float s = red_q(*sl);
          const float4 v = make_float4(s, __shfl_down_sync(FULLM, s, 1),
                                       __shfl_down_sync(FULLM, s, 2),
                                       __shfl_down_sync(FULLM, s, 3));
          join();
          const int o = i / R;
          if (l == 0 || l == 4)
            st_async(remote(pf + ((i - o * R) * H + h) * TE + fa, o), v,
                     remote(pfb + i - o * R, o));
        }
      }
    }
    // backward, rows in decreasing order as their x land, each row's
    // columns in decreasing order (the order the owners need them)
    for (int i = ir1; i >= ir0; --i) {
      mbar_wait(xb + i, true);
      for (int j = jhi(i); j >= jlo(i); --j) {
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
        dot_t<TE>(tile(P.fs[i] + j - hs), xv + i * TE, tc, rl, s);
        s = red_16(s);
        // the first row of this run holding column j is its last here
        int imin = ir0;
        while (j < jlo(imin) || j > jhi(imin)) ++imin;
        if (rl == 0) {
          float4* ba = reinterpret_cast<float4*>(bacc + j * TE + 4 * tc);
          if (i != ir1 && j >= jlo(i + 1) && j <= jhi(i + 1)) {
            const float4 p = *ba;
            s.x += p.x;
            s.y += p.y;
            s.z += p.z;
            s.w += p.w;
          }
          *ba = s;
        }
        if (i == imin) {
          join();
          const int o = j / R;
          if (rl == 0)
            st_async(
                remote(pb + ((j - o * R) * (H + 1) + h) * TE + 4 * tc, o), s,
                remote(pbb + j - o * R, o));
        }
      }
    }
  }
  join();
}

// Shared memory of a plan, and its offsets (floats)
void col_layout(ColPlan* P, int te) {
  const int nt = 4 * te;
  P->o_xv = P->nb * te;
  P->o_pf = P->o_xv + P->nb * te;
  P->o_pb = P->o_pf + P->R * P->H * te;
  P->o_bar = P->o_pb + P->R * (P->H + 1) * te;
  P->o_work = (P->o_bar + 2 * (2 * P->nb + 3 * P->R + P->ntb) + 3) & ~3;
  const int own = P->R * te + te, help = P->fr * nt + P->nb * te;
  // (tiles 1024-byte aligned for the boxes' swizzle; 1024 bytes more for
  // the alignment of the base)
  P->o_tiles = (P->o_work + (own > help ? own : help) + 255) & ~255;
  P->smem = ((size_t)P->o_tiles + (size_t)P->ntb * te * te) * 4 + 1024;
}

// The plan of a solve of n rows with te-row tiles and ndc (0 or 1) stacks
// of diagonal tiles: groups of R = group_rows block rows and the fewest
// helpers (a power of two blocks in all) whose runs fit.  False where
// nothing fits one cluster.
bool col_plan(int n, int te, int ndc, ColPlan* P) {
  const int nb = (n + te - 1) / te, R = te == 64 ? group_rows<64>()
                                                 : group_rows<128>();
  *P = ColPlan{};
  P->nb = nb;
  P->R = R;
  P->ndc = ndc;
  P->ng = (nb + R - 1) / R;
  if (nb < 1 || nb > CL_MAX_NB || P->ng > CL_MAX_CS) return false;
  for (int i = 0; i < nb; ++i) {
    const int f = R * (i / R - 1);
    P->fs[i + 1] = P->fs[i] + (f > 0 ? f : 0);
  }
  const int nfar = P->fs[nb];
  const int own = R * ndc + (P->ng > 1 ? R * R : 0) + R * (R - 1) / 2;
  for (int cs = 1; cs <= CL_MAX_CS; cs *= 2) {
    if (cs < P->ng + (nfar > 0 ? 1 : 0)) continue;
    P->cs = cs;
    P->H = cs - P->ng;
    int most = 0;
    P->fr = 0;
    for (int i = 0; i < nb; ++i) P->rowmask[i] = P->colmask[i] = 0;
    for (int hh = 0; hh <= P->H; ++hh)
      P->hs[hh] = P->H ? (int)((long long)hh * nfar / P->H) : 0;
    for (int hh = 0; hh < P->H; ++hh) {
      const int s = P->hs[hh], e = P->hs[hh + 1];
      most = e - s > most ? e - s : most;
      int r0 = -1, r1 = -1;
      for (int i = 0; i < nb; ++i)
        for (int j = 0; j < P->fs[i + 1] - P->fs[i]; ++j) {
          const int t = P->fs[i] + j;
          if (t < s || t >= e) continue;
          P->rowmask[i] |= 1u << hh;
          P->colmask[j] |= 1u << hh;
          if (r0 < 0) r0 = i;
          r1 = i;
        }
      if (r0 >= 0 && r1 - r0 + 1 > P->fr) P->fr = r1 - r0 + 1;
    }
    P->ntb = own > most ? own : most;
    col_layout(P, te);
    if (P->smem <= CL_MAX_SMEM) return true;
  }
  return false;
}

template <int TE>
int col_launch(const ColArgs& a, cudaStream_t stream) {
  static bool attr = false;
  static struct {
    int cs;
    size_t smem;
  } seen[16];
  static int nseen = 0;
  auto kernel = col_solve_kernel<TE>;
  cudaError_t e = cudaSuccess;
  if (!attr) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             CL_MAX_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return (int)e;
    }
    attr = true;
  }
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = a.pl.cs;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.pl.cs);
  cfg.blockDim = dim3(4 * TE);
  cfg.dynamicSmemBytes = a.pl.smem;
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  // the card must hold the cluster (asked once per shape)
  bool known = false;
  for (int k = 0; k < nseen; ++k)
    known |= seen[k].cs == a.pl.cs && seen[k].smem == a.pl.smem;
  if (!known) {
    int held = 0;
    e = cudaOccupancyMaxActiveClusters(&held, kernel, &cfg);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return (int)e;
    }
    if (held < 1) return (int)cudaErrorInvalidConfiguration;
    if (nseen < 16) seen[nseen++] = {a.pl.cs, a.pl.smem};
  }
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return ip_status();
}

// The tensor map of an fp32 matrix for the kernel (boxes of te rows x 32
// floats, swizzled), kept for the last few (base, rows, cols, ld, te): the
// PCG applies one factor many times.
bool col_map(CUtensorMap* m, const float* base, int rows, int cols, int ld,
             int te) {
  static struct {
    const float* base;
    int rows, cols, ld, te;
    CUtensorMap map;
  } seen[8];
  static int next = 0;
  for (auto& e : seen)
    if (e.base == base && e.rows == rows && e.cols == cols && e.ld == ld &&
        e.te == te) {
      *m = e.map;
      return true;
    }
  if (!ip_make_map(m, base, rows, cols, ld, 32, te, true)) return false;
  seen[next] = {base, rows, cols, ld, te, *m};
  next = (next + 1) % 8;
  return true;
}

}  // namespace

// The one-column solve of b (n floats) into x: one launch of one cluster,
// no scratch.  F, M and G are each NULL or one and the same stack.
// Refused (cudaErrorInvalidValue) where the factor does not fit the
// cluster's shared memory, where two stacks differ, or where L's rows,
// the stack or X are not 16-byte aligned (TMA reads rows 16-byte aligned,
// x is written 16 bytes at a time).
IP_API int ip_block_solve_column(const float* L, int ldl, int n, int te,
                                 const float* F, const float* M,
                                 const float* G, const float* B, float* X,
                                 cudaStream_t stream) {
  if (n <= 0) return 0;
  if ((te != 64 && te != 128) || ldl < n) return (int)cudaErrorInvalidValue;
  const float* D = F ? F : (M ? M : G);
  if ((F && F != D) || (M && M != D) || (G && G != D))
    return (int)cudaErrorInvalidValue;
  auto al = [](const float* q) { return ((uintptr_t)q & 15) == 0; };
  if (!al(L) || ldl % 4 || !al(D) || !al(X))
    return (int)cudaErrorInvalidValue;
  const int ndc = D ? 1 : 0, nb = (n + te - 1) / te;
  ColArgs a = {};
  if (!col_map(&a.lmap, L, n, n, ldl, te) ||
      (D && !col_map(&a.dmap, D, nb * te, te, te, te)))
    return (int)cudaErrorInvalidValue;
  a.D[0] = F;
  a.D[1] = M;
  a.D[2] = G;
  a.B = B;
  a.X = X;
  a.n = n;
  // the plan of each (n, te, ndc), made once
  static struct {
    int n, te, ndc;
    bool ok;
    ColPlan pl;
  } plans[16];
  static int nplans = 0;
  int k = 0;
  while (k < nplans && (plans[k].n != n || plans[k].te != te ||
                        plans[k].ndc != ndc))
    ++k;
  if (k == nplans) {
    k = nplans < 16 ? nplans++ : 15;
    plans[k].n = n;
    plans[k].te = te;
    plans[k].ndc = ndc;
    plans[k].ok = col_plan(n, te, ndc, &plans[k].pl);
  }
  if (!plans[k].ok) return (int)cudaErrorInvalidValue;
  a.pl = plans[k].pl;
  return te == 64 ? col_launch<64>(a, stream) : col_launch<128>(a, stream);
}
