#!/usr/bin/env python3
"""Where the time of csrc/hop.cu's operator pass goes, on one NVIDIA H100.

    python3 chip_hop_probe.py            # needs one GPU and nvcc

Builds a probe library from csrc/hop.cu (included as it is, so the probe
kernels call the same device functions) plus kernels that run one part
of the pass each, and times each part with CUDA events over 50 launches
back to back, at the refined solve's three shapes (2200×200, 4010×950
with P, 11000×1000; seeded inputs):

* ``h_apply``: the entry ``ip_h_apply`` (the pass, then the column sums:
  two launches);
* ``reg``: the register form of the pass (rows read into registers, the
  warps' partials in shared memory), P's rows included, no barrier;
* ``reg_noP_nomx``: ``reg`` without P's rows and without writing M x;
* ``regv0``, ``regv1_fence``, ``regv2_16B``, ``regv0_384threads``:
  variants of its loop in a kernel of its own (r > 512 only; no P, no
  M x; 512 threads a block): as hop.cu's, a compiler barrier between a
  row's loads and its arithmetic, 16-byte loads (another order of the
  dot: for bandwidth only), 384 threads a block;
* ``ld``: every block reads its rows with 16-byte loads and sums them
  (the bandwidth a plain streaming read reaches);
* ``colsum``: the column sums of the blocks' partials alone;
* ``prows``: the rows of P alone;
* ``sync1``, ``sync11``: a cooperative launch with 1 and with 11 grid
  barriers (their difference over 10 is one barrier's cost);
* ``sp_loop``: strip.cuh's pass (the parent design: every thread issues
  cp.async copies into two strips, strips handed out round-robin).

Prints one JSON line per shape with ms per launch of each part, and the
card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "interiorpoint_tpu_torch" / "csrc"
OUT = ROOT / "interiorpoint_tpu_torch" / "_build" / "probe"

SOURCE = r'''
#include "HOP_CU"

namespace {

__global__ void __launch_bounds__(HP_THREADS, 1)
probe_ld(const double* M, double* part, int m, int r, HpGeom g) {
  long i0, i1;
  hp_rows(g, m, &i0, &i1);
  double a = 0.0;
  if (i0 < i1) {
    const double2* p = reinterpret_cast<const double2*>(M + i0 * r);
    const long n = (i1 - i0) * r / 2;
    for (long e = threadIdx.x; e < n; e += HP_THREADS) {
      const double2 v = __ldcs(p + e);
      a += v.x + v.y;
    }
  }
  a = ip_warp_sum(a);
  if ((threadIdx.x & 31) == 0) part[(size_t)blockIdx.x * r + (threadIdx.x >> 5)] = a;
}

__global__ void __launch_bounds__(HP_THREADS, 1)
probe_colsum(const double* part, double* out, int r) {
  const int lane = threadIdx.x & 31;
  hp_cols(r, [&](int j) {
    const double v = hp_colsum(part, gridDim.x, r, j);
    if (lane == 0) out[j] = v;
  });
}

__global__ void __launch_bounds__(HP_THREADS, 1)
probe_prows(const double* P, const double* x, double* px, int r, HpGeom g) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j0 = blockIdx.x * g.prb;
  const int j1 = j0 + g.prb < r ? j0 + g.prb : r;
  for (int j = j0 + warp; j < j1; j += HP_WARPS) {
    const double d = hp_dot<true, 8>(P + (size_t)j * r, x, r, lane);
    if (lane == 0) px[j] = d;
  }
}

// strip.cuh's sp_loop (the parent design of the pass: cp.async by every
// thread into two strips, strips handed out round-robin)
__global__ void __launch_bounds__(SP_THREADS, 1)
probe_sp(const double* M, const double* wt, const double* x, double* part,
         int m, int r, SpGeom g) {
  const SpSmem s = sp_smem(g, r);
  const double* xs;
  double* acc;
  sp_begin<false>(s, x, part, r, &xs, &acc);
  sp_loop<true, false>(M, m, r, g, xs, acc, s.tiles, s.ys,
                       [&](int i, double d) { return wt[i] * d; });
  sp_end<false>(s, part, r);
}

// the register form of the pass (hp_apply, no barrier)
template <int NPL>
__global__ void __launch_bounds__(HP_THREADS, 1)
probe_reg(const double* M, const double* wt, const double* x,
          const double* P, double* mx, double* part, double* px, int m,
          int r, HpGeom g) {
  hp_init(r);
  HpSmem s = hp_smem<NPL>(g, r, nullptr, nullptr);
  hp_apply<NPL, false>(g, s, M, wt, P, x, mx, part, px, m, r);
}

// variants of the register form's loop (no P, no mx): V 0 as hop.cu's,
// 1 with a compiler barrier between a row's loads and its arithmetic, 2
// 16-byte loads (another order of the dot: bandwidth only)
template <int NPL, int V, int THREADS>
__global__ void __launch_bounds__(THREADS, 1)
probe_regv(const double* M, const double* wt, const double* x,
           double* part, int m, int r, HpGeom g) {
  extern __shared__ __align__(16) unsigned char raw[];
  double* accw = reinterpret_cast<double*>(raw);
  constexpr int WARPS = THREADS / 32;
  double* xs = accw + WARPS * r;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int j = tid; j < r; j += THREADS) xs[j] = x[j];
  __syncthreads();
  long i0, i1;
  hp_rows(g, m, &i0, &i1);
  const int nm = i0 < i1 ? (int)(i1 - i0) : 0;
  double* aw = accw + (size_t)warp * r;
  for (int j = lane; j < r; j += 32) aw[j] = 0.0;
  for (int t = warp; t < nm; t += WARPS) {
    const double* row = M + (size_t)(i0 + t) * r;
    double v[NPL];
    if (V != 2) {
#pragma unroll
      for (int u = 0; u < NPL; ++u) {
        const int j = lane + 32 * u;
        v[u] = j < r ? __ldcg(row + j) : 0.0;
      }
    } else {
#pragma unroll
      for (int u = 0; u < NPL / 2; ++u) {
        const int j = 2 * lane + 64 * u;
        const double2 q = j + 1 < r ? __ldcg(reinterpret_cast<const double2*>(row + j))
                                    : make_double2(0.0, 0.0);
        v[2 * u] = q.x;
        v[2 * u + 1] = q.y;
      }
    }
    if (V == 1) asm volatile("" ::: "memory");
    double acc = 0.0;
#pragma unroll
    for (int u = 0; u < NPL; ++u)
      if (lane + 32 * u < r) acc = fma(v[u], xs[lane + 32 * u], acc);
    const double y = wt[i0 + t] * ip_warp_sum(acc);
#pragma unroll
    for (int u = 0; u < NPL; ++u) {
      const int j = lane + 32 * u;
      if (j < r) aw[j] = fma(y, v[u], aw[j]);
    }
  }
  __syncthreads();
  for (int j = tid; j < r; j += THREADS) {
    double a = 0.0;
    for (int w = 0; w < WARPS; ++w) a += accw[(size_t)w * r + j];
    part[(size_t)blockIdx.x * r + j] = a;
  }
}

struct SyncArgs {
  int n;
  double* out;
};

__global__ void __launch_bounds__(HP_THREADS, 1) probe_sync(SyncArgs a) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < a.n; ++i) grid.sync();
  if (threadIdx.x == 0) a.out[blockIdx.x] = a.n;
}

}  // namespace

// ms per launch of part `kind` over `reps` launches back to back
IP_API float probe_time(int kind, const double* M, const double* wt,
                        const double* x, const double* P, double* ws,
                        double* mx, double* out, int m, int r, int reps,
                        cudaStream_t st) {
  const HpGeom gl = hp_geom_of(m, r, false), g = gl;
  const SpGeom sg = sp_geom(r, M);
  static int set_sp = -1;
  if (kind == 9) sp_allow(probe_sp, sg.smem, &set_sp);
  double* part = ws;
  static int set[8] = {-1, -1, -1, -1, -1, -1, -1, -1};
  const void* kr = gl.npl == 8    ? (const void*)probe_reg<8>
                   : gl.npl == 16 ? (const void*)probe_reg<16>
                                  : (const void*)probe_reg<32>;
  if (kind == 10 || kind == 15) sp_allow(kr, gl.smem, &set[3 + gl.npl / 8]);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int pass = 0; pass < 2; ++pass) {
    cudaEventRecord(e0, st);
    for (int i = 0; i < (pass ? reps : 2); ++i) {
      switch (kind) {
        case 0:
          ip_h_apply(M, wt, x, P, mx, ws, out, m, r, st);
          break;
        case 4:
          probe_ld<<<g.nblk, HP_THREADS, 0, st>>>(M, part, m, r, g);
          break;
        case 5:
          probe_colsum<<<g.nblk, HP_THREADS, 0, st>>>(part, out, r);
          break;
        case 6:
          probe_prows<<<g.nblk, HP_THREADS, 0, st>>>(P, x, out, r, g);
          break;
        case 10:
        case 15: {
          HpGeom ga = gl;
          const double* Pk = kind == 15 ? nullptr : P;
          double* mk = kind == 15 ? nullptr : mx;
          void* args[] = {&M, &wt, &x, &Pk, &mk, &part, &out, &m, &r, &ga};
          cudaLaunchKernel(kr, dim3(gl.nblk), dim3(HP_THREADS), args, gl.smem,
                           st);
          break;
        }
        case 11:
        case 12:
        case 13:
        case 14: {
          const void* kv[4] = {(const void*)probe_regv<32, 0, 512>,
                               (const void*)probe_regv<32, 1, 512>,
                               (const void*)probe_regv<32, 2, 512>,
                               (const void*)probe_regv<32, 0, 384>};
          const int th = kind == 14 ? 384 : 512;
          const int sm = 8 * (th / 32 + 1) * r;
          static int setv[4] = {-1, -1, -1, -1};
          sp_allow(kv[kind - 11], sm, &setv[kind - 11]);
          HpGeom ga = gl;
          void* args[] = {&M, &wt, &x, &part, &m, &r, &ga};
          cudaLaunchKernel(kv[kind - 11], dim3(gl.nblk), dim3(th), args, sm,
                           st);
          break;
        }
        case 9:
          probe_sp<<<sg.nblk, SP_THREADS, sg.smem, st>>>(M, wt, x, part, m,
                                                         r, sg);
          break;
        default: {
          SyncArgs a{kind == 7 ? 1 : 11, out};
          void* args[] = {&a};
          cudaLaunchCooperativeKernel((const void*)probe_sync, dim3(g.nblk),
                                      dim3(HP_THREADS), args, 0, st);
        }
      }
    }
    cudaEventRecord(e1, st);
    cudaEventSynchronize(e1);
  }
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  if (cudaGetLastError() != cudaSuccess) return -1.f;
  return ms / reps;
}
'''

# the parts timed, by their code in probe_time
KINDS = {"h_apply": 0, "ld": 4, "colsum": 5, "prows": 6, "sync1": 7,
         "sync11": 8, "sp_loop": 9, "reg": 10, "regv0": 11,
         "regv1_fence": 12, "regv2_16B": 13, "regv0_384threads": 14,
         "reg_noP_nomx": 15}
SHAPES = ((2200, 200, False), (4010, 950, True), (11000, 1000, False))


def build() -> ctypes.CDLL:
    from interiorpoint_tpu_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "hop_probe.cu"
    src.write_text(SOURCE.replace("HOP_CU", str(CSRC / "hop.cu")))
    lib = OUT / "libhop_probe.so"
    out = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared",
                          "-Xptxas", "-v", "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    # registers, spills and shared memory of each probe kernel
    (OUT / "ptxas.txt").write_text(out.stderr)
    if out.returncode != 0:
        raise RuntimeError(out.stderr[-3000:])
    h = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    h.probe_time.argtypes = [I] + [P] * 7 + [I] * 3 + [P]
    h.probe_time.restype = ctypes.c_float
    return h


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_hop_probe: torch.cuda.is_available() is "
                         "false; the probe needs a GPU")
    sys.path.insert(0, str(ROOT))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    h = build()
    stream = torch.cuda.current_stream().cuda_stream
    for m, r, with_p in SHAPES:
        rng = np.random.default_rng(m + r)
        dev = dict(dtype=torch.float64, device="cuda")
        M = torch.as_tensor(rng.uniform(-1, 1, (m, r)), **dev)
        wt = torch.as_tensor(rng.uniform(0.1, 2.0, m), **dev)
        x = torch.as_tensor(rng.standard_normal(r), **dev)
        P = torch.eye(r, **dev) * 2.0 if with_p else None
        ws = torch.zeros((256 + 1) * r, **dev)
        mx, out = torch.empty(m, **dev), torch.empty(r, **dev)

        def t(i):
            return h.probe_time(i, M.data_ptr(), wt.data_ptr(), x.data_ptr(),
                                None if P is None else P.data_ptr(),
                                ws.data_ptr(), mx.data_ptr(), out.data_ptr(),
                                m, r, 50, stream)

        ms = {k: t(i) for k, i in KINDS.items()
              if (k != "prows" or P is not None)
              and (not k.startswith("regv") or r > 512)}
        torch.cuda.synchronize()
        print(json.dumps({"shape": [m, r], "P": with_p,
                          "bytes": 8 * m * r, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
