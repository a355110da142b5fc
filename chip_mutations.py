#!/usr/bin/env python3
"""Mutation check of chip_smoke.py's kernel checks (K1, K2, K3a, K4, K5)
on one NVIDIA H100: each mutant is a copy of the checkout with one kernel
or its orchestration deliberately broken; the rows of its step run on it
with every failed check collected (K1: the fused operator and refined
solve of csrc/hop.cu, held by K1's checks at the first states of
lp1000_auto and qp1000_pd and by phase_h_apply_wide; K2: the seeded K2
preconditioner checks (its branches among them: ``k2_branches``),
lp1000_barrier and qp1000_barrier and their K2 checks; K3b: the
factor, inverse and solve checks; K3b wide: the solve's checks at p > 1
(phase_k3b_wide: wsolve.cu's kernel and chol.cu's 8-column one); K3b
column: the solve's checks at p = 1 (phase_column_solve: csolve.cu's
kernel and chol.cu's one-column tasks past it, K2's LDL solve and K3b);
K3a: the factor and inverse checks in
fp32 and fp64,
then socp1000_pd_full and its K5 checks; K4: the SOCP reference,
socp1000_barrier and its K4 checks; K5: the SOCP reference, socp1000_pd,
then socp1000_pd_full and lp1000_pd_eq with their K5 checks and the
pe = 90 direction; harness: the harness phase, entry(), the dry run and
the three examples with their checks).

    python3 chip_mutations.py [MUTANT ...]     # needs one GPU and nvcc

The copies go under interiorpoint_tpu_torch/_build/mutants/ (git-ignored)
and each builds its own library.  Prints one JSON line per mutant (the
checks that failed) and exits non-zero if a mutant passed every check.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ROWS_CU = "interiorpoint_tpu_torch/csrc/rows.cu"
CHOL_CU = "interiorpoint_tpu_torch/csrc/chol.cu"
CONES_CU = "interiorpoint_tpu_torch/csrc/cones.cu"
KKT_CU = "interiorpoint_tpu_torch/csrc/kkt.cu"
KKT_PY = "interiorpoint_tpu_torch/ops/kkt_step.py"
LDL_CU = "interiorpoint_tpu_torch/csrc/ldl.cu"
HOP_CU = "interiorpoint_tpu_torch/csrc/hop.cu"
WSOLVE_CU = "interiorpoint_tpu_torch/csrc/wsolve.cu"
CSOLVE_CU = "interiorpoint_tpu_torch/csrc/csolve.cu"

# name -> (step whose rows and checks run, source, exact text, replacement)
# or (step, [(source, exact text, replacement), ...]) for several edits
MUTANTS = {
    "pass1_drops_last_row_weight": (
        "K2", ROWS_CU, "      w[i] = isi * isi;",
        "      w[i] = i == k - 1 ? 0.0 : isi * isi;"),
    "sweep_phisum_skips_block_last_row": (
        "K2", ROWS_CU,
        "for (int q = 0; q < n; ++q) acc += ip_phi(sj * su[q]);",
        "for (int q = 0; q < n - 1; ++q) acc += ip_phi(sj * su[q]);"),
    "sweep_umax_skips_block_last_row": (
        "K2", ROWS_CU,
        "for (int q = 0; q < n; ++q) M = ip_nanmax(M, su[q]);",
        "for (int q = 0; q < n - 1; ++q) M = ip_nanmax(M, su[q]);"),
    "select_takes_smallest_accepted": (
        "K2", ROWS_CU, "        idx = j;\n        break;",
        "        idx = j;"),
    # W = L^-1 leaves out the term L_{i,i-1} W_{i-1,k} of every block
    # W_ik with i - k >= 2 (the task i == j + 1 only finishes W_jk)
    "inverse_skips_last_block_term": (
        "K2", CHOL_CU, "        if (i == j) {",
        "        if (i <= j + 1) {"),
    "cone_ssq_skips_last_row": (
        "K4", CONES_CU,
        "for (int m = threadIdx.x; m < M; m += CONE_THREADS)\n"
        "    acc = fma(l[m], l[m], acc);",
        "for (int m = threadIdx.x; m < M - 1; m += CONE_THREADS)\n"
        "    acc = fma(l[m], l[m], acc);"),
    "cone_sweep_drops_rhs_domain_test": (
        "K4", CONES_CU, "vmin[j] > DOMAIN_MARGIN - 1.0 &&", "true &&"),
    "cone_g_drops_rhs_c": (
        "K4", CONES_CU, "const double gk = a - rhs[k] * c[(size_t)k * r + j];",
        "const double gk = a;"),
    # the 64 x 64 diagonal block's inverse drops one off-diagonal term of
    # its lower-left 32 x 32 block, -W_B (L_BA W_A): the last of each
    # entry's 32 (both precisions)
    "diag_inverse_drops_off_diagonal_term": (
        "K3a", CHOL_CU, "blk<T, false>(c, Xs, rl, 32, Xs, 32, cl, 32);",
        "blk<T, false>(c, Xs, rl, 32, Xs, 32, cl, 31);"),
    # the fp64 DMMA tile product of the trailing update (and the panel)
    # skips its first k-slice of 4
    "dmma_update_skips_k_slice": (
        "K3a", CHOL_CU, "for (int k0 = 0; k0 < BLK; k0 += 4) {",
        "for (int k0 = 4; k0 < BLK; k0 += 4) {"),
    # the panel below each 16-wide leaf of the diagonal block leaves out
    # the leaf's last column's term of every substitution step
    "leaf_panel_drops_last_column_term": (
        "K3a", CHOL_CU,
        "for (int c = j + 1; c < 16; ++c) v[c] = fma(-v[j], L[c * LD + j]",
        "for (int c = j + 1; c < 15; ++c) v[c] = fma(-v[j], L[c * LD + j]"),
    # the factor's ordering: a worker's panel L_ik reads Dinv_k without
    # waiting for the owner's flag on tile (k, k) (column 0's panels start
    # while the owner still factors tile (0, 0))
    "panel_reads_dinv_before_diag_flag": (
        "K3a", CHOL_CU, "      wait_count(a, k, k, k + 1);\n", ""),
    # the Schur build leaves out F's last row (Y's last column is zero)
    "kkt_schur_drops_last_f_row": (
        "K5", KKT_CU, "Fs[jj][ii] = (a < pe && j < r)",
        "Fs[jj][ii] = (a < pe - 1 && j < r)"),
    # the Schur-CG operator skips the Ds scaling on its right side (in
    # the orchestration both versions share)
    # a K3b task reads the tile y_j of the forward sweep without waiting
    # for its flag
    "k3b_owner_reads_before_flag": (
        "K3b", CHOL_CU, "      wait_flag(fwd + j * nch + t % nch, epoch);\n",
        ""),
    # the one-column solve (csrc/csolve.cu): an owner leaves out the row
    # partial of its highest-ranked helper (a far tile's L_ij y_j)
    "column_drops_last_helper_partial": (
        "K3b column", CSOLVE_CU,
        "        for (unsigned m = hm; m; m &= m - 1)\n"
        "          pre[r] -= pf[",
        "        for (unsigned m = hm & ~(0x80000000u >> __clz(hm)); m;\n"
        "             m &= m - 1)\n"
        "          pre[r] -= pf["),
    # the forward diagonal product F_i applied to b_i before the row's
    # partial sums are taken off (y_i = F_i b_i - sum, not F_i (b_i - sum))
    "column_diag_before_partials": (
        "K3b column", CSOLVE_CU, [
            ("      const float v = pre[r] - red_q(acc[r]);",
             "      const float v0 = red_q(acc[r]);\n"
             "      const float v = F ? pre[r] : pre[r] - v0;"),
            ("        const float y = red_q(dot_fr<TE>(fd[r], vb, fq));",
             "        const float y =\n"
             "            red_q(dot_fr<TE>(fd[r], vb, fq)) - v0;")]),
    # the ragged last block row (n not a multiple of the tile edge) reads
    # its b as zeros
    "column_skips_ragged_last_row": (
        "K3b column", CSOLVE_CU,
        "      pre[r] = r < Rg && row < n ? __ldg(a.B + row) : 0.f;",
        "      pre[r] = r < Rg && row < n - n % TE ? __ldg(a.B + row) : 0.f;"),
    # chol.cu's 8-column tasks (the solve at p > 1 past the wide kernel's
    # rows): the backward sweep leaves out the last block row's term
    # L_ji^T x_j (at n = 4161 its one ragged row)
    "chunked_backward_skips_last_block_row": (
        "K3b wide", CHOL_CU,
        "    for (int j = nb - 1; j > i; --j) {\n      float lr[SEG];",
        "    for (int j = nb - 1 - (PC > 1); j > i; --j) {\n"
        "      float lr[SEG];"),
    # the same at one column a task (the solve at p = 1 past csolve.cu's
    # rows: n = 1100 and np = 1152 of phase_column_solve)
    "chunked_one_column_skips_last_block_row": (
        "K3b column", CHOL_CU,
        "    for (int j = nb - 1; j > i; --j) {\n      float lr[SEG];",
        "    for (int j = nb - 1 - (PC == 1); j > i; --j) {\n"
        "      float lr[SEG];"),
    # the wide solve (csrc/wsolve.cu): the last column of a ragged chunk
    # (p not a multiple of W) is neither kept nor written
    "wide_drops_ragged_chunk_last_column": (
        "K3b wide", WSOLVE_CU,
        "        const bool in = row < a.n && col < a.p;",
        "        const bool in =\n"
        "            row < a.n && col < a.p - (c0 + W > a.p ? 1 : 0);"),
    # a consumer takes the ring slot of the next stage: a staged sub-tile
    # consumed one stage early, before it has landed
    "wide_consumes_stage_early": (
        "K3b wide", WSOLVE_CU, "    return ring + q * Gm::SLOT;",
        "    return ring + (stage % WS_STAGES) * Gm::SLOT;"),
    # the backward sweep stages L_i'j (untransposed) where it needs L_ji'
    "wide_backward_reads_l_untransposed": (
        "K3b wide", WSOLVE_CU,
        "    r0 = col ? w.j * TE + w.kc * Gm::KC : ip * TE;\n"
        "    c0 = col ? ip * TE : w.j * TE + w.kc * Gm::KC;",
        "    r0 = col ? ip * TE + w.kc * Gm::KC : ip * TE;\n"
        "    c0 = col ? w.j * TE : w.j * TE + w.kc * Gm::KC;"),
    # the Newton-Schulz tile inverse stops one iteration early (at 1e-4,
    # not 1e-6) and accepts every finite tile
    "ns_tile_stops_early_without_gate": ("K2", [
        (LDL_CU, "it < NS_ITERS && f2 > NS_TOL2",
         "it < NS_ITERS && f2 > 1e2f * NS_TOL2"),
        (LDL_CU, "const bool miss = !(f2 <= NS_GATE2);",
         "const bool miss = !isfinite(f2);")]),
    # the workers' first task (stage 0, rows 0-31 of tile (2, 1)) leaves
    # its rows un-updated (np >= 384: the synthetic factors at 512, 1024)
    "ldl_update_skips_a_tile": (
        "K2", LDL_CU,
        "a.A[(size_t)gi * np + gj] = cur[u] - O[(e / TB) * TLD + e % TB];",
        "a.A[(size_t)gi * np + gj] =\n"
        "                cur[u] - (t == 0 ? 0.f : O[(e / TB) * TLD + e % TB]);"),
    # the carry is accepted (and stops) at ||I - Hs X||_F^2 < 1e-2
    "carry_accepts_above_gate": (
        "K2", LDL_CU, "constexpr float CARRY_GATE2 = 1e-4f;",
        "constexpr float CARRY_GATE2 = 1e-2f;"),
    # look-ahead ordering: tile 1's inverse starts from tile (1, 1) as it
    # was before stage 0's update landed (the source, not the working copy)
    "lookahead_inverts_tile_before_update": (
        "K2", LDL_CU,
        "k == 0 ? a.src : a.A, np, k0, k0, TB, k == 0 ? a.delta : 0.f",
        "k <= 1 ? a.src : a.A, np, k0, k0, TB, k <= 1 ? a.delta : 0.f"),
    # the cluster exchange of the tile inverse drops its barrier: a block
    # reads the other blocks' shares of the residual and rows of X'
    # without waiting for them to be written
    "ns_exchange_drops_cluster_barrier": (
        "K2", LDL_CU,
        "      // the next block's rows on)\n      cl.sync();\n",
        "      // the next block's rows on)\n"),
    # K2's decisions on the device: the refined solve reads the form of
    # the preconditioner wrongly (always the W-solve, never K2's X)
    "k2_form_always_w": (
        "K2", HOP_CU, "const int form = KF && a.kind ? *a.kind : 0;",
        "const int form = 0;"),
    # the device pivot floor on the fallback's first rung never sets its
    # flag (the rung is kept by finiteness alone)
    "k2_pivot_floor_dropped": (
        "K2", CHOL_CU, "if (threadIdx.x == 0 && hit) *bad = 1;",
        "if (threadIdx.x == 0 && hit && bad == nullptr) *bad = 1;"),
    # the LDL re-seed M^-1 I ignores its flag: it runs after a carry hit
    # too, over the refreshed X, from a factor that was skipped
    "k2_reseed_ignores_skip": (
        "K2", WSOLVE_CU, "  if (a.run && *a.run == 0) return;\n",
        "\n"),
    # the PCG's keep test inverted: a PCG that lowered the residual is
    # dropped, one that did not is kept
    "k2_pcg_keep_inverted": (
        "K2", HOP_CU, "    kept = s2 < s0;", "    kept = !(s2 < s0);"),
    # the fused refined solve runs one more round after its exit test
    # fires
    "refined_solve_exits_one_round_late": (
        "K1", HOP_CU, "      exited = true;\n      break;",
        "      if (exited) break;\n      exited = true;"),
    # the fused operator gives the last rows (16 of them) weight 0
    "h_apply_drops_last_strip_weight": (
        "K1", HOP_CU, "const double y = wt[i0 + t] * d;",
        "const double y = i0 + t >= m - 16 ? 0.0 : wt[i0 + t] * d;"),
    # the side channel keeps M x of the previous round when the solve runs
    # all its rounds
    "side_channel_of_previous_round": (
        "K1", HOP_CU, "    op(a.x, a.mx);",
        "    op(a.x, it + 1 < a.refine ? a.mx : mx2);"),
    # the pass with rows read in place (rows past the register form: the
    # wide shapes and the 3000 x 1200 check of phase_h_apply_wide) leaves
    # the last row of each group of 12 out of the column sums
    "in_place_pass_drops_group_last_row": (
        "K1", HOP_CU, "for (int rr = 0; rr < h; ++rr)",
        "for (int rr = 0; rr < h - 1; ++rr)"),
    # the even split of M's rows leaves out the matrix's last row (the
    # last block that has rows)
    "even_split_drops_last_row": (
        "K1", HOP_CU, "*i1 = *i0 + g.rpb < m ? *i0 + g.rpb : m;",
        "*i1 = *i0 + g.rpb < m ? *i0 + g.rpb : m - 1;"),
    # the W-solve's column sums leave out block 0's band of W (rows
    # [0, R_1)) from W^T u
    "w_band_of_block_zero_skipped": (
        "K1", HOP_CU, "if (bb < nb && band[bb + 1] > j)",
        "if (bb > 0 && bb < nb && band[bb + 1] > j)"),
    "schur_cg_skips_right_ds": (
        "K5", KKT_PY,
        "return ds * ops.c_matvec(F, solve(ops.ct_matvec(F, ds * y))[0])",
        "return ds * ops.c_matvec(F, solve(ops.ct_matvec(F, y))[0])"),
    # the mixed KKT solve skips its fp64 factor when the refinement's
    # residual is not finite (an fp32 factor that passes with a pivot at
    # rounding level, as K3a's does in the distributed demo's batch LP)
    "mixed_solve_keeps_nonfinite_residual": (
        "harness", "interiorpoint_tpu_torch/ops/kkt.py",
        "sync.read(~(rn <= 1e-10 * bnorm))", "sync.read(rn > 1e-10 * bnorm)"),
    # pass1_drops_last_row_weight's edit, driven through the harness: the
    # kernel checks at the examples' shapes (among them the four steps
    # along the route where H is singular) catch it, not only the answers
    "harness_pass1_drops_last_row_weight": (
        "harness", ROWS_CU, "      w[i] = isi * isi;",
        "      w[i] = i == k - 1 ? 0.0 : isi * isi;"),
}

# Run inside a K2 mutant: the barrier rows and their K2 checks, every check
# collected instead of raised.
DRIVE = r'''
import json
import chip_smoke as cs
from scipy.optimize import linprog
fails = []
cs.check = lambda cond, msg: None if cond else fails.append(msg[:400])
cs.emit = lambda obj: None
cs.phase_device()
cs.phase_build()
p = cs.lp_recipe(1000)
ref = linprog(p["c"], A_ub=p["C"], b_ub=p["d"], A_eq=p["A"], b_eq=p["b"],
              bounds=[(-3, 3)] * 1000, method="highs")
refs = {"highs_lp1000": float(ref.fun),
        "qp1000_pd": cs.make_solver("qp1000_pd", "cuda").solve()}
cs.phase_k2_synthetic({})
for row in ("lp1000_barrier", "qp1000_barrier"):
    solver, _ = cs.drive_row(row, refs)
    for state in cs.k2_states(row, solver):
        cs.k2_check(row, *state, solver.cfg)
print(json.dumps({"fails": fails}))
'''
# Run inside a K3b mutant: the factor, inverse and solve checks at the
# main path's sizes, every check collected.
DRIVE_K3B = r'''
import json
import chip_smoke as cs
fails = []
cs.check = lambda cond, msg: None if cond else fails.append(msg[:400])
cs.emit = lambda obj: None
cs.phase_device()
cs.phase_build()
cs.phase_k3({})
print(json.dumps({"fails": fails}))
'''
# Run inside a mutant of the one-column solve: its checks at p = 1 (K2's
# LDL solve and K3b, phase_column_solve), every check collected.
DRIVE_K3B_COLUMN = r'''
import json
import chip_smoke as cs
fails = []
cs.check = lambda cond, msg: None if cond else fails.append(msg[:400])
cs.emit = lambda obj: None
cs.phase_device()
cs.phase_build()
cs.phase_column_solve({})
print(json.dumps({"fails": fails}))
'''
# Run inside a mutant of the wide solve: its checks at p > 1 (K3b at the
# LASSO ladder's width and the other widths, the LDL reseed), every check
# collected.
DRIVE_K3B_WIDE = r'''
import json
import chip_smoke as cs
fails = []
cs.check = lambda cond, msg: None if cond else fails.append(msg[:400])
cs.emit = lambda obj: None
cs.phase_device()
cs.phase_build()
cs.phase_k3b_wide({})
print(json.dumps({"fails": fails}))
'''

# Run inside a K4 mutant: the SOCP reference (full-space engine, no K4),
# socp1000_barrier and its K4 checks, every check collected.
DRIVE_K4 = r'''
import json
import chip_smoke as cs
fails = []
cs.check = lambda cond, msg: None if cond else fails.append(msg[:400])
cs.emit = lambda obj: None
cs.phase_device()
cs.phase_build()
refs = {}
cs.socp_reference(refs)
solver, _ = cs.drive_row("socp1000_barrier", refs)
for state in cs.k4_states(solver):
    cs.k4_check("socp1000_barrier", *state, solver.cfg)
print(json.dumps({"fails": fails}))
'''
# Run inside a K5 mutant: the SOCP reference, socp1000_pd (the reference
# of socp1000_pd_full; no equality block, so no Schur build), then the two
# rows with an equality block and their K5 checks, every check collected.
DRIVE_K5 = r'''
import json
import chip_smoke as cs
from scipy.optimize import linprog
fails = []
cs.check = lambda cond, msg: None if cond else fails.append(msg[:400])
cs.emit = lambda obj: None
cs.phase_device()
cs.phase_build()
p = cs.lp_recipe(1000)
ref = linprog(p["c"], A_ub=p["C"], b_ub=p["d"], A_eq=p["A"], b_eq=p["b"],
              bounds=[(-3, 3)] * 1000, method="highs")
refs = {"highs_lp1000": float(ref.fun)}
cs.socp_reference(refs)
cs.drive_row("socp1000_pd", refs)
for row in ("socp1000_pd_full", "lp1000_pd_eq"):
    solver, _ = cs.drive_row(row, refs)
    states = cs.k5_states(solver)
    for label, state in states.items():
        cs.k5_check(row, label, *state)
    if row == "lp1000_pd_eq":
        cs.k5_check(row, "pe90", *cs.pe90_state(states["first"]))
print(json.dumps({"fails": fails}))
'''
# Run inside a K3a mutant: the factor and inverse checks in both precisions
# at the main path's sizes, then the K5 row with an equality block of
# pe = 50 (fp64 factors of H and S) and its K5 checks, every check
# collected.
DRIVE_K3A = r'''
import json
import chip_smoke as cs
fails = []
cs.check = lambda cond, msg: None if cond else fails.append(msg[:400])
cs.emit = lambda obj: None
cs.phase_device()
cs.phase_build()
cs.phase_k3({})
refs = {}
cs.socp_reference(refs)
cs.drive_row("socp1000_pd", refs)
solver, _ = cs.drive_row("socp1000_pd_full", refs)
for label, state in cs.k5_states(solver).items():
    cs.k5_check("socp1000_pd_full", label, *state)
print(json.dumps({"fails": fails}))
'''
# Run inside a K1 mutant (the fused operator and refined solve, shared by
# K1 and K4): K1's pieces, its fused operator and refined solve checks and
# whole steps at the two n = 1000 primal-dual rows' first states, then
# the operator at the wide shapes and both entries at 3000 x 1200, where
# rows are read in place (phase_h_apply_wide), every check collected.
DRIVE_K1 = r'''
import json
import chip_smoke as cs
fails = []
cs.check = lambda cond, msg: None if cond else fails.append(msg[:400])
cs.emit = lambda obj: None
cs.phase_device()
cs.phase_build()
cs.ROWS = ("lp1000_auto", "qp1000_pd")
cs.phase_k1({})
cs.phase_h_apply_wide({})
print(json.dumps({"fails": fails}))
'''
# Run inside a harness mutant: the harness phase (entry(), the dry run and
# the three examples with their checks), every check collected.
DRIVE_HARNESS = r'''
import json
import chip_smoke as cs
fails = []
cs.check = lambda cond, msg: None if cond else fails.append(msg[:400])
cs.emit = lambda obj: None
card = cs.phase_device()
cs.phase_build()
cs.phase_harness({}, card)
print(json.dumps({"fails": fails}))
'''
DRIVES = {"K1": DRIVE_K1, "K2": DRIVE, "K3a": DRIVE_K3A, "K3b": DRIVE_K3B,
          "K3b wide": DRIVE_K3B_WIDE, "K3b column": DRIVE_K3B_COLUMN,
          "K4": DRIVE_K4, "K5": DRIVE_K5,
          "harness": DRIVE_HARNESS}


def edits(name: str):
    """[(source, exact text, replacement)] of a mutant."""
    spec = MUTANTS[name]
    if len(spec) == 3 and isinstance(spec[2], list):   # one source, edits
        return [(spec[1], old, new) for old, new in spec[2]]
    return spec[1] if len(spec) == 2 else [spec[1:]]


def make_mutant(name: str) -> Path:
    dst = ROOT / "interiorpoint_tpu_torch" / "_build" / "mutants" / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT, dst, ignore=shutil.ignore_patterns(
        ".git", "_build", "_archive", "chiprun_out", "__pycache__"))
    for path, old, new in edits(name):
        src = (dst / path).read_text()
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the text to break is not in {path} "
                               "exactly once")
        (dst / path).write_text(src.replace(old, new))
    return dst


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_mutations: torch.cuda.is_available() is "
                         "false; the mutants need a GPU")
    names = argv or list(MUTANTS)
    for name in names:
        if name not in MUTANTS:
            raise SystemExit(f"unknown mutant {name!r}")
    missed = []
    for name in names:
        dst = make_mutant(name)
        try:
            out = subprocess.run([sys.executable, "-c",
                                  DRIVES[MUTANTS[name][0]]], cwd=dst,
                                 capture_output=True, text=True,
                                 timeout=900)
        except subprocess.TimeoutExpired:
            # a mutant that stalls the run is caught too
            out = None
        lines = [] if out is None else [
            ln for ln in out.stdout.splitlines()
            if ln.startswith('{"fails"')]
        # a mutant that crashes the run is caught too
        fails = (json.loads(lines[-1])["fails"] if lines
                 else ["run timed out"] if out is None
                 else ["run failed: " + out.stderr[-600:]])
        print(json.dumps({"mutant": name, "caught": bool(fails),
                          "fails": fails}), flush=True)
        shutil.rmtree(dst, ignore_errors=True)
        if not fails:
            missed.append(name)
    print(json.dumps({"ok": not missed, "missed": missed}), flush=True)
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
