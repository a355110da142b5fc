#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (interiorpoint_tpu_torch) on one NVIDIA
H100 and check it.

    python3 chip_smoke.py            # needs one GPU and nvcc
    python3 chip_smoke.py --profile [ROW ...]

With ``--profile`` it runs phases 1 and 2 and then, for each named row
(default lp1000_barrier and lp5000_barrier), one warm-up solve and one
solve under torch.profiler, and prints the kernels' device time, its
share of the solve's wall time and the top kernels by device time.

Phases, in order; any failure raises and exits non-zero:

1. Device: a CUDA device of capability (9, 0); prints its name and power
   limit as nvidia-smi gives them.
2. Build: compiles csrc/*.cu with nvcc for sm_90a (kernels/_build.py).
3. Kernel against plain version on the card, from seeded numpy inputs:
   the blocked Cholesky factor and its inverse W = L⁻¹ (K3a) in fp32 and
   in fp64 (one cooperative launch each, counted), each held by its
   backward error against the plain version's, and the solve (K3b, one
   launch) by backward error at n = 200, 800, 1000, 1100 (the main
   path's warm-start and dual-recovery sizes, none a multiple of the
   64-wide block; after the rows, again at the widest right-hand side
   the main path gave it; at p = 1 also K2's LDL solve at np = 256, 512,
   1024 and both past the one-cluster kernel's capacity,
   ``phase_column_solve``), each also beside one PyTorch call that
   computes the same function (torch.linalg.cholesky,
   torch.cholesky_solve; timed only); the fp32 Gram at 2200×200 and
   11000×1001 (against plain and fp64, beside fp32 torch.matmul); K2's
   preconditioner on seeded inputs (the block-LDL factor with
   Newton–Schulz tile inverses and its solve at np = 256, 512 and 1024,
   an Hs refused at a late tile, the carry trial's hit and 12-iteration
   miss at np = 256 and 512: flags, ‖I − M⁻¹Hs‖_F, hits, each tile's
   iterations; and the whole preconditioner with its branch decided on
   the device, ``k2_branches``: a carry hit, LDL rung 0, LDL rung 1 and
   the Cholesky fallback with rung 0 refused by the pivot floor, each the
   plain twin's branch and form with no host read, and the refined solve
   on it, a PCG run among them; ip_k2_decide and ip_pivot_floor against
   their twins); the fused
   operator of K1 and K4 at two widths past the main path's, where the
   pass reads rows in place and then keeps x in global memory, and both
   it and the refined solve at 3000×1200, past the register form, where
   the pass reads rows in place with x in shared memory; and,
   at the
   three primal-dual row shapes from each row's
   own first state, every piece of the primal-dual step
   (K1: pass 1 with Cᵀλ, the right-hand side with Cᵀt and the ds pass
   from C·dz, the fp32 Gram, equilibration, factor, inverse and W-solve;
   the fused operator ip_h_apply, H x and M x; the refined solve
   ip_refined_solve with its counts, its fp64 residual and its side
   channel M·x bitwise equal to a fresh ip_h_apply, also on a worse
   preconditioner that drives the PCG; and, at the first row, the jitter
   ladder on the device on a seeded Hs that fails rung 0) on shared
   inputs, each timed (``pieces_ms``), then one whole step; CUDA kernels
   against their plain PyTorch versions on the same GPU.  The whole step
   must make no host read and take the same jitter rung and, per
   direction, the same solve counts (refinement rounds, stalled, PCG
   rounds, PCG kept) as its plain version at the main path's own
   direction gate, so that a worse preconditioner fails even where the
   fp64 refinement would pull its answer back.
   Times are CUDA-event medians of 7 runs after a warm-up.
4. Main path, one row at a time, every kernel counter set to 0 just
   before the row's first solve and read just after it (each kernel of
   the row must have launched, no plain version may have run, in the
   first solve or in the three timed ones):
   a. the primal-dual rows lp1000_auto, qp1000_pd, lp5000_pd, cross-
      checked against HiGHS (LP n=1000), the port's own CPU solve (QP)
      and an fp64 KKT certificate (LP n=5000);
   b. the barrier rows lp1000_barrier, qp1000_barrier, lp5000_barrier
      (the default algorithm) and lp1000_phase1 (an explicit in-bounds x0
      whose projection is infeasible, so phase one runs first), held
      against HiGHS within the reported duality gap, against the pd rows'
      values, and by the equality and bound residuals at n=5000;
   c. after each barrier row, the barrier Newton step K2 and its
      direction K2d at the row's shape, from the state its first Newton
      step saw (the warm start at t0, or phase one's start on [C | −1])
      and from the row's last state (its final iterate and t, where the
      deep stage's conditioning brings in the PCG escalation): pass 1
      over C, the gradient, the Gram with w = 1/s², the direction's
      refined solve (by its fp64 residual) and the line-search sweep
      (per-candidate Σφ, max u, also with the largest u rolled onto a
      block's edge row, selection, x') on shared inputs; C·dx read from
      the refinement's last operator pass against a fresh pass; K2's
      preconditioner (``k2_preconditioner``: the LDL rungs' flags and
      ‖I − M⁻¹Hs‖_F, or the Cholesky fallback's rungs, and the carry
      trial from this state's seed toward the next state; where the two
      LDL factors' flags differ, ``ldl_dispute`` holds the CUDA one on
      its own intermediates, and the whole steps below are held against
      the plain step on the CUDA step's preconditioner); the
      whole step at the path's own direction gate (the same candidate
      index; no host read in the CUDA step, the same preconditioner
      branch, Cholesky rungs and refined-solve counts, see
      ``reads_check``; no host read, and no other operation that waits
      for the device (``hidden_syncs``), in a step, a direction or two
      carried steps) and at a strict gate (x' to 1e-9, against the plain
      step on the CUDA preconditioner applied in the CUDA solve's order
      where the reference solve stops above its exit, and the Newton
      decrement to 1e-9 beyond its first-order sensitivity to the two
      versions'
      differences in g and w); the direction alone (its g within the
      rounding bound, its dx by its fp64 residual); the refined solve on
      the step's own preconditioner (its form, counts and times).  The
      rows' first solves make one host read a K2 step (``sync_sites``).
   d. the SOCP rows socp1000_barrier (bench_socp(1000)'s settings, with
      the dual recovery, so K3 runs) and socp1000_phase1 (an explicit x0
      whose projection onto Fx = g leaves the cones, so phase one runs
      first, on the oracle path): K4 must take every main-stage Newton
      step; each value is held within the reported gap (+1e-8 rel) of the
      same instance solved by the full-space engine on the card
      (socp1000_full: no reduction, no K4, solved before the rows), and
      the point by an fp64 certificate (every cone slack and rhs > 0,
      ‖Fx − g‖∞ ≤ 1e-8·scale).
   e. after socp1000_barrier, the SOCP Newton step K4 from the state its
      first step saw and from the row's last state: pass 1 (lhs, rhs, the
      per-cone Σ lhs², s, w, the gathered row weights), G and the
      gradient on shared inputs, the Gram of the stacked [A; c; G], the
      direction by its fp64 residual, the fused operator and the refined
      solve on the stacked matrix (as K1's), the line-search coefficients
      from A·dx, the sweep (Σφ, the domain minima, selection, x'; also on
      coefficients where only the rhs ≥ 0 test decides), each timed, and
      whole steps at the path's gate (no host read, the same rung and
      solve counts) and a strict one.
   f. the dense-KKT rows, through K5 on every direction (no plain version
      may run, and K1 not at all): socp1000_pd (bench.py:716's row,
      ``SOCPSolver(algorithm="pd")`` on bench_socp(1000) with the duals:
      the reduced problem, K5 with no equality block, r = 950), held
      within the two gaps (+1e-8 rel) of socp1000_full, by the SOCP
      certificate and by ‖Fx − g‖∞ after the expansion;
      socp1000_pd_full (the same with ``reduced=False``: F as K5's
      equality block, r = 1000, pe = 50), held within the gaps of
      socp1000_pd's value and by the certificate; lp1000_pd_eq
      (``solve_lp(..., algorithm="pd", epsilon=1e-6)`` on bench_lp(1000)'s
      data: 800 equalities, C stacked with the box, r = 1000, pe = 800),
      held within 1e-6 relative of HiGHS and by the KKT certificate.
      Each prints its K5 launches, factorizations (one per Newton
      matrix: held), Schur-CG rounds and refined H-solves per direction
      and host syncs per iteration.
   g. after each K5 row, K5 against its plain version from the row's
      first and last K5 direction, all in fp64: the equilibration of H,
      the H factor and W by backward error, the Schur build Y and
      S = YᵀY against the plain products within the rounding of an
      r-term sum, S's equilibration, factor and inverse, a refined
      H-solve by its fp64 residual, then whole directions: one
      factorization each, equal Schur-CG round counts (reported instead
      where a factor's last pivot sits at rounding level and the versions
      take different jitter rungs), dx and dy within 1e-11 of a dense
      fp64 solve of the KKT matrix (at the last state, where that solve
      is itself off by cond·u, within 2·cond(K, x)·u, Skeel's condition
      of the KKT matrix, if that is larger) and
      rn2 ≤ 1e-18·bn2 + 1e-20; also one
      direction with pe = 90 (the S factor crosses a 64-wide block edge).
      Each state is timed for K5 (prepare and direction), the direction
      alone on prepared factors, its plain version and
      torch.linalg.solve on the fp64 KKT matrix (on H when pe = 0).
   h. the LASSO row lasso1000 (bench.py:150-160's bench_lasso(1000):
      A of 2400 x 1000 with the bias column, n = 1001, 30 samples, fp64,
      the default adaptive ρ and relax): its first solve builds the
      ladder of five Q⁻¹ through K3a and K3b (p = n = 1001) with no plain
      version, then the ADMM iterations; each rung's Q⁻¹ is held by
      ‖QX − I‖_F/‖I‖_F ≤ 1e-12 beside the plain path's ladder on the
      card, the iterations must equal the port's CPU solve of the same
      instance (solved before the rows) and X agree with it to 1e-8; it
      prints the subgradient residual, the host syncs and the peak
      device memory, and times K3a and K3b on its first rung's inputs.
   i. after lp1000_barrier and socp1000_barrier, ``certify`` of the
      solved driver (its tensors on the card) against the certificate of
      a copy of the driver with its problem on the CPU (1e-12), the point
      strictly interior and feasible.
   Every row prints its iterations, Newton steps, host syncs, first-solve
   seconds and the median of three steady-state solves; the K2 rows also
   K2's preconditioner branches (carry hits, which must be at least one
   at r ≤ 512, LDL rungs, Cholesky fallbacks), the fallback's factor and
   inverse launches inside K2's steps (one inverse and one to four factor
   rungs per fallback: held) and C·dx's sources.

5. Utilities on the card: a mid-solve checkpoint of lp1000_barrier
   (``solve(max_outer_iters=..., checkpoint_path=...)``) resumed in a
   fresh solver (``resume=True``) takes the uninterrupted solve's stages,
   Newton steps and value (1e-12; bitwise equality reported), and
   tests/data/miplib/flow40.npy through ``miplib.solve_lp_npy`` on the
   barrier and pd engines agrees with HiGHS (1e-4 and 1e-8) at a
   feasible point.

6. parallel/ (``phase_parallel``, after the main path; counters set to 0
   just before each row's first call and read just after): the batch
   rows, ``solve_batch`` over eight instances on the card's mesh, each
   instance bitwise its single-instance call: batch8_lp_barrier (K2; K2
   on [C | −1] in instance 3's phase one; within the gap + 1e-9 rel of
   HiGHS), batch8_lp_pd (K1; 1e-6 of HiGHS), batch8_lp_pd_eq (K5;
   instance 0 within 1e-9 of lp1000_pd_eq, every instance by the KKT
   certificate), batch8_socp_barrier (K4 on the reduced problems; the
   cone certificate, instance 0 against socp1000_full), each timed as
   the median of 3 after the first call; lasso1000_sharded
   (``solve_lasso_sharded`` on a one-card mesh: the K3a/K3b ladder, the
   iterations of lasso1000, X within 1e-12 of ``solve_lasso``); then on a
   one-rank NCCL group the script creates: dist_lp5000_barrier/_pd,
   dist_qp1000_barrier, dist_socp1000_barrier/_pd (plain torch; against
   the pd rows' values, the KKT or cone certificates) and dist_cholesky
   at n = 5000 (within 8x torch.linalg.cholesky's backward error), each
   once after a warm-up on a small instance.  The kernels line adds the
   batch rows' launches (and lists them apart, ``launches_parallel``).

7. The harness (``phase_harness``, after the utilities; counters set to
   0 just before each run and read just after, no plain version may
   run): ``entry()``'s single Newton step on the card in float32 and on
   a float64 copy of its arguments, each against the same call on the
   CPU; ``dryrun_multichip(1)`` on a one-rank NCCL group; and the three
   examples' ``main()`` in this process (examples/demo_torch.py,
   phase_one_demo_torch.py, distributed_demo_torch.py), each timed,
   each required to launch its kernels (``HARNESS_KERNELS``) and held by
   its independent checks: every LP within 1e-6 of HiGHS, the demo's pd
   and barrier LP values within their gaps, its QP by the KKT
   certificate, its SOCP constraint residuals ≤ 1e-6, its LASSO path by
   the optimality residual, the phase-one demo's signs of s.  The
   kernels line lists the phase's launches apart (``launches_harness``).
   Then each example runs once more, untimed, with the inputs of every
   fp32 factor of its mixed KKT solves and of the first K1, K2 and K4
   step and K3b solve at each shape recorded (``harness_recording``),
   and each is held against its plain version on those inputs
   (``harness_kernel_checks``: K3a by its flag and backward error, K3b by
   its backward error, K1, K2 and K4 by ``k1_check``, ``k2_check`` and
   ``k4_check``; where K2's H = CᵀWC is singular, at the phase-one
   demo's 200 × 1001, the preconditioner on shared inputs and four steps
   along the route, each step's dx and x' against the plain step's).

Output: one JSON line per kernel comparison and per row, then the card
line as nvidia-smi prints it, the kernel summary ``{"kernels": [...]}``
(each kernel with its time, its plain version's, the least time the card
could take for the same work and, where one exists, the PyTorch call's)
and, last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
from collections import Counter
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def emit(obj) -> None:
    print(json.dumps(obj, sort_keys=True), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def rel_err(a, b) -> float:
    a = a.double().flatten()
    b = b.double().flatten()
    den = float(b.abs().max()) if b.numel() else 0.0
    return float((a - b).abs().max()) / max(den, 1e-300)


def abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def time_ms(fn, reps: int = 7) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after one
    warm-up run."""
    import torch
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1))
    ts.sort()
    return ts[len(ts) // 2]


def lp_recipe(n, seed=1):
    """bench.py bench_lp: the reference LP recipe, seed 1 (``seed``: the
    same recipe at another seed)."""
    import numpy as np
    m, k = int(0.8 * n), int(0.2 * n)
    np.random.seed(seed)
    A = np.random.uniform(-2, 2, (m, n))
    C = np.random.uniform(-2, 2, (k, n))
    x_feas = np.random.uniform(-2, 2, n)
    c = np.random.uniform(-2, 2, n)
    return dict(c=c, A=A, b=A @ x_feas, C=C, d=C @ x_feas)


def qp_recipe(n):
    """bench.py bench_qp: the reference QP recipe, seed 1."""
    import numpy as np
    m, k = int(0.8 * n), 20
    np.random.seed(1)
    Pp = np.random.uniform(-2, 2, (m, n))
    P = Pp.T @ Pp + np.eye(n)
    A = np.random.uniform(-2, 2, (m, n))
    C = np.random.uniform(-2, 2, (k, n))
    x_feas = np.random.uniform(-2, 2, n)
    q = np.random.uniform(-2, 2, n)
    return dict(P=P, q=q, A=A, b=A @ x_feas, C=C, d=C @ x_feas)


LP_KW = dict(lower_bound=-3, upper_bound=3, suppress_print=True,
             check_cvxpy=False, epsilon=1e-4, mu=15, t0=1,
             max_inner_iters=20, max_outer_iters=10, beta=0.5, alpha=0.05,
             dtype="float64")
QP_KW = dict(lower_bound=-3, upper_bound=3, suppress_print=True,
             check_cvxpy=False, epsilon=1e-8, mu=15, t0=0.01,
             max_inner_iters=100, max_outer_iters=10, beta=0.6,
             dtype="float64")


def phase1_x0(n):
    """An in-bounds start whose projection onto Ax = b leaves the box
    (seeded): the barrier's reduced start is infeasible."""
    import numpy as np
    return np.random.RandomState(5).uniform(-2.9, 2.9, n)


def socp_recipe(n):
    """bench.py bench_socp: generate_socp(n) after np.random.seed(1) (5
    cones of 0.8n rows, 50 equalities, P, q).  Returns (problem, x0)."""
    import numpy as np
    from interiorpoint_tpu_torch.utils.generators import generate_socp
    np.random.seed(1)
    p = generate_socp(n)
    return p, p.pop("x0")


SOCP_KW = dict(suppress_print=True, check_cvxpy=False, epsilon=1e-4, mu=15,
               t0="auto", max_inner_iters=500, max_outer_iters=20, beta=0.5,
               alpha=0.05, dtype="float64")


def socp_phase1_x0(n):
    """bench_socp's x0 moved by a seeded shift whose projection onto
    Fx = g leaves the cones (the largest squared-cone violation is ~8e3
    at n = 1000): the barrier's reduced start is infeasible.  A shift of
    3·N(0, 1) instead puts it ~7e6 outside, and the squared-slack phase
    one (the JAX package's) then stalls for 20 stages."""
    import numpy as np
    shift = np.random.RandomState(7).standard_normal(n)
    return socp_recipe(n)[1] + 0.1 * shift


def lasso_recipe():
    """bench.py bench_lasso(1000): generate_lasso(1000) after
    np.random.seed(1) (A of 2400 x 1000, 30 samples)."""
    import numpy as np
    from interiorpoint_tpu_torch.utils.generators import generate_lasso
    np.random.seed(1)
    return generate_lasso(1000)


# bench_lasso's settings (bench.py:150-160), with the default adaptive ρ
# and relax: the bias column makes n = 1001
LASSO_KW = dict(rho=0.4, max_iters=5000, check_stop=10, add_bias=True,
                eps_rel=1e-6, eps_abs=1e-6, check_cvxpy=False,
                dtype="float64")


class FunctionalPD:
    """``solve_lp(c, A, b, C, d, lb=-3, ub=3, algorithm="pd",
    epsilon=1e-6)`` on bench_lp(1000)'s data (800 equalities handed to
    pd_solve, C stacked with the box to 2200 x 1000), behind the
    attributes of a solver that ``drive_row`` reads."""

    def __init__(self, device):
        self.p = lp_recipe(1000)
        self.device = device

    def solve(self):
        from interiorpoint_tpu_torch import solve_lp
        p = self.p
        res = solve_lp(p["c"], p["A"], p["b"], p["C"], p["d"], lb=-3, ub=3,
                       algorithm="pd", epsilon=1e-6, device=self.device)
        self.xstar = res.z.cpu().numpy()
        self.value = float(p["c"] @ self.xstar)
        self.optimality_gap = res.gap
        self.outer_iters = res.iters
        self.last_metrics = {"algorithm": "pd", "converged": res.converged}
        return self.value


def make_solver(row: str, device: str):
    from interiorpoint_tpu_torch import (LassoSolver, LPSolver, QPSolver,
                                         SOCPSolver)
    if row == "lasso1000":
        p = lasso_recipe()
        return LassoSolver(p["A"], p["b"], reg=p["reg"], **LASSO_KW,
                           device=device)
    if row == "lp1000_pd_eq":
        return FunctionalPD(device)
    if row.startswith("socp1000"):
        # bench_socp(1000)'s settings; the barrier row also recovers the
        # duals (K3), and the full-space row is the rows' reference (no
        # reduction, so no K4); the conic Mehrotra rows (bench.py:716's
        # socp1000_pd, with the duals) run K5 on the reduced problem
        # (pe = 0) and in full space (pe = 50)
        extra = {"socp1000_barrier": dict(get_dual_variables=True),
                 "socp1000_phase1": {},
                 "socp1000_full": dict(reduced=False),
                 "socp1000_pd": dict(algorithm="pd",
                                     get_dual_variables=True),
                 "socp1000_pd_full": dict(algorithm="pd", reduced=False,
                                          get_dual_variables=True)}[row]
        p, x0 = socp_recipe(1000)
        return SOCPSolver(**p, **SOCP_KW, x0=x0, device=device, **extra)
    if row == "lp1000_auto":
        return LPSolver(**lp_recipe(1000), **LP_KW, algorithm="auto",
                        get_dual_variables=True, device=device)
    if row == "qp1000_pd":
        return QPSolver(**qp_recipe(1000), **QP_KW, algorithm="pd",
                        device=device)
    if row == "lp5000_pd":
        return LPSolver(**lp_recipe(5000), **LP_KW, algorithm="pd",
                        device=device)
    # the barrier rows: bench.py's settings with its default algorithm
    if row in ("lp1000_barrier", "lp1000_phase1"):
        return LPSolver(**lp_recipe(1000), **LP_KW, device=device)
    if row == "qp1000_barrier":
        return QPSolver(**qp_recipe(1000), **QP_KW, device=device)
    if row == "lp5000_barrier":
        return LPSolver(**lp_recipe(5000), **LP_KW, device=device)
    raise KeyError(row)


def solve_kwargs(row: str):
    if row == "lp1000_phase1":
        return {"x0": phase1_x0(1000)}
    if row == "socp1000_phase1":
        return {"x0": socp_phase1_x0(1000)}
    return {}


ROWS = ("lp1000_auto", "qp1000_pd", "lp5000_pd")
BARRIER_ROWS = ("lp1000_barrier", "qp1000_barrier", "lp5000_barrier",
                "lp1000_phase1")
SOCP_ROWS = ("socp1000_barrier", "socp1000_phase1")
K5_ROWS = ("socp1000_pd", "socp1000_pd_full", "lp1000_pd_eq")
LASSO_ROWS = ("lasso1000",)
# the kernels each row's first solve must launch (the LP phase-one row
# starts from an explicit x0: no least-squares warm start, so no K3; the
# SOCP rows have no inequality block to warm-start, and only the barrier
# row recovers duals, through K3)
ROW_KERNELS = {"lp1000_auto": ("K1", "K3a", "K3b"),
               "qp1000_pd": ("K1", "K3a", "K3b"),
               "lp5000_pd": ("K1", "K3a", "K3b"),
               "lp1000_barrier": ("K2", "K3a", "K3b"),
               "qp1000_barrier": ("K2", "K3a", "K3b"),
               "lp5000_barrier": ("K2", "K3a", "K3b"),
               "lp1000_phase1": ("K2",),
               "socp1000_barrier": ("K4", "K3a", "K3b"),
               "socp1000_phase1": ("K4",),
               "socp1000_pd": ("K5", "K3a", "K3b"),
               "socp1000_pd_full": ("K5",),
               "lp1000_pd_eq": ("K5",),
               "lasso1000": ("K3a", "K3b")}
# K2 against its plain version at a strict direction gate: the refinement
# and PCG run to a residual of ~3e-13 (exit_rel2 floor 1e-25), so the two
# directions agree far below the path's own gate
K2_STRICT_TOL = 1e-13
K2_STEP_TOL = 1e-9
K1_COMPARE_TOL = 1e-6
# K1 pieces against their plain versions on shared inputs (relative to
# the largest entry of the plain result): fp64 passes over C, and the fp32
# preconditioner, whose summation orders differ between the two versions
PIECE_TOL64 = 1e-12
PIECE_TOL32 = 1e-5
# the Gram sums up to 11000 fp32 products per entry, in a different order
# in each version (each ~1e-5 off the fp64 product at 11000 x 1000); it is
# also held by its own error against fp64, at most 4x the plain version's
GRAM_TOL = 5e-5
# fp64 unit roundoff
U64 = 2.0 ** -53


def gamma(n):
    """Higham's γₙ = n·u/(1 − n·u): the bound on the rounding of an n-term
    fp64 sum, relative to the sum of its terms' sizes."""
    return n * U64 / (1.0 - n * U64)


# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W):
# device-memory bandwidth, fp32 outside the tensor cores, fp64 outside
# them (vector) and on them (DMMA, for the work the fp64 factors of K3a
# and K5 can put there).
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_F64 = 34e12
PEAK_F64_TC = 67e12


def bound(nbytes, f32=0.0, f64=0.0, f64tc=0.0):
    """The least time the card could take for the work: the larger of the
    bytes over the memory rate and the operations over their peak rates."""
    tb = nbytes / PEAK_BYTES
    to = f32 / PEAK_F32 + f64 / PEAK_F64 + f64tc / PEAK_F64_TC
    return {"bound_ms": max(tb, to) * 1e3,
            "bound_by": "bytes" if tb >= to else "operations",
            "bound_bytes": nbytes, "bound_f32_flops": f32,
            "bound_f64_flops": f64, "bound_f64_tc_flops": f64tc}


def k2_work(k, r, qp):
    """fp32 and fp64 operations of one barrier Newton step from k and r
    alone (not from the entries it launched, which the preconditioner's
    branch decides): the fp64 pass over C for pass 1 and the one for Cᵀv
    (2kr each; the refinement's operator applications are left out), tP z
    for a QP (2r²), the Gram's lower half k·r·(r+1) and one factor r³/3
    in fp32."""
    return (k * r * (r + 1) + r ** 3 / 3.0,
            4.0 * k * r + (2.0 * r * r if qp else 0.0))


def ldl_factor_work(np_, tiles, blk=128):
    """fp32 operations (flops) of the block-LDL factor of an np × np Hs on
    these inputs; ``tiles``: the plain factor's stats (the reference's
    iterations, so that a kernel that iterates more gets no larger bound),
    [‖I − X·Ds‖²_F, iterations] per tile.  Each tile up to the first that
    missed its gate: 3 power iterations (2·blk² each), the residual
    product X₀·Ds (2·blk³) and per Newton–Schulz iteration its two blk³
    products (4·blk³); each stage whose tile passed: its panels and
    trailing tiles, 2·blk³ each (m panels and m(m+1)/2 tiles, m the tiles
    below it).  Tiles after a missed one count nothing."""
    import math

    from interiorpoint_tpu_torch.ops import hybrid

    nb = np_ // blk
    ops = 0.0
    for k, (f2, its) in enumerate(tiles[:nb]):
        if math.isnan(its):
            break
        ops += 6.0 * blk ** 2 + 2.0 * blk ** 3 + 4.0 * blk ** 3 * its
        if not f2 <= hybrid.NS_TILE_GATE2:
            break
        m = nb - k - 1
        ops += 2.0 * blk ** 3 * (m + m * (m + 1) // 2)
    return ops


def ldl_factor_bytes(np_, blk=128):
    """Bytes the factor must move: Hs read once, the working copy, the
    panels and the tile inverses written once (fp32)."""
    return 4 * (3 * np_ * np_ + blk * np_)


def carry_bound(np_, iters):
    """bound() of the carry trial: Hs and X read, X' written (fp32), and
    per iteration its three np³ products (and one for the first
    residual)."""
    return bound(3 * 4 * np_ * np_, f32=2.0 * np_ ** 3 * (3 * iters + 1))


def step_bytes(k, r, qp, nk_vec, nr_vec):
    """Bytes a step must move: C in fp64 and fp32 (and P, for a QP) read
    once, and its k- and r-length vectors in and out (fp64)."""
    return 12 * k * r + (12 * r * r if qp else 0) + 8 * (nk_vec * k
                                                         + nr_vec * r)


def entry_deltas(fn):
    """Run fn; return its result and the C-entry launches it made."""
    from interiorpoint_tpu_torch.kernels import _build
    before = dict(_build.LAUNCHES)
    out = fn()
    return out, {e: n - before.get(e, 0) for e, n in _build.LAUNCHES.items()
                 if n - before.get(e, 0)}


def comparer(err, tol):
    """cmp(name, a, b, t, floor=0): records in err[name] the largest
    difference of a from b relative to max(‖b‖∞, floor), and t in
    tol[name]."""
    import torch

    def cmp(name, a, b, t, floor=0.0):
        a, b = a.double(), b.double()
        den = max(float(b.abs().max()), floor, 1e-300)
        # equal entries (the step ratios may both be +inf) differ by 0
        diff = torch.where(a == b, torch.zeros_like(a), a - b)
        err[name] = float(diff.abs().max()) / den
        tol[name] = t

    return cmp


def gram_pieces(C32, w, P32, cmp, err, tol, info):
    """The CUDA Gram against the plain one, and each against the fp64
    product of the same fp32 inputs (the CUDA one at most 4x the plain
    one's own error)."""
    from interiorpoint_tpu_torch.ops.pd_step import _Cuda, _Plain
    Hp = _Plain.gram(C32, w, P32)
    Hc = _Cuda.gram(C32, w, P32)
    C64 = C32.double()
    H64 = (C64 * w.float().double()[:, None]).T @ C64
    if P32 is not None:
        H64 = H64 + P32.double()
    del C64
    cmp("gram", Hc, Hp, GRAM_TOL)
    own = {}
    for name, H in (("cuda", Hc), ("plain", Hp)):
        own[name] = float((H.double() - H64).abs().max()) / float(
            H64.abs().max())
    err["gram.vs_fp64"], tol["gram.vs_fp64"] = own["cuda"], (
        4.0 * own["plain"] + 1e-6)
    info["gram.vs_fp64_plain"] = own["plain"]
    return Hp


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    cap = torch.cuda.get_device_capability(0)
    check(tuple(cap) == (9, 0), f"need compute capability (9, 0), got {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    from interiorpoint_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    _build.lib()
    secs = time.perf_counter() - t0
    emit({"phase": "build", "seconds": secs,
          "nvcc_seconds": _build.build_seconds,
          "library": _build.library_path().name})


def back_errors(H, L, W):
    """Backward errors of a factor and its inverse, in fp64: ‖LLᵀ − H‖
    relative to ‖H‖ and ‖WL − I‖ (max norms); H lower-stored."""
    import torch
    H = torch.tril(H.double())
    H = H + torch.tril(H, -1).T
    L, W = L.double(), W.double()
    eye = torch.eye(L.shape[0], dtype=torch.float64, device=L.device)
    return (float((L @ L.T - H).abs().max()) / float(H.abs().max()),
            float((W @ L - eye).abs().max()))


# K3a's widths: one stage (64), r = 200 (np = 256), 800, the K1/K4 rows'
# r = 1000 (np = 1024), the LASSO ladder's 1001, and 1100 (18 stages)
K3A_WIDTHS = (64, 200, 800, 1000, 1001, 1100)


def phase_k3(results):
    """K3a (the factor and the inverse) in fp32 and fp64 and K3b (fp32) at
    K3A_WIDTHS, against their plain versions and one PyTorch call each;
    then K3a's ladder cases (``k3a_cases``) and K2's Cholesky fallback
    (``k3a_fallback``)."""
    import numpy as np
    import torch
    from interiorpoint_tpu_torch.ops import chol

    for n in K3A_WIDTHS:
        rng = np.random.default_rng(n)
        M = rng.standard_normal((n, n))
        H64 = M @ M.T / n + np.eye(n)
        for dt in (torch.float32, torch.float64):
            H = torch.as_tensor(H64, dtype=dt, device="cuda")
            np_ = chol.padded(n, chol.cuda_block())
            (L, D, bad), ent = entry_deltas(
                lambda: chol.factor_cuda(H, n, np_, 0.0))
            W, ent_w = entry_deltas(lambda: chol.invert_cuda(L, D))
            Lp, Dp, badp = chol.factor_plain(H, n, np_, 0.0)
            Wp = chol.invert_plain(Lp, Dp)
            torch.cuda.synchronize()
            check(int(bad) == 0 and int(badp) == 0,
                  f"K3a {dt} n={n}: factor failed")
            Hp = torch.eye(np_, dtype=dt, device="cuda")
            Hp[:n, :n] = H
            fb, ib = back_errors(Hp, L, W)
            fbp, ibp = back_errors(Hp, Lp, Wp)
            # the plain version's own error, 4x, plus the rounding of the
            # product that measures it
            floor = 1e-6 if dt == torch.float32 else 1e-14
            t_fac = time_ms(lambda: chol.factor_cuda(H, n, np_, 0.0))
            t_fac_dev = queued_ms(lambda: chol.factor_cuda(H, n, np_, 0.0))
            t_inv = time_ms(lambda: chol.invert_cuda(L, D))
            t_fac_p = time_ms(lambda: chol.factor_plain(H, n, np_, 0.0))
            t_inv_p = time_ms(lambda: chol.invert_plain(Lp, Dp))
            t_lib = time_ms(lambda: torch.linalg.cholesky(H))
            # one PyTorch call that computes W = L⁻¹ (a yardstick)
            Ln = L[:n, :n].contiguous()
            eye_n = torch.eye(n, dtype=dt, device="cuda")
            t_inv_lib = time_ms(lambda: torch.linalg.solve_triangular(
                Ln, eye_n, upper=False))
            es = 4 if dt == torch.float32 else 8
            tri = n * (n + 1) // 2 * es     # a triangle of entries
            fl = {"f64tc" if dt == torch.float64 else "f32": n ** 3 / 3.0}
            rec = {"phase": "kernel", "kernel": "K3a", "n": n,
                   "dtype": str(dt).replace("torch.", ""),
                   "factor_backward": fb, "factor_backward_plain": fbp,
                   "invert_backward": ib, "invert_backward_plain": ibp,
                   "factor_abs_err": abs_err(L[:n, :n], Lp[:n, :n]),
                   "launches_per_factor": ent, "launches_per_inverse": ent_w,
                   "factor_ms": t_fac, "factor_device_ms": t_fac_dev,
                   "factor_plain_ms": t_fac_p,
                   "factor_library_ms": t_lib, "invert_ms": t_inv,
                   "invert_plain_ms": t_inv_p, "invert_library_ms": t_inv_lib,
                   "invert_abs_err": abs_err(W[:n, :n], chol.invert_plain(
                       L, D)[:n, :n]),
                   # factor: the lower triangle of H in, L and Dinv out;
                   # the inverse: L in, W out; n³/3 operations each
                   "factor_bound": bound(2 * tri + np_ * 64 * es, **fl),
                   "invert_bound": bound(2 * tri, **fl)}
            emit(rec)
            check(fb <= 4.0 * fbp + floor,
                  f"K3a {dt} n={n}: factor backward error {fb:.3g} against "
                  f"the plain version's {fbp:.3g}")
            check(ib <= 4.0 * ibp + floor,
                  f"K3a {dt} n={n}: inverse backward error {ib:.3g} against "
                  f"the plain version's {ibp:.3g}")
            check(ent == {chol._entry("ip_chol_factor", dt): 1}
                  and sum(ent_w.values()) == 1,
                  f"K3a {dt} n={n}: {ent} launches per factor, {ent_w} per "
                  "inverse")
            results[("K3a", str(dt), n)] = rec

        # K3b, and the fp32 K3a through its standalone wrapper
        H = torch.as_tensor(H64, dtype=torch.float32, device="cuda")
        B = torch.as_tensor(rng.standard_normal((n,)), dtype=torch.float32,
                            device="cuda")
        L, D, bad = chol.cholesky_blocked(H)
        Lp, Dp, badp = chol.cholesky_blocked_plain(H)
        X = chol.cholesky_solve_blocked(L, D, B)
        Xp = chol.cholesky_solve_blocked_plain(Lp, Dp, B)
        torch.cuda.synchronize()
        check(int(bad) == 0 and int(badp) == 0, f"K3a n={n}: factor failed")
        eL, eX = rel_err(L, Lp), rel_err(X, Xp)
        be, be_p = k3b_backward(H, X, B), k3b_backward(H, Xp, B)
        _, ent_s = entry_deltas(lambda: chol.cholesky_solve_blocked(L, D, B))
        t_sol = time_ms(lambda: chol.cholesky_solve_blocked(L, D, B))
        t_sol_p = time_ms(lambda: chol.cholesky_solve_blocked_plain(
            Lp, Dp, B))
        # one PyTorch call (a yardstick; the port never calls it)
        Llib = torch.linalg.cholesky(H)
        t_sol_lib = time_ms(lambda: torch.cholesky_solve(B[:, None], Llib))
        rec = {"phase": "kernel", "kernel": "K3b", "n": n, "p": 1,
               "factor_rel_err": eL, "solve_rel_err": eX,
               "solve_backward": be, "solve_backward_plain": be_p,
               "launches_per_solve": ent_s,
               "solve_abs_err": abs_err(X, Xp),
               "solve_ms": t_sol, "solve_plain_ms": t_sol_p,
               "solve_library_ms": t_sol_lib,
               "solve_bound": k3b_bound(n, 1)}
        emit(rec)
        check(eL <= 1e-5, f"K3a n={n}: L rel err {eL:.3g} > 1e-5")
        check(eX <= 1e-4, f"K3b n={n}: X rel err {eX:.3g} > 1e-4")
        check(be <= 4.0 * be_p + 1e-7,
              f"K3b n={n}: backward error {be:.3g} against the plain "
              f"version's {be_p:.3g}")
        check(sum(ent_s.values()) == 1, f"K3b n={n}: {ent_s} launches")
        results[("K3b", n)] = rec
    k3a_cases(results)
    k3a_fallback(results)


def k3a_cases(results, n=1000):
    """K3a's jitter-ladder cases at n in fp32 and fp64, each CUDA factor
    held against the plain one on the same inputs, ``bad`` equal:
    * a δ > 0 rung (``after`` set: the previous rung failed) on a singular
      PSD matrix (rank n − 10), by backward error against H + δI;
    * the skipped rung after it (``after`` zero): ``out`` and ``bad``
      untouched, in one launch that returns at once; its time;
    * a matrix that stops being positive definite in its last 64-block
      (a diagonal entry of row n − 10 made negative): both flags set, the
      CUDA factor's leading (np − 64)² block held against the plain
      factor of that block (the plain factor of the whole is NaN), and its
      last block not finite (NaN propagates)."""
    import numpy as np
    import torch
    from interiorpoint_tpu_torch.ops import chol

    rng = np.random.default_rng(12)
    M = rng.standard_normal((n, n - 10))
    Hsing = M @ M.T / n
    Hlate = M @ M.T / n + np.eye(n)
    Hlate[n - 10, n - 10] = -1.0
    np_ = chol.padded(n, chol.cuda_block())
    head = np_ - chol.cuda_block()
    for dt in (torch.float32, torch.float64):
        where = f"K3a {str(dt).replace('torch.', '')} n={n}"
        floor = 1e-6 if dt == torch.float32 else 1e-14
        one = torch.ones((), dtype=torch.int32, device="cuda")
        zero = torch.zeros((), dtype=torch.int32, device="cuda")
        H = torch.as_tensor(Hsing, dtype=dt, device="cuda")
        delta = 1e-3
        (L, D, bad), ent = entry_deltas(
            lambda: chol.factor_cuda(H, n, np_, delta, after=one))
        Lp, Dp, badp = chol.factor_plain(H, n, np_, delta, after=one)
        Hd = torch.eye(np_, dtype=dt, device="cuda")
        Hd[:n, :n] = H + delta * torch.eye(n, dtype=dt, device="cuda")
        fb = back_errors(Hd, L, chol.invert_plain(L, D))[0]
        fbp = back_errors(Hd, Lp, chol.invert_plain(Lp, Dp))[0]
        rec = {"phase": "kernel", "kernel": "K3a cases", "n": n,
               "dtype": str(dt).replace("torch.", ""),
               "delta": delta, "delta_bad": [int(bad), int(badp)],
               "delta_factor_backward": [fb, fbp],
               "delta_launches": ent}
        check(int(bad) == int(badp) == 0 and fb <= 4.0 * fbp + floor
              and sum(ent.values()) == 1,
              f"{where}: δ rung flags {rec['delta_bad']}, backward errors "
              f"{rec['delta_factor_backward']} (CUDA, plain), {ent}")
        # the skipped rung: the previous rung's flag is 0
        keep_L, keep_D = L.clone(), D.clone()
        keep_Lp = Lp.clone()
        bz = torch.zeros((), dtype=torch.int32, device="cuda")
        bzp = torch.zeros((), dtype=torch.int32, device="cuda")
        _, ent = entry_deltas(lambda: chol.factor_cuda(
            H, n, np_, 1.0, out=(L, D), after=zero, bad=bz))
        chol.factor_plain(H, n, np_, 1.0, out=(Lp, Dp), after=zero, bad=bzp)
        torch.cuda.synchronize()
        rec.update(skip_bad=[int(bz), int(bzp)], skip_launches=ent,
                   skip_ms=time_ms(lambda: chol.factor_cuda(
                       H, n, np_, 1.0, out=(L, D), after=zero, bad=bz)),
                   skip_device_ms=queued_ms(lambda: chol.factor_cuda(
                       H, n, np_, 1.0, out=(L, D), after=zero, bad=bz)))
        check(int(bz) == int(bzp) == 0 and torch.equal(L, keep_L)
              and torch.equal(D, keep_D) and torch.equal(Lp, keep_Lp)
              and sum(ent.values()) == 1,
              f"{where}: a skipped rung changed its output or flag "
              f"{rec['skip_bad']} (CUDA, plain), {ent}")
        # positive definite but for the last 64-block
        H = torch.as_tensor(Hlate, dtype=dt, device="cuda")
        L, D, bad = chol.factor_cuda(H, n, np_, 0.0)
        Lp, Dp, badp = chol.factor_plain(H, n, np_, 0.0)
        Lh, Dh, badh = chol.factor_plain(H[:head, :head].contiguous(), head,
                                         head, 0.0)
        lead = L[:head, :head].contiguous()
        fb = back_errors(H[:head, :head], lead,
                         chol.invert_plain(lead, D[:head]))[0]
        fbp = back_errors(H[:head, :head], Lh, chol.invert_plain(Lh, Dh))[0]
        tail_finite = bool(torch.isfinite(L[head:, head:]).all())
        rec.update(late_bad=[int(bad), int(badp)], late_head_bad=int(badh),
                   late_head_backward=[fb, fbp],
                   late_plain_finite=bool(torch.isfinite(Lp).all()),
                   late_tail_finite=tail_finite)
        emit(rec)
        check(int(bad) == int(badp) == 1 and int(badh) == 0
              and fb <= 4.0 * fbp + floor and not tail_finite
              and not rec["late_plain_finite"],
              f"{where}: late failure: flags {rec['late_bad']}, leading "
              f"block {rec['late_head_backward']} (CUDA, plain), last "
              f"block finite {tail_finite}")
        results[("K3a cases", str(dt))] = rec


def k3a_fallback(results):
    """K2's Cholesky fallback (factor of Hs + δI and its inverse, δ = 1e-6
    as K2's first rung) at np = 256 and 1024 in fp32: CUDA events per
    call, the device's time per call with the calls queued, the plain
    pair and ``torch.linalg.cholesky_ex`` beside them."""
    import numpy as np
    import torch
    from interiorpoint_tpu_torch.ops.pd_step import _Cuda, _Plain

    for np_ in (256, 1024):
        rng = np.random.default_rng(np_)
        M = rng.standard_normal((np_, np_))
        Hs = torch.as_tensor(M @ M.T / np_ + np.eye(np_),
                             dtype=torch.float32, device="cuda")

        def cuda():
            return _Cuda.invert(*_Cuda.factor(Hs, 1e-6)[:2])

        W = cuda()
        Wp = _Plain.invert(*_Plain.factor(Hs, 1e-6)[:2])
        rec = {"phase": "kernel", "kernel": "K2 Cholesky fallback",
               "np": np_, "W_abs_err": abs_err(W, Wp),
               "factor_invert_ms": time_ms(cuda),
               "factor_invert_device_ms": queued_ms(cuda),
               "factor_invert_plain_ms": time_ms(
                   lambda: _Plain.invert(*_Plain.factor(Hs, 1e-6)[:2])),
               "library_ms": time_ms(lambda: torch.linalg.cholesky_ex(Hs))}
        emit(rec)
        check(rec["W_abs_err"] <= 1e-3 * float(Wp.abs().max()),
              f"K2 Cholesky fallback np={np_}: W abs err "
              f"{rec['W_abs_err']:.3g}")
        results[("K2 fallback", np_)] = rec


def k3b_backward(H, X, B):
    """Backward error of a solve of H X = B (H fp32, lower triangle the
    factor's source), in fp64: ‖HX − B‖∞ / (‖H‖∞‖X‖∞ + ‖B‖∞)."""
    Hd = H.double()
    Xd = X.double().reshape(H.shape[0], -1)
    Bd = B.double().reshape(H.shape[0], -1)
    return float((Hd @ Xd - Bd).abs().max()) / (
        float(Hd.abs().sum(dim=1).max()) * float(Xd.abs().max())
        + float(Bd.abs().max()))


def phase_k3b_widest(results, shapes):
    """K3b at the widest right-hand side the main path gave it (``shapes``:
    the (n, p) of its calls), against its plain version by backward error,
    with torch.cholesky_solve timed beside it."""
    import numpy as np
    import torch
    from interiorpoint_tpu_torch.ops import chol

    n, p = max(shapes, key=lambda np_: (np_[1], np_[0]))
    rng = np.random.default_rng(n + p)
    M = rng.standard_normal((n, n))
    H = torch.as_tensor(M @ M.T / n + np.eye(n), dtype=torch.float32,
                        device="cuda")
    B = torch.as_tensor(rng.standard_normal((n, p) if p > 1 else (n,)),
                        dtype=torch.float32, device="cuda")
    L, D, _ = chol.cholesky_blocked(H)
    X, ent = entry_deltas(lambda: chol.cholesky_solve_blocked(L, D, B))
    Xp = chol.cholesky_solve_blocked_plain(L, D, B)
    torch.cuda.synchronize()
    be, be_p = k3b_backward(H, X, B), k3b_backward(H, Xp, B)
    Llib = torch.linalg.cholesky(H)
    B2 = B.reshape(n, -1)
    rec = {"phase": "kernel", "kernel": "K3b", "n": n, "p": p,
           "main_path_shapes": sorted(set(shapes)),
           "solve_bound": k3b_bound(n, p),
           "solve_backward": be, "solve_backward_plain": be_p,
           "solve_rel_err": rel_err(X, Xp), "launches_per_solve": ent,
           "solve_ms": time_ms(lambda: chol.cholesky_solve_blocked(L, D, B)),
           "solve_plain_ms": time_ms(
               lambda: chol.cholesky_solve_blocked_plain(L, D, B)),
           "solve_library_ms": time_ms(lambda: torch.cholesky_solve(B2,
                                                                    Llib))}
    emit(rec)
    check(be <= 4.0 * be_p + 1e-7,
          f"K3b n={n} p={p}: backward error {be:.3g} against the plain "
          f"version's {be_p:.3g}")
    check(sum(ent.values()) == 1, f"K3b n={n} p={p}: {ent} launches")
    results[("K3b", "widest")] = rec


def k3b_wide_shapes():
    """(n, p) of ``phase_k3b_wide`` besides the LASSO ladder's: the
    crossover's p = 1 and 2 (csolve.cu's one-cluster kernel, the wide one),
    the mixed KKT solves' and the tests' p = 2, 3 and p = 256 at n = 1001
    (16 block rows, the last one ragged), the harness LASSO example's
    (61, 61) (one block row), and p = 3 past the wide kernel's rows
    (chol.solve_route's "chunked": chol.cu's 8-column tasks; 66 block
    rows, the last one of one row)."""
    from interiorpoint_tpu_torch.ops import chol
    return [(1001, p) for p in (1, 2, 3, 256)] + [
        (61, 61), (chol.WIDE_MAX_N + 65, 3)]


def ldl_solve_bound(np_, p=1):
    """The LDL solve's least time at np and p right-hand sides (p = np:
    the carry reseed M⁻¹I): L̃'s strictly lower 128-row tiles (its
    diagonal tiles are the identity, never read), the tile inverses, B in
    and X out once; per column 2 nb(nb − 1)·128² fp32 operations for the
    two sweeps and 2 np·128 for the tile products."""
    te = 128
    nb = np_ // te
    tiles = nb * (nb - 1) // 2 * te * te
    return bound(4 * tiles + 4 * np_ * te + 8 * np_ * p,
                 f32=p * (4.0 * tiles + 2.0 * np_ * te))


def phase_k3b_wide(results):
    """The solve at p > 1 on the card against its plain version by
    backward error (within 4x the plain version's + 1e-7), each call
    launching once the kernel of the route ``chol.solve_route`` names
    (chol.cu's 8-column kernel among them): K3b at (1001, 1001)
    with B = diag(d) (the LASSO ladder's first solve: d = diag(H)^-1/2)
    and with a dense B (a refinement round's residual), and at
    ``k3b_wide_shapes``; the LDL solve's carry reseed M⁻¹I at np = 256 and
    1024 (TE = 128, M the tile inverses of the plain factor of a seeded
    Hs, as ``phase_k2_synthetic``'s) against ``ldl_solve_plain``.  Each
    timed beside its plain version and, for K3b, torch.cholesky_solve,
    with its bound."""
    import numpy as np
    import torch
    from interiorpoint_tpu_torch.ops import chol, hybrid
    from interiorpoint_tpu_torch.ops.newton_step import _Cuda, _Plain

    entry = SOLVE_ENTRY
    spd = {}
    cases = [(1001, 1001, "diag"), (1001, 1001, "dense")] + [
        (n, p, "dense") for n, p in k3b_wide_shapes()]
    for n, p, kind in cases:
        if n not in spd:
            rng = np.random.default_rng(n)
            M = torch.as_tensor(rng.standard_normal((n, n)), device="cuda")
            H = (M @ M.T / n + torch.eye(n, dtype=M.dtype, device="cuda")
                 ).float()
            L, D, bad = chol.cholesky_blocked(H)
            check(int(bad) == 0, f"K3b wide n={n}: factor failed")
            spd[n] = (H, L, D, torch.linalg.cholesky(H))
        H, L, D, Llib = spd[n]
        rng = np.random.default_rng(n * 7 + p)
        if kind == "diag":
            B = torch.diag(1.0 / torch.sqrt(torch.diagonal(H))).contiguous()
        else:
            B = torch.as_tensor(rng.standard_normal((n, p) if p > 1 else n),
                                dtype=torch.float32, device="cuda")
        where = f"K3b wide n={n} p={p} {kind}"
        route = chol.solve_route(n, p, chol.cuda_block())
        X, ent = entry_deltas(lambda: chol.cholesky_solve_blocked(L, D, B))
        Xp = chol.cholesky_solve_blocked_plain(L, D, B)
        torch.cuda.synchronize()
        be, be_p = k3b_backward(H, X, B), k3b_backward(H, Xp, B)
        B2 = B.reshape(n, -1)
        rec = {"phase": "kernel", "kernel": "K3b", "n": n, "p": p,
               "rhs": kind, "route": route, "launches_per_solve": ent,
               "solve_backward": be, "solve_backward_plain": be_p,
               "solve_abs_err": abs_err(X, Xp),
               "solve_ms": time_ms(
                   lambda: chol.cholesky_solve_blocked(L, D, B)),
               "solve_device_ms": queued_ms(
                   lambda: chol.cholesky_solve_blocked(L, D, B)),
               "solve_plain_ms": time_ms(
                   lambda: chol.cholesky_solve_blocked_plain(L, D, B)),
               "solve_library_ms": time_ms(
                   lambda: torch.cholesky_solve(B2, Llib)),
               "solve_library_device_ms": queued_ms(
                   lambda: torch.cholesky_solve(B2, Llib)),
               "solve_bound": k3b_bound(n, p)}
        emit(rec)
        check(bool(torch.isfinite(X).all()), f"{where}: X not finite")
        check(be <= 4.0 * be_p + 1e-7,
              f"{where}: backward error {be:.3g} against the plain "
              f"version's {be_p:.3g}")
        check(ent == {entry[route]: 1}, f"{where}: {ent} launches, route "
              f"{route}")
        results[("K3b wide", n, p, kind)] = rec
    b = hybrid.LDL_BLK
    for n in (200, 1001):
        rng = np.random.default_rng(n)
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        Hs = _Plain.equilibrate(torch.as_tensor(
            (Q * np.logspace(0, 3, n)) @ Q.T, dtype=torch.float32,
            device="cuda"), b)[0]
        np_ = Hs.shape[0]
        where = f"LDL reseed np={np_}"
        Lp, Dp, bp = _Plain.ldl_factor(Hs, 0.0)
        check(int(bp) == 0, f"{where}: the plain factor failed")
        eye = torch.eye(np_, dtype=Hs.dtype, device="cuda")
        wide0 = hybrid.ldl_solve_cuda.wide_launches
        X, ent = entry_deltas(lambda: _Cuda.ldl_solve(Lp, Dp, eye))
        Xp = _Plain.ldl_solve(Lp, Dp, eye)
        torch.cuda.synchronize()
        be = [ldl_backward(Lp, Dp, X, eye), ldl_backward(Lp, Dp, Xp, eye)]
        rec = {"phase": "kernel", "kernel": "K2 LDL reseed", "np": np_,
               "p": np_, "route": chol.solve_route(np_, np_, b),
               "launches_per_solve": ent,
               "wide_launches": hybrid.ldl_solve_cuda.wide_launches - wide0,
               "solve_backward": be, "solve_abs_err": abs_err(X, Xp),
               "solve_ms": time_ms(lambda: _Cuda.ldl_solve(Lp, Dp, eye)),
               "solve_device_ms": queued_ms(
                   lambda: _Cuda.ldl_solve(Lp, Dp, eye)),
               "solve_plain_ms": time_ms(
                   lambda: _Plain.ldl_solve(Lp, Dp, eye)),
               "solve_bound": ldl_solve_bound(np_, np_)}
        emit(rec)
        check(bool(torch.isfinite(X).all()), f"{where}: X not finite")
        check(be[0] <= 4.0 * be[1] + 1e-7,
              f"{where}: backward errors {be} (CUDA, plain)")
        check(ent == {"ip_block_solve_wide": 1} and rec["wide_launches"] == 1,
              f"{where}: {ent} launches, {rec['wide_launches']} counted wide")
        results[("LDL reseed", np_)] = rec


# the C entry of each route of the solve (ops/chol.py ``solve_route``)
SOLVE_ENTRY = {"column": "ip_block_solve_column",
               "wide": "ip_block_solve_wide", "chunked": "ip_block_solve"}


def column_cases():
    """(kind, n) of ``phase_column_solve``: the LDL solve at np = 256 (the
    n = 1000 barrier rows), 512 and 1024 (lp5000_barrier), and past the
    cluster's capacity at np = 1152; K3b at the harness LASSO example's
    n = 61 (one block row), 200 (one block holds it all), 800 (the
    warm start and dual recovery of the n = 1000 rows), 1001 (16 block
    rows, the last one ragged) and past the capacity at 1100."""
    return [("ldl", n) for n in (200, 400, 1001, 1100)] + [
        ("k3b", n) for n in (61, 200, 800, 1001, 1100)]


def phase_column_solve(results):
    """The solve at p = 1 on the card against its plain version by
    backward error (within 4x the plain version's + 1e-7), each call
    launching once the kernel of the route ``chol.solve_route`` names
    (csolve.cu's one-cluster kernel up to ``chol.COLUMN_MAX_N`` rows,
    chol.cu's 8-column kernel past it): K2's LDL solve M⁻¹b (TE = 128, M
    the tile inverses of the plain factor of a seeded Hs, as
    ``phase_k3b_wide``'s reseed cases) and K3b (TE = 64, the factor of a
    seeded SPD matrix) at ``column_cases``.  Each timed per call
    (``time_ms``) and on the device (``queued_ms``) beside its plain
    version and, for K3b, torch.cholesky_solve, with its bound."""
    import numpy as np
    import torch
    from interiorpoint_tpu_torch.ops import chol, hybrid
    from interiorpoint_tpu_torch.ops.newton_step import _Cuda, _Plain

    for kind, n in column_cases():
        rng = np.random.default_rng(n + (0 if kind == "k3b" else 1))
        if kind == "ldl":
            b = hybrid.LDL_BLK
            Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
            Hs = _Plain.equilibrate(torch.as_tensor(
                (Q * np.logspace(0, 3, n)) @ Q.T, dtype=torch.float32,
                device="cuda"), b)[0]
            np_ = Hs.shape[0]
            Lp, Dp, bp = _Plain.ldl_factor(Hs, 0.0)
            check(int(bp) == 0, f"LDL solve np={np_}: the plain factor "
                  "failed")
            v = torch.as_tensor(rng.standard_normal(np_),
                                dtype=torch.float32, device="cuda")

            def cuda():
                return _Cuda.ldl_solve(Lp, Dp, v)

            def plain():
                return _Plain.ldl_solve(Lp, Dp, v)

            def backward(x):
                return ldl_backward(Lp, Dp, x, v)
            where, size = f"LDL solve np={np_}", np_
            route = chol.solve_route(np_, 1, b)
            bnd, lib = ldl_solve_bound(np_), None
        else:
            M = torch.as_tensor(rng.standard_normal((n, n)), device="cuda")
            H = (M @ M.T / n + torch.eye(n, dtype=M.dtype, device="cuda")
                 ).float()
            L, D, bad = chol.cholesky_blocked(H)
            check(int(bad) == 0, f"K3b n={n}: factor failed")
            v = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32,
                                device="cuda")
            Llib, v2 = torch.linalg.cholesky(H), v[:, None]

            def cuda():
                return chol.cholesky_solve_blocked(L, D, v)

            def plain():
                return chol.cholesky_solve_blocked_plain(L, D, v)

            def backward(x):
                return k3b_backward(H, x, v)

            def lib():
                return torch.cholesky_solve(v2, Llib)
            where, size = f"K3b n={n} p=1", n
            route = chol.solve_route(n, 1, chol.cuda_block())
            bnd = k3b_bound(n, 1)
        X, ent = entry_deltas(cuda)
        Xp = plain()
        torch.cuda.synchronize()
        be, be_p = backward(X), backward(Xp)
        rec = {"phase": "kernel", "kernel": "K3b" if kind == "k3b"
               else "K2 LDL solve", "n": size, "p": 1, "route": route,
               "launches_per_solve": ent, "solve_backward": be,
               "solve_backward_plain": be_p, "solve_abs_err": abs_err(X, Xp),
               "solve_ms": time_ms(cuda), "solve_device_ms": queued_ms(cuda),
               "solve_plain_ms": time_ms(plain),
               "solve_library_ms": lib and time_ms(lib),
               "solve_library_device_ms": lib and queued_ms(lib),
               "solve_bound": bnd}
        emit(rec)
        check(bool(torch.isfinite(X).all()), f"{where}: X not finite")
        check(be <= 4.0 * be_p + 1e-7,
              f"{where}: backward error {be:.3g} against the plain "
              f"version's {be_p:.3g}")
        check(ent == {SOLVE_ENTRY[route]: 1},
              f"{where}: {ent} launches, route {route}")
        check((route == "column") == (size <= chol.COLUMN_MAX_N),
              f"{where}: route {route}")
        results[("column", kind, size)] = rec


def queued_ms(fn, n: int = 64) -> float:
    """The device's time per call of ``fn``: ``n`` calls queued behind a
    sleep on the stream (so the host's enqueue time stays off the card's
    timeline), CUDA events around them, divided by ``n``."""
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def late_fail_hs(np_, fail_tile, seed=11, device="cuda"):
    """A Jacobi-scaled SPD Hs (np × np, fp32 on the card) whose block-LDL
    factor with 128-wide tiles passes every tile before ``fail_tile`` and
    refuses that one: Hs = L D Lᵀ with L unit block-lower (entries
    0.3·N(0, 1)/√128 below the diagonal tiles), D block diagonal, each
    tile of spectrum logspace(0, −1) except tile ``fail_tile``'s,
    logspace(0, −12), which no fp32 Newton–Schulz iteration inverts to the
    gate."""
    import numpy as np
    import torch
    from interiorpoint_tpu_torch.ops import hybrid
    from interiorpoint_tpu_torch.ops.newton_step import _Plain

    b = hybrid.LDL_BLK
    rng = np.random.default_rng(seed)
    L = np.eye(np_)
    D = np.zeros((np_, np_))
    for k in range(np_ // b):
        s_k = slice(k * b, (k + 1) * b)
        L[(k + 1) * b:, s_k] = 0.3 * rng.standard_normal(
            (np_ - (k + 1) * b, b)) / np.sqrt(b)
        Q, _ = np.linalg.qr(rng.standard_normal((b, b)))
        ev = np.logspace(0, -12 if k == fail_tile else -1, b)
        D[s_k, s_k] = (Q * ev) @ Q.T
    H = L @ D @ L.T
    H = 0.5 * (H + H.T)
    return _Plain.equilibrate(torch.as_tensor(H, dtype=torch.float32,
                                              device=device), b)[0]


def phase_k2_synthetic(results):
    """K2's preconditioner pieces on seeded inputs, CUDA against plain.

    The block-LDL factor of a Jacobi-scaled SPD Hs (κ = 1e3) at np = 256,
    512 and 1024 (r = 200, 500, 1001): one launch, the same flags,
    ‖I − M⁻¹Hs‖_F within 1.25x the plain factor's plus 1e-4, each tile's
    iterations within one of the plain factor's (``ldl_tile_iterations``;
    its final ‖I − X·Ds‖²_F printed beside the plain one), and its solve by
    backward error.  At np = 1024 also an Hs whose rung 0 fails at tile 6
    of 8 (``late_fail_hs``): both versions refuse it there, the CUDA
    factor stops (tile 7 untouched, tile 6's inverse NaN) and its
    intermediates up to tile 6 are what its inputs give
    (``ldl_intermediates``).  At np ≤ 512 the carry trial on an Hs of
    κ = 1e2 from the fp64 inverse of it rescaled by 1% (a hit), and on an
    Hs of κ = 1e4 from the identity (a miss after 12 iterations): the same
    hit, ‖I − Hs·X‖_F within 1.25x the plain trial's plus 1e-4, iterations
    within one.  Times each piece beside its plain version (CUDA events
    around each call, and ``queued_ms``, the device's own time per call),
    a rung the carry's hit skips, and the Cholesky factor and inverse the
    LDL replaces."""
    import math

    import numpy as np
    import torch
    from interiorpoint_tpu_torch.ops import hybrid
    from interiorpoint_tpu_torch.ops.newton_step import _Cuda, _Plain

    b = hybrid.LDL_BLK
    one = torch.ones((), dtype=torch.int32, device="cuda")
    for n in (200, 500, 1001):
        rng = np.random.default_rng(n)
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        H = (Q * np.logspace(0, 3, n)) @ Q.T
        Hs = _Plain.equilibrate(torch.as_tensor(H, dtype=torch.float32,
                                                device="cuda"), b)[0]
        np_ = Hs.shape[0]
        nt = np_ // b
        where = f"K2 synthetic np={np_}"
        eye = torch.eye(np_, dtype=Hs.dtype, device="cuda")
        st_p = torch.full((nt, 2), float("nan"), device="cuda")
        Lp, Dp, bp = _Plain.ldl_factor(Hs, 0.0, stats=st_p)
        Mp = _Plain.ldl_solve(Lp, Dp, eye)
        res_p = float((eye - Mp @ Hs).norm())
        st_c = torch.full((nt, 2), float("nan"), device="cuda")
        work = torch.empty_like(Hs)
        (Lc, Dc, bc), ent = entry_deltas(
            lambda: _Cuda.ldl_factor(Hs, 0.0, stats=st_c, work=work))
        Mc = _Cuda.ldl_solve(Lc, Dc, eye)
        res = float((eye - Mc @ Hs).norm())
        tiles = [st_c.tolist(), st_p.tolist()]
        rec = {"phase": "kernel", "kernel": "K2 preconditioner", "np": np_,
               "ldl_bad": [int(bc), int(bp)], "ldl_launches": ent,
               "ldl_resid": [res, res_p],
               "ldl_Dinv_abs_err": abs_err(Dc, Dp),
               "ldl_tiles": tiles,
               "ldl_factor_ms": time_ms(lambda: _Cuda.ldl_factor(Hs, 0.0)),
               "ldl_factor_device_ms": queued_ms(
                   lambda: _Cuda.ldl_factor(Hs, 0.0)),
               "ldl_factor_bound": bound(ldl_factor_bytes(np_),
                                         f32=ldl_factor_work(np_, tiles[1]))}
        check(ent == {"ip_ldl_factor": 1}, f"{where}: launches {ent}")
        check(int(bc) == 0 and int(bp) == 0,
              f"{where}: LDL flags {rec['ldl_bad']}")
        check(res <= 1.25 * res_p + 1e-4,
              f"{where}: ‖I − M⁻¹Hs‖_F {[res, res_p]} (CUDA, plain)")
        rec["ldl_tiles_apart"] = ldl_tile_iterations(where, Hs, 0.0, work,
                                                     (Lc, Dc), tiles)
        b1 = Hs @ torch.ones(np_, dtype=Hs.dtype, device="cuda")
        xc, xp = _Cuda.ldl_solve(Lp, Dp, b1), _Plain.ldl_solve(Lp, Dp, b1)
        rec.update({
            "ldl_solve_rel_err": rel_err(xc, xp),
            "ldl_solve_backward": [ldl_backward(Lp, Dp, xc, b1),
                                   ldl_backward(Lp, Dp, xp, b1)],
            "ldl_factor_plain_ms": time_ms(
                lambda: _Plain.ldl_factor(Hs, 0.0), reps=3),
            "ldl_skipped_ms": time_ms(
                lambda: _Cuda.ldl_factor(Hs, 0.0, skip=one)),
            "ldl_skipped_device_ms": queued_ms(
                lambda: _Cuda.ldl_factor(Hs, 0.0, skip=one)),
            "ldl_solve_ms": time_ms(lambda: _Cuda.ldl_solve(Lp, Dp, b1)),
            "ldl_solve_plain_ms": time_ms(
                lambda: _Plain.ldl_solve(Lp, Dp, b1)),
            "cholesky_inverse_ms": time_ms(
                lambda: _Cuda.invert(*_Cuda.factor(Hs, 0.0)[:2])),
            "cholesky_library_ms": time_ms(
                lambda: torch.linalg.cholesky_ex(Hs))})
        be = rec["ldl_solve_backward"]
        check(be[0] <= 4.0 * be[1] + 1e-7,
              f"K2 synthetic np={np_}: LDL solve backward errors {be} "
              "(CUDA, plain)")
        _, _, bsk = _Cuda.ldl_factor(Hs, 0.0, skip=one)
        check(int(bsk) == 0, f"K2 synthetic np={np_}: a skipped rung "
              f"reports bad = {int(bsk)}")
        if np_ == 1024:
            rec["late_fail"] = ldl_late_fail(np_, 6)
        if np_ <= hybrid.NS_MAX_RP:
            H2 = (Q * np.logspace(0, 2, n)) @ Q.T
            Hs2 = _Plain.equilibrate(torch.as_tensor(
                H2, dtype=torch.float32, device="cuda"), b)[0]
            sc = 1.0 + 0.01 * rng.uniform(-1, 1, np_)
            Hb = Hs2.double().cpu().numpy() * sc[:, None] * sc[None, :]
            X0 = torch.as_tensor(np.linalg.inv(Hb), dtype=torch.float32,
                                 device="cuda")
            H4 = (Q * np.logspace(0, 4, n)) @ Q.T
            Hs4 = _Plain.equilibrate(torch.as_tensor(
                H4, dtype=torch.float32, device="cuda"), b)[0]
            for kind, (Hc, Xs) in (("hit", (Hs2, X0)), ("miss", (Hs4, eye))):
                Xc, hc, r2c, itc = _Cuda.ns_refresh(Hc, Xs)
                Xp, hp, r2p, itp = _Plain.ns_refresh(Hc, Xs)
                c = {"hit": [int(hc), int(hp)],
                     "rho2": [float(r2c), float(r2p)],
                     "iterations": [int(itc), int(itp)],
                     "X_rel_err": rel_err(Xc, Xp),
                     "ms": time_ms(lambda: _Cuda.ns_refresh(Hc, Xs)),
                     "device_ms": queued_ms(
                         lambda: _Cuda.ns_refresh(Hc, Xs)),
                     "plain_ms": time_ms(
                         lambda: _Plain.ns_refresh(Hc, Xs), reps=3),
                     "bound": carry_bound(np_, int(itp))}
                rec["carry_" + kind] = c
                want = 1 if kind == "hit" else 0
                check(int(hc) == want and int(hp) == want
                      and (kind == "hit" or int(itp) == hybrid.NS_ITERS),
                      f"K2 synthetic np={np_}: carry {kind} {c}")
                check(math.sqrt(float(r2c)) <= 1.25 * math.sqrt(float(r2p))
                      + 1e-4 and abs(int(itc) - int(itp)) <= 1,
                      f"K2 synthetic np={np_}: carry {kind} {c['rho2']} "
                      f"after {c['iterations']} iterations (CUDA, plain)")
        emit(rec)
        results[("K2 synthetic", np_)] = rec
    k2_branches(results)


def k2_branch_grams():
    """[(name, H (n × n fp64 Gram), its square root M with MᵀM = H, the
    carry's seed X0 or None, the branch expected)] for ``k2_branches``:
    a carry hit (κ = 1e2, n = 200, the carry the fp64 inverse of its
    Jacobi-scaled form rescaled by 1%); LDL rung 0 (κ = 1e3, n = 200); LDL
    rung 1 (κ = 1e2 with row and column 150 zeroed, n = 200: the second
    tile is singular at δ = 0, and the jitter of rung 1 alone makes its
    zeroed coordinate invertible); the Cholesky fallback with its first
    rung refused by the pivot floor (I − (1 − 1e-7)vvᵀ, n = 500: both LDL
    rungs refuse it, and the δ = 0 factor is finite with its smallest
    pivot² below the floor, so the fallback takes rung 1)."""
    import numpy as np

    out = []
    n = 200
    rng = np.random.default_rng(n)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    for name, top, zero in (("carry_hit", 2, None), ("ldl_rung0", 3, None),
                            ("ldl_rung1", 2, 150)):
        ev = np.logspace(0, top, n)
        M = (Q * np.sqrt(ev)).T
        if zero is not None:
            M[:, zero] = 0.0
        H = M.T @ M
        X0 = None
        if name == "carry_hit":
            d = 1.0 / np.sqrt(np.diag(H))
            sc = 1.0 + 0.01 * rng.uniform(-1, 1, n)
            Hb = H * (d * sc)[:, None] * (d * sc)[None, :]
            X0 = np.eye(256)
            X0[:n, :n] = np.linalg.inv(Hb)
        out.append((name, H, M, X0,
                    {"carry_hit": 0, "ldl_rung0": 1, "ldl_rung1": 2}[name]))
    n = 500
    rng = np.random.default_rng(5)
    v = rng.uniform(0.5, 1.5, n)
    v /= np.linalg.norm(v)
    H = np.eye(n) - (1 - 1e-7) * np.outer(v, v)
    w, U = np.linalg.eigh(H)
    M = (U * np.sqrt(np.clip(w, 0.0, None))).T
    out.append(("fallback_floor", H, M, None, 4))
    return out


def k2_branches(results):
    """K2's preconditioner (ops/newton_step.py ``preconditioner``, every
    branch decided on the device) on ``k2_branch_grams``, CUDA against the
    plain twin: the branch the device took equals the plain one's and the
    one expected (ST_BRANCH numbering: 0 hit, 1 / 2 LDL rung 0 / 1, 3 + i
    the fallback at jitter rung i); its launches make no host read; the
    same form (X or W); ‖I − M⁻¹Hs‖_F within 1.25x the plain one's plus
    1e-4, and the carry's new X within 1e-2 of the plain one's on a hit.
    Where M is well conditioned (the hit and rung 0), the refined solve on
    each version's own preconditioner (H = MᵀM, a seeded right-hand side,
    three rounds at the strict gate) by its fp64 residual, and on the
    hit's system a solve on the unrefreshed seed X0 with one round, which
    stalls and runs the PCG: the same counts [rounds, stalled, PCG rounds,
    kept].
    Times the preconditioner's launches, ``ip_k2_decide`` and
    ``ip_pivot_floor`` beside their plain twins."""
    import numpy as np
    import torch
    from interiorpoint_tpu_torch.ops import chol, hybrid, refine, sync
    from interiorpoint_tpu_torch.ops import newton_step as ns

    f32, f64 = torch.float32, torch.float64
    strict2 = K2_STRICT_TOL ** 2
    for name, H, M, X0, want in k2_branch_grams():
        where = f"K2 branch {name}"
        H32 = torch.as_tensor(H, dtype=f32, device="cuda")
        pres = {}
        for tag, ops in (("cuda", ns._Cuda), ("plain", ns._Plain)):
            carry = None
            if X0 is not None:
                carry = ns.NSCarry(X=torch.as_tensor(X0, dtype=f32,
                                                     device="cuda"), ok=True)
            c0 = sync.count
            pre = ns.preconditioner(ops, H32, carry)
            reads = sync.count - c0
            pres[tag] = (pre, reads, carry)
        (pc, reads, carry_c), (pp, _, carry_p) = pres["cuda"], pres["plain"]
        Hs = ns._Plain.equilibrate(H32, hybrid.LDL_BLK)[0]
        eye = torch.eye(Hs.shape[0], dtype=f32, device="cuda")

        def resid(pre):
            form = int(pre.kind)
            Mi = (pre.X if form == 1 else
                  ns._Plain.ldl_solve(*pre.ldl, eye) if form == 2
                  else pre.W.T @ pre.W)
            return float((eye - Mi @ Hs).norm())

        rec = {"phase": "kernel", "kernel": "K2 branch", "case": name,
               "np": Hs.shape[0], "branch": [int(pc.branch), int(pp.branch)],
               "expected": want, "form": [int(pc.kind), int(pp.kind)],
               "host_reads": reads, "resid": [resid(pc), resid(pp)]}
        check(reads == 0, f"{where}: {reads} host reads in the CUDA "
              "preconditioner")
        check(rec["branch"] == [want, want] and rec["form"][0] ==
              rec["form"][1], f"{where}: branch {rec['branch']}, form "
              f"{rec['form']} (CUDA, plain), {want} expected")
        check(rec["resid"][0] <= 1.25 * rec["resid"][1] + 1e-4,
              f"{where}: ‖I − M⁻¹Hs‖_F {rec['resid']} (CUDA, plain)")
        if carry_c is not None:
            rec["carry_X_rel_err"] = rel_err(carry_c.X, carry_p.X)
            check(carry_c.ok and rec["carry_X_rel_err"] <= 1e-2
                  and carry_c.X.data_ptr() == pc.X.data_ptr(),
                  f"{where}: the carry's X {rec['carry_X_rel_err']} from "
                  "the plain one's, or not the step's preconditioner")
        if name in ("carry_hit", "ldl_rung0"):
            Mt = torch.as_tensor(M, dtype=f64, device="cuda").contiguous()
            wt = torch.ones(Mt.shape[0], dtype=f64, device="cuda")
            b = torch.as_tensor(
                np.random.default_rng(7).standard_normal(Mt.shape[1]),
                dtype=f64, device="cuda")
            Ht = Mt.T @ Mt
            D = pc.dsc[:Mt.shape[1]].double()

            def fres(x):
                return float(((D * (Ht @ x - b)) ** 2).sum()
                             / ((D * b) ** 2).sum())

            runs = [("solve", pc, pp, 3)]
            if X0 is not None:
                Xs = torch.as_tensor(X0, dtype=f32, device="cuda")
                one = torch.ones((), dtype=torch.int32, device="cuda")
                weak = ns.Precond(kind=one, W=pc.W, X=Xs, ldl=pc.ldl,
                                  dsc=pc.dsc, branch=pc.branch, trial=True)
                runs.append(("solve_pcg", weak, weak, 1))
            for tag, qc, qp, nref in runs:
                xc, _, _, _, cc = ns._Cuda.refined_solve(
                    Mt, wt, None, qc.W, qc.dsc, b, nref, strict2,
                    kind=qc.kind, X=qc.X, ldl=qc.ldl)
                xp, _, _, _, cp = ns._Plain.refined_solve(
                    Mt, wt, None, qp.W, qp.dsc, b, nref, strict2,
                    kind=qp.kind, X=qp.X, ldl=qp.ldl)
                cc, cp = cc.tolist(), cp.tolist()
                rc, rp = fres(xc), fres(xp)
                rec[tag] = {"counts": [cc, cp], "resid": [rc, rp],
                            "ms": time_ms(lambda: ns._Cuda.refined_solve(
                                Mt, wt, None, qc.W, qc.dsc, b, nref, strict2,
                                kind=qc.kind, X=qc.X, ldl=qc.ldl))}
                check(rc <= 4.0 * max(rp, 1e-24),
                      f"{where}: {tag} residual {rc:.3g} against the "
                      f"plain one's {rp:.3g}")
                check(cc == cp, f"{where}: {tag} counts {cc} against the "
                      f"plain solve's {cp}")
                if tag == "solve_pcg":
                    check(cp[1] == 1 and cp[2] > 0,
                          f"{where}: the weak preconditioner did not drive "
                          f"the PCG: {cp}")
        rec["ms"] = time_ms(lambda: ns.preconditioner(ns._Cuda, H32))
        rec["device_ms"] = queued_ms(
            lambda: ns.preconditioner(ns._Cuda, H32), n=16)
        rec["plain_ms"] = time_ms(
            lambda: ns.preconditioner(ns._Plain, H32), reps=3)
        emit(rec)
        results[("K2 branch", name)] = rec
    # the two small kernels of the branch, on the flags of the cases above
    # and on the fallback case's δ = 0 factor
    i32 = torch.int32
    ints = [torch.tensor(v, dtype=i32, device="cuda") for v in (0, 1)]
    dec_err = 0
    for hit in (None, ints[0], ints[1]):
        for b0 in ints:
            for b1 in (None, ints[0], ints[1]):
                for carry in (False, True):
                    dc = hybrid.decide_cuda(hit, b0, b1, carry)
                    dp = hybrid.decide_plain(hit, b0, b1, carry)
                    n_ = 1 if b1 is None else 5
                    dec_err += int(not torch.equal(dc[:n_], dp[:n_]))
    check(dec_err == 0, f"ip_k2_decide: {dec_err} flag sets differ from "
          "the plain twin's")
    Hf = torch.as_tensor(k2_branch_grams()[-1][1], dtype=f32, device="cuda")
    Hs = ns._Plain.equilibrate(Hf, hybrid.LDL_BLK)[0]
    L = ns._Cuda.factor(Hs, 0.0)[0]
    floor2 = refine.pivot_floor2(Hs.shape[0], 0.0, f32)
    fl = {}
    for tag, fn in (("cuda", chol.pivot_floor_cuda),
                    ("plain", chol.pivot_floor_plain)):
        flags = []
        for f2 in (floor2, 0.0):
            bad = torch.zeros((), dtype=i32, device="cuda")
            flags.append(int(fn(L, f2, bad)))
        skipped = torch.zeros((), dtype=i32, device="cuda")
        fn(L, floor2, skipped, after=ints[0])
        flags.append(int(skipped))
        fl[tag] = flags
    check(fl["cuda"] == fl["plain"] == [1, 0, 0],
          f"ip_pivot_floor: flags {fl} (at the floor, at 0, skipped)")
    one = ints[1]
    bad = torch.zeros((), dtype=i32, device="cuda")
    rec = {"phase": "kernel", "kernel": "K2 branch kernels",
           "decide_mismatches": dec_err, "pivot_floor_flags": fl,
           "decide_ms": time_ms(lambda: hybrid.decide_cuda(one, one, one,
                                                           True)),
           "decide_device_ms": queued_ms(
               lambda: hybrid.decide_cuda(one, one, one, True)),
           "decide_plain_ms": time_ms(
               lambda: hybrid.decide_plain(one, one, one, True)),
           "pivot_floor_ms": time_ms(
               lambda: chol.pivot_floor_cuda(L, floor2, bad)),
           "pivot_floor_device_ms": queued_ms(
               lambda: chol.pivot_floor_cuda(L, floor2, bad)),
           "pivot_floor_plain_ms": time_ms(
               lambda: chol.pivot_floor_plain(L, floor2, bad)),
           "pivot_floor_np": L.shape[0]}
    emit(rec)
    results[("K2 branch kernels",)] = rec


def ldl_late_fail(np_, tile):
    """The factor on ``late_fail_hs(np_, tile)``, CUDA against plain, at
    rung 0: both refuse it at ``tile`` (every earlier tile passes), the
    CUDA factor leaves the later tiles' stats as they were and poisons
    tile ``tile``'s inverse, and its intermediates up to that tile hold
    (``ldl_intermediates``).  Returns the record."""
    import math

    import torch
    from interiorpoint_tpu_torch.ops import hybrid
    from interiorpoint_tpu_torch.ops.newton_step import _Cuda, _Plain

    b, g = hybrid.LDL_BLK, hybrid.NS_TILE_GATE2
    Hs = late_fail_hs(np_, tile)
    nt = np_ // b
    st_c = torch.full((nt, 2), float("nan"), device="cuda")
    st_p = torch.full((nt, 2), float("nan"), device="cuda")
    work = torch.empty_like(Hs)
    Lc, Dc, bc = _Cuda.ldl_factor(Hs, 0.0, stats=st_c, work=work)
    _, _, bp = _Plain.ldl_factor(Hs, 0.0, stats=st_p)
    tc, tp = st_c.tolist(), st_p.tolist()
    worst, tiles, _ = ldl_intermediates(Hs, 0.0, work, Lc, Dc, tile)
    rec = {"np": np_, "tile": tile, "bad": [int(bc), int(bp)],
           "tiles": [tc, tp], "intermediates_over_bound": worst,
           "inverse_resid": tiles,
           "ms": time_ms(lambda: _Cuda.ldl_factor(Hs, 0.0)),
           "device_ms": queued_ms(lambda: _Cuda.ldl_factor(Hs, 0.0)),
           "bound": bound(ldl_factor_bytes(np_),
                          f32=ldl_factor_work(np_, tp))}
    rec["tiles_apart"] = ldl_tile_iterations(
        f"late-failing LDL np={np_}", Hs, 0.0, work, (Lc, Dc), [tc, tp])
    passed = [r[0] <= g for r in tc]
    check(int(bc) == 1 and int(bp) == 1,
          f"late-failing LDL np={np_}: flags {rec['bad']} (CUDA, plain)")
    check(passed[:tile] == [True] * tile and not passed[tile]
          and [r[0] <= g for r in tp][:tile + 1] == passed[:tile + 1],
          f"late-failing LDL np={np_}: tiles {rec['tiles']} (CUDA, plain)")
    check(all(math.isnan(r[0]) and math.isnan(r[1]) for r in tc[tile + 1:])
          and not bool(torch.isfinite(Dc[tile * b:(tile + 1) * b]).any()),
          f"late-failing LDL np={np_}: the stages after tile {tile} ran "
          f"({tc}) or its inverse is not poisoned")
    check(worst <= 1.0 and all(math.sqrt(r2) <= lim for _, r2, lim in tiles),
          f"late-failing LDL np={np_}: intermediates {worst} of their "
          f"bound, tile inverses {tiles}")
    return rec


# the K2 shapes of the barrier rows (2200 x 200, and phase one's 11000 x
# 1001 at n = 5000)
GRAM_SHAPES = ((2200, 200), (11000, 1001))


def phase_gram(results):
    """The fp32 Gram (K1, K2 and K4 share it) at the barrier rows' shapes
    from seeded inputs in the barrier step's layout, against its plain
    version and fp64 (as in ``gram_pieces``), timed (median of 15) beside
    one fp32 torch.matmul (no TF32)."""
    import numpy as np
    import torch
    from interiorpoint_tpu_torch.ops.newton_step import prep_newton_consts
    from interiorpoint_tpu_torch.ops.pd_step import _Cuda, _Plain

    for k, r in GRAM_SHAPES:
        rng = np.random.default_rng(k + r)
        # the barrier step's layout (rows 16 bytes apart)
        C64 = torch.as_tensor(rng.uniform(-2, 2, (k, r)), device="cuda")
        C32 = prep_newton_consts(C64, C64[:, 0].contiguous()).C32
        del C64
        w = torch.as_tensor(rng.uniform(0.1, 10.0, k), dtype=torch.float64,
                            device="cuda")
        err, tol, info = {}, {}, {}
        gram_pieces(C32, w, None, comparer(err, tol), err, tol, info)
        _, ent = entry_deltas(lambda: _Cuda.gram(C32, w, None))
        Cw = C32 * w.float()[:, None]
        t = time_ms(lambda: _Cuda.gram(C32, w, None), reps=15)
        flops = k * r * (r + 1)
        rec = {"phase": "kernel", "kernel": "gram", "shape": [k, r],
               "err": err, "tol": tol, "info": info, "launches": ent,
               "ms": t, "plain_ms": time_ms(lambda: _Plain.gram(C32, w,
                                                                None)),
               "library_ms": time_ms(lambda: torch.matmul(Cw.T, C32)),
               "tflops": flops / t / 1e9,
               "share_of_ffma_peak": flops / t / 1e-3 / PEAK_F32,
               "max_abs_err": abs_err(_Cuda.gram(C32, w, None),
                                      _Plain.gram(C32, w, None)),
               # C32 and w in, H out; the lower half's operations
               "bound": bound(4 * k * r + 8 * k + 4 * r * r, f32=flops)}
        emit(rec)
        bad = {q: (err[q], tol[q]) for q in err if not err[q] <= tol[q]}
        check(not bad, f"Gram {k}x{r}: off against plain: {bad}")
        results[("gram", k, r)] = rec


def k1_inputs(row):
    """The main path's reduced problem and its first (z, s, λ)."""
    import torch
    from interiorpoint_tpu_torch.ops.pd import (_objective_vector, _start,
                                                dir_stall_tol)
    from interiorpoint_tpu_torch.ops.pd_step import prep_pd_consts
    solver = make_solver(row, "cuda")
    prob = solver._reduced.prob
    z0 = solver._default_z0().contiguous()
    s0, lam0 = _start(prob.C, prob.d, z0)
    cs = prep_pd_consts(prob.C, prob.d, getattr(prob, "P", None))
    q = _objective_vector(prob, z0).contiguous()
    dtol = dir_stall_tol(solver.cfg.epsilon, cap=3e-5)
    return cs, q, z0, s0.contiguous(), lam0.contiguous(), dtol


def factor_pieces(Hs, prefix, where, cmp, err, tol, info,
                  borderline_ok=False):
    """The jittered factor and the inverse of the equilibrated matrix Hs
    (fp32 for K1, K2, K4; fp64 for K5), CUDA against plain: the same
    ladder rung, then each held by its backward error ‖LLᵀ − (Hs + δI)‖
    and ‖WL − I‖ (which the conditioning of Hs does not inflate) within 4x
    the plain version's plus the rounding of the check's own fp64
    product, and W against the plain inverse of the same factor.  Keys are ``prefix`` +
    "factor.backward", "invert.W", "invert.backward".  Returns the CUDA
    and the plain inverse (W of the CUDA factor) and the jitter δ.

    With ``borderline_ok`` the two versions may disagree on a rung whose
    smallest pivot² (of the version that succeeded) lies below the
    factor's rounding, 4·(n+1)·u·max|Hs + δI|: there the sign of the
    last pivot is decided by the summation order.  Both then go on to the
    next rung, and the rung is reported (``prefix`` + "borderline")."""
    import torch
    from interiorpoint_tpu_torch.ops.pd_step import _Cuda, _Plain

    n = Hs.shape[0]
    f32 = Hs.dtype == torch.float32
    unit = 2.0 ** -24 if f32 else U64
    # the fp64 check's own rounding, and W's forward difference (κ(L)·u)
    floor, w_tol = (1e-6, PIECE_TOL32) if f32 else (1e-14, 1e-6)
    for delta in (0.0, 1e-6, 3e-3, 1.0):
        Lc, Dc, bad_c = _Cuda.factor(Hs, delta)
        Lp, _, bad_p = _Plain.factor(Hs, delta)
        if int(bad_c) != int(bad_p):
            L_ok = Lc if int(bad_c) == 0 else Lp
            piv2 = float(torch.diagonal(L_ok).double().pow(2).min())
            rnd = 4.0 * (n + 1) * unit * (float(Hs.abs().max()) + delta)
            check(borderline_ok and piv2 <= rnd,
                  f"{where}: {prefix}factor flags differ at jitter {delta} "
                  f"(smallest pivot² {piv2:.3g}, rounding {rnd:.3g})")
            info[prefix + "borderline"] = [delta, piv2, rnd]
            continue
        if int(bad_p) == 0:
            break
    Lf = Lp.double()
    info[prefix + "factor.L_vs_plain"] = float(
        (Lc.double() - Lf).abs().max()) / float(Lf.abs().max())
    eye = torch.eye(Hs.shape[0], dtype=torch.float64, device=Hs.device)
    Hs_j = Hs.double() + delta * eye

    def back_factor(L):
        L = L.double()
        return float((L @ L.T - Hs_j).abs().max()) / float(
            Hs_j.abs().max())

    err[prefix + "factor.backward"] = back_factor(Lc)
    tol[prefix + "factor.backward"] = 4.0 * back_factor(Lp) + floor
    Wc, Wp = _Cuda.invert(Lc, Dc), _Plain.invert(Lc, Dc).contiguous()
    cmp(prefix + "invert.W", Wc, Wp, w_tol)

    def back_invert(W):
        return float((W.double() @ Lc.double() - eye).abs().max())

    err[prefix + "invert.backward"] = back_invert(Wc)
    tol[prefix + "invert.backward"] = 4.0 * back_invert(Wp) + floor
    info[prefix + "jitter"] = delta
    return Wc, Wp, delta


def solve_counts(rec):
    """[[δ, rounds, stalled, PCG rounds, PCG kept], ...] of a step's
    ``record`` (one entry per refined solve)."""
    return [[float(e["delta"])] + [int(v) for v in e["counts"].tolist()]
            for e in rec]


def resid_of(apply_h, x, b, dsc):
    """‖D(b − H x)‖²/‖D b‖² in fp64 by plain torch."""
    r = b.shape[0]
    D = dsc[:r].double()
    return float(((D * (b - apply_h(x))) ** 2).sum()) / float(
        ((D * b) ** 2).sum())


def operator_pieces(where, M, wt, P, x, b, W, dsc, refine, stall2, cmp, err,
                    tol, info, times):
    """The fused operator (ip_h_apply) and the refined solve
    (ip_refined_solve) against their plain versions on shared inputs: H x
    and M x at PIECE_TOL64; the solve with the same counts (rounds,
    stalled, PCG rounds, PCG kept), x by its fp64 residual within 4x the
    largest of the exit, the plain x's residual and the rounding floor,
    the side channel M·x bitwise equal to a fresh ip_h_apply of the
    returned x; then again on a preconditioner made worse (the Gram's
    diagonal raised by up to 30%, one round, stall gate 1e-24), which
    drives the PCG.  Zero host reads in the CUDA solve."""
    import numpy as np
    import torch
    from interiorpoint_tpu_torch.ops import refine as rf
    from interiorpoint_tpu_torch.ops import sync
    from interiorpoint_tpu_torch.ops.pd_step import _Cuda, _Plain

    (hc, mc), ent = entry_deltas(lambda: _Cuda.h_apply(M, wt, x, P))
    hp, mp = _Plain.h_apply(M, wt, x, P)
    cmp("h_apply.hx", hc, hp, PIECE_TOL64)
    cmp("h_apply.mx", mc, mp, PIECE_TOL64)
    info["h_apply.launches"] = ent
    info["h_apply.max_abs_err"] = max(abs_err(hc, hp), abs_err(mc, mp))
    info["operator.shape"] = list(M.shape)
    info["operator.qp"] = P is not None
    m_, r_ = M.shape
    # M, wt and x in, H x and M x out, 4mr operations (+ P x)
    info["h_apply.bound"] = bound(
        8 * m_ * r_ + 16 * m_ + 16 * r_ + (8 * r_ * r_ if P is not None
                                            else 0),
        f64=4.0 * m_ * r_ + (2.0 * r_ * r_ if P is not None else 0.0))
    times["h_apply"] = [time_ms(lambda: _Cuda.h_apply(M, wt, x, P)),
                        time_ms(lambda: _Plain.h_apply(M, wt, x, P)), None]
    info["h_apply.queued_ms"] = queued_ms(lambda: _Cuda.h_apply(M, wt, x, P))

    def h64(v):
        return _Plain.h_apply(M, wt, v, P)[0]

    rng = np.random.default_rng(M.shape[0] + M.shape[1])
    bump = torch.as_tensor(rng.uniform(0.0, 0.3, M.shape[1]),
                           dtype=torch.float32, device=M.device)
    Wbad, dbad, _ = rf.factor_inverse_device(
        _Cuda, _Plain.gram(M.float(), wt, None if P is None else P.float())
        * (1.0 + torch.diag(bump)))
    for tag, Wt, dt, nref, st2 in (("solve", W, dsc, refine, stall2),
                                   ("solve_pcg", Wbad, dbad, 1, 1e-24)):
        s0 = sync.count
        out_c, ent = entry_deltas(lambda: _Cuda.refined_solve(
            M, wt, P, Wt, dt, b, nref, st2))
        xc, rnc, bnc, mxc, cc = out_c
        torch.cuda.synchronize()
        reads = sync.count - s0
        xp, rnp, bnp, mxp, cp = _Plain.refined_solve(M, wt, P, Wt, dt, b,
                                                     nref, st2)
        fresh = _Cuda.h_apply(M, wt, xc, P)[1]
        counts = [cc.tolist(), cp.tolist()]
        res_c, res_p = resid_of(h64, xc, b, dt), resid_of(h64, xp, b, dt)
        Ma = M.abs()
        fl = Ma.T @ (wt * (Ma @ xp.abs()))
        if P is not None:
            fl = fl + P.abs() @ xp.abs()
        D = dt[:b.shape[0]].double()
        floor = float(((D * gamma(M.shape[0] + M.shape[1] + 2)
                        * (fl + b.abs())) ** 2).sum()) / float(
                            ((D * b) ** 2).sum())
        err[tag + ".resid"] = res_c
        tol[tag + ".resid"] = 4.0 * max(rf.exit_rel2_of(st2), res_p, floor)
        err[tag + ".host_reads"] = reads
        tol[tag + ".host_reads"] = 0
        err[tag + ".side_channel_bitwise"] = float(not torch.equal(mxc,
                                                                   fresh))
        tol[tag + ".side_channel_bitwise"] = 0.0
        info[tag + ".counts"] = counts
        info[tag + ".x_vs_plain"] = rel_err(xc, xp)
        info[tag + ".x_abs_err"] = abs_err(xc, xp)
        info[tag + ".bound"] = solve_bound(M.shape[0], M.shape[1],
                                           P is not None, counts[0])
        info[tag + ".resid_plain"] = res_p
        info[tag + ".launches"] = ent
        check(counts[0] == counts[1],
              f"{where}: {tag} counts [rounds, stalled, PCG rounds, kept] "
              f"{counts[0]} against the plain solve's {counts[1]}")
        if tag == "solve_pcg":
            check(counts[0][1] == 1 and counts[0][2] > 0,
                  f"{where}: the worse preconditioner did not drive the PCG "
                  f"({counts[0]})")
        times[tag] = [time_ms(lambda: _Cuda.refined_solve(M, wt, P, Wt, dt, b,
                                                          nref, st2)),
                      time_ms(lambda: _Plain.refined_solve(
                          M, wt, P, Wt, dt, b, nref, st2), reps=3), None]
        info[tag + ".queued_ms"] = queued_ms(lambda: _Cuda.refined_solve(
            M, wt, P, Wt, dt, b, nref, st2), n=16)


def solve_bound(m, r, qp, counts):
    """The least time of a refined solve that made ``counts`` [rounds,
    stalled, PCG rounds, kept] decisions: each operator application
    (rounds + PCG rounds + one for the PCG's result) reads M (and P), wt
    and x, 4mr (+ 2r²) fp64 operations; each preconditioner application
    (rounds + PCG rounds + one to start the PCG) reads W's lower triangle
    twice, 2r² fp32 operations."""
    rounds, stalled, pcg, _ = counts
    n_op = rounds + pcg + stalled
    n_w = rounds + pcg + stalled
    return bound(n_op * (8 * m * r + 8 * m + (8 * r * r if qp else 0))
                 + n_w * 4 * r * r + 16 * r,
                 f32=n_w * 2.0 * r * r,
                 f64=n_op * (4.0 * m * r + (2.0 * r * r if qp else 0.0)))


def ladder_pieces(where, n, err, tol, info):
    """The device jitter ladder (``factor_jittered_device``) on a seeded
    unit-diagonal Hs (n × n) that fails rung 0 (three negative
    eigenvalues of -1e-3): the CUDA and plain device ladders take the
    rung the host ladder ``factor_jittered`` takes, with no host read in
    the CUDA one, and a finite factor."""
    import numpy as np
    import torch
    from interiorpoint_tpu_torch.ops import refine as rf
    from interiorpoint_tpu_torch.ops import sync
    from interiorpoint_tpu_torch.ops.pd_step import _Cuda, _Plain

    rng = np.random.default_rng(n)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    ev = np.linspace(1.0, 2.0, n)
    ev[:3] = -1e-3
    Hs = _Cuda.equilibrate(torch.as_tensor((Q * ev) @ Q.T,
                                           dtype=torch.float32,
                                           device="cuda"))[0]
    seen = []

    class Rec(_Plain):
        @staticmethod
        def factor(A, delta, **kw):
            seen.append(delta)
            return _Plain.factor(A, delta, **kw)

    rf.factor_jittered(Rec, Hs)
    s0 = sync.count
    Lc, _, dc = rf.factor_jittered_device(_Cuda, Hs)
    dc = float(dc)
    reads = sync.count - s0
    dp = float(rf.factor_jittered_device(_Plain, Hs)[2])
    info["ladder.rungs"] = {"host": seen, "cuda": dc, "plain": dp}
    check(seen[-1] > 0.0 and dc == seen[-1] and dp == seen[-1]
          and bool(torch.isfinite(Lc).all()),
          f"{where}: device ladder rungs {info['ladder.rungs']}")
    err["ladder.host_reads"], tol["ladder.host_reads"] = reads, 0


# widths past the main path's at which the operator's pass (csrc/hop.cu)
# takes its other forms: rows read in place (no row fits in shared memory
# beside x), and x and the column partial in global memory too
WIDE_SHAPES = ((96, 8000), (96, 15000))
# a width past the register form (r > 1024: rows read in place, x in
# shared memory), at which both entries run through operator_pieces
IN_PLACE_SHAPE = (3000, 1200)


def phase_h_apply_wide(results):
    """The fused operator at WIDE_SHAPES from seeded inputs (with P),
    against its plain version at PIECE_TOL64, H x and M x; then both
    entries at IN_PLACE_SHAPE (``phase_hop_in_place``)."""
    import numpy as np
    import torch
    from interiorpoint_tpu_torch.ops.pd_step import _Cuda, _Plain

    for m, r in WIDE_SHAPES:
        rng = np.random.default_rng(m + r)
        dev = dict(dtype=torch.float64, device="cuda")
        M = torch.as_tensor(rng.uniform(-1, 1, (m, r)), **dev)
        wt = torch.as_tensor(rng.uniform(0.1, 2.0, m), **dev)
        x = torch.as_tensor(rng.standard_normal(r), **dev)
        P = torch.eye(r, **dev) * 2.0
        err, tol = {}, {}
        cmp = comparer(err, tol)
        hc, mc = _Cuda.h_apply(M, wt, x, P)
        hp, mp = _Plain.h_apply(M, wt, x, P)
        cmp("h_apply.hx", hc, hp, PIECE_TOL64)
        cmp("h_apply.mx", mc, mp, PIECE_TOL64)
        rec = {"phase": "kernel", "kernel": "ip_h_apply", "shape": [m, r],
               "err": err, "tol": tol}
        emit(rec)
        bad = {q: (err[q], tol[q]) for q in err if not err[q] <= tol[q]}
        check(not bad, f"ip_h_apply {m}x{r}: off against plain: {bad}")
        results[("h_apply", m, r)] = rec
        del M, P
    results[("hop in place",) + IN_PLACE_SHAPE] = phase_hop_in_place()


def phase_hop_in_place():
    """ip_h_apply and ip_refined_solve at IN_PLACE_SHAPE (the pass with
    rows read in place) on seeded inputs with P, held as operator_pieces
    holds them at the main path's states."""
    import numpy as np
    import torch
    from interiorpoint_tpu_torch.ops import refine as rf
    from interiorpoint_tpu_torch.ops.pd_step import _Cuda

    m, r = IN_PLACE_SHAPE
    rng = np.random.default_rng(m + r)
    dev = dict(dtype=torch.float64, device="cuda")
    M = torch.as_tensor(rng.standard_normal((m, r)), **dev)
    wt = torch.as_tensor(10.0 ** rng.uniform(-2, 2, m), **dev)
    P = torch.diag(torch.as_tensor(rng.uniform(0.5, 2.0, r), **dev))
    x = torch.as_tensor(rng.standard_normal(r), **dev)
    b = torch.as_tensor(rng.standard_normal(r), **dev)
    W, dsc, _ = rf.factor_inverse_device(_Cuda, _Cuda.gram(
        M.float(), wt, P.float()))
    err, tol, info, times = {}, {}, {}, {}
    operator_pieces(f"hop in place {m}x{r}", M, wt, P, x, b, W, dsc, 3, 1e-12,
                    comparer(err, tol), err, tol, info, times)
    bad = {q: (err[q], tol[q]) for q in err if not err[q] <= tol[q]}
    rec = {"phase": "kernel", "kernel": "hop in place", "shape": [m, r],
           "err": err, "tol": tol, "pieces_info": info, "pieces_ms": times}
    emit(rec)
    check(not bad, f"hop in place {m}x{r}: off against plain: {bad}")
    return rec


def k1_pieces(row, cs, q, z, s, lam, dtol):
    """Every CUDA piece of the step against its plain version on the same
    inputs (this row's own first state), and each piece's time.  Returns
    {piece: err}, {piece: tolerance}, {name: value} of what is reported,
    not held, and {piece: [ms, plain ms, library ms]}."""
    import numpy as np
    import torch
    from interiorpoint_tpu_torch.ops import refine as rf
    from interiorpoint_tpu_torch.ops.pd_step import _Cuda, _Plain

    C, k, r = cs.C, cs.k, cs.r
    rng = np.random.default_rng(k + r)
    dev = dict(dtype=torch.float64, device=C.device)
    x = torch.as_tensor(rng.standard_normal(r), **dev)
    dz = torch.as_tensor(rng.standard_normal(r), **dev) * 1e-2 * (
        1.0 + float(z.abs().max()))
    err, tol, info, times = {}, {}, {}, {}
    cmp = comparer(err, tol)

    # fp64 passes over C; ‖rp‖ of the exactly feasible warm start is
    # rounding noise, so rp is held relative to 1 + ‖d‖∞
    d_floor = 1.0 + float(cs.d.abs().max())
    args1 = (C, z, s, lam, cs.d, q, cs.P)
    oc, op = _Cuda.pass1(*args1), _Plain.pass1(*args1)
    for name, a, b, fl in zip(("rp", "inv_s", "w", "gap", "rp_inf", "rd",
                               "rd_inf"), oc, op,
                              (d_floor, 0, 0, 0, d_floor, 0, 0)):
        cmp("pass1." + name, a, b, PIECE_TOL64, fl)
    rp, inv_s, w, _, _, rd, _ = op
    times["pass1"] = [time_ms(lambda: _Cuda.pass1(*args1)),
                      time_ms(lambda: _Plain.pass1(*args1)), None]
    cmp("c_matvec_w", _Cuda.c_matvec(C, x, w), _Plain.c_matvec(C, x, w),
        PIECE_TOL64)
    if cs.P is not None:
        cmp("p_matvec", _Cuda.p_matvec(cs.P, x), _Plain.p_matvec(cs.P, x),
            PIECE_TOL64)
    sig_mu = (s @ lam) / k * 0.1
    rc, t, b = _Plain.rhs(C, s, lam, rp, inv_s, None, None, sig_mu, False,
                          rd)
    for name, a, bb in zip(("rc", "t", "b"),
                           _Cuda.rhs(C, s, lam, rp, inv_s, None, None,
                                     sig_mu, False, rd), (rc, t, b)):
        cmp("rhs." + name, a, bb, PIECE_TOL64)
    times["rhs"] = [time_ms(lambda: _Cuda.rhs(C, s, lam, rp, inv_s, None,
                                              None, sig_mu, False, rd)),
                    time_ms(lambda: _Plain.rhs(C, s, lam, rp, inv_s, None,
                                               None, sig_mu, False, rd)),
                    None]
    cdz = C @ dz
    dc = _Cuda.ds_pass(cdz, rp, rc, lam, s, inv_s)
    dp = _Plain.ds_pass(cdz, rp, rc, lam, s, inv_s)
    for name, a, bb in zip(("ds", "dl", "ap", "ad"), dc, dp):
        cmp("ds_pass." + name, a, bb, PIECE_TOL64)
    times["ds_pass"] = [time_ms(lambda: _Cuda.ds_pass(cdz, rp, rc, lam, s,
                                                      inv_s)),
                        time_ms(lambda: _Plain.ds_pass(cdz, rp, rc, lam, s,
                                                       inv_s)), None]
    for name, a, bb in zip(
            ("rc", "t", "b"),
            _Cuda.rhs(C, s, lam, rp, inv_s, dp[0], dp[1], sig_mu, True, rd),
            _Plain.rhs(C, s, lam, rp, inv_s, dp[0], dp[1], sig_mu, True,
                       rd)):
        cmp("rhs_corrector." + name, a, bb, PIECE_TOL64)
    gap = op[3]
    sg = (s, lam, dp[0], dp[1], dp[2], dp[3], gap)
    for name, a, bb in zip(("sigma", "sig_mu"), _Cuda.sigma(*sg),
                           _Plain.sigma(*sg)):
        cmp("sigma." + name, a, bb, PIECE_TOL64)
    times["sigma"] = [time_ms(lambda: _Cuda.sigma(*sg)),
                      time_ms(lambda: _Plain.sigma(*sg)), None]
    one = torch.ones((), **dev)
    pdz = None if cs.P is None else cs.P @ dz
    up = (s, lam, dp[0], dp[1], dp[2], dp[3], z, dz, pdz, 0.5 * one,
          1e-20 * one, one, gap, op[4], op[6])
    for name, a, bb in zip(("z", "s", "lam", "stats"), _Cuda.update(*up),
                           _Plain.update(*up)):
        cmp("update." + name, a, bb, PIECE_TOL64)
    times["update"] = [time_ms(lambda: _Cuda.update(*up)),
                       time_ms(lambda: _Plain.update(*up)), None]

    # fp32 preconditioner, each piece on the plain version's input.  The
    # Gram, the factor and the inverse are held by their own accuracy
    # against the plain version's: the Gram against the fp64 product of
    # the same fp32 inputs, the factor and the inverse by their backward
    # errors ‖LLᵀ−Hs‖ and ‖WL−I‖, which the conditioning of Hs does not
    # inflate (it does inflate the forward difference of L, reported in
    # `info` and not held).
    Hp = gram_pieces(cs.C32, w, cs.P32, cmp, err, tol, info)
    Cw = cs.C32 * w.float()[:, None]
    times["gram"] = [time_ms(lambda: _Cuda.gram(cs.C32, w, cs.P32)),
                     time_ms(lambda: _Plain.gram(cs.C32, w, cs.P32)),
                     time_ms(lambda: torch.matmul(Cw.T, cs.C32))]
    del Cw
    Hs_c, dsc_c = _Cuda.equilibrate(Hp)
    Hs, dsc = _Plain.equilibrate(Hp)
    cmp("equilibrate.Hs", Hs_c[:r, :r], Hs[:r, :r], PIECE_TOL32)
    cmp("equilibrate.dsc", dsc_c[:r], dsc[:r], PIECE_TOL32)
    Hs = Hs_c     # the CUDA padding from here on (identity either way)
    Wp = factor_pieces(Hs, "", f"K1 {row}", cmp, err, tol, info)[1]
    times["factor_rungs"] = [
        time_ms(lambda: rf.factor_jittered_device(_Cuda, Hs)),
        time_ms(lambda: rf.factor_jittered_device(_Plain, Hs), reps=3), None]
    Lc, Dc, _ = rf.factor_jittered_device(_Cuda, Hs)
    times["inverse"] = [time_ms(lambda: _Cuda.invert(Lc, Dc)),
                        time_ms(lambda: _Plain.invert(Lc, Dc)), None]
    b32 = torch.as_tensor(rng.standard_normal(r), dtype=torch.float32,
                          device=C.device)
    cmp("w_solve", _Cuda.w_solve(Wp, b32), _Plain.w_solve(Wp, b32),
        PIECE_TOL32)
    # the fused operator and the refined solve at this state (the CUDA
    # preconditioner, the predictor's right-hand side)
    Wc = _Cuda.invert(Lc, Dc)
    operator_pieces(f"K1 {row}", C, w, cs.P, x, b, Wc, dsc_c, 3, dtol ** 2,
                    cmp, err, tol, info, times)
    torch.cuda.synchronize()
    return err, tol, info, times


@contextlib.contextmanager
def sync_sites():
    """Count every host read (ops/sync.py) made inside the block by the
    line that made it ("ops/<module>.py:<line>"); yields the Counter."""
    from interiorpoint_tpu_torch.ops import sync
    sites = Counter()
    orig = sync.read, sync.read_list

    def at(f):
        def counted(t):
            fr = sys._getframe(1)
            path = fr.f_code.co_filename.replace("\\", "/")
            sites[path[path.rfind("/ops/") + 1:] + f":{fr.f_lineno}"] += 1
            return f(t)
        return counted

    sync.read, sync.read_list = at(orig[0]), at(orig[1])
    try:
        yield sites
    finally:
        sync.read, sync.read_list = orig


def hidden_syncs(fn):
    """(fn(), the synchronizing CUDA operations it made): PyTorch's sync
    debug mode warns at every operation that waits for the device (a read
    of a device scalar, a pageable copy to the card), which
    ``ops/sync.py`` does not count.  Each is recorded as the "file:line"
    that warned and the innermost line of this repository's code under
    it; warnings from this function's own frame (the mode's switches) are
    not fn's and are left out."""
    import warnings

    import torch
    sites = []
    me = sys._getframe()

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        frames, f = [], sys._getframe(1)
        while f is not None and f is not me:
            frames.append(f)
            f = f.f_back
        own = next((g for g in frames
                    if g.f_code.co_filename.startswith(str(ROOT))), None)
        if own is None and f is me:
            return
        where = ("?" if own is None else
                 f"{Path(own.f_code.co_filename).relative_to(ROOT)}:"
                 f"{own.f_lineno}")
        path = Path(filename)
        sites.append(f"{path.parent.name}/{path.name}:{lineno} from {where}")

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sites


def step_rounds(fn, *args, **kw):
    """Host reads (jitter rungs, refinement and PCG rounds) of one step."""
    from interiorpoint_tpu_torch.ops import sync
    c0 = sync.count
    out = fn(*args, **kw)
    return out, sync.count - c0


def step_reads(fn, *args, **kw):
    """One step with its host reads counted (ops/sync.py) and its
    decisions: K2's preconditioner branch and its refined solve's counts
    [rounds, stalled, PCG rounds, kept] from the step's stats row, and
    each Cholesky rung of the fallback that ran (a rung skipped on the
    device is not recorded), with its flag, a finiteness witness of its
    factor read by plain torch, its smallest pivot² and the factor's
    rounding 4·(n+1)·u·(max|Hs| + δ) (as in ``factor_pieces``).  The
    recorder reads each rung's flags after its launch; those reads are
    the check's, not the step's, and ``sync.count`` does not see them.
    Returns (out, {"reads", "branch", "counts", "rungs"})."""
    import torch
    from interiorpoint_tpu_torch.ops import newton_step as ns
    from interiorpoint_tpu_torch.ops import pd_step, sync

    rungs = []
    saved = {cls: cls.__dict__["factor"] for cls in (pd_step._Cuda,
                                                     pd_step._Plain)}

    def recording(orig):
        def factor(Hs, delta, **kw):
            after = kw.get("after")
            L, Dinv, bad = orig(Hs, delta, **kw)
            if after is not None and not int(after):
                return L, Dinv, bad
            n = Hs.shape[0]
            unit = 2.0 ** -24 if Hs.dtype == torch.float32 else U64
            rungs.append({
                "delta": delta, "bad": int(bad),
                "finite": bool(torch.isfinite(L).all())
                and bool(torch.isfinite(Dinv).all()),
                "pivot2_min": float(torch.diagonal(L).double().pow(2).min()),
                "rounding": 4.0 * (n + 1) * unit
                * (float(Hs.abs().max()) + delta)})
            return L, Dinv, bad
        return staticmethod(factor)

    for cls, f in saved.items():
        setattr(cls, "factor", recording(f.__func__))
    try:
        c0 = sync.count
        out = fn(*args, **kw)
        reads = sync.count - c0
    finally:
        for cls, f in saved.items():
            setattr(cls, "factor", f)
    st = out[1].tolist()
    return out, {"reads": reads, "branch": int(st[ns.ST_BRANCH]),
                 "counts": [int(st[i]) for i in (ns.ST_ROUNDS, ns.ST_STALLED,
                                                 ns.ST_PCG, ns.ST_KEPT)],
                 "rungs": rungs}


def reads_readings(rd_c, rd_p, st_c, st_p):
    """The record of two whole steps' host reads and decisions
    (``step_reads``) and of their residuals at the refinement's exit,
    rn2/bn2 (stats rows)."""
    from interiorpoint_tpu_torch.ops.newton_step import ST_BN2, ST_RN2

    return {"host_reads_at_dir_tol": [rd_c["reads"], rd_p["reads"]],
            "branch_at_dir_tol": [rd_c["branch"], rd_p["branch"]],
            "counts_at_dir_tol": [rd_c["counts"], rd_p["counts"]],
            "rungs_at_dir_tol": [rd_c["rungs"], rd_p["rungs"]],
            "exit_rn2_over_bn2": [st_c[ST_RN2] / st_c[ST_BN2],
                                  st_p[ST_RN2] / st_p[ST_BN2]]}


def reads_check(where, rd, dtol):
    """The CUDA step's decisions against the reference step's (``rd``
    from ``reads_readings``; K2's reference is the plain step on the CUDA
    step's preconditioner where the two LDL factors rightly disagree,
    ``k2_check``).  The CUDA step makes no host read.  Every Cholesky
    rung's flag must match its factor's finiteness.  Both must take the
    same preconditioner branch (the carry, an LDL rung, or the Cholesky
    fallback at the same jitter rung) and run the same rungs, and the
    refined solves the same counts (rounds, stalled, PCG rounds, kept)."""
    reads_c, _ = rd["host_reads_at_dir_tol"]
    check(reads_c == 0, f"{where}: the CUDA step made {reads_c} host reads")
    rungs_c, rungs_p = rd["rungs_at_dir_tol"]
    for name, rungs in (("CUDA", rungs_c), ("plain", rungs_p)):
        for g in rungs:
            check(g["bad"] == int(not g["finite"]),
                  f"{where}: the {name} factor's flag {g['bad']} at jitter "
                  f"{g['delta']} against its finiteness {g['finite']}")
    br_c, br_p = rd["branch_at_dir_tol"]
    check(br_c == br_p, f"{where}: preconditioner branch {br_c} against "
          f"the reference step's {br_p}")
    n_c, n_p = len(rungs_c), len(rungs_p)
    short = rungs_c if n_c < n_p else rungs_p
    g = short[-1] if n_c != n_p and short else None
    check(n_c == n_p,
          f"{where}: {n_c} jitter rungs against the plain step's {n_p}"
          + (f" (smallest pivot² {g['pivot2_min']:.3g} of the factor that "
             f"succeeded, rounding {g['rounding']:.3g})" if g else ""))
    c_c, c_p = rd["counts_at_dir_tol"]
    exit_c, exit_p = rd["exit_rn2_over_bn2"]
    check(c_c == c_p,
          f"{where}: solve counts {c_c} (exit rn2/bn2 {exit_c:.3g}) against "
          f"the reference step's {c_p} ({exit_p:.3g}) at dir_tol {dtol:.3g}")


def k1_work(k, r, qp):
    """fp32 and fp64 operations of one primal-dual step from k and r alone
    (not from the entries it launched, which its solves' rounds decide):
    the Gram's lower half k·r·(r+1) and one factor r³/3 in fp32; pass 1
    with Cᵀλ (4kr) and, per direction, Cᵀt and C·dz (4kr each) in fp64,
    12kr in all (the refinement's operator applications are left out), and
    P z for a QP (2r²)."""
    return (k * r * (r + 1) + r ** 3 / 3.0,
            12.0 * k * r + (2.0 * r * r if qp else 0.0))


def phase_k1(results):
    for row in ROWS:
        cs, q, z, s, lam, dtol = k1_inputs(row)
        results[("K1", row)] = k1_check(row, cs, q, z, s, lam, dtol,
                                        ladder=row == ROWS[0])


def k1_check(row, cs, q, z, s, lam, dtol, ladder=False):
    """K1 against its plain version at one state: every piece on shared
    inputs (``k1_pieces``; with ``ladder`` the device jitter ladder at
    this r too), then whole steps at the path's own gate and at a strict
    one.  Returns the record."""
    import torch
    from interiorpoint_tpu_torch.ops.pd_step import pd_step, pd_step_plain

    perr, ptol, pinfo, times = k1_pieces(row, cs, q, z, s, lam, dtol)
    if ladder:
        ladder_pieces(f"K1 {row}", cs.r, perr, ptol, pinfo)
    bad = {p: (perr[p], ptol[p]) for p in perr if not perr[p] <= ptol[p]}
    # the whole step at the main path's own gate: no host read inside
    # the CUDA step, the same jitter rung and the same solve counts
    # (rounds, stalled, PCG rounds, PCG kept) per direction as the
    # plain step, and the corrector residual srn2 of the same grade
    rec_c, rec_p = [], []
    (_, _, _, st_c), n_c = step_rounds(pd_step, cs, q, z, s, lam,
                                       dir_tol=dtol, record=rec_c)
    (_, _, _, st_p), n_p = step_rounds(pd_step_plain, cs, q, z, s, lam,
                                       dir_tol=dtol, record=rec_p)
    counts = [solve_counts(rec_c), solve_counts(rec_p)]
    srn2 = [float(st_c[6]) / float(st_c[7]),
            float(st_p[6]) / float(st_p[7])]
    # compared at the strict direction gate (residual exit 1e-8): the
    # two versions build their fp32 preconditioners in different
    # summation orders, so they agree to the refinement exit grade,
    # and the post-step stats (σ = (μ_aff/μ)³, (1−α)·‖rp‖) amplify
    # direction differences; timed at the main path's own gate
    out = pd_step(cs, q, z, s, lam, dir_tol=K1_COMPARE_TOL)
    ref = pd_step_plain(cs, q, z, s, lam, dir_tol=K1_COMPARE_TOL)
    torch.cuda.synchronize()
    errs = [rel_err(a, b) for a, b in zip(out[:3], ref[:3])]
    st, stp = out[3].cpu().tolist(), ref[3].cpu().tolist()
    # ‖rp‖∞ (entries 1, 9) of the exactly feasible warm start is
    # rounding noise (~1e-15): relative to 1e-7·(1 + ‖d‖∞) there
    rp_floor = 1e-7 * (1.0 + float(cs.d.abs().max()))
    st_errs = {i: abs(st[i] - stp[i])
               / max(abs(stp[i]), rp_floor if i in (1, 9) else 1e-12)
               for i in (0, 1, 2, 3, 4, 5, 8, 9, 10)}
    st_err = max(st_errs.values())
    t = time_ms(lambda: pd_step(cs, q, z, s, lam, dir_tol=dtol))
    tp = time_ms(lambda: pd_step_plain(cs, q, z, s, lam, dir_tol=dtol))
    _, entries = entry_deltas(lambda: pd_step(cs, q, z, s, lam,
                                              dir_tol=dtol))
    qp = cs.P is not None
    f32, f64 = k1_work(cs.k, cs.r, qp)
    # in: q, z (r); s, λ, d (k); out: z' (r), s', λ' (k)
    bnd = bound(step_bytes(cs.k, cs.r, qp, 5, 3), f32=f32, f64=f64)
    rec = {"phase": "kernel", "kernel": "K1", "row": row,
           "shape": list(cs.C.shape), "qp": qp,
           "dir_tol_compared": K1_COMPARE_TOL, "dir_tol_timed": dtol,
           "z_rel_err": errs[0], "s_rel_err": errs[1],
           "lam_rel_err": errs[2], "stats_rel_err": st_err,
           "stats": st, "stats_plain": stp,
           "pieces_err": perr, "pieces_tol": ptol,
           "pieces_info": pinfo, "pieces_ms": times,
           "host_reads_at_dir_tol": [n_c, n_p],
           "solve_counts_at_dir_tol": counts,
           "srn2_over_sbn2_at_dir_tol": srn2,
           "max_abs_err": max(abs_err(a, b)
                              for a, b in zip(out[:3], ref[:3])),
           "ms": t, "plain_ms": tp, "step_entries": entries, **bnd}
    emit(rec)
    check(not bad, f"K1 {row}: pieces off against plain: {bad}")
    check(n_c == 0, f"K1 {row}: {n_c} host reads inside the CUDA step")
    check(counts[0] == counts[1],
          f"K1 {row}: [δ, rounds, stalled, PCG rounds, kept] per "
          f"direction {counts[0]} against the plain step's {counts[1]} "
          f"at dir_tol {dtol:.3g}")
    check(srn2[0] <= max(dtol ** 2, srn2[1]),
          f"K1 {row}: corrector residual {srn2} at dir_tol {dtol:.3g}")
    check(max(errs) <= 1e-5, f"K1 {row}: state rel err {errs}")
    check(st_err <= 1e-5, f"K1 {row}: stats rel err {st_err:.3g}")
    return rec


def kkt_certificate(solver, p, gap_tol=True):
    """fp64 KKT certificate of an LP solution (bounds ±3): equality,
    bound and row residuals, and (``gap_tol``) the duality gap."""
    import numpy as np
    x = solver.xstar
    A, b, C, d = p["A"], p["b"], p["C"], p["d"]
    scale = 1.0 + max(np.abs(b).max(), np.abs(d).max(), 3.0)
    eq = float(np.abs(A @ x - b).max())
    bnd = float(max(0.0, (x - 3.0).max(), (-3.0 - x).max()))
    row = float(max(0.0, (C @ x - d).max()))
    gap = float(solver.optimality_gap)
    out = {"eq_inf": eq, "bound_viol": bnd, "row_viol": row, "gap": gap,
           "scale": scale}
    for key in ("eq_inf", "bound_viol", "row_viol"):
        check(out[key] <= 1e-6 * scale, f"certificate {key}: {out}")
    if gap_tol:
        check(gap <= 1e-6 * (1.0 + abs(solver.value)),
              f"certificate gap: {out}")
    return out


def socp_certificate(x, p):
    """fp64 feasibility certificate of an SOCP point: every squared-cone
    slack rhs² − ‖lhs‖² and every rhs = cᵀx + d positive, and
    ‖Fx − g‖∞ ≤ 1e-8·scale, scale = 1 + ‖g‖∞ + ‖F‖∞‖x‖∞."""
    import numpy as np
    rhs = np.array([ci @ x + di for ci, di in zip(p["c"], p["d"])])
    ssq = np.array([float(np.sum((Ai @ x + bi) ** 2))
                    for Ai, bi in zip(p["A"], p["b"])])
    F, g = p["F"], p["g"]
    scale = (1.0 + float(np.abs(g).max())
             + float(np.abs(F).sum(axis=1).max()) * float(np.abs(x).max()))
    out = {"min_cone_slack": float((rhs ** 2 - ssq).min()),
           "min_rhs": float(rhs.min()),
           "eq_inf": float(np.abs(F @ x - g).max()), "scale": scale}
    check(out["min_cone_slack"] > 0 and out["min_rhs"] > 0,
          f"SOCP certificate: a cone is violated: {out}")
    check(out["eq_inf"] <= 1e-8 * scale, f"SOCP certificate: {out}")
    return out


KERNELS = ("K1", "K2", "K2d", "K3a", "K3b", "K4", "K5")


def _kernel_fns():
    """{kernel: (wrapper, plain version)} of every kernel of the port."""
    from interiorpoint_tpu_torch.ops import (chol, kkt_step, newton_step,
                                             pd_step, socp_step)
    return {"K1": (pd_step.pd_step, pd_step.pd_step_plain),
            "K2": (newton_step.newton_step, newton_step.newton_step_plain),
            "K2d": (newton_step.newton_dir, newton_step.newton_dir_plain),
            "K3a": (chol.cholesky_blocked, chol.cholesky_blocked_plain),
            "K3b": (chol.cholesky_solve_blocked,
                    chol.cholesky_solve_blocked_plain),
            "K4": (socp_step.socp_newton_step,
                   socp_step.socp_newton_step_plain),
            "K5": (kkt_step.kkt_dir, kkt_step.kkt_dir_plain)}


# the fp32 factor and inverse entries as launched inside K2's steps on the
# main path (phase_main counts them around each step; only K2's Cholesky
# fallback launches them there)
K2_FALLBACK_ENTRIES = ("ip_chol_factor", "ip_chol_invert")
K2_FALLBACK = {}

# K2's preconditioner wrappers (ops/hybrid.py): their launch counters
# (wrapper, or wrapper.counter); K2.ldl_solve counts every LDL solve,
# K2.ldl_solve_wide those on wsolve.cu's kernel (p > 1: the carry reseed
# M⁻¹I)
K2_PIECES = {"K2.ldl_factor": "ldl_factor_cuda",
             "K2.ldl_solve": "ldl_solve_cuda",
             "K2.ldl_solve_wide": "ldl_solve_cuda.wide_launches",
             "K2.carry_refresh": "ns_refresh_cuda",
             "K2.decide": "decide_cuda",
             "K2.reseed_wtw": "gram_tn_cuda"}


def _piece(name):
    """(wrapper, counter attribute) of a K2_PIECES entry."""
    from interiorpoint_tpu_torch.ops import hybrid
    fn, _, attr = name.partition(".")
    return getattr(hybrid, fn), attr or "launches"


def solve_tally():
    """The refined solves' device tally (ops/pd_step.py ``TALLY``):
    operator passes, refinement rounds, PCG rounds, solves."""
    from interiorpoint_tpu_torch.ops import pd_step
    t = [0, 0, 0, 0]
    for v in pd_step.TALLY.values():
        t = [a + b for a, b in zip(t, v.tolist())]
    return dict(zip(("operator_passes", "rounds", "pcg_rounds", "solves"),
                    t))


# (m, r, with P, counts tensor) of every ip_refined_solve launch since the
# counters were zeroed, while phase_main drives the rows (hop_recording)
HOP_CALLS = []


def hop_recording():
    """Record HOP_CALLS from pd_step._Cuda.refined_solve (K1's and, by
    inheritance, K2's and K4's wrapper; no host read).  Returns the
    undo."""
    from interiorpoint_tpu_torch.ops import pd_step
    orig = pd_step._Cuda.refined_solve

    def recording(M, wt, P, W, dsc, b, refine, stall_rel2, **kw):
        out = orig(M, wt, P, W, dsc, b, refine, stall_rel2, **kw)
        HOP_CALLS.append((M.shape[0], M.shape[1], P is not None, out[4]))
        return out

    pd_step._Cuda.refined_solve = staticmethod(recording)
    return lambda: setattr(pd_step._Cuda, "refined_solve",
                           staticmethod(orig))


def hop_by_shape(calls):
    """{"m x r" (+P): {"launches": n, "passes": operator passes}} of
    HOP_CALLS entries; a solve's passes are rounds + PCG rounds + stalled
    (the PCG's result), as its kernel tallies them."""
    import torch
    if not calls:
        return {}
    c = torch.stack([e[3] for e in calls]).cpu().tolist()
    out = {}
    for (m, r, qp, _), (rounds, stalled, pcg, _) in zip(calls, c):
        d = out.setdefault(f"{m}x{r}" + ("+P" if qp else ""),
                           {"launches": 0, "passes": 0})
        d["launches"] += 1
        d["passes"] += rounds + pcg + stalled
    return out


def merge_by_shape(total, part):
    """Add hop_by_shape's ``part`` into ``total`` (in place)."""
    for k, v in part.items():
        d = total.setdefault(k, {"launches": 0, "passes": 0})
        d["launches"] += v["launches"]
        d["passes"] += v["passes"]
    return total


def counters():
    from interiorpoint_tpu_torch.ops import kkt_step, sync
    from interiorpoint_tpu_torch.ops import newton_step as ns
    from interiorpoint_tpu_torch.kernels import _build
    fns = _kernel_fns()
    launches = {k: f.launches for k, (f, _) in fns.items()}
    launches.update({k: getattr(*_piece(f)) for k, f in K2_PIECES.items()})
    return {
        "launches": launches,
        # K2's preconditioner branches and C·dx sources
        "k2": dict(ns.COUNTS),
        "plain": {k: p.calls for k, (_, p) in fns.items()},
        "entries": dict(_build.LAUNCHES),
        "k2_fallback": dict(K2_FALLBACK),
        # K5's directions, Schur-CG rounds and refined H-solves
        "kkt": dict(kkt_step.COUNTS),
        # K1's and K4's refined solves, counted by their kernel
        "solve": solve_tally(),
        "syncs": sync.count,
    }


def reset_counters():
    from interiorpoint_tpu_torch.ops import kkt_step, pd_step, sync
    from interiorpoint_tpu_torch.ops import newton_step as ns
    from interiorpoint_tpu_torch.kernels import _build
    for f, p in _kernel_fns().values():
        f.launches = 0
        p.calls = 0
    for f in K2_PIECES.values():
        setattr(*_piece(f), 0)
    ns.COUNTS.clear()
    K2_FALLBACK.clear()
    _build.reset_launches()
    kkt_step.COUNTS.clear()
    for t in pd_step.TALLY.values():
        t.zero_()
    HOP_CALLS.clear()
    sync.count = 0


def diff(after, before):
    return {g: {k: after[g].get(k, 0) - before.get(g, {}).get(k, 0)
                for k in after[g]}
            for g in ("launches", "plain", "entries", "kkt", "k2",
                      "k2_fallback", "solve")}


# ---------------------------------------------------------------------------
# K2 on the card: pieces, sweep and whole steps from a row's states
# ---------------------------------------------------------------------------

def k2_states(row, solver):
    """[(label, consts, tc, z, tP, cfg)] of the row: the state the first
    Newton step saw (the warm start at t0, or phase one's start on
    [C | −1] when that start is infeasible) and, for the barrier rows,
    the last one (the final iterate and t)."""
    import torch
    from interiorpoint_tpu_torch.ops.barrier import (
        make_phase1_linear_oracle, make_qp_oracle)
    rf = solver._reduced
    prob = rf.prob
    oracle = make_qp_oracle(prob, try_diag=False)
    cs = oracle.nt_consts()
    C, d, lin, P = oracle.lin_form
    cfg = solver.cfg

    def scaled(t):
        return (t * lin).contiguous(), (None if P is None
                                        else (t * P).contiguous())

    if row == "lp1000_phase1":
        x0 = torch.as_tensor(phase1_x0(1000), dtype=C.dtype, device=C.device)
        z0 = rf.basis.N.T @ (x0 - rf.basis.x_p)
    else:
        z0 = solver._default_z0()
    smin = float((d - C @ z0).min())
    states = []
    if smin > 0:
        tc, tP = scaled(solver._t0(None))
        states.append(("first", cs, tc, z0.contiguous(), tP))
    else:
        p1 = make_phase1_linear_oracle(prob)
        z = torch.cat([z0, z0.new_tensor([1.0 - smin])]).contiguous()
        states.append(("first_phase1", p1.nt_consts(),
                       (cfg.phase1_t0 * p1.lin_form[2]).contiguous(), z,
                       None))
    if row != "lp1000_phase1":
        x = torch.as_tensor(solver.xstar, dtype=C.dtype, device=C.device)
        z_last = (rf.basis.N.T @ (x - rf.basis.x_p)).contiguous()
        tc, tP = scaled(float(solver._result.t))
        states.append(("last", cs, tc, z_last, tP))
    return states


def ldl_backward(Lt, Dinv, x, b):
    """Backward error of x as the LDL solve's M⁻¹b, in fp64 on the factor's
    own M = L̃ X⁻ᵀ L̃ᵀ (L̃ the unit block-lower of Lt's strictly lower
    tiles, X the tile inverses of Dinv): ‖Mx − b‖∞ / (‖M‖∞‖x‖∞ + ‖b‖∞).
    A forward error of the solve grows with L̃'s conditioning; this does
    not."""
    import torch
    from interiorpoint_tpu_torch.ops import hybrid

    t = hybrid.LDL_BLK
    n = Lt.shape[0]
    L = torch.eye(n, dtype=torch.float64, device=Lt.device)
    D = torch.zeros_like(L)
    for k in range(n // t):
        s_k = slice(k * t, (k + 1) * t)
        L[(k + 1) * t:, s_k] = Lt[(k + 1) * t:, s_k].double()
        D[s_k, s_k] = torch.linalg.inv(Dinv[s_k].double().T)
    M = L @ D @ L.T
    # x and b are vectors or (rows, p) matrices, zero-padded to n rows
    xd = torch.zeros((n, x[0].numel()), dtype=torch.float64,
                     device=x.device)
    xd[:min(n, x.shape[0])] = x.double().reshape(x.shape[0], -1)[:n]
    bd = torch.zeros_like(xd)
    bd[:b.shape[0]] = b.double().reshape(b.shape[0], -1)
    return float((M @ xd - bd).abs().max()) / (
        float(M.abs().sum(dim=1).max()) * float(xd.abs().max())
        + float(bd.abs().max()))


def ldl_intermediates(Hs, delta, A, Lt, Dinv, upto):
    """The CUDA LDL factor of Hs + δI held in fp64 by plain torch through
    its own intermediates, tiles 0..``upto`` (``A`` the factor's working
    copy, ``hybrid.ldl_factor_cuda``'s ``work``): every trailing tile as
    stage j read it, Ā_ij = (Hs + δI)_ij − Σ_{m<j} L_im Ā_jmᵀ, and every
    panel L_ij = Ā_ij X_j, each within its fp32 rounding bound
    γ·(the sum of its terms' sizes); and every tile inverse X_i the factor
    left finite by its gate's own quantity on the kernel's Schur tile
    S_i = Ā_ii, ‖I − X·Ds‖_F in fp64, which an fp32 evaluation that
    passed the gate leaves within √gate plus that evaluation's bound
    ‖γ_{b+4}·|X||Ds|‖_F.  Returns (the largest difference over its
    bound, [[tile, ‖I − X·Ds‖²_F in fp64, √gate + bound] of each finite
    X_i], abar: (i, j) ↦ Ā_ij in fp64)."""
    import math

    import torch
    from interiorpoint_tpu_torch.ops import hybrid

    b = hybrid.LDL_BLK
    u32 = 2.0 ** -24

    def g32(n):
        return n * u32 / (1.0 - n * u32)

    eye = torch.eye(b, dtype=torch.float64, device=Hs.device)

    def tile(M, i, j):
        return M[i * b:(i + 1) * b, j * b:(j + 1) * b].double()

    def src(i, j):
        return tile(Hs, i, j) + (delta * eye if i == j else 0.0)

    def abar(i, j):
        return src(i, 0) if j == 0 else tile(A, i, j)

    worst = 0.0
    for i in range(upto + 1):
        for j in range(1, i + 1):
            ref, size = src(i, j), src(i, j).abs()
            for m in range(j):
                lm, am = tile(Lt, i, m), abar(j, m)
                ref = ref - lm @ am.T
                size = size + lm.abs() @ am.abs().T
            worst = max(worst, float(((abar(i, j) - ref).abs()
                                      / (g32(b + j + 1) * size).clamp(
                                          min=1e-300)).max()))
        for j in range(i):
            x = Dinv[j * b:(j + 1) * b].double()
            ref = abar(i, j) @ x
            size = abar(i, j).abs() @ x.abs()
            worst = max(worst, float(((tile(Lt, i, j) - ref).abs()
                                      / (g32(b) * size).clamp(
                                          min=1e-300)).max()))
    tiles = []
    for i in range(upto + 1):
        x = Dinv[i * b:(i + 1) * b].double()
        if not bool(torch.isfinite(x).all()):
            continue
        S = abar(i, i)
        dsc = S.diagonal().clamp(min=1e-300).rsqrt()
        Ds = S * dsc[:, None] * dsc[None, :]
        Xs = x / (dsc[:, None] * dsc[None, :])
        R = eye - Xs @ Ds
        ev = float((g32(b + 4) * (Xs.abs() @ Ds.abs())).norm())
        tiles.append([i, float((R * R).sum()),
                      math.sqrt(hybrid.NS_TILE_GATE2) + ev])
    return worst, tiles, abar


def ldl_dispute(Hs, delta, A, fc, st_p):
    """Where the CUDA and plain LDL factors of Hs + δI take different
    flags: whether the CUDA one's decision stands on its own.  Its
    intermediates must be what its inputs give (``ldl_intermediates``, up
    to the first tile either version refused, or every tile where the
    CUDA factor passed them all), and its decision on that tile k must
    be the plain tile inverse's on the kernel's own Schur tile S_k,
    unless the plain iteration there ends at its cap without reaching its
    target (the fp32 floor, where the summation order decides the gate).
    Returns (record, ok)."""
    import math

    import torch
    from interiorpoint_tpu_torch.ops import hybrid

    b, g = hybrid.LDL_BLK, hybrid.NS_TILE_GATE2
    nt = Hs.shape[0] // b
    kc = next((i for i in range(nt) if not bool(torch.isfinite(
        fc[1][i * b:(i + 1) * b]).all())), None)
    kp = next((i for i in range(nt) if not float(st_p[i, 0]) <= g), None)
    if kc is None and kp is None:
        return {"tile": None}, False
    k = min(i for i in (kc, kp) if i is not None)
    upto = nt - 1 if kc is None else k
    worst, tiles, abar = ldl_intermediates(Hs, delta, A, fc[0], fc[1],
                                           upto)
    rec = {"tile": k, "cuda_refused": kc == k, "plain_refused": kp == k,
           "intermediates_over_bound": worst, "tiles": tiles}
    ok = worst <= 1.0 and all(math.sqrt(r2) <= lim for _, r2, lim in tiles)
    _, bad, f2, its = hybrid.ns_tile_inv_plain(abar(k, k).float())
    rec["plain_on_cuda_schur"] = [bool(bad), float(f2), its]
    if (kc == k) != bool(bad):
        ok = ok and its == hybrid.NS_TILE_ITERS
    return rec, ok


def ldl_tiles_apart(tiles_c, tiles_p):
    """The tiles of one LDL factor whose CUDA Newton–Schulz iterations lie
    more than one from the plain factor's, [[tile, cuda, plain], ...],
    compared (from each factor's stats, [‖I − X·Ds‖²_F, iterations] per
    tile) up to the first tile where either iteration stopped short of
    its target: at its cap or diverging, the count is set by the fp32
    floor's rounding, and every later tile's Schur input carries that
    tile's floor (``ldl_dispute`` and the gate's own checks hold the
    factor there)."""
    from interiorpoint_tpu_torch.ops import hybrid

    out = []
    for i, ((f2c, itc), (f2p, itp)) in enumerate(zip(tiles_c, tiles_p)):
        if not (f2c <= hybrid.NS_TILE_TOL2 and f2p <= hybrid.NS_TILE_TOL2):
            break
        if abs(itc - itp) > 1:
            out.append([i, itc, itp])
    return out


def ldl_tile_iterations(where, Hs, delta, A, fc, tiles):
    """Each tile's Newton–Schulz iterations in the CUDA LDL factor of
    Hs + δI (``A`` its working copy, ``fc`` its (Lt, Dinv), ``tiles`` the
    CUDA and plain stats) within one of the plain factor's
    (``ldl_tiles_apart``); where a tile's lie further apart, within one of
    the plain tile inverse's on the kernel's own Schur tile, the CUDA
    factor's intermediates up to it within their rounding bounds
    (``ldl_intermediates``), as ``ldl_dispute`` settles a flag.  Returns
    the record of the tiles apart, or None where none is."""
    import math

    from interiorpoint_tpu_torch.ops import hybrid

    apart = ldl_tiles_apart(*tiles)
    if not apart:
        return None
    worst, inv, abar = ldl_intermediates(Hs, delta, A, fc[0], fc[1],
                                         apart[-1][0])
    ok = worst <= 1.0 and all(math.sqrt(r2) <= lim for _, r2, lim in inv)
    for t in apart:
        t.append(hybrid.ns_tile_inv_plain(abar(t[0], t[0]).float())[3])
        ok = ok and abs(t[3] - t[1]) <= 1
    check(ok, f"{where}: LDL tile iterations [tile, CUDA, plain, plain on "
          f"the CUDA Schur tile] {apart}, intermediates {worst} of their "
          "bound")
    return {"tiles": apart, "over_bound": worst}


def k2_preconditioner(where, Hp, Hn, err, tol, info, times):
    """K2's preconditioner (ops/newton_step.py ``preconditioner``) on
    shared inputs, CUDA against plain: the Jacobi-scaled Hs of the Gram Hp
    padded to the LDL's 128-wide tiles, then the block-LDL factor at each
    of its jitter rungs (the same accept/fail flag, or one ``ldl_dispute``
    settles; each tile's iterations within one, ``ldl_tile_iterations``;
    where accepted, ‖I − M⁻¹Hs‖_F within 1.25x the plain factor's plus
    1e-4) or, where
    both rungs fail, the pivot-floored Cholesky ladder (the same rungs;
    ‖I − WᵀW·Hs‖_F held the same way); and at np ≤ 512 the carry trial
    from this seed (the plain factor's M⁻¹ or WᵀW) on the next state's Hs
    (Gram Hn): the same hit, a hit only below the gate, ‖I − Hs·X‖_F held
    the same way.  Fills ``times`` with each piece's time at this state
    (ms, plain, library where one PyTorch call computes the same
    function)."""
    import math

    import torch
    from interiorpoint_tpu_torch.ops import hybrid, refine
    from interiorpoint_tpu_torch.ops.newton_step import _Cuda, _Plain

    Hs = _Plain.equilibrate(Hp, hybrid.LDL_BLK)[0]
    np_ = Hs.shape[0]
    eye = torch.eye(np_, dtype=Hs.dtype, device=Hs.device)
    b = Hs @ torch.ones(np_, dtype=Hs.dtype, device=Hs.device)

    def resid(Mi):
        return float((eye - Mi @ Hs).norm())

    took, seed = None, None
    nt = np_ // hybrid.LDL_BLK
    for rung, delta in enumerate(hybrid.LDL_JITTERS):
        st_c = torch.full((nt, 2), float("nan"), device=Hs.device)
        st_p = torch.full((nt, 2), float("nan"), device=Hs.device)
        work = torch.empty_like(Hs)
        fc = _Cuda.ldl_factor(Hs, delta, stats=st_c, work=work)
        fp = _Plain.ldl_factor(Hs, delta, stats=st_p)
        flags = [int(fc[2]), int(fp[2])]
        info[f"ldl{rung}.bad"] = list(flags)
        info[f"ldl{rung}.tiles"] = [st_c.tolist(), st_p.tolist()]
        if flags[0] != flags[1]:
            # the two fp32 iterations' rounding may set a tile at its gate
            # apart: the CUDA factor's decision is held on its own
            # intermediates (``ldl_dispute``); the comparison then goes on
            # along the plain factor's branch, and the whole steps follow
            # the CUDA step's own (``k2_check``)
            rec, ok = ldl_dispute(Hs, delta, work, fc, st_p)
            info["ldl.dispute"] = [delta, rec]
            check(ok, f"{where}: LDL flags {flags} (CUDA, plain) at jitter "
                  f"{delta}, and the CUDA factor's decision does not stand "
                  f"on its own: {rec}")
            flags[0] = flags[1]
        else:
            info[f"ldl{rung}.tiles_apart"] = ldl_tile_iterations(
                f"{where}: jitter {delta}", Hs, delta, work, fc,
                info[f"ldl{rung}.tiles"])
        if rung == 0:
            times["ldl_factor"] = [
                time_ms(lambda: _Cuda.ldl_factor(Hs, 0.0)),
                time_ms(lambda: _Plain.ldl_factor(Hs, 0.0), reps=3), None]
        if flags[1]:
            continue
        took = rung
        seed = _Plain.ldl_solve(fp[0], fp[1], eye)
        info["ldl.resid_plain"] = resid(seed)
        if int(fc[2]) == 0:     # not a disputed tile the CUDA one refused
            info["ldl.Dinv_abs_err"] = abs_err(fc[1], fp[1])
            res_c = resid(_Cuda.ldl_solve(fc[0], fc[1], eye))
            info["ldl.resid"] = res_c
            floor = sorted({i for st in (st_c, st_p)
                            for i, t in enumerate(st.tolist())
                            if t[1] >= hybrid.NS_TILE_ITERS})
            if floor:
                # a tile ended at the iteration cap above its target, in
                # one factor or both (its fp32 floor): the two factors'
                # M⁻¹ part there by that tile's rounding, so the CUDA
                # factor is held on its own intermediates instead, as
                # ldl_dispute holds a flag decided at the floor
                worst, tiles, _ = ldl_intermediates(
                    Hs, delta, work, fc[0], fc[1], nt - 1)
                info["ldl.floor"] = {"tiles": floor, "over_bound": worst,
                                     "inverses": tiles}
                check(worst <= 1.0 and all(math.sqrt(r2) <= lim
                                           for _, r2, lim in tiles),
                      f"{where}: an LDL tile at its fp32 floor and the "
                      f"CUDA factor's intermediates off: {info['ldl.floor']}")
            else:
                err["ldl.resid"] = res_c
                tol["ldl.resid"] = 1.25 * info["ldl.resid_plain"] + 1e-4
        xc = _Cuda.ldl_solve(fp[0], fp[1], b)
        xp = _Plain.ldl_solve(fp[0], fp[1], b)
        # each by its backward error on the factor's own M
        err["ldl.solve"] = ldl_backward(fp[0], fp[1], xc, b)
        tol["ldl.solve"] = 4.0 * ldl_backward(fp[0], fp[1], xp, b) + 1e-7
        info["ldl.solve_abs_err"] = abs_err(xc, xp)
        times["ldl_solve"] = [
            time_ms(lambda: _Cuda.ldl_solve(fp[0], fp[1], b)),
            time_ms(lambda: _Plain.ldl_solve(fp[0], fp[1], b)), None]
        break
    if took is None:
        rungs, seeds = {}, {}
        for name, ops in (("cuda", _Cuda), ("plain", _Plain)):
            seen = []

            class Rec(ops):
                @staticmethod
                def factor(A, delta, _f=ops.factor, _seen=seen):
                    _seen.append(delta)
                    return _f(A, delta)

            W = ops.invert(*refine.factor_jittered(Rec, Hs,
                                                   pivot_floor=True))
            rungs[name], seeds[name] = seen, ops.gram_tn(W)
        info["fallback.rungs"] = rungs
        check(rungs["cuda"] == rungs["plain"],
              f"{where}: Cholesky fallback rungs {rungs}")
        # the ladder as the step runs it: on the device, the pivot floor
        # on its first rung from ip_pivot_floor
        delta_dev = float(refine.factor_jittered_device(
            _Cuda, Hs, pivot_floor=True)[2])
        info["fallback.device_delta"] = delta_dev
        check(delta_dev == rungs["plain"][-1],
              f"{where}: the device ladder took δ = {delta_dev}, the host "
              f"ladder {rungs['plain']}")
        seed = seeds["plain"]
        err["fallback.resid"] = resid(seeds["cuda"])
        info["fallback.resid_plain"] = resid(seed)
        tol["fallback.resid"] = 1.25 * info["fallback.resid_plain"] + 1e-4
    info["preconditioner"] = ("cholesky_fallback" if took is None
                              else f"ldl_rung{took}")
    Lc, Dc, _ = _Cuda.factor(Hs, 1e-6)
    info["cholesky.W_abs_err"] = abs_err(_Cuda.invert(Lc, Dc),
                                         _Plain.invert(Lc, Dc))
    times["cholesky_fallback"] = [
        time_ms(lambda: _Cuda.invert(*_Cuda.factor(Hs, 1e-6)[:2])),
        time_ms(lambda: _Plain.invert(*_Plain.factor(Hs, 1e-6)[:2])),
        time_ms(lambda: torch.linalg.cholesky_ex(Hs))]
    if np_ > hybrid.NS_MAX_RP:
        return
    Hs_n = _Plain.equilibrate(Hn, hybrid.LDL_BLK)[0]
    Xc, hc, r2c, itc = _Cuda.ns_refresh(Hs_n, seed)
    Xp, hp, r2p, itp = _Plain.ns_refresh(Hs_n, seed)
    info["carry"] = {"hit": [int(hc), int(hp)],
                     "rho2": [float(r2c), float(r2p)],
                     "iterations": [int(itc), int(itp)]}
    check(int(hc) == int(hp), f"{where}: carry hits {info['carry']}")
    check(not int(hc) or float(r2c) < hybrid.NS_GATE2,
          f"{where}: the carry hit above its gate: {info['carry']}")
    info["carry.X_abs_err"] = abs_err(Xc, Xp)
    if int(hp):
        # held where the trial converged; a diverging trial's residual is
        # reported only
        err["carry.resid"] = math.sqrt(float(r2c))
        tol["carry.resid"] = 1.25 * math.sqrt(float(r2p)) + 1e-4
        err["carry.X"] = rel_err(Xc, Xp)
        tol["carry.X"] = 1e-2   # two fp32 iterations, preconditioner grade
    times["carry_refresh"] = [
        time_ms(lambda: _Cuda.ns_refresh(Hs_n, seed)),
        time_ms(lambda: _Plain.ns_refresh(Hs_n, seed), reps=3), None]
    # the step's bound counts no carry; the refresh's own work is its
    # iterations' three np³ products (and one for the residual)
    info["carry.bound"] = carry_bound(np_, int(itp))


def step_ldl_branch(where, cs, z, tP32, info):
    """Where the CUDA and plain K2 steps at a state take different LDL
    branches while the two factors agree on the shared Hs: the CUDA
    factor and the plain one on the CUDA step's own Hs (its pass 1, Gram
    and equilibration), rung by rung until the CUDA factor passes.  A
    rung whose flags differ there must be settled by ``ldl_dispute``
    (checked); where they agree, the CUDA branch is the plain factor's on
    the CUDA step's inputs (each held piece by piece).  Returns whether
    the comparison then goes on against the plain step on the CUDA step's
    preconditioner (True unless no rung was compared)."""
    import torch
    from interiorpoint_tpu_torch.ops import hybrid
    from interiorpoint_tpu_torch.ops.newton_step import _Cuda, _Plain

    w = _Cuda.nt_pass1(cs.C, z, cs.d)[2]
    Hs = _Cuda.equilibrate(_Cuda.gram(cs.C32, w, tP32), hybrid.LDL_BLK)[0]
    nt = Hs.shape[0] // hybrid.LDL_BLK
    seen = []
    for delta in hybrid.LDL_JITTERS:
        st_c = torch.full((nt, 2), float("nan"), device=Hs.device)
        st_p = torch.full((nt, 2), float("nan"), device=Hs.device)
        work = torch.empty_like(Hs)
        fc = _Cuda.ldl_factor(Hs, delta, stats=st_c, work=work)
        fp = _Plain.ldl_factor(Hs, delta, stats=st_p)
        flags = [int(fc[2]), int(fp[2])]
        seen.append([delta, flags])
        if flags[0] != flags[1]:
            rec, ok = ldl_dispute(Hs, delta, work, fc, st_p)
            info["ldl.step_dispute"] = [delta, rec]
            check(ok, f"{where}: the step's own LDL flags {flags} (CUDA, "
                  f"plain) at jitter {delta}, and the CUDA factor's decision "
                  f"does not stand on its own: {rec}")
            break
        if flags[0] == 0:
            break
    info["ldl.step_branch"] = seen
    return bool(seen)


def resid_unconverged(res_ref, exit2, floor, info, name):
    """Whether a reference K2 solve stopped above its exit: its residual
    above 4x the larger of the refinement's exit and the rounding floor of
    evaluating it.  Recorded in ``info`` as ``<name>.resid_unconverged``."""
    out = res_ref > 4.0 * max(exit2, floor)
    info[name + ".resid_unconverged"] = bool(out)
    return out


# the seeds of the row permutations of C under which a reference K2 solve
# that stopped above its exit runs again (``k2_check``)
K2_RESID_PERMS = (1, 2, 3)


def permuted_consts(cs, seeds):
    """[(p, the K2 constants of C[p], d[p])] for the row permutations p
    drawn from ``seeds``: the same system, summed in other orders."""
    import numpy as np
    import torch
    from interiorpoint_tpu_torch.ops import newton_step as ns

    out = []
    for s in seeds:
        p = torch.as_tensor(np.random.default_rng(s).permutation(cs.k),
                            device=cs.C.device)
        out.append((p, ns.prep_newton_consts(cs.C[p], cs.d[p])))
    return out


def plain_on_cuda_preconditioner():
    """The plain K2 backend on the CUDA step's fp32 preconditioner: pass
    1, the Gram, the equilibration, the LDL factor, the Cholesky factor
    and inverse, the carry trial and the re-seeds are the CUDA kernels',
    so on the same inputs it takes the CUDA step's branch with the CUDA
    step's M⁻¹ (each of those is held by itself: ``gram_pieces``,
    ``k2_preconditioner``); its applications of the X and LDL forms are
    the CUDA solve's own device functions (``hybrid.precond_apply_cuda``:
    bitwise what ip_refined_solve applies inside itself to the same
    vector); the gradient, the refined solve's fp64 rounds, PCG and
    operator passes, the W form's application and the sweep are plain.
    Where the two versions' preconditioners rightly differ (an LDL tile
    the two fp32 iterations set apart, ``ldl_dispute``), and where the
    reference solve stops above its exit (a PCG out of rounds stops where
    the fp32 preconditioner's rounding sets it), the CUDA step is held
    against it."""
    from interiorpoint_tpu_torch.ops import hybrid
    from interiorpoint_tpu_torch.ops import newton_step as ns
    from interiorpoint_tpu_torch.ops import pd_step

    class PlainOnCuda(ns._Plain):
        nt_pass1 = staticmethod(ns._Cuda.nt_pass1)
        gram = staticmethod(ns._Cuda.gram)
        equilibrate = staticmethod(ns._Cuda.equilibrate)
        ldl_factor = staticmethod(ns._Cuda.ldl_factor)
        ldl_solve = staticmethod(ns._Cuda.ldl_solve)
        invert = staticmethod(ns._Cuda.invert)
        ns_refresh = staticmethod(ns._Cuda.ns_refresh)
        gram_tn = staticmethod(ns._Cuda.gram_tn)
        precond_apply = staticmethod(hybrid.precond_apply_cuda)

        @staticmethod
        def factor(Hs, delta, **kw):
            # looked up per call, so that step_reads records its rungs
            return pd_step._Cuda.factor(Hs, delta, **kw)

    return PlainOnCuda


def k2_check(row, label, cs, tc, z, tP, cfg):
    """K2 and K2d against their plain versions at one state.

    At a deep state the inputs of the direction are themselves ill-
    conditioned: s = d − Cz loses digits where a slack is far below its
    terms (a/|s| reached 5e12 at qp1000's last state), and g is a sum of
    terms ~1e9× larger than itself near the central path.  So no two fp64
    implementations with different summation orders agree on dx or the
    Newton decrement to a fixed relative tolerance there.  Each part is
    held by what its own inputs allow instead: the pieces on shared
    inputs relative to their terms' sizes, the direction by its fp64
    residual, and the decrement within 1e-9 beyond its first-order
    sensitivity to the two versions' differences in g and w, which are
    held to their rounding bounds."""
    import math

    import torch
    from interiorpoint_tpu_torch.kernels import _build
    from interiorpoint_tpu_torch.ops import newton_step as ns
    from interiorpoint_tpu_torch.ops.newton import sigmas
    from interiorpoint_tpu_torch.ops.pd import dir_stall_tol
    from interiorpoint_tpu_torch.ops.pd_step import _Plain

    C, k, r = cs.C, cs.k, cs.r
    Ca = C.abs()
    tPa = None if tP is None else tP.abs()
    tP32 = None if tP is None else tP.float()
    sig = sigmas(cfg, device=C.device)
    alpha = cfg.alpha
    dtol = dir_stall_tol(cfg.epsilon)
    refine = cfg.pallas_refine
    strict2 = K2_STRICT_TOL ** 2
    exit2 = max(strict2 * 1e-4, 1e-25)      # the refinement's own exit
    err, tol, info = {}, {}, {}
    cmp = comparer(err, tol)

    # pass 1.  s = d − Cz is a dot product: its rounding scales with
    # a = |d| + |C||z|, not with s, so s is held relative to a, and 1/s,
    # w = 1/s² entry by entry relative to the condition a/|s| of s
    sc, ic, wc, mc = ns._Cuda.nt_pass1(C, z, cs.d)
    sp, ip_, wp, mp = ns._Plain.nt_pass1(C, z, cs.d)
    a = cs.d.abs() + Ca @ z.abs()
    kap = a / sp.abs()
    err["pass1.s"] = float(((sc - sp).abs() / a).max())
    err["pass1.inv_s"] = float(((ic - ip_).abs() / (ip_.abs() * kap)).max())
    err["pass1.w"] = float(((wc - wp).abs() / (2 * wp.abs() * kap)).max())
    err["pass1.smin"] = float((mc - mp).abs() / a[sp.argmin()])
    for name in ("pass1.s", "pass1.inv_s", "pass1.w", "pass1.smin"):
        tol[name] = PIECE_TOL64
    info["min_slack"] = float(mp)
    info["max_condition_of_s"] = float(kap.max())
    # first-order rounding bound of either version's g (Higham's γₙ of
    # its sums, through 1/s); two versions differ by at most twice it
    rel_s = gamma(r + 1) * kap
    a_g = tc.abs() + Ca.T @ ip_.abs()
    if tP is not None:
        a_g = a_g + tPa @ z.abs()
    b_g = gamma(k + 2) * a_g + Ca.T @ (ip_.abs() * (rel_s + U64))

    # the gradient on shared 1/s, relative to the sizes of its terms
    gsh = {}
    for name, ops in (("cuda", ns._Cuda), ("plain", ns._Plain)):
        gsh[name] = tc + ops.ct_matvec(C, ip_)
        if tP is not None:
            gsh[name] = gsh[name] + ops.p_matvec(tP, z)
    err["grad"] = float(((gsh["cuda"] - gsh["plain"]).abs()
                         / a_g.clamp(min=1e-300)).max())
    tol["grad"] = PIECE_TOL64
    gp = gsh["plain"]
    Hp = gram_pieces(cs.C32, wp, tP32, cmp, err, tol, info)
    D = _Plain.equilibrate(Hp)[1][:r].double()

    def resid(dx, w, g):
        """‖D(H dx + g)‖²/‖D g‖² for H = Cᵀ diag(w) C (+ tP), in fp64 by
        plain torch, and the same ratio for the bound of that
        evaluation's own rounding (below which it cannot tell)."""
        hx = C.T @ (w * (C @ dx))
        fl = Ca.T @ (w * (Ca @ dx.abs()))
        if tP is not None:
            hx = hx + tP @ dx
            fl = fl + tPa @ dx.abs()
        fl = gamma(k + r + 2) * (fl + g.abs())
        gn = float(((D * g) ** 2).sum())
        return (float(((D * (hx + g)) ** 2).sum()) / gn,
                float(((D * fl) ** 2).sum()) / gn)

    # whole steps at the path's own gate: the same candidate, no host read
    # in the CUDA step, and the same decisions (branch, Cholesky rungs,
    # the solve's counts) as in ``reads_check``
    kw = dict(alpha=alpha, refine=cfg.pallas_refine, tP32=tP32)
    (xg, stg), rd_c = step_reads(ns.newton_step, cs, tc, z, tP, sig,
                                 dir_tol=dtol, **kw)
    (xgp, stgp), rd_p = step_reads(ns.newton_step_plain, cs, tc, z, tP, sig,
                                   dir_tol=dtol, **kw)
    # the preconditioner on shared inputs, and the carry trial toward the
    # state the plain step moves to
    times = {}
    w_next = ns._Plain.nt_pass1(C, xgp, cs.d)[2]
    k2_preconditioner(f"K2 {row} {label}", Hp,
                      _Plain.gram(cs.C32, w_next, tP32), err, tol, info,
                      times)
    # where the two LDL factors rightly disagree, every comparison below
    # is against the plain version on the CUDA step's own preconditioner
    # (so on its branch), not on its own
    disputed = "ldl.dispute" in info
    if not disputed and rd_c["branch"] != rd_p["branch"]:
        # each step factors its own Gram's Hs: the CUDA step's branch must
        # be the plain factor's on the CUDA step's own Hs, or a flag at a
        # tile's fp32 floor that ldl_dispute settles there
        disputed = step_ldl_branch(f"K2 {row} {label}", cs, z, tP32, info)
    ref_ops = plain_on_cuda_preconditioner() if disputed else ns._Plain
    info["reference"] = ("plain on the CUDA preconditioner" if disputed
                         else "plain")

    def ref_step(tol_):
        if not disputed:
            return ns.newton_step_plain(cs, tc, z, tP, sig, dir_tol=tol_,
                                        **kw)
        return ns._newton_step(ref_ops, cs, tc, z, tP, tP32, sig, alpha,
                               kw["refine"], float(tol_) ** 2)

    if disputed:
        (xgp, stgp), rd_p = step_reads(ref_step, dtol)
    stg, stgp = stg.tolist(), stgp.tolist()
    Cw = cs.C32 * wp.float()[:, None]
    times["gram"] = [time_ms(lambda: ns._Cuda.gram(cs.C32, wp, tP32)),
                     time_ms(lambda: _Plain.gram(cs.C32, wp, tP32)),
                     time_ms(lambda: torch.matmul(Cw.T, cs.C32))]
    del Cw
    # the direction's solve on shared w and g at the strict gate, each
    # version end to end on its own preconditioner (the reference's is the
    # plain one, or the CUDA one where the two LDL factors rightly
    # disagree): the CUDA dx's residual at most 2x (in norm) the largest
    # of the gate, the reference dx's residual and the rounding floor of
    # evaluating it
    sol = {name: ns._solve_dir(ops, cs, wp, gp, tP, tP32, refine, strict2)
           for name, ops in (("cuda", ns._Cuda), ("plain", ref_ops))}
    dsol = {name: v[0] for name, v in sol.items()}
    # C·dx of the sweep from the last operator pass, against a fresh pass
    # (None where the solve's exit was not an application of its dx: a
    # rejected PCG, and the step then pays one more pass)
    cdx_c = sol["cuda"][3]
    info["side_channel.cdx_taken"] = cdx_c is not None
    if cdx_c is not None:
        fresh = ns._Cuda.c_matvec(C, dsol["cuda"])
        err["side_channel.cdx"] = rel_err(cdx_c, fresh)
        tol["side_channel.cdx"] = PIECE_TOL64
        info["side_channel.cdx_bitwise"] = bool(torch.equal(cdx_c, fresh))
    res_c, _ = resid(dsol["cuda"], wp, gp)
    res_p, floor_p = resid(dsol["plain"], wp, gp)
    info["solve.resid_plain"] = res_p
    info["solve.resid_floor"] = floor_p
    # where the reference solve stopped above its exit (the refinement
    # stalled and the PCG ran out of rounds on a poor fp32 preconditioner,
    # at deep states), where it stops is set by rounding: the reference
    # runs again on the same system under K2_RESID_PERMS's row
    # permutations of C, and the CUDA residual is held against the
    # largest of those residuals and its own
    perms = None
    if resid_unconverged(res_p, exit2, floor_p, info, "solve"):
        perms = permuted_consts(cs, K2_RESID_PERMS)
        spread = [resid(ns._solve_dir(ref_ops, q, wp[p], gp, tP, tP32,
                                      refine, strict2)[0], wp, gp)
                  for p, q in perms]
        info["solve.resid_permuted"] = [v[0] for v in spread]
        res_p = max([res_p] + [v[0] for v in spread])
        floor_p = max([floor_p] + [v[1] for v in spread])
    err["solve.resid"] = res_c
    tol["solve.resid"] = 4.0 * max(exit2, floor_p, res_p)
    info["solve.dx_vs_plain"] = rel_err(dsol["cuda"], dsol["plain"])

    # the sweep on shared inputs: the plain direction at the strict gate
    dx, g, _ = ns.newton_dir_plain(cs, tc, z, tP, dir_tol=K2_STRICT_TOL,
                                   tP32=tP32)
    cdx = C @ dx
    gdx = g @ dx
    q2 = (0.5 * (dx @ (tP @ dx)) if tP is not None
          else torch.zeros_like(gdx))
    phc, umc, selc, xc = ns._Cuda.sweep(cdx, ip_, sig, gdx, q2, alpha, z, dx)
    php, ump, selp, xp = ns._Plain.sweep(cdx, ip_, sig, gdx, q2, alpha, z,
                                         dx)
    fin = torch.isfinite(php)
    check(torch.equal(torch.isfinite(phc), fin),
          f"K2 {row} {label}: the sweep's finite candidates differ")
    err["sweep.phisum"] = float(((phc - php).abs() / php.abs().clamp(
        min=1e-300))[fin].max()) if bool(fin.any()) else 0.0
    tol["sweep.phisum"] = PIECE_TOL64
    cmp("sweep.umax", umc, ump, PIECE_TOL64)
    cmp("sweep.x_new", xc, xp, PIECE_TOL64)
    sel_c, sel_p = selc.tolist(), selp.tolist()
    check(sel_c == sel_p, f"K2 {row} {label}: sweep selections {sel_c} "
          f"against {sel_p}")
    info["finite_candidates"] = int(fin.sum())
    info["sweep_selection"] = sel_p
    # max u again with the rows rolled so that the largest u falls on the
    # last row of the first block of the sweep, and on the last row of C
    # (a reduction that drops a block's edge row is exact elsewhere)
    i_max = int((cdx * ip_).argmax())
    edge = 0.0
    for pos in (_build.query("ip_sweep_rows") - 1, k - 1):
        shift = (pos - i_max) % k
        args = (cdx.roll(shift), ip_.roll(shift), sig, gdx, q2, alpha, z, dx)
        edge = max(edge, rel_err(ns._Cuda.sweep(*args)[1],
                                 ns._Plain.sweep(*args)[1]))
    err["sweep.umax_at_block_edges"] = edge
    tol["sweep.umax_at_block_edges"] = PIECE_TOL64

    # ... and at the strict gate: x' and the Newton decrement to 1e-9
    (xs, sts), ds_entries = entry_deltas(lambda: ns.newton_step(
        cs, tc, z, tP, sig, dir_tol=K2_STRICT_TOL, **kw))
    xsp, stsp = ref_step(K2_STRICT_TOL)
    sts, stsp = sts.tolist(), stsp.tolist()
    xs_ref = xsp
    if perms is not None and not disputed:
        # the reference solve stopped above its exit at the strict gate
        # (solve.resid_unconverged): where a PCG that runs out of rounds
        # stops, and with it x', is set by the fp32 preconditioner's
        # rounding, so x' is held against the plain step on the CUDA
        # step's preconditioner applied in the CUDA solve's own order
        xs_ref = ns._newton_step(plain_on_cuda_preconditioner(), cs, tc, z,
                                 tP, tP32, sig, alpha, kw["refine"],
                                 K2_STRICT_TOL ** 2)[0]
    info["step.x_new_reference"] = (
        "plain on the CUDA preconditioner"
        if disputed or perms is not None else "plain")
    cmp("step.x_new", xs, xs_ref, K2_STEP_TOL)
    # the direction alone (K2d), strict gate: its g within twice the
    # rounding bound of the plain one's (held as a ratio to the bound),
    # and its dx by its residual on the system its own pass 1 built,
    # against the reference direction's on its own
    dxc, gc, rnc = ns.newton_dir(cs, tc, z, tP, dir_tol=K2_STRICT_TOL,
                                 tP32=tP32)
    err["dir.g_over_bound"] = float(((gc - g).abs()
                                     / (2.0 * b_g).clamp(min=1e-300)).max())
    tol["dir.g_over_bound"] = 1.0
    dx_r, g_r, w_r = dx, g, wp
    if disputed:
        dx_r, g_r = ns._direction(ref_ops, cs, tc, z, tP, tP32, 3,
                                  K2_STRICT_TOL ** 2)[:2]
        w_r = wc
    res_d, _ = resid(dxc, wc, gc)
    res_dp, floor_dp = resid(dx_r, w_r, g_r)
    info["dir.resid_plain"] = res_dp
    # held as solve.resid is, each permuted direction by its residual on
    # its own pass 1 and gradient
    if resid_unconverged(res_dp, exit2, floor_dp, info, "dir"):
        spread = []
        for p, q in perms or permuted_consts(cs, K2_RESID_PERMS):
            dq, gq = ns._direction(ref_ops, q, tc, z, tP, tP32, 3,
                                   strict2)[:2]
            wq = torch.empty_like(w_r)
            wq[p] = ref_ops.nt_pass1(q.C, z, q.d)[2]
            spread.append(resid(dq, wq, gq))
        info["dir.resid_permuted"] = [v[0] for v in spread]
        res_dp = max([res_dp] + [v[0] for v in spread])
        floor_dp = max([floor_dp] + [v[1] for v in spread])
    err["dir.resid"] = res_d
    tol["dir.resid"] = 4.0 * max(exit2, floor_dp, res_dp)
    # reported only: the plain refinement on the CUDA direction's own pass
    # 1 and preconditioner, at the strict gate
    dpc = ns._direction(plain_on_cuda_preconditioner(), cs, tc, z, tP,
                        tP32, 3, K2_STRICT_TOL ** 2)
    info["dir.resid_plain_on_cuda"] = resid(dpc[0], wc, dpc[1])[0]
    # nd = ½ gᵀH⁻¹g moves by −dx·δg − ½ Σ δwᵢ (C dx)ᵢ² with its inputs
    # (first order), by ½ dx·r under each solve's residual r, and by the
    # dot's own rounding.  Held within 1e-9 relative plus twice the first
    # term for the two versions' measured δg and δw (each held above to
    # its rounding bound) and the other two terms
    nd_p = abs(stsp[ns.ST_ND])
    allow = (2.0 * float((dx_r.abs() * (gc - g_r).abs()).sum())
             + float(((wc - w_r).abs() * (C @ dx_r) ** 2).sum())
             + 0.5 * float((dx_r / D).norm()) * (math.sqrt(sts[ns.ST_RN2])
                                                 + math.sqrt(
                                                     stsp[ns.ST_RN2]))
             + 2.0 * gamma(r) * float((g_r.abs() * dx_r.abs()).sum()))
    err["step.nd"] = abs(sts[ns.ST_ND] - stsp[ns.ST_ND]) / max(nd_p, 1e-300)
    tol["step.nd"] = K2_STEP_TOL + allow / max(nd_p, 1e-300)
    info["step.nd_allowance"] = allow / max(nd_p, 1e-300)
    info["dir.dx_vs_plain"] = rel_err(dxc, dx_r)
    torch.cuda.synchronize()

    # the refined solve on the step's own preconditioner (X or W as its
    # branch decides), CUDA against plain on the same Precond
    Hc = ns._Cuda.gram(cs.C32, wp, tP32)
    pre = ns.preconditioner(ns._Cuda, Hc)
    sargs = (C, wp, tP, pre.W, pre.dsc, -gp, refine, strict2)
    skw = dict(kind=pre.kind, X=pre.X, ldl=pre.ldl)
    sc = ns._Cuda.refined_solve(*sargs, **skw)
    sp = ns._Plain.refined_solve(*sargs, **skw)
    info["solve.form"] = int(pre.kind)
    info["solve.counts"] = [sc[4].tolist(), sp[4].tolist()]
    info["solve.x_rel_err"] = rel_err(sc[0], sp[0])
    if info["solve.form"]:
        # the X or LDL form alone on the solve's first vector, float(D b),
        # against its plain twin (reported: the form is held through the
        # solves above)
        from interiorpoint_tpu_torch.ops import hybrid
        v32 = (-gp * pre.dsc[:r].double()).float()
        info["precond_apply.vs_plain"] = rel_err(
            hybrid.precond_apply_cuda(info["solve.form"], pre.X, pre.ldl,
                                      v32),
            hybrid.precond_apply_plain(info["solve.form"], pre.X, pre.ldl,
                                       v32))
    times["refined_solve"] = [
        time_ms(lambda: ns._Cuda.refined_solve(*sargs, **skw)),
        time_ms(lambda: ns._Plain.refined_solve(*sargs, **skw), reps=3),
        None]
    info["refined_solve.device_ms"] = queued_ms(
        lambda: ns._Cuda.refined_solve(*sargs, **skw), n=16)
    times["preconditioner"] = [
        time_ms(lambda: ns.preconditioner(ns._Cuda, Hc)),
        time_ms(lambda: ns.preconditioner(ns._Plain, Hc), reps=3), None]
    del Hc, pre, sargs, skw, sc, sp

    # no host read inside a step, a direction, or a pair of steps with the
    # carry (where r allows it: the second tries it) on the card
    from interiorpoint_tpu_torch.ops import hybrid, sync

    def steps():
        ns.newton_step(cs, tc, z, tP, sig, dir_tol=dtol, **kw)
        ns.newton_dir(cs, tc, z, tP, dir_tol=dtol, tP32=tP32)
        branches = []
        if hybrid.ns_carry_supported(r):
            carry = ns.NSCarry()
            zc = z
            for _ in range(2):
                zc, stc = ns.newton_step(cs, tc, zc, tP, sig, dir_tol=dtol,
                                         carry=carry, **kw)
                branches.append(stc[ns.ST_BRANCH])
        return branches

    # ... nor any other operation that waits for the device
    c0 = sync.count
    carry_branches, hidden = hidden_syncs(steps)
    torch.cuda.synchronize()
    info["syncs_inside_steps"] = sync.count - c0
    info["hidden_syncs_inside_steps"] = hidden
    info["carry_branches"] = [int(b) for b in carry_branches]
    check(info["syncs_inside_steps"] == 0 and not hidden,
          f"K2 {row} {label}: {info['syncs_inside_steps']} host reads and "
          f"synchronizing operations at {hidden} inside the steps on the "
          "card")

    t_step = time_ms(lambda: ns.newton_step(cs, tc, z, tP, sig,
                                            dir_tol=dtol, **kw))
    t_step_p = time_ms(lambda: ns.newton_step_plain(cs, tc, z, tP, sig,
                                                    dir_tol=dtol, **kw))
    t_dir = time_ms(lambda: ns.newton_dir(cs, tc, z, tP, dir_tol=dtol,
                                          tP32=tP32))
    t_dir_p = time_ms(lambda: ns.newton_dir_plain(cs, tc, z, tP,
                                                  dir_tol=dtol, tP32=tP32))
    _, st_entries = entry_deltas(lambda: ns.newton_step(
        cs, tc, z, tP, sig, dir_tol=dtol, **kw))
    _, dir_entries = entry_deltas(lambda: ns.newton_dir(
        cs, tc, z, tP, dir_tol=dtol, tP32=tP32))
    qp = tP is not None
    # step: in tc, z (r), d (k), sigmas; out x' (r); dir: out dx, g (r);
    # the operations from k and r alone (``k2_work``)
    f32, f64 = k2_work(k, r, qp)
    step_bound = bound(step_bytes(k, r, qp, 1, 3) + 8 * sig.numel(),
                       f32=f32, f64=f64)
    dir_bound = bound(step_bytes(k, r, qp, 1, 4), f32=f32, f64=f64)
    bad = {p: (err[p], tol[p]) for p in err if not err[p] <= tol[p]}
    reads = reads_readings(rd_c, rd_p, stg, stgp)
    rec = {"phase": "kernel", "kernel": "K2", "row": row, "state": label,
           "shape": [k, r], "qp": qp, "dir_tol": dtol,
           "dir_tol_strict": K2_STRICT_TOL,
           "stats": stg, "stats_plain": stgp,
           "stats_strict": sts, "stats_strict_plain": stsp,
           **reads, "pieces_err": err, "pieces_tol": tol,
           "pieces_info": info,
           "max_abs_err": abs_err(xs, xs_ref), "dir_max_abs_err":
           abs_err(dxc, dx), "strict_step_entries": ds_entries,
           "step_entries": st_entries, "ms": t_step, "plain_ms": t_step_p,
           "dir_ms": t_dir, "dir_plain_ms": t_dir_p,
           "step_bound": step_bound, "dir_bound": dir_bound,
           "pieces_ms": times}
    emit(rec)
    check(not bad, f"K2 {row} {label}: pieces off against plain: {bad}")
    check(stg[ns.ST_INDEX] == stgp[ns.ST_INDEX]
          and stg[ns.ST_ANY] == stgp[ns.ST_ANY],
          f"K2 {row} {label}: candidate {stg[ns.ST_INDEX]} against the "
          f"reference step's {stgp[ns.ST_INDEX]}")
    reads_check(f"K2 {row} {label}", reads, dtol)
    return rec


# ---------------------------------------------------------------------------
# K4 on the card: pieces, sweep and whole steps from the SOCP row's states
# ---------------------------------------------------------------------------

def k4_states(solver):
    """[(label, consts, tq, z, tP)] of the reduced SOCP row: the state its
    first K4 step saw (the projected start at t0) and its last one (the
    final iterate and t)."""
    import torch
    rf = solver._reduced
    prob = rf.prob
    cs = solver._oracle_fn_z(prob).socp_consts()
    N, x_p = rf.basis.N, rf.basis.x_p

    def scaled(t):
        tq = (t * prob.q if prob.q is not None
              else torch.zeros(cs.r, dtype=N.dtype, device=N.device))
        return tq.contiguous(), (None if prob.P is None
                                 else (t * prob.P).contiguous())

    x = torch.as_tensor(solver.xstar, dtype=N.dtype, device=N.device)
    tq0, tP0 = scaled(solver._t0(None))
    tq1, tP1 = scaled(float(solver._result.t))
    return [("first", cs, tq0, solver._default_z0().contiguous(), tP0),
            ("last", cs, tq1, (N.T @ (x - x_p)).contiguous(), tP1)]


def k4_work(K, M, r, qp):
    """fp32 and fp64 operations of one K4 step from its shapes alone (not
    from the entries it launched, which its solve's rounds decide): the
    Gram's lower half of the stacked (K·M + 2K) × r matrix and one factor
    r³/3 in fp32; pass 1, the G pass and the line-search pass over A
    (2·K·M·r each) in fp64, 6·K·M·r in all (the refinement's operator
    applications are left out), and tP z for a QP (2r²)."""
    return ((K * M + 2 * K) * r * (r + 1) + r ** 3 / 3.0,
            6.0 * K * M * r + (2.0 * r * r if qp else 0.0))


def k4_check(row, label, cs, tq, z, tP, cfg):
    """K4 against its plain version at one state, held as ``k2_check``
    holds K2: each piece on shared inputs relative to the sizes of its
    terms (lhs and rhs are dot products; s = rhs² − ‖lhs‖² cancels; w =
    2/(s+ε) inherits the condition of s), the Gram by its error against
    the fp64 product, the direction by its fp64 residual, the sweep on
    shared coefficients (and once on coefficients where the rhs ≥ 0 test
    alone decides), the fused operator and the refined solve on the
    stacked matrix (``operator_pieces``), then whole steps at the path's
    gate (same candidate, no host read in the CUDA step, the same jitter
    rung and solve counts as the plain step) and at a strict gate (x' to 1e-9, the Newton
    decrement within 1e-9 beyond its first-order sensitivity to the two
    versions' own pass-1 and gradient differences)."""
    import math

    import numpy as np

    import torch
    from interiorpoint_tpu_torch.ops import newton_step as ns
    from interiorpoint_tpu_torch.ops import socp_step as ks
    from interiorpoint_tpu_torch.ops.newton import sigmas
    from interiorpoint_tpu_torch.ops.pd import dir_stall_tol
    from interiorpoint_tpu_torch.ops.pd_step import _Cuda, _Plain

    A, K, M, r = cs.A, cs.K, cs.M, cs.r
    Aa, ca = A.abs(), cs.c.abs()
    tPa = None if tP is None else tP.abs()
    tP32 = None if tP is None else tP.float()
    sig = sigmas(cfg, device=A.device)
    alpha, refine = cfg.alpha, cfg.pallas_refine
    dtol = dir_stall_tol(cfg.epsilon)
    strict2 = K2_STRICT_TOL ** 2
    exit2 = max(strict2 * 1e-4, 1e-25)
    err, tol, info = {}, {}, {}
    cmp = comparer(err, tol)

    def held(name, diff, size):
        err[name] = float((diff.abs() / size.clamp(min=1e-300)).max())
        tol[name] = PIECE_TOL64

    # pass 1, each version into stacked weights [w_row; w; w²] of its own
    # (the plain version's, wt, are the ones the pieces below share)
    km = K * M
    wt = torch.empty(km + 2 * K, dtype=A.dtype, device=A.device)
    lc, rc, sc, wc, wrc, mc = ks._Cuda.socp_pass1(A, z, cs.b, cs.c, cs.d, M,
                                                  torch.empty_like(wt))
    lp, rp, sp, wp, wrp, mp = ks._Plain.socp_pass1(A, z, cs.b, cs.c, cs.d, M,
                                                   wt)
    a_l = Aa @ z.abs() + cs.b.abs()
    a_r = ca @ z.abs() + cs.d.abs()
    size_s = (rp * rp + (lp * lp).reshape(K, M).sum(1)
              + 2.0 * rp.abs() * a_r
              + 2.0 * (lp.abs() * a_l).reshape(K, M).sum(1))
    kap = size_s / sp.abs()
    held("pass1.lhs", lc - lp, a_l)
    held("pass1.rhs", rc - rp, a_r)
    held("pass1.ssq", (rc * rc - sc) - (rp * rp - sp), size_s)
    held("pass1.s", sc - sp, size_s)
    held("pass1.w", wc - wp, wp.abs() * kap)
    err["pass1.w_row_gather"] = float(
        (wrc != wc.repeat_interleave(M)).sum())
    err["pass1.smin"] = float(mc != sc.min())
    tol["pass1.w_row_gather"] = tol["pass1.smin"] = 0.0
    info["min_slack"] = float(mp)
    info["max_condition_of_s"] = float(kap.max())

    # G and the gradient on shared lhs, rhs and w
    Gc, wGc = ks._Cuda.socp_gcone(A, lp, cs.c, rp, wp, M,
                                  torch.empty_like(cs.c))
    Gp, wGp = ks._Plain.socp_gcone(A, lp, cs.c, rp, wp, M,
                                   torch.empty_like(cs.c))
    a_G = (torch.einsum("kmr,km->kr", Aa.reshape(K, M, r),
                        lp.abs().reshape(K, M)) + rp.abs()[:, None] * ca)
    held("G", Gc - Gp, a_G)
    a_g = tq.abs() + wp.abs() @ a_G
    g_c, g_p = tq + wGc, tq + wGp
    if tP is not None:
        g_c = g_c + _Cuda.p_matvec(tP, z)
        g_p = g_p + _Plain.p_matvec(tP, z)
        a_g = a_g + tPa @ z.abs()
    held("grad", g_c - g_p, a_g)

    # the fp32 preconditioner's Gram: one Gram of the stacked [A; c; G]
    # with the weights [w_row; w; w²] (+ tP32), both written as the step
    # writes them (the plain pass 1 and G again, into wt and cs.Ast)
    times = {}
    ks._gradient(ks._Plain, cs, tq, z, tP, wt)
    S, ws = cs.Ast[km:], wt[km:]
    Hp = gram_pieces(cs.Ast32, wt, tP32, cmp, err, tol, info)
    Mw = cs.Ast32 * wt.float()[:, None]
    times["gram"] = [time_ms(lambda: _Cuda.gram(cs.Ast32, wt, tP32)),
                     time_ms(lambda: _Plain.gram(cs.Ast32, wt, tP32)),
                     time_ms(lambda: torch.matmul(Mw.T, cs.Ast32))]
    del Mw
    D = _Plain.equilibrate(Hp)[1][:r].double()
    Sa = S.abs()

    def resid(dx, g):
        """‖D(H dx + g)‖²/‖D g‖² for the oracle's Hessian on the shared
        inputs, in fp64 by plain torch, and the same ratio for the bound
        of that evaluation's own rounding."""
        hx = A.T @ (wrp * (A @ dx)) + S.T @ (ws * (S @ dx))
        fl = Aa.T @ (wrp * (Aa @ dx.abs())) + Sa.T @ (ws * (Sa @ dx.abs()))
        if tP is not None:
            hx = hx + tP @ dx
            fl = fl + tPa @ dx.abs()
        fl = gamma(K * M + r + 2) * (fl + g.abs())
        gn = float(((D * g) ** 2).sum())
        return (float(((D * (hx + g)) ** 2).sum()) / gn,
                float(((D * fl) ** 2).sum()) / gn)

    dsol = {name: ks._solve_dir(ops, cs, wt, g_p, tP, tP32, refine,
                                strict2)[0]
            for name, ops in (("cuda", ks._Cuda), ("plain", ks._Plain))}
    # the fused operator and the refined solve on the stacked matrix at
    # this state (the CUDA preconditioner, b = −g), and the pieces' times
    from interiorpoint_tpu_torch.ops import refine as rf
    Hs_c, dsc_c = _Cuda.equilibrate(_Cuda.gram(cs.Ast32, wt, tP32))
    Lc, Dc, _ = rf.factor_jittered_device(_Cuda, Hs_c)
    Wc = _Cuda.invert(Lc, Dc)
    xr = torch.as_tensor(np.random.default_rng(K * M + r).standard_normal(r),
                         dtype=A.dtype, device=A.device)
    operator_pieces(f"K4 {row} {label}", cs.Ast, wt, tP, xr, -g_p, Wc,
                    dsc_c, refine, dtol ** 2, cmp, err, tol, info, times)
    times["factor_rungs"] = [
        time_ms(lambda: rf.factor_jittered_device(_Cuda, Hs_c)),
        time_ms(lambda: rf.factor_jittered_device(_Plain, Hs_c), reps=3),
        None]
    times["inverse"] = [time_ms(lambda: _Cuda.invert(Lc, Dc)),
                        time_ms(lambda: _Plain.invert(Lc, Dc)), None]
    res_c, _ = resid(dsol["cuda"], g_p)
    res_p, floor_p = resid(dsol["plain"], g_p)
    err["solve.resid"] = res_c
    tol["solve.resid"] = 4.0 * max(exit2, floor_p, res_p)
    info["solve.resid_plain"] = res_p
    info["solve.resid_floor"] = floor_p
    info["solve.dx_vs_plain"] = rel_err(dsol["cuda"], dsol["plain"])

    # the line-search coefficients on the shared (plain) direction and its
    # A dx
    dx = dsol["plain"]
    adx_p, cdx_p = A @ dx, cs.c @ dx
    ipc = ks._Cuda.socp_lscoef(adx_p, lp, M)
    ipp = ks._Plain.socp_lscoef(adx_p, lp, M) + (cdx_p,)
    adx = (Aa @ dx.abs()).reshape(K, M)
    for name, a, b, size in zip(
            ("ip1", "ip2"), ipc, ipp,
            ((lp.abs().reshape(K, M) * adx).sum(1), (adx * adx).sum(1))):
        held("lscoef." + name, a - b, size)

    # the sweep on shared coefficients
    gdx = g_p @ dx
    q2 = (0.5 * (dx @ (tP @ dx)) if tP is not None
          else torch.zeros_like(gdx))
    phc, umc, vmc, selc, xc = ks._Cuda.socp_sweep(*ipp, rp, sp, sig, gdx, q2,
                                                 alpha, z, dx)
    php, ump, vmp, selp, xp = ks._Plain.socp_sweep(*ipp, rp, sp, sig, gdx,
                                                   q2, alpha, z, dx)
    fin = torch.isfinite(php)
    check(torch.equal(torch.isfinite(phc), fin),
          f"K4 {row} {label}: the sweep's finite candidates differ")
    err["sweep.phisum"] = float(((phc - php).abs() / php.abs().clamp(
        min=1e-300))[fin].max()) if bool(fin.any()) else 0.0
    tol["sweep.phisum"] = PIECE_TOL64
    cmp("sweep.umin", umc, ump, PIECE_TOL64)
    cmp("sweep.vmin", vmc, vmp, PIECE_TOL64)
    cmp("sweep.x_new", xc, xp, PIECE_TOL64)
    check(selc.tolist() == selp.tolist(), f"K4 {row} {label}: sweep "
          f"selections {selc.tolist()} against {selp.tolist()}")
    info["sweep_selection"] = selp.tolist()
    # coefficients where only the rhs ≥ 0 test decides: cone 0's step
    # keeps its squared slack (p1 = p2 = 0) but leaves rhs ≥ 0 at σ ≥ 0.5
    one = torch.ones(K, dtype=A.dtype, device=A.device)
    e0 = torch.zeros_like(one)
    e0[0] = 1.0
    rhs_case = (-2.0 * e0, 4.0 * e0, -2.0 * e0, one, one, sig,
                -one[0], 0.0 * one[0], alpha, z, dx)
    sel_rc = ks._Cuda.socp_sweep(*rhs_case)[3].tolist()
    sel_rp = ks._Plain.socp_sweep(*rhs_case)[3].tolist()
    check(sel_rc == sel_rp and sel_rp[0] < 0.5, f"K4 {row} {label}: rhs-"
          f"decided sweep selections {sel_rc} against {sel_rp}")

    # the tail kernels: g·dx and q2, and the stats row from them
    tpdx = None if tP is None else tP @ dx
    for name, a, b in zip(("gdx", "q2"), ks._Cuda.socp_dots(g_p, dx, tpdx),
                          ks._Plain.socp_dots(g_p, dx, tpdx)):
        cmp("dots." + name, a, b, PIECE_TOL64)
    st_args = (gdx, q2, gdx.abs() * 1e-6, gdx.abs(), selp, sp.min())
    cmp("stats_row", ks._Cuda.socp_stats(*st_args),
        ks._Plain.socp_stats(*st_args), 0.0)
    times["line_search"] = [
        time_ms(lambda: ks._Cuda.socp_sweep(
            *ks._Cuda.socp_lscoef(adx_p, lp, M), cdx_p, rp, sp, sig, gdx, q2,
            alpha, z, dx)),
        time_ms(lambda: ks._Plain.socp_sweep(
            *ks._Plain.socp_lscoef(adx_p, lp, M), cdx_p, rp, sp, sig, gdx,
            q2, alpha, z, dx)), None]

    # whole steps at the path's own gate: the same candidate, no host
    # read inside the CUDA step, the same jitter rung and solve counts
    kw = dict(alpha=alpha, refine=refine, tP32=tP32)
    rec_c, rec_p = [], []
    (xg, stg), n_c = step_rounds(ks.socp_newton_step, cs, tq, z, tP, sig,
                                 dir_tol=dtol, record=rec_c, **kw)
    (xgp, stgp), n_p = step_rounds(ks.socp_newton_step_plain, cs, tq, z, tP,
                                   sig, dir_tol=dtol, record=rec_p, **kw)
    counts = [solve_counts(rec_c), solve_counts(rec_p)]
    stg, stgp = stg.tolist(), stgp.tolist()
    # ... and at the strict gate: x' to 1e-9, and the decrement
    (xs, sts), ds_entries = entry_deltas(lambda: ks.socp_newton_step(
        cs, tq, z, tP, sig, dir_tol=K2_STRICT_TOL, **kw))
    xsp, stsp = ks.socp_newton_step_plain(cs, tq, z, tP, sig,
                                          dir_tol=K2_STRICT_TOL, **kw)
    sts, stsp = sts.tolist(), stsp.tolist()
    cmp("step.x_new", xs, xsp, K2_STEP_TOL)
    # nd = ½ gᵀH⁻¹g moves by −dx·δg − ½ dxᵀδH dx with the versions' own
    # g and H (δH from δw and δG), by ½ dx·r under each solve's residual
    # and by the dot's rounding; held as K2's
    gfc, (_, _, _, wfc, _, _) = ks._gradient(ks._Cuda, cs, tq, z, tP,
                                             torch.empty_like(wt))
    Gfc = cs.Ast[km + K:].clone()
    gfp, (_, _, _, wfp, _, _) = ks._gradient(ks._Plain, cs, tq, z, tP, wt)
    Gfp = cs.Ast[km + K:]
    ip2, cdx = ipp[1], ipp[2]
    allow = (2.0 * float((dx.abs() * (gfc - gfp).abs()).sum())
             + float(((wfc - wfp).abs() * (ip2 + cdx * cdx)).sum())
             + float(((wfc * (Gfc @ dx)) ** 2
                      - (wfp * (Gfp @ dx)) ** 2).abs().sum())
             + 0.5 * float((dx / D).norm()) * (math.sqrt(sts[ns.ST_RN2])
                                               + math.sqrt(stsp[ns.ST_RN2]))
             + 2.0 * gamma(r) * float((gfp.abs() * dx.abs()).sum()))
    nd_p = abs(stsp[ns.ST_ND])
    err["step.nd"] = abs(sts[ns.ST_ND] - stsp[ns.ST_ND]) / max(nd_p, 1e-300)
    tol["step.nd"] = K2_STEP_TOL + allow / max(nd_p, 1e-300)
    info["step.nd_allowance"] = allow / max(nd_p, 1e-300)
    torch.cuda.synchronize()

    # pass 1, the G pass and the curvature rows as the step runs them:
    # into stacked weights and the stacked matrix's G rows
    wt_t = torch.empty_like(wt)
    times["pass1_and_gradient"] = [
        time_ms(lambda: ks._gradient(ks._Cuda, cs, tq, z, tP, wt_t)),
        time_ms(lambda: ks._gradient(ks._Plain, cs, tq, z, tP, wt_t)), None]
    t_step = time_ms(lambda: ks.socp_newton_step(cs, tq, z, tP, sig,
                                                 dir_tol=dtol, **kw))
    t_step_p = time_ms(lambda: ks.socp_newton_step_plain(
        cs, tq, z, tP, sig, dir_tol=dtol, **kw))
    _, st_entries = entry_deltas(lambda: ks.socp_newton_step(
        cs, tq, z, tP, sig, dir_tol=dtol, **kw))
    f32, f64 = k4_work(K, M, r, tP is not None)
    # in: A (fp64 and fp32), b, c, d, tq, z, tP (fp64 and fp32), σ;
    # out: x'
    nbytes = (12 * K * M * r + 8 * (K * M + K * r + K + 3 * r + sig.numel())
              + (12 * r * r if tP is not None else 0))
    bnd = bound(nbytes, f32=f32, f64=f64)
    bad = {p: (err[p], tol[p]) for p in err if not err[p] <= tol[p]}
    rec = {"phase": "kernel", "kernel": "K4", "row": row, "state": label,
           "shape": [K, M, r], "qp": tP is not None, "dir_tol": dtol,
           "dir_tol_strict": K2_STRICT_TOL,
           "stats": stg, "stats_plain": stgp,
           "stats_strict": sts, "stats_strict_plain": stsp,
           "host_reads_at_dir_tol": [n_c, n_p],
           "solve_counts_at_dir_tol": counts,
           "exit_rn2_over_bn2": [stg[ns.ST_RN2] / stg[ns.ST_BN2],
                                 stgp[ns.ST_RN2] / stgp[ns.ST_BN2]],
           "pieces_err": err, "pieces_tol": tol,
           "pieces_info": info, "pieces_ms": times,
           "rhs_decided_selection": sel_rp,
           "max_abs_err": abs_err(xs, xsp),
           "strict_step_entries": ds_entries, "step_entries": st_entries,
           "ms": t_step, "plain_ms": t_step_p, **bnd}
    emit(rec)
    check(not bad, f"K4 {row} {label}: pieces off against plain: {bad}")
    check(stg[ns.ST_INDEX] == stgp[ns.ST_INDEX]
          and stg[ns.ST_ANY] == stgp[ns.ST_ANY],
          f"K4 {row} {label}: candidate {stg[ns.ST_INDEX]} against the "
          f"plain step's {stgp[ns.ST_INDEX]}")
    check(n_c == 0, f"K4 {row} {label}: {n_c} host reads inside the CUDA "
          "step")
    check(counts[0] == counts[1],
          f"K4 {row} {label}: [δ, rounds, stalled, PCG rounds, kept] "
          f"{counts[0]} against the plain step's {counts[1]} at dir_tol "
          f"{dtol:.3g}")
    return rec


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

def drive_row(row, refs):
    """Solve the row on the card with every counter set to 0 just before
    its first solve; then three timed solves.  Returns (solver, record)."""
    import numpy as np
    import torch
    from interiorpoint_tpu_torch.ops import hybrid

    reset_counters()
    t0 = time.perf_counter()
    solver = make_solver(row, "cuda")
    kw = solve_kwargs(row)
    with sync_sites() as sites:
        val = solver.solve(**kw)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    first = diff(counters(), {})
    hop_shapes = hop_by_shape(HOP_CALLS)
    for kname in ROW_KERNELS[row]:
        check(first["launches"][kname] > 0,
              f"{row}: kernel {kname} never launched")
    for kname, cnt in first["plain"].items():
        check(cnt == 0, f"{row}: plain version of {kname} ran")
    times, syncs = [], []
    for _ in range(3):
        s0 = counters()["syncs"]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        solver.solve(**kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        syncs.append(counters()["syncs"] - s0)
    for kname, cnt in counters()["plain"].items():
        check(cnt == 0, f"{row}: plain version of {kname} ran")
    m = solver.last_metrics
    rec = {"phase": "main", "row": row, "value": val,
           "algorithm": m["algorithm"],
           "outer_iterations": solver.outer_iters,
           "first_solve_s": first_s,
           "solve_s_median": sorted(times)[1], "solve_s": times,
           "host_syncs_per_solve": syncs[-1],
           "launches_first_solve": first["launches"],
           "entry_launches_first_solve": first["entries"],
           "refined_solves_first_solve": first["solve"],
           "refined_solves_by_shape_first_solve": hop_shapes,
           "host_syncs_by_site_first_solve": dict(sites)}
    if row in ROWS + SOCP_ROWS:
        # K1 and K4 solve every direction in one launch of
        # ip_refined_solve, whose operator passes (the fused operator of
        # ip_h_apply) its kernel counts
        sv = first["solve"]
        n_rs = first["entries"].get("ip_refined_solve", 0)
        check(n_rs > 0 and sv["solves"] == n_rs and sv["operator_passes"] > 0,
              f"{row}: {n_rs} ip_refined_solve launches, device tally {sv}")
    if m["algorithm"] == "pd":
        rec["iterations"] = solver.outer_iters
        rec["converged"] = bool(m["converged"])
        check(rec["converged"], f"{row}: not converged")
        if row in K5_ROWS:
            # K5 takes every direction: two per iteration, plus the
            # residual calls of kkt_solve's refinement
            kkt = first["kkt"]
            dirs = kkt.get("directions", 0)
            facs = kkt.get("factorizations", 0)
            rec.update(k5_launches=first["launches"]["K5"],
                       k5_directions=dirs, k5_factorizations=facs,
                       k5_refinement_directions=dirs - 2 * solver.outer_iters,
                       cg_rounds_per_direction=kkt.get("cg_rounds", 0)
                       / max(dirs, 1),
                       h_solves_per_direction=kkt.get("h_solves", 0)
                       / max(dirs, 1),
                       host_syncs_per_iteration=syncs[-1]
                       / max(solver.outer_iters, 1))
            check(dirs == first["launches"]["K5"]
                  and dirs >= 2 * solver.outer_iters,
                  f"{row}: {first['launches']['K5']} K5 launches and "
                  f"{dirs} directions for {solver.outer_iters} iterations")
            check(first["launches"]["K1"] == 0,
                  f"{row}: the fused pd step K1 ran")
            # one fp64 factorization per Newton matrix: the predictor, the
            # corrector and kkt_solve's refinement share it
            check(facs == solver.outer_iters,
                  f"{row}: {facs} K5 factorizations for "
                  f"{solver.outer_iters} Newton matrices")
    else:
        steps = int(m["newton_iters"])
        p1 = solver._result.phase1
        rec.update(newton_steps=steps, inner_iters=solver.inner_iters,
                   phase1_ran=bool(m["phase1_ran"]),
                   phase1_newton_steps=(p1.newton_iters
                                        if m["phase1_ran"] else 0),
                   dual_gap=solver.optimality_gap, t_final=m["t_final"],
                   max_outer_iters=solver.cfg.max_outer_iters)
        all_steps = steps + rec["phase1_newton_steps"]
        rec["host_syncs_per_step"] = syncs[-1] / max(all_steps, 1)
        if row in SOCP_ROWS:
            # K4 takes every main-stage step; SOCP phase one runs the
            # oracle path (the JAX package's gate excludes it)
            check(first["launches"]["K4"] == steps
                  and first["launches"]["K2"] == 0,
                  f"{row}: {first['launches']['K4']} K4 launches for "
                  f"{steps} main-stage Newton steps")
        else:
            check(first["launches"]["K2"] == all_steps,
                  f"{row}: {first['launches']['K2']} K2 launches for "
                  f"{all_steps} Newton steps")
            # K2's preconditioner branches; the carry at r <= 512 must hit
            k2 = first["k2"]
            rec["k2_preconditioner"] = k2
            rec["k2_fallback_entries"] = {
                e: first["k2_fallback"].get(e, 0)
                for e in K2_FALLBACK_ENTRIES}
            r_k2 = solver._reduced.prob.C.shape[1]
            if hybrid.ns_carry_supported(r_k2):
                check(k2.get("carry_hits", 0) >= 1,
                      f"{row}: no carry hit in {k2}")
            # K2 makes no host read inside a step: one read a step (the
            # engine's, ops/newton.py), none in K2's modules; the stages'
            # reads are ops/ipm.py's, the rest the solve's set-up (the
            # reduction and the warm start)
            def at(*mods):
                return sum(n for site, n in sites.items()
                           if site.split(":")[0] in mods)
            engine = at("ops/newton.py")
            inside = at("ops/newton_step.py", "ops/refine.py",
                        "ops/hybrid.py", "ops/pd_step.py", "ops/chol.py")
            rec.update(k2_syncs_per_step=engine / max(all_steps, 1),
                       k2_syncs_inside_steps=inside,
                       stage_syncs=at("ops/ipm.py"),
                       host_syncs_first_solve=sum(sites.values()))
            check(engine == all_steps and inside == 0,
                  f"{row}: host reads by site {dict(sites)} for "
                  f"{all_steps} Newton steps")
    check(np.all(np.isfinite(solver.xstar)), f"{row}: non-finite x")

    gap = solver.optimality_gap
    if row in ("lp1000_auto", "lp1000_barrier", "lp1000_phase1"):
        ref = refs["highs_lp1000"]
        rec["highs"] = ref
        rec["rel_err_vs_highs"] = abs(val - ref) / abs(ref)
        if row == "lp1000_auto":
            check(solver.v_star is not None and solver.lam_star is not None,
                  "lp1000_auto: duals missing")
            check(rec["rel_err_vs_highs"] <= 1e-6,
                  f"{row}: rel err vs HiGHS {rec['rel_err_vs_highs']:.3g}")
        else:
            check(abs(val - ref) <= gap + 1e-9 * abs(ref),
                  f"{row}: |value − HiGHS| {abs(val - ref):.3g} above the "
                  f"gap {gap:.3g}")
        if row == "lp1000_phase1":
            check(rec["phase1_ran"], "lp1000_phase1: phase one did not run")
    elif row == "qp1000_pd":
        rec["cpu_value"] = refs["cpu_qp1000"]
        rec["rel_err_vs_cpu"] = abs(val - rec["cpu_value"]) / abs(
            rec["cpu_value"])
        check(rec["rel_err_vs_cpu"] <= 1e-8,
              f"qp1000_pd: rel err vs CPU solve {rec['rel_err_vs_cpu']:.3g}")
    elif row == "qp1000_barrier":
        ref = refs["qp1000_pd"]
        rec["pd_value"] = ref
        check(abs(val - ref) <= gap + 1e-7 * abs(ref),
              f"{row}: |value − qp1000_pd| {abs(val - ref):.3g} above the "
              f"gap {gap:.3g}")
    elif row == "lp5000_pd":
        rec["certificate"] = kkt_certificate(solver, lp_recipe(5000))
    elif row == "lp5000_barrier":
        ref = refs["lp5000_pd"]
        rec["pd_value"] = ref
        rec["certificate"] = kkt_certificate(solver, lp_recipe(5000),
                                             gap_tol=False)
        check(abs(val - ref) <= gap + 1e-6 * (1.0 + abs(val)),
              f"{row}: |value − lp5000_pd| {abs(val - ref):.3g} above the "
              f"gap {gap:.3g}")
    elif row in SOCP_ROWS:
        ref = refs["socp1000_full"]
        rec["reference"] = ("socp1000_full: the same instance through the "
                            "full-space engine on the card (reduced=False: "
                            "no reduction, no K4)")
        rec["reference_value"] = ref
        rec["abs_err_vs_reference"] = abs(val - ref)
        check(abs(val - ref) <= gap + 1e-8 * abs(ref),
              f"{row}: |value − socp1000_full| {abs(val - ref):.3g} above "
              f"the gap {gap:.3g}")
        rec["certificate"] = socp_certificate(solver.xstar,
                                              socp_recipe(1000)[0])
        if row == "socp1000_barrier":
            check(solver.lam_star is not None and solver.v_star is not None,
                  f"{row}: duals missing")
        else:
            check(rec["phase1_ran"], f"{row}: phase one did not run")
    elif row == "socp1000_pd":
        ref = refs["socp1000_full"]
        gap_ref = refs["socp1000_full_gap"]
        rec.update(reference_value=ref, reference_gap=gap_ref,
                   abs_err_vs_reference=abs(val - ref))
        check(abs(val - ref) <= gap + gap_ref + 1e-8 * abs(val),
              f"{row}: |value − socp1000_full| {abs(val - ref):.3g} above "
              f"the gaps {gap:.3g} + {gap_ref:.3g}")
        rec["certificate"] = socp_certificate(solver.xstar,
                                              socp_recipe(1000)[0])
        check(solver.lam_star is not None and solver.v_star is not None,
              f"{row}: duals missing")
    elif row == "socp1000_pd_full":
        ref = refs["socp1000_pd"]
        gap_ref = refs["socp1000_pd_gap"]
        rec.update(reference_value=ref, abs_err_vs_reference=abs(val - ref))
        check(abs(val - ref) <= gap + gap_ref + 1e-8 * abs(val),
              f"{row}: |value − socp1000_pd| {abs(val - ref):.3g} above "
              f"the gaps {gap:.3g} + {gap_ref:.3g}")
        rec["certificate"] = socp_certificate(solver.xstar,
                                              socp_recipe(1000)[0])
    elif row == "lp1000_pd_eq":
        ref = refs["highs_lp1000"]
        rec["highs"] = ref
        rec["rel_err_vs_highs"] = abs(val - ref) / abs(ref)
        check(rec["rel_err_vs_highs"] <= 1e-6,
              f"{row}: rel err vs HiGHS {rec['rel_err_vs_highs']:.3g}")
        rec["certificate"] = kkt_certificate(solver, lp_recipe(1000))
    emit(rec)
    refs[row + "_gap"] = gap
    refs[row] = val
    return solver, rec


def lasso_subgradient(A, b, reg, X):
    """The LASSO optimality residual of tests/test_lasso.py with a bias
    column first (A holds it): the distance of Aᵀ(AX − b)/m from
    −reg·∂‖X‖₁ on the regularized rows, and |Aᵀ(AX − b)/m| on the bias
    row (largest entry)."""
    import numpy as np
    G = A.T @ (A @ X - b) / A.shape[0]
    Gr, Xr = G[1:], X[1:]
    on = np.abs(Xr) > 1e-9
    res = np.where(on, Gr + reg * np.sign(Xr),
                   np.maximum(np.abs(Gr) - reg, 0.0))
    return max(float(np.abs(G[0]).max()), float(np.abs(res).max()))


def k3b_bound(n, p):
    """K3b's least time at (n, p): L's strictly lower 64-row tiles and the
    lower triangles of Dinv's tiles (together as many floats as L's lower
    triangle, n(n + 1)/2), B in and X out once; per column n(n + 1)
    fp32 operations a sweep."""
    return bound(n * (n + 1) // 2 * 4 + 2 * n * p * 4,
                 f32=2.0 * n * (n + 1) * p)


def lasso_kernels(A, rho):
    """K3a and K3b at the LASSO ladder's shape, on the first rung's inputs
    as ops/kkt.py hands them to the kernels: the fp32 factor of the
    Jacobi-scaled Q = AᵀA + mρI (n = 1001), and the fp32 solve with the
    scaled identity as its n right-hand sides, each against its plain
    version and one PyTorch call."""
    import torch
    from interiorpoint_tpu_torch.ops import chol

    m, n = A.shape
    Q = A.T @ A + (m * rho) * torch.eye(n, dtype=A.dtype, device=A.device)
    dsc = 1.0 / torch.sqrt(torch.diagonal(Q))
    Hs = (Q * dsc[:, None] * dsc[None, :]).to(torch.float32).contiguous()
    B = torch.diag(dsc).to(torch.float32).contiguous()
    np_ = chol.padded(n, chol.cuda_block())
    L, D, bad = chol.cholesky_blocked(Hs)
    Lp, _, badp = chol.cholesky_blocked_plain(Hs)
    X = chol.cholesky_solve_blocked(L, D, B)
    Xp = chol.cholesky_solve_blocked_plain(L, D, B)
    torch.cuda.synchronize()
    check(int(bad) == 0 and int(badp) == 0, "lasso1000: K3a factor failed")
    Hd = Hs.double()

    def factor_backward(Lf):
        Ld = torch.tril(Lf.double())
        return float((Ld @ Ld.T - Hd).abs().max()) / float(Hd.abs().max())

    fb, fbp = factor_backward(L), factor_backward(Lp)
    be, be_p = k3b_backward(Hs, X, B), k3b_backward(Hs, Xp, B)
    Llib = torch.linalg.cholesky(Hs)
    tri = n * (n + 1) // 2 * 4
    rec = {"phase": "kernel", "kernel": "K3a+K3b", "row": "lasso1000",
           "n": n, "p": n, "rho": rho,
           "factor_backward": fb, "factor_backward_plain": fbp,
           "factor_abs_err": abs_err(L, Lp),
           "factor_ms": time_ms(lambda: chol.cholesky_blocked(Hs)),
           "factor_plain_ms": time_ms(
               lambda: chol.cholesky_blocked_plain(Hs)),
           "factor_library_ms": time_ms(lambda: torch.linalg.cholesky(Hs)),
           "factor_bound": bound(2 * tri + np_ * 64 * 4, f32=n ** 3 / 3.0),
           "solve_backward": be, "solve_backward_plain": be_p,
           "solve_abs_err": abs_err(X, Xp),
           "solve_ms": time_ms(lambda: chol.cholesky_solve_blocked(L, D, B)),
           "solve_plain_ms": time_ms(
               lambda: chol.cholesky_solve_blocked_plain(L, D, B)),
           "solve_library_ms": time_ms(lambda: torch.cholesky_solve(B,
                                                                    Llib)),
           "solve_bound": k3b_bound(n, n)}
    emit(rec)
    check(fb <= 4.0 * fbp + 1e-6,
          f"lasso1000: K3a backward error {fb:.3g} against the plain "
          f"version's {fbp:.3g}")
    check(be <= 4.0 * be_p + 1e-7,
          f"lasso1000: K3b backward error {be:.3g} against the plain "
          f"version's {be_p:.3g}")
    return rec


def drive_lasso(row, refs, results):
    """The LASSO row: one solve on the card (the ladder of Q⁻¹ through K3a
    and K3b, then the ADMM iterations) with every counter set to 0 just
    before it, three timed solves on the kept ladder, the ladder against
    the plain path's on the card, and the result against the port's CPU
    solve.  Returns the row's record."""
    import numpy as np
    import torch
    from interiorpoint_tpu_torch.ops import admm, chol
    from interiorpoint_tpu_torch.ops import kkt as kkt_mod

    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solver = make_solver(row, "cuda")
    X, sols, _, iters = solver.solve()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    first = diff(counters(), {})
    syncs_first = counters()["syncs"]
    for kname in ROW_KERNELS[row]:
        check(first["launches"][kname] > 0,
              f"{row}: kernel {kname} never launched")
    for kname, cnt in first["plain"].items():
        check(cnt == 0, f"{row}: plain version of {kname} ran")
    peak = torch.cuda.max_memory_allocated()
    times, syncs = [], []
    for _ in range(3):
        s0 = counters()["syncs"]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        solver.solve()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        syncs.append(counters()["syncs"] - s0)
    for kname, cnt in counters()["plain"].items():
        check(cnt == 0, f"{row}: plain version of {kname} ran")
    # the ladder alone, once more now that every library call is warm
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    admm.admm_prepare(solver._A, solver.cfg)
    torch.cuda.synchronize()
    ladder_s = time.perf_counter() - t1

    # each rung's Q⁻¹ by ‖QX − I‖_F / ‖I‖_F, beside the plain path's
    # ladder on the card (kkt.py's factor and solve swapped for their
    # plain versions)
    A = solver._A
    m, n = A.shape
    rhos = admm._ladder_rhos(solver.cfg)
    fac, sol = kkt_mod.cholesky_blocked, kkt_mod.cholesky_solve_blocked
    kkt_mod.cholesky_blocked = chol.cholesky_blocked_plain
    kkt_mod.cholesky_solve_blocked = chol.cholesky_solve_blocked_plain
    try:
        plain = admm.admm_prepare(A, solver.cfg)
    finally:
        kkt_mod.cholesky_blocked, kkt_mod.cholesky_solve_blocked = fac, sol
    AtA = A.T @ A
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    ladder = []
    for rho, Xc, Xp in zip(rhos, solver._prepared, plain):
        Q = AtA + (m * rho) * eye
        rc = float(torch.linalg.norm(Q @ Xc - eye) / torch.linalg.norm(eye))
        rp = float(torch.linalg.norm(Q @ Xp - eye) / torch.linalg.norm(eye))
        ladder.append({"rho": rho, "resid": rc, "resid_plain": rp,
                       "rel_diff_plain": rel_err(Xc, Xp)})
        check(rc <= 1e-12, f"{row}: ‖QX − I‖ {rc:.3g} at ρ = {rho}")
    del plain

    cpu = refs["cpu_" + row]
    x_err = float(np.abs(X - cpu["X"]).max() / np.abs(cpu["X"]).max())
    p = lasso_recipe()
    A_aug = np.hstack([np.ones((p["A"].shape[0], 1)), p["A"]])
    rec = {"phase": "main", "row": row, "iterations": iters,
           "cpu_iterations": cpu["iterations"], "rel_err_vs_cpu": x_err,
           "mean_objective": float(np.mean(sols)),
           "subgradient_residual": lasso_subgradient(A_aug, p["b"],
                                                     p["reg"], X),
           "first_solve_s": first_s, "ladder_s": ladder_s,
           "solve_s_median": sorted(times)[1],
           "solve_s": times, "host_syncs_first_solve": syncs_first,
           "host_syncs_per_solve": syncs[-1],
           "max_memory_allocated": peak, "ladder": ladder,
           "launches_first_solve": first["launches"],
           "entry_launches_first_solve": first["entries"],
           "refined_solves_first_solve": first["solve"]}
    emit(rec)
    check(iters == cpu["iterations"],
          f"{row}: {iters} iterations, the CPU solve took "
          f"{cpu['iterations']}")
    check(x_err <= 1e-8, f"{row}: X rel err vs CPU solve {x_err:.3g}")
    check(np.all(np.isfinite(X)) and X.shape == (n, 30),
          f"{row}: X of shape {X.shape}")
    # every solve of the ladder (p = n = 1001) on the wide kernel
    wide = first["entries"].get("ip_block_solve_wide", 0)
    check(wide > 0 and wide == first["launches"]["K3b"],
          f"{row}: {wide} wide solves of {first['launches']['K3b']}")
    results[("lasso_kernels", row)] = lasso_kernels(A, rhos[0])
    del solver
    torch.cuda.empty_cache()
    return rec


def certify_on_card(row, solver):
    """``certify`` of a solved driver whose tensors live on the card,
    against the same certificate of a copy of the driver with its problem
    on the CPU; a barrier point is strictly interior, and feasible."""
    import copy
    import dataclasses
    import torch
    from interiorpoint_tpu_torch import certify

    cert = certify(solver)
    host = copy.copy(solver)
    host._prob = dataclasses.replace(solver._prob, **{
        f.name: getattr(solver._prob, f.name).cpu()
        for f in dataclasses.fields(solver._prob)
        if getattr(solver._prob, f.name) is not None})
    host._eq = tuple(None if t is None else t.cpu() for t in solver._eq)
    host.device = torch.device("cpu")
    ref = certify(host)
    fields = ("objective", "stationarity", "eq_residual", "min_slack",
              "complementarity", "dual_gap")
    diffs = {f: abs(getattr(cert, f) - getattr(ref, f))
             / max(1.0, abs(getattr(ref, f))) for f in fields}
    rec = {"phase": "certify", "row": row,
           **{f: getattr(cert, f) for f in fields},
           "polished": cert.polished, "ok_1e-6": cert.ok(1e-6),
           "diff_vs_cpu_copy": diffs}
    emit(rec)
    check(max(diffs.values()) <= 1e-12,
          f"{row}: certificate on the card against the CPU copy's: {diffs}")
    check(cert.min_slack > 0 and cert.eq_residual <= 1e-8,
          f"{row}: certificate {rec}")
    return rec


def phase_utils():
    """The utilities on the card, after the main path: a mid-solve
    checkpoint of lp1000_barrier resumed in a fresh solver (the same
    stages, steps and value as an uninterrupted solve), and
    tests/data/miplib/flow40.npy through ``miplib.solve_lp_npy`` on the
    barrier and pd engines against HiGHS (tests/test_utils.py's
    tolerances)."""
    import os
    import tempfile
    import numpy as np
    import torch
    from scipy.optimize import linprog
    from interiorpoint_tpu_torch.utils import miplib

    row = "lp1000_barrier"
    ref = make_solver(row, "cuda")
    v_ref = ref.solve()
    stages = ref.outer_iters
    p1 = ref._result.phase1
    p1_stages = p1.outer_iters if p1 is not None and np.isfinite(p1.s) else 0
    # max_outer_iters caps phase one's stages and the main stages apart:
    # phase one completes, the main loop stops after mid stages
    mid = max(p1_stages, stages // 2)
    check(0 < mid < stages, f"{row}: {stages} stages, phase one "
          f"{p1_stages}: nothing to cut")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, row + ".npz")
        part = make_solver(row, "cuda")
        part.solve(max_outer_iters=mid, checkpoint_path=path)
        res = make_solver(row, "cuda")
        v = res.solve(checkpoint_path=path, resume=True)
    torch.cuda.synchronize()
    rec = {"phase": "checkpoint", "row": row, "stages": stages,
           "phase1_stages": p1_stages, "cut_after": mid, "part_stages": part.outer_iters,
           "resumed_stages": res.outer_iters, "value": v_ref,
           "resumed_value": v, "rel_diff": abs(v - v_ref) / abs(v_ref),
           "bitwise": bool(v == v_ref
                           and np.array_equal(res.xstar, ref.xstar)),
           "inner_iters": ref.inner_iters,
           "resumed_inner_iters": res.inner_iters}
    emit(rec)
    check(part.outer_iters == mid and res.outer_iters == stages
          and res.inner_iters == ref.inner_iters,
          f"{row} resumed: {rec}")
    check(rec["rel_diff"] <= 1e-12, f"{row} resumed: {rec}")

    path = str(ROOT / "tests" / "data" / "miplib" / "flow40.npy")
    c, A, b, C, d, ub, lb = miplib.load_lp_npy(path)
    hi = linprog(c, A_ub=C, b_ub=d, A_eq=A, b_eq=b,
                 bounds=list(zip(lb, ub)), method="highs")
    check(hi.status == 0, "HiGHS failed on flow40")
    out = {"phase": "miplib", "instance": "flow40", "highs": hi.fun}
    for alg, eps, tol in (("barrier", 1e-6, 1e-4), ("pd", 1e-8, 1e-8)):
        s = miplib.solve_lp_npy(path, device="cuda", suppress_print=True,
                                check_cvxpy=False, epsilon=eps,
                                algorithm=alg)
        x = s.xstar
        err = abs(s.value - hi.fun) / abs(hi.fun)
        out[alg] = {"value": s.value, "rel_err_vs_highs": err,
                    "eq_inf": float(np.abs(A @ x - b).max()),
                    "row_viol": float((C @ x - d).max()),
                    "bound_viol": float(max((lb - x).max(), (x - ub).max())),
                    "device": str(s.device)}
        check(err < tol, f"flow40 {alg}: rel err vs HiGHS {err:.3g}")
        check(s.device.type == "cuda", f"flow40 {alg} on {s.device}")
        if alg == "pd":
            check(s.last_metrics["converged"] is True,
                  "flow40 pd: not converged")
        else:
            r = out[alg]
            check(r["eq_inf"] < 1e-6 and r["row_viol"] < 1e-6
                  and r["bound_viol"] <= 1e-8,
                  f"flow40 barrier: infeasible point {r}")
    emit(out)


# C entries whose main-path launches the kernels line reports
MAIN_ENTRIES = ("ip_chol_factor", "ip_chol_factor64", "ip_chol_invert",
                "ip_gram", "ip_refined_solve", "ip_h_apply", "ip_block_solve",
                "ip_block_solve_column", "ip_block_solve_wide",
                "ip_k2_decide", "ip_pivot_floor")


def phase_main(results):
    import torch
    from scipy.optimize import linprog

    # references that are not the main path (the QP's CPU solve runs the
    # plain versions, so it comes before any row's counters are zeroed)
    p = lp_recipe(1000)
    ref_lp = linprog(p["c"], A_ub=p["C"], b_ub=p["d"], A_eq=p["A"],
                     b_eq=p["b"], bounds=[(-3, 3)] * 1000, method="highs")
    check(ref_lp.status == 0, "HiGHS failed on lp1000")
    refs = {"highs_lp1000": float(ref_lp.fun),
            "cpu_qp1000": make_solver("qp1000_pd", "cpu").solve()}
    lasso_cpu = make_solver("lasso1000", "cpu")
    X, _, _, it = lasso_cpu.solve()
    refs["cpu_lasso1000"] = {"X": X, "iterations": it}
    del lasso_cpu
    socp_reference(refs)
    launches = {k: 0 for k in KERNELS + tuple(K2_PIECES) + MAIN_ENTRIES
                 + ("operator_passes",)}
    # the (n, p) of every K3b call of the main path (its only caller is
    # ops/kkt.py's fp32 factor solve)
    from interiorpoint_tpu_torch.ops import kkt as kkt_mod
    k3b, k3b_shapes = kkt_mod.cholesky_solve_blocked, []

    def k3b_recording(L, Dinv, B):
        k3b_shapes.append((B.shape[0], 1 if B.ndim == 1 else B.shape[1]))
        return k3b(L, Dinv, B)

    kkt_mod.cholesky_solve_blocked = k3b_recording
    # the fp32 factor and inverse entries launched inside K2's steps: only
    # its Cholesky fallback launches them there
    from interiorpoint_tpu_torch.ops import newton as newton_mod
    from interiorpoint_tpu_torch.ops.refine import FACTOR_JITTERS
    k2_step = newton_mod.newton_step

    def k2_recording(*a, **kw):
        out, ent = entry_deltas(lambda: k2_step(*a, **kw))
        for e in K2_FALLBACK_ENTRIES:
            K2_FALLBACK[e] = K2_FALLBACK.get(e, 0) + ent.get(e, 0)
        return out

    newton_mod.newton_step = k2_recording
    hop_undo = hop_recording()
    launches["hop_shapes"] = {}
    for row in ROWS + BARRIER_ROWS + SOCP_ROWS + K5_ROWS + LASSO_ROWS:
        if row in LASSO_ROWS:
            rec, solver = drive_lasso(row, refs, results), None
        else:
            solver, rec = drive_row(row, refs)
        for kname, cnt in rec["launches_first_solve"].items():
            launches[kname] += cnt
        for e in MAIN_ENTRIES:
            launches[e] += rec["entry_launches_first_solve"].get(e, 0)
        launches["operator_passes"] += rec["refined_solves_first_solve"][
            "operator_passes"]
        merge_by_shape(launches["hop_shapes"],
                       rec.get("refined_solves_by_shape_first_solve", {}))
        if row in BARRIER_ROWS:
            # every K2 step launches the fallback's four rungs and its
            # inverse, which skip themselves on the device outside the
            # branch; the branch's own count comes from the steps' stats
            fb = rec["k2_fallback_entries"]
            k2c = rec["k2_preconditioner"]
            n_fb = k2c.get("cholesky_fallback", 0)
            n_k2 = rec["launches_first_solve"]["K2"]
            check(fb["ip_chol_invert"] == n_k2
                  and fb["ip_chol_factor"] == len(FACTOR_JITTERS) * n_k2
                  and n_fb == sum(k2c.get(f"fallback_rung{i}", 0)
                                  for i in range(len(FACTOR_JITTERS))),
                  f"{row}: K2's fallback launched {fb} in {n_k2} steps, "
                  f"taken {n_fb} times: {k2c}")
            for e, n in fb.items():
                launches["K2.fallback." + e] = launches.get(
                    "K2.fallback." + e, 0) + n
            launches["K2.fallbacks"] = launches.get("K2.fallbacks", 0) + n_fb
        results[("main", row)] = rec
        if row in ("lp1000_barrier", "socp1000_barrier"):
            results[("certify", row)] = certify_on_card(row, solver)
        if row in BARRIER_ROWS:
            for label, cs, tc, z, tP in k2_states(row, solver):
                results[("K2", row, label)] = k2_check(row, label, cs, tc, z,
                                                       tP, solver.cfg)
        if row == "socp1000_barrier":
            for label, cs, tq, z, tP in k4_states(solver):
                results[("K4", row, label)] = k4_check(row, label, cs, tq, z,
                                                       tP, solver.cfg)
        if row in K5_ROWS:
            states = k5_states(solver)
            for label, state in states.items():
                results[("K5", row, label)] = k5_check(row, label, *state)
            if row == "lp1000_pd_eq":
                results[("K5", row, "pe90")] = k5_check(
                    row, "pe90", *pe90_state(states["first"]))
            del states
        del solver
        torch.cuda.empty_cache()
    kkt_mod.cholesky_solve_blocked = k3b
    newton_mod.newton_step = k2_step
    hop_undo()
    hs = launches["hop_shapes"]
    check(sum(v["launches"] for v in hs.values())
          == launches["ip_refined_solve"]
          and sum(v["passes"] for v in hs.values())
          == launches["operator_passes"],
          f"refined solves by shape {hs} against "
          f"{launches['ip_refined_solve']} launches and "
          f"{launches['operator_passes']} passes")
    results[("refs",)] = refs
    return launches, k3b_shapes


def socp_reference(refs):
    """The SOCP rows' reference: bench_socp(1000)'s instance through the
    full-space barrier engine on the card (no reduction, so no K4, and no
    K5).  Solved before any row's counters are zeroed; its value and gap
    go into ``refs``."""
    import torch
    solver = make_solver("socp1000_full", "cuda")
    t0 = time.perf_counter()
    val = solver.solve()
    torch.cuda.synchronize()
    emit({"phase": "reference", "row": "socp1000_full", "value": val,
          "dual_gap": solver.optimality_gap, "outer_iterations":
          solver.outer_iters, "newton_steps": int(sum(solver.inner_iters)),
          "solve_s": time.perf_counter() - t0})
    refs["socp1000_full"] = val
    refs["socp1000_full_gap"] = solver.optimality_gap
    return val


# ---------------------------------------------------------------------------
# K5 on the card: pieces and whole directions from the K5 rows' states
# ---------------------------------------------------------------------------

def k5_states(solver):
    """{"first", "last"}: the inputs (H, consts, r1, rpe, tolerances) of
    the first and the last K5 direction of one more solve of the row (the
    first iteration's predictor; the last direction, at the late NT or
    Mehrotra systems)."""
    import math

    from interiorpoint_tpu_torch.ops import kkt_step
    calls = {}
    orig = kkt_step._kkt_dir

    def record(fac, r1, rpe, refine, rounds, stall_rel2, cg_rel2):
        kw = dict(refine=refine, rounds=rounds,
                  dir_tol=math.sqrt(stall_rel2), cg_tol=math.sqrt(cg_rel2))
        calls.setdefault("first", (fac.H, fac.cs, r1, rpe, kw))
        calls["last"] = (fac.H, fac.cs, r1, rpe, kw)
        return orig(fac, r1, rpe, refine, rounds, stall_rel2, cg_rel2)

    # the orchestration behind kkt_dir_prepared, so that it keeps counting
    kkt_step._kkt_dir = record
    try:
        solver.solve()
    finally:
        kkt_step._kkt_dir = orig
    return calls


def pe90_state(first):
    """A direction with pe = 90 (not a multiple of the factor's 64-wide
    block, so the Schur factor crosses a block edge): lp1000_pd_eq's
    first H with its first 90 equality rows."""
    from interiorpoint_tpu_torch.ops.kkt_step import prep_kkt_consts
    H, cs, r1, rpe, kw = first
    return (H, prep_kkt_consts(cs.F[:90], cs.r), r1,
            rpe[:90].contiguous(), kw)


def k5_work(r, pe):
    """fp64 operations the function of one K5 direction needs, from r and
    pe alone (the card could run the cubic terms on its fp64 tensor
    cores): a Cholesky-based Schur solve of the KKT system, H's factor
    (r³/3), Y = L⁻¹Fᵀ (r²·pe), S = YᵀY's lower half (r·pe²), S's factor
    (pe³/3), and the solves of one right-hand side (2r² + 4·r·pe + 2pe²).
    No inverse and no term of the rounds a version takes."""
    return (r ** 3 / 3.0 + r * r * pe + r * pe * pe + pe ** 3 / 3.0
            + 2.0 * r * r + 4.0 * r * pe + 2.0 * pe * pe)


def k5_check(row, label, H, cs, r1, rpe, kw):
    """K5 against its plain version at one state, piece by piece on shared
    inputs, all fp64: H's equilibration; the H factor and W by backward
    error; the Schur build Y and S = YᵀY against the plain products of the
    same inputs within the rounding bound of an r-term fp64 sum, 2γᵣ·(|A||B|);
    S's equilibration, factor and inverse; a refined H-solve by its fp64
    residual; then whole directions: the same Schur-CG round count as the
    plain version, dx and dy within 1e-11 of a dense fp64 solve of the KKT
    matrix (at the last state within 2·cond(K, x)·u, Skeel's condition,
    if that is larger: the dense solve's own error is cond·u) and
    rn2 ≤ 1e-18·bn2 + 1e-20 (the bound of
    tests/test_pallas_kkt.py:46).  Reports the factorizations, Schur-CG
    rounds, H-solves and host reads of a direction, and times K5 (prepare
    and direction), the direction alone on prepared factors, its plain
    version and one PyTorch call (torch.linalg.solve on the fp64 KKT
    matrix, or on H when pe = 0)."""
    import torch
    from interiorpoint_tpu_torch.ops import kkt_step as kk
    from interiorpoint_tpu_torch.ops.kkt_step import _Cuda, _Plain

    r, pe = cs.r, cs.pe
    where = f"K5 {row} {label}"
    refine = kw.get("refine", 3)
    stall2 = float(kw.get("dir_tol", 1e-6)) ** 2
    err, tol, info = {}, {}, {}
    cmp = comparer(err, tol)

    Hs_c, dsc_c = _Cuda.equilibrate(H)
    Hs_p, dsc_p = _Plain.equilibrate(H)
    cmp("equilibrate.Hs", Hs_c[:r, :r], Hs_p[:r, :r], PIECE_TOL64)
    cmp("equilibrate.dsc", dsc_c[:r], dsc_p[:r], PIECE_TOL64)
    W, _, _ = factor_pieces(Hs_c, "H.", where, cmp, err, tol, info,
                            borderline_ok=True)

    def held(name, a, b, A, B, k):
        """|a − b| within 2γₖ·max(|A||B|), the rounding of a k-term sum
        done in two orders."""
        err[name] = float((a - b).abs().max())
        tol[name] = 2.0 * gamma(k) * float((A.abs() @ B.abs()).max())

    if pe:
        Wl = torch.tril(W[:r, :r])
        DFt = dsc_c[:r, None] * cs.F.T
        Yc = _Cuda.kkt_schur(W, dsc_c, cs.F)
        Yp = _Plain.kkt_schur(W, dsc_c, cs.F)
        held("schur.Y", Yc, Yp, Wl, DFt, r + 1)
        del Wl, DFt
        Sc, Sp = _Cuda.schur_gram(Yp), _Plain.schur_gram(Yp)
        held("schur.S", Sc, Sp, Yp.T, Yp, r)
        Ss_c, ds_c = _Cuda.equilibrate(Sp)
        Ss_p, ds_p = _Plain.equilibrate(Sp)
        cmp("S.equilibrate.Ss", Ss_c[:pe, :pe], Ss_p[:pe, :pe], PIECE_TOL64)
        factor_pieces(Ss_c, "S.", where, cmp, err, tol, info,
                      borderline_ok=True)

    # one refined H-solve of r1 per version, by its fp64 residual in the
    # plain version's equilibrated metric (against the refinement's exit,
    # the plain solve's residual and the rounding floor of evaluating it)
    D = dsc_p[:r]
    Ha = H.abs()

    def resid(x):
        res = ((D * (r1 - H @ x)) ** 2).sum() / ((D * r1) ** 2).sum()
        fl = gamma(r + 1) * (Ha @ x.abs() + r1.abs())
        return float(res), float(((D * fl) ** 2).sum()
                                  / ((D * r1) ** 2).sum())

    fac = {"cuda": kk.kkt_prepare(H, cs), "plain": kk.kkt_prepare_plain(H, cs)}
    xs = {n: kk.h_solver(f, refine, stall2)(r1)[0] for n, f in fac.items()}
    res_c, _ = resid(xs["cuda"])
    res_p, floor_p = resid(xs["plain"])
    borderline = "H.borderline" in info or "S.borderline" in info
    err["hsolve.resid"] = res_c
    tol["hsolve.resid"] = max(4.0 * max(kk.H_EXIT_REL2, res_p, floor_p),
                              stall2 if borderline else 0.0)
    info["hsolve.resid_plain"] = res_p
    info["hsolve.resid_floor"] = floor_p

    # whole directions: the same Schur-CG rounds and H-solves, host reads
    outs, cnt = {}, {}
    for n, fn in (("cuda", kk.kkt_dir), ("plain", kk.kkt_dir_plain)):
        c0 = dict(kk.COUNTS)
        (outs[n], cnt[n + "_host_reads"]) = step_rounds(fn, H, cs, r1, rpe,
                                                        **kw)
        for key in ("factorizations", "cg_rounds", "h_solves"):
            cnt[n + "_" + key] = kk.COUNTS[key] - c0.get(key, 0)
    dx, dy, rn2, bn2 = outs["cuda"]
    rn2, bn2 = float(rn2), float(bn2)
    if pe:
        K = torch.zeros((r + pe, r + pe), dtype=torch.float64,
                        device=H.device)
        K[:r, :r] = H
        K[:r, r:] = cs.F.T
        K[r:, :r] = cs.F
        rhs = torch.cat([r1, -rpe])
    else:
        K, rhs = H, r1
    sol = torch.linalg.solve(K, rhs)
    got = torch.cat([dx, dy])
    err["dense"] = float((got - sol).norm() / sol.norm())
    info["dense_plain"] = float((torch.cat(outs["plain"][:2]) - sol).norm()
                                / sol.norm())
    # 1e-11 of the dense solve.  At the last state the KKT matrix can be so
    # ill-conditioned that the dense fp64 solve itself is further off:
    # there within max(1e-11, 2·cond(K, x)·u), Skeel's condition number
    # cond(K, x) = ‖|K⁻¹||K||x|‖∞/‖x‖∞ of the dense solution x (each of
    # the two solves is off by up to cond·u); κ₂ = torch.linalg.cond of K,
    # the normwise bound, is recorded beside it
    tol["dense"] = 1e-11
    if label == "last":
        xa = sol.abs()
        skeel = float((torch.linalg.inv(K).abs() @ (K.abs() @ xa)).max()
                      / xa.max())
        info["dense_skeel"] = skeel
        info["dense_kappa2"] = float(torch.linalg.cond(K))
        tol["dense"] = max(1e-11, 2.0 * skeel * U64)
    info["rn2_over_bn2"] = rn2 / bn2
    info["rn2_over_bn2_plain"] = float(outs["plain"][2]) / bn2
    err["rn2"] = rn2
    tol["rn2"] = 1e-18 * bn2 + 1e-20
    torch.cuda.synchronize()

    t = time_ms(lambda: kk.kkt_dir(H, cs, r1, rpe, **kw))
    t_prep = time_ms(lambda: kk.kkt_prepare(H, cs))
    t_dir = time_ms(lambda: kk.kkt_dir_prepared(fac["cuda"], r1, rpe, **kw))
    tp = time_ms(lambda: kk.kkt_dir_plain(H, cs, r1, rpe, **kw))
    tl = time_ms(lambda: torch.linalg.solve(K, rhs))
    # in: H, F, r1, rpe (fp64); out: dx, dy
    nbytes = 8 * r * r + 8 * pe * r + 16 * (r + pe)
    bnd = bound(nbytes, f64tc=k5_work(r, pe))
    bad = {k: (err[k], tol[k]) for k in err if not err[k] <= tol[k]}
    rec = {"phase": "kernel", "kernel": "K5", "row": row, "state": label,
           "shape": [r, pe], "tolerances": kw, "pieces_err": err,
           "pieces_tol": tol, "pieces_info": info, "counts": cnt,
           "max_abs_err": abs_err(got, torch.cat(outs["plain"][:2])),
           "ms": t, "prepare_ms": t_prep, "direction_ms": t_dir,
           "plain_ms": tp, "library_ms": tl, **bnd}
    emit(rec)
    check(not bad, f"{where}: pieces off: {bad}")
    check(cnt["cuda_factorizations"] == 1,
          f"{where}: {cnt['cuda_factorizations']} factorizations in one "
          "direction")
    # equal Schur-CG rounds wherever both versions factor the same
    # matrices (no borderline rung; rn2 is held either way)
    check(borderline or cnt["cuda_cg_rounds"] == cnt["plain_cg_rounds"],
          f"{where}: {cnt['cuda_cg_rounds']} Schur-CG rounds against the "
          f"plain version's {cnt['plain_cg_rounds']}")
    return rec


# the pieces_info key of each K2 piece's difference from its plain twin
ERR_KEY = {"ldl_factor": "ldl.Dinv_abs_err",
           "cholesky_fallback": "cholesky.W_abs_err",
           "ldl_solve": "ldl.solve_abs_err",
           "carry_refresh": "carry.X_abs_err"}


def synthetic_factor(results):
    """The LDL factor's times on phase_k2_synthetic's inputs, by np: ms
    (CUDA events per call), device_ms (queued), bound_ms, and the skipped
    rung's."""
    out = {}
    for (kind, *rest), v in results.items():
        if kind == "K2 synthetic":
            out[rest[0]] = {"ms": v["ldl_factor_ms"],
                            "device_ms": v["ldl_factor_device_ms"],
                            "bound_ms": v["ldl_factor_bound"]["bound_ms"],
                            "plain_ms": v["ldl_factor_plain_ms"],
                            "skipped_ms": v["ldl_skipped_ms"],
                            "skipped_device_ms": v["ldl_skipped_device_ms"]}
            if "late_fail" in v:
                lf = v["late_fail"]
                out[f"{rest[0]}_late_fail"] = {
                    "ms": lf["ms"], "device_ms": lf["device_ms"],
                    "bound_ms": lf["bound"]["bound_ms"]}
    return out


def synthetic_carry(results):
    """The carry trial's times on phase_k2_synthetic's hit and miss
    states, by np."""
    out = {}
    for (kind, *rest), v in results.items():
        if kind == "K2 synthetic":
            for state in ("hit", "miss"):
                c = v.get("carry_" + state)
                if c is not None:
                    out[f"{rest[0]}_{state}"] = {
                        "ms": c["ms"], "device_ms": c["device_ms"],
                        "plain_ms": c["plain_ms"],
                        "bound_ms": c["bound"]["bound_ms"],
                        "iterations": c["iterations"]}
    return out


def ldl_launches_by_np(results):
    """The LDL solves at p = 1 of the main path's first solves, by the np
    of each barrier row (one np a row: phase one's r + 1 pads alike)."""
    out = {}
    for row in BARRIER_ROWS:
        first = results[("main", row)]["launches_first_solve"]
        shape = next(v["shape"] for (kind, *rest), v in results.items()
                     if kind == "K2" and rest[0] == row)
        np_ = -(-shape[1] // 128) * 128
        out[np_] = out.get(np_, 0) + first["K2.ldl_solve"] - first[
            "K2.ldl_solve_wide"]
    return out


def column_times(results, kind):
    """``phase_column_solve``'s times of one kind ("ldl", "k3b") by size:
    ms, device ms, plain, library (K3b), bound, route."""
    out = {}
    for (tag, *rest), v in results.items():
        if tag == "column" and rest[0] == kind:
            out[rest[1]] = {
                "route": v["route"], "ms": v["solve_ms"],
                "device_ms": v["solve_device_ms"],
                "plain_ms": v["solve_plain_ms"],
                "library_ms": v["solve_library_ms"],
                "library_device_ms": v["solve_library_device_ms"],
                "bound_ms": v["solve_bound"]["bound_ms"],
                "backward": [v["solve_backward"], v["solve_backward_plain"]]}
    return out


# the states at which the refined solve and the fused operator are timed
# for the kernels line: K1 at its rows' first states, K4 at
# socp1000_barrier's first state (the stacked 4010 x 950 matrix with P)
HOP_STATES = (("K1", "lp1000_auto"), ("K1", "qp1000_pd"), ("K1", "lp5000_pd"),
              ("K4", "socp1000_barrier", "first"))


def hop_by_state(results):
    """Per HOP_STATES entry: its shape, and for ip_h_apply and both paths of
    the refined solve (``operator_pieces``: ``solve`` on the step's
    preconditioner, ``solve_pcg`` on a worse one) ms a call, device ms a
    call with the calls queued, the plain version's ms, the bound and (the
    solve) its counts."""
    out = []
    for key in HOP_STATES:
        rec = results.get(key)
        if rec is None:
            continue
        info, ms = rec["pieces_info"], rec["pieces_ms"]
        row = {"state": " ".join(key[1:]) + (" first" if key[0] == "K1"
                                              else ""),
               "kernel": key[0], "shape": info["operator.shape"],
               "qp": info["operator.qp"]}
        for tag in ("h_apply", "solve", "solve_pcg"):
            row[tag] = {"ms": ms[tag][0], "plain_ms": ms[tag][1],
                        "queued_ms": info.get(tag + ".queued_ms"),
                        "bound_ms": info[tag + ".bound"]["bound_ms"]}
            if tag != "h_apply":
                row[tag]["counts"] = info[tag + ".counts"][0]
        out.append(row)
    return out


def k2_solve_by_state(results):
    """K2's refined solve at each K2 state ``k2_check`` timed: the form
    its branch took (1 X, 2 the LDL sweeps, 0 W), ms a call, device ms
    (queued), the plain
    version's ms and the counts (CUDA, plain) at the strict gate."""
    out = []
    for (kind, *rest), v in results.items():
        if kind == "K2" and "refined_solve" in v.get("pieces_ms", {}):
            info = v["pieces_info"]
            ms, plain, _ = v["pieces_ms"]["refined_solve"]
            out.append({"state": rest, "shape": v["shape"],
                        "form": info["solve.form"], "ms": ms,
                        "device_ms": info["refined_solve.device_ms"],
                        "plain_ms": plain, "counts": info["solve.counts"],
                        "preconditioner_ms": v["pieces_ms"][
                            "preconditioner"][:2]})
    return out


def k2_path_counts(results):
    """K2 on the barrier rows' first solves: host reads per step (the
    engine's one read), host reads inside the timed steps of ``k2_check``,
    and the preconditioner's branches and the refined solves' counts
    summed over the rows (ops/newton_step.py ``COUNTS``)."""
    per_step, inside, counts = {}, {}, Counter()
    for row in BARRIER_ROWS:
        rec = results[("main", row)]
        per_step[row] = rec["k2_syncs_per_step"]
        counts.update(rec["k2_preconditioner"])
    for (kind, *rest), v in results.items():
        if kind == "K2" and "syncs_inside_steps" in v["pieces_info"]:
            inside[" ".join(rest)] = v["pieces_info"]["syncs_inside_steps"]
    return {"syncs_per_step": per_step, "syncs_inside_step": inside,
            "preconditioner_counts": dict(counts)}


def k2_small(name, entry, launches, results, key, nbytes, replaces,
             source):
    """A kernels-line entry for one of K2's one-block flag kernels, from
    ``k2_branches``' record (its result equal to the plain twin's on every
    input there: max_abs_err 0)."""
    r = results[("K2 branch kernels",)]
    b = bound(nbytes)
    ok = (r["decide_mismatches"] == 0 if key == "decide" else
          r["pivot_floor_flags"]["cuda"] == r["pivot_floor_flags"]["plain"])
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[entry],
            "max_abs_err": 0.0 if ok else 1.0, "ms": r[key + "_ms"],
            "device_ms": r[key + "_device_ms"],
            "plain_ms": r[key + "_plain_ms"], "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "library_ms": None}


def summary(results, launches):
    k1 = results[("K1", "lp5000_pd")]
    k3 = results[("K3a", "torch.float32", 800)]
    k3d = results[("K3a", "torch.float64", 800)]
    k3b = results[("K3b", 800)]
    # the reseed at the np of the main path's reseeds (lp1000_barrier,
    # qp1000_barrier, lp1000_phase1; lp5000_barrier's np = 1024 runs none)
    reseed = results[("LDL reseed", 256)]
    lasso = results[("main", "lasso1000")]
    lk = results[("lasso_kernels", "lasso1000")]
    # K2 at its largest shape, from the row's first state (the warm start,
    # or phase one's start when the warm start is infeasible)
    k2 = next(v for key, v in results.items()
              if key[:2] == ("K2", "lp5000_barrier"))
    k4 = results[("K4", "socp1000_barrier", "first")]
    # K5 at the Schur-CG branch's main-path shape (r = 1000, pe = 50)
    k5 = results[("K5", "socp1000_pd_full", "first")]
    src = "interiorpoint_tpu_torch/csrc/"
    srcs = [src + "rows.cu", src + "gram.cu", src + "chol.cu"]
    k1_srcs = srcs + [src + "hop.cu", src + "strip.cuh"]
    k2_srcs = srcs + [src + "ldl.cu"]
    gram = results[("gram",) + GRAM_SHAPES[-1]]

    def bnd(b):
        return {"bound_ms": b["bound_ms"], "bound_by": b["bound_by"]}

    fb_entries = {e: launches.get("K2.fallback." + e, 0)
                  for e in K2_FALLBACK_ENTRIES}

    def k2_piece(name, n_launches, key, replaces, source, work, **extra):
        """A K2 preconditioner piece from the first K2 state (barrier rows
        in order, the largest shape first) that timed it."""
        order = ("lp5000_barrier",) + tuple(r for r in BARRIER_ROWS
                                            if r != "lp5000_barrier")
        for row in order:
            for (kind, *rest), v in results.items():
                if kind == "K2" and rest[0] == row and key in v[
                        "pieces_ms"]:
                    ms, plain, lib = v["pieces_ms"][key]
                    np_ = -(-v["shape"][1] // 128) * 128
                    b = work(np_, v) if callable(work) else work
                    return {"name": name, "route": "cuda",
                            "source": source, "replaces": replaces,
                            "launches": n_launches, **extra,
                            "max_abs_err": v["pieces_info"].get(
                                ERR_KEY[key]),
                            "ms": ms, "plain_ms": plain, **bnd(b),
                            "library_ms": lib, "shape": [np_, np_],
                            "state": [row, rest[1]]}
        return None

    return {"kernels": [
        # K1 and K2 are sequences of launches from three sources; "source"
        # names the one with their own passes, "sources" all three
        {"name": "K1 pd_step", "route": "cuda", "source": src + "rows.cu",
         "sources": k1_srcs,
         "replaces": "interiorpoint_tpu/ops/pallas_pd.py:368",
         "launches": launches["K1"],
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"], **bnd(k1), "library_ms": None,
         "shape": k1["shape"], "pieces_ms": k1["pieces_ms"]},
        # the refined solve of K1, K2 and K4 in one cooperative launch, at
        # lp5000_pd's first state (the predictor's right-hand side; the W
        # form); K2's at its states (the form its branch took) in
        # k2_by_state; no single PyTorch call computes it
        {"name": "K1/K2/K4 refined solve (ip_refined_solve)",
         "route": "cuda",
         "source": src + "hop.cu",
         "replaces": "interiorpoint_tpu/ops/pallas_newton.py:747",
         "launches": launches["ip_refined_solve"],
         "max_abs_err": k1["pieces_info"]["solve.x_abs_err"],
         "ms": k1["pieces_ms"]["solve"][0],
         "plain_ms": k1["pieces_ms"]["solve"][1],
         **bnd(k1["pieces_info"]["solve.bound"]), "library_ms": None,
         "shape": k1["shape"],
         "counts": k1["pieces_info"]["solve.counts"][0],
         # every timed state, and the main path's launches and operator
         # passes by the shape of M
         "by_state": hop_by_state(results),
         "k2_by_state": k2_solve_by_state(results),
         "main_path_launches_by_shape": launches["hop_shapes"]},
        # the fused operator: the main path never launches its own entry
        # (launches: 0); its pass runs inside ip_refined_solve, whose
        # kernel counts every pass on the device (ops/pd_step.py TALLY).
        # ms is the entry's own two launches at lp5000_pd's first state
        {"name": "K1/K4 fused operator (ip_h_apply)", "route": "cuda",
         "source": src + "hop.cu", "sources": [src + "hop.cu",
                                               src + "strip.cuh"],
         "replaces": "interiorpoint_tpu/ops/pallas_pd.py:186",
         "launches": launches["ip_h_apply"],
         "passes_inside_refined_solve": launches["operator_passes"],
         "ms_of": "the ip_h_apply entry alone (not launched on the path)",
         "max_abs_err": k1["pieces_info"]["h_apply.max_abs_err"],
         "ms": k1["pieces_ms"]["h_apply"][0],
         "plain_ms": k1["pieces_ms"]["h_apply"][1],
         **bnd(k1["pieces_info"]["h_apply.bound"]), "library_ms": None,
         "shape": k1["shape"],
         "by_state": [{"state": b["state"], "shape": b["shape"],
                       **b["h_apply"]} for b in hop_by_state(results)]},
        # syncs_per_step: the main path's host reads per K2 step (the
        # engine's one) on the barrier rows' first solves, and those
        # inside the timed steps (0); the branches the steps took
        {"name": "K2 newton_step", "route": "cuda",
         "source": src + "rows.cu", "sources": k2_srcs,
         "replaces": "interiorpoint_tpu/ops/pallas_newton.py:964",
         "launches": launches["K2"],
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"], **bnd(k2["step_bound"]),
         "library_ms": None, "shape": k2["shape"],
         **k2_path_counts(results)},
        # the branch of K2's preconditioner and the pivot floor of its
        # fallback's first rung, launched in every step (each skips itself
        # outside its branch); timed on k2_branches' inputs
        k2_small("K2 branch (ip_k2_decide)", "ip_k2_decide", launches,
                 results, "decide", 32,
                 "interiorpoint_tpu/ops/pallas_newton.py:681",
                 src + "ldl.cu"),
        k2_small("K2 pivot floor (ip_pivot_floor)", "ip_pivot_floor",
                 launches, results, "pivot_floor",
                 4 * results[("K2 branch kernels",)]["pivot_floor_np"] + 4,
                 "interiorpoint_tpu/ops/pallas_newton.py:505",
                 src + "chol.cu"),
        # K2d is K2's first half: the main path runs its launches inside
        # K2 and never calls it alone
        {"name": "K2d newton_dir", "route": "cuda",
         "source": src + "rows.cu", "sources": k2_srcs,
         "replaces": "interiorpoint_tpu/ops/pallas_newton.py:922",
         "launches": launches["K2d"],
         "max_abs_err": k2["dir_max_abs_err"], "ms": k2["dir_ms"],
         "plain_ms": k2["dir_plain_ms"], **bnd(k2["dir_bound"]),
         "library_ms": None, "shape": k2["shape"]},
        # K2's pieces (K1 and K4 share the Gram): the Gram at 11000 x
        # 1001 from seeded inputs, the preconditioner's at a K2 state
        {"name": "K2 Gram (fp32, K1/K2/K4)", "route": "cuda",
         "source": src + "gram.cu",
         "replaces": "interiorpoint_tpu/ops/pallas_newton.py:623",
         "launches": launches["ip_gram"], "max_abs_err": gram["max_abs_err"],
         "ms": gram["ms"], "plain_ms": gram["plain_ms"],
         **bnd(gram["bound"]), "library_ms": gram["library_ms"],
         "shape": gram["shape"]},
        *[e for e in (
            # bound: the work of this state's rung-0 factor (each tile's
            # Newton-Schulz iterations as the plain factor's stats give
            # them)
            k2_piece("K2 hybrid factor (block-LDL, Newton-Schulz tiles)",
                     launches["K2.ldl_factor"], "ldl_factor",
                     "interiorpoint_tpu/ops/pallas_newton.py:445",
                     src + "ldl.cu",
                     lambda n, v: bound(ldl_factor_bytes(n),
                                        f32=ldl_factor_work(
                                            n, v["pieces_info"][
                                                "ldl0.tiles"][1])),
                     status="redesigned",
                     synthetic=synthetic_factor(results)),
            # launches: the factor's rungs and the inverse, as launched
            # inside K2's steps; fallbacks: the times K2 took the branch
            k2_piece("K2 Cholesky fallback (factor and inverse)",
                     sum(fb_entries.values()), "cholesky_fallback",
                     "interiorpoint_tpu/ops/pallas_newton.py:505",
                     src + "chol.cu",
                     lambda n, v: bound(12 * n * n, f32=2 * n ** 3 / 3.0),
                     entry_launches=fb_entries,
                     fallbacks=launches.get("K2.fallbacks", 0)),
            # launches at p = 1 (csolve.cu's one-cluster kernel), split
            # by the rows' np; the reseed's on wsolve.cu below; "seeded":
            # phase_column_solve's times by np
            k2_piece("K2 LDL solve",
                     launches["K2.ldl_solve"] - launches["K2.ldl_solve_wide"],
                     "ldl_solve",
                     "interiorpoint_tpu/ops/pallas_newton.py:479",
                     src + "csolve.cu",
                     lambda n, v: ldl_solve_bound(n),
                     status="redesigned",
                     launches_by_width={
                         "p1": launches["K2.ldl_solve"]
                         - launches["K2.ldl_solve_wide"],
                         "wide": launches["K2.ldl_solve_wide"]},
                     launches_by_np=ldl_launches_by_np(results),
                     entry_launches={"ip_block_solve_column": launches[
                         "ip_block_solve_column"]},
                     seeded=column_times(results, "ldl")),
            k2_piece("K2 carry refresh (Newton-Schulz)",
                     launches["K2.carry_refresh"], "carry_refresh",
                     "interiorpoint_tpu/ops/pallas_newton.py:649",
                     src + "ldl.cu",
                     lambda n, v: v["pieces_info"]["carry.bound"],
                     status="redesigned",
                     synthetic=synthetic_carry(results)))
          if e is not None],
        # the LDL solve at p = np (the carry reseed M⁻¹I, each time the
        # carry misses and an LDL rung holds) on wsolve.cu, from the seeded
        # factor at np = 256 of phase_k3b_wide
        {"name": "K2 LDL solve at p = np (carry reseed)", "route": "cuda",
         "source": src + "wsolve.cu",
         "replaces": "interiorpoint_tpu/ops/pallas_newton.py:479",
         "launches": launches["K2.ldl_solve_wide"],
         "max_abs_err": reseed["solve_abs_err"], "ms": reseed["solve_ms"],
         "device_ms": reseed["solve_device_ms"],
         "plain_ms": reseed["solve_plain_ms"], **bnd(reseed["solve_bound"]),
         "library_ms": None, "shape": [reseed["np"], reseed["p"]]},
        # K3a in fp32 (the standalone factor, and the factor the step
        # kernels K1, K2, K4 run) and in fp64 (K5's factors): launches of
        # its C entry on the main path
        {"name": "K3a cholesky_blocked (fp32)", "route": "cuda",
         "source": src + "chol.cu",
         "replaces": "interiorpoint_tpu/ops/pallas_chol.py:143",
         "launches": launches["K3a"],
         "entry_launches": launches["ip_chol_factor"],
         "max_abs_err": k3["factor_abs_err"], "ms": k3["factor_ms"],
         "plain_ms": k3["factor_plain_ms"], **bnd(k3["factor_bound"]),
         "library_ms": k3["factor_library_ms"], "shape": [800, 800]},
        {"name": "K3a inverse W = L^-1 (fp32)", "route": "cuda",
         "source": src + "chol.cu",
         "replaces": "interiorpoint_tpu/ops/pallas_chol.py:143",
         "launches": launches["ip_chol_invert"],
         "max_abs_err": k3["invert_abs_err"], "ms": k3["invert_ms"],
         "plain_ms": k3["invert_plain_ms"], **bnd(k3["invert_bound"]),
         "library_ms": k3["invert_library_ms"], "shape": [800, 800]},
        {"name": "K3a factor (fp64, DMMA)", "route": "cuda",
         "source": src + "chol.cu",
         "replaces": "interiorpoint_tpu/ops/pallas_chol.py:143",
         "launches": launches["ip_chol_factor64"],
         "max_abs_err": k3d["factor_abs_err"], "ms": k3d["factor_ms"],
         "plain_ms": k3d["factor_plain_ms"], **bnd(k3d["factor_bound"]),
         "library_ms": k3d["factor_library_ms"], "shape": [800, 800]},
        # at p = 1 on csolve.cu's one-cluster kernel (its entry's
        # launches over the main path, the LDL solves' included, in
        # entry_launches); calls_by_n: every p = 1 call of phase_main
        # (each row's first solve and its three timed ones) by n;
        # "seeded": phase_column_solve's times by n
        {"name": "K3b cholesky_solve_blocked", "route": "cuda",
         "source": src + "csolve.cu", "status": "redesigned",
         "replaces": "interiorpoint_tpu/ops/pallas_chol.py:172",
         "launches": launches["K3b"],
         "calls_by_n": {n: c for (n, p), c in sorted(
             Counter(results[("k3b_shapes",)]).items()) if p == 1},
         "entry_launches": {"ip_block_solve_column": launches[
             "ip_block_solve_column"]},
         "max_abs_err": k3b["solve_abs_err"], "ms": k3b["solve_ms"],
         "plain_ms": k3b["solve_plain_ms"], **bnd(k3b["solve_bound"]),
         "library_ms": k3b["solve_library_ms"], "shape": [800, 1],
         "seeded": column_times(results, "k3b")},
        # K3a and K3b at the LASSO ladder's shape, on its first rung's
        # inputs; launches: the lasso1000 row's (five factors, one per ρ
        # rung, and the refinement rounds' solves with n right-hand sides)
        {"name": "K3a cholesky_blocked (fp32, LASSO ladder)",
         "route": "cuda", "source": src + "chol.cu",
         "replaces": "interiorpoint_tpu/ops/pallas_chol.py:143",
         "launches": lasso["launches_first_solve"]["K3a"],
         "max_abs_err": lk["factor_abs_err"], "ms": lk["factor_ms"],
         "plain_ms": lk["factor_plain_ms"], **bnd(lk["factor_bound"]),
         "library_ms": lk["factor_library_ms"], "shape": [lk["n"], lk["n"]],
         "row": "lasso1000"},
        # (wsolve.cu; entry_launches: its C entry over the main path, the
        # reseeds of the K2 rows included)
        {"name": "K3b cholesky_solve_blocked (LASSO ladder, p = n)",
         "route": "cuda", "source": src + "wsolve.cu",
         "replaces": "interiorpoint_tpu/ops/pallas_chol.py:172",
         "launches": lasso["launches_first_solve"]["K3b"],
         "entry_launches": {
             "ip_block_solve_wide": launches["ip_block_solve_wide"]},
         "max_abs_err": lk["solve_abs_err"], "ms": lk["solve_ms"],
         "plain_ms": lk["solve_plain_ms"], **bnd(lk["solve_bound"]),
         "library_ms": lk["solve_library_ms"], "shape": [lk["n"], lk["p"]],
         "row": "lasso1000"},
        # K4: the cone passes of cones.cu plus K1's Gram, factor, inverse,
        # W-solve and fp64 operator passes; no single PyTorch call
        # computes the step
        {"name": "K4 socp_newton_step", "route": "cuda",
         "source": src + "cones.cu", "sources": [src + "cones.cu"] + k1_srcs,
         "replaces": "interiorpoint_tpu/ops/pallas_socp.py:220",
         "launches": launches["K4"],
         "max_abs_err": k4["max_abs_err"], "ms": k4["ms"],
         "plain_ms": k4["plain_ms"], **bnd(k4), "library_ms": None,
         "shape": k4["shape"], "pieces_ms": k4["pieces_ms"]},
        # K5: the fp64 Schur build and Gram of kkt.cu plus the fp64
        # equilibration, factor, inverse and W-solve and the fp64 matvecs;
        # prepared once per direction here (the main path shares one
        # preparation between its directions); library: one
        # torch.linalg.solve of the fp64 KKT matrix
        {"name": "K5 kkt_dir", "route": "cuda", "source": src + "kkt.cu",
         "sources": [src + "kkt.cu"] + srcs,
         "replaces": "interiorpoint_tpu/ops/pallas_kkt.py:119",
         "launches": launches["K5"],
         "max_abs_err": k5["max_abs_err"], "ms": k5["ms"],
         "plain_ms": k5["plain_ms"], **bnd(k5),
         "library_ms": k5["library_ms"], "shape": k5["shape"]},
    ]}


def phase_profile(rows, top=12):
    """torch.profiler over one steady-state solve of each row (after one
    warm-up solve): the device time of the kernels by name (their sum and
    its share of the solve's wall time) and the top ``top`` of them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from interiorpoint_tpu_torch.ops import hybrid

    for row in rows:
        solver = make_solver(row, "cuda")
        kw = solve_kwargs(row)
        solver.solve(**kw)
        torch.cuda.synchronize()
        factors = hybrid.ldl_factor_cuda.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            solver.solve(**kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        factors = hybrid.ldl_factor_cuda.launches - factors
        # kernels and copies only: events that ran on the device and are
        # not the CPU-side aten ops that launched them
        dev = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.self_device_time_total > 0
               and not e.key.startswith("aten::")]
        dev.sort(key=lambda v: -v[1])
        busy = sum(v[1] for v in dev)
        check(busy > 0, f"profile {row}: no device time in the trace")
        # K2's LDL factor is one device kernel per call
        ldl = sum(n for k, _, n in dev if "ldl_kernel" in k)
        check(ldl == factors, f"profile {row}: {ldl} LDL factor kernels "
              f"for {factors} calls")
        m = solver.last_metrics
        # barrier: Newton steps; pd: iterations; LASSO: ADMM iterations
        emit({"phase": "profile", "row": row, "solve_s": wall,
              "ldl_factor_calls": factors, "ldl_factor_kernels": ldl,
              "kernel_device_ms": busy, "busy_share": busy / 1e3 / wall,
              "steps": (solver.outer_iters if m.get("algorithm") == "pd"
                        else int(m["newton_iters"])),
              "top": [[k, ms, n] for k, ms, n in dev[:top]]})
        del solver
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# parallel/ on the card: batched solves through the kernels, the sharded
# LASSO and the row- and cone-sharded solves on a one-rank NCCL group
# ---------------------------------------------------------------------------

BATCH = 8
BATCH_ROWS = ("batch8_lp_barrier", "batch8_lp_pd", "batch8_lp_pd_eq",
              "batch8_socp_barrier")
# the kernels each parallel row must launch
PAR_ROW_KERNELS = {"batch8_lp_barrier": ("K2",), "batch8_lp_pd": ("K1",),
                   "batch8_lp_pd_eq": ("K5",),
                   "batch8_socp_barrier": ("K4",),
                   "lasso1000_sharded": ("K3a", "K3b")}
# LP_KW's barrier settings, and SOCP_KW's with its t0="auto" taken from
# instance 0 (``socp_auto_t0``: solve_batch takes one t0 for the batch, as
# the JAX package's does)
BATCH_LP_CFG = dict(epsilon=1e-4, mu=15.0, t0=1.0, alpha=0.05, beta=0.5,
                    max_inner_iters=20, max_outer_iters=10, dtype="float64")
BATCH_SOCP_CFG = dict(epsilon=1e-4, mu=15.0, alpha=0.05, beta=0.5,
                      max_inner_iters=500, max_outer_iters=20,
                      dtype="float64")
# the kernels line's entries whose launches the parallel rows and the
# harness add to (a counter, or a counter less the counters of its
# launches listed on another entry)
PAR_ENTRY_KEYS = {"K1 pd_step": "K1", "K2 newton_step": "K2",
                  "K2d newton_dir": "K2d",
                  "K3a cholesky_blocked (fp32)": "K3a",
                  "K3b cholesky_solve_blocked": "K3b",
                  "K4 socp_newton_step": "K4", "K5 kkt_dir": "K5",
                  "K1/K2/K4 refined solve (ip_refined_solve)":
                      "ip_refined_solve",
                  "K2 branch (ip_k2_decide)": "ip_k2_decide",
                  "K2 pivot floor (ip_pivot_floor)": "ip_pivot_floor",
                  "K2 Gram (fp32, K1/K2/K4)": "ip_gram",
                  "K3a inverse W = L^-1 (fp32)": "ip_chol_invert",
                  "K3a factor (fp64, DMMA)": "ip_chol_factor64",
                  "K2 hybrid factor (block-LDL, Newton-Schulz tiles)":
                      "K2.ldl_factor",
                  "K2 LDL solve": ("K2.ldl_solve", "K2.ldl_solve_wide"),
                  "K2 LDL solve at p = np (carry reseed)":
                      "K2.ldl_solve_wide",
                  "K2 carry refresh (Newton-Schulz)": "K2.carry_refresh"}


def batch_lp_instances():
    """batch8_lp_barrier's eight inequality-form LPs, instance s from
    RandomState(100 + s): C₀ = U(−2, 2) of 1800 × 200, x_f = U(−2, 2),
    d₀ = C₀x_f + 1, the box ±3 as rows [I; −I] (C of 2200 × 200,
    lp1000_barrier's K2 shape), c = U(−2, 2).  x0 = x_f, except instance
    3's x_f + 5, outside the box, so its phase one runs.  Returns
    ([dict(c, C, d)], x0 of (8, 200))."""
    import numpy as np
    probs, x0s = [], []
    eye = np.eye(200)
    for s in range(BATCH):
        rng = np.random.RandomState(100 + s)
        C0 = rng.uniform(-2, 2, (1800, 200))
        xf = rng.uniform(-2, 2, 200)
        c = rng.uniform(-2, 2, 200)
        probs.append(dict(c=c, C=np.vstack([C0, eye, -eye]),
                          d=np.concatenate([C0 @ xf + 1.0,
                                            np.full(400, 3.0)])))
        x0s.append(xf + (5.0 if s == 3 else 0.0))
    return probs, np.stack(x0s)


def batch_socp_instances():
    """batch8_socp_barrier's eight SOCPs: generate_socp(1000,
    rng=RandomState(1 + s)) (5 cones × 800 rows, 50 equalities, P, q;
    instance 0 is bench_socp(1000)'s); x0 the recipe's, except instance
    3's x0 + 0.1·N(0, 1) (seed 7), whose projection onto Fx = g leaves
    the cones, so its phase one runs.  The batch solves their reduced
    problems (``reduce_socp``: the pure-cone form K4 takes, as
    socp1000_barrier does).  Without F the recipe's cones are active at
    the optimum and every stage of the squared-cone barrier runs its
    500-step cap, ending on a cone's boundary (PERF.md §6)."""
    import numpy as np
    from interiorpoint_tpu_torch.utils.generators import generate_socp
    probs, x0s = [], []
    for s in range(BATCH):
        p = generate_socp(1000, rng=np.random.RandomState(1 + s))
        x0 = p.pop("x0")
        p.pop("lower_bound"), p.pop("upper_bound")
        if s == 3:
            x0 = x0 + 0.1 * np.random.RandomState(7).standard_normal(1000)
        probs.append(p)
        x0s.append(x0)
    return probs, np.stack(x0s)


def socp_auto_t0(p, x0):
    """SOCP_KW's t0="auto" (models/base.py ``_t0``): the cone count over
    max(|f(x0)|, 1), f = ½xᵀPx + qᵀx.  From t0 = 1 the squared-cone
    barrier on these recipes runs every stage to its step cap."""
    f0 = 0.5 * x0 @ p["P"] @ x0 + p["q"] @ x0
    return len(p["A"]) / max(abs(float(f0)), 1.0)


def same_instance(single, res, i):
    """Whether instance i of a batched result is bitwise ``single``."""
    import numpy as np
    import torch
    for f, a in single._asdict().items():
        b = getattr(res, f)
        if a is None:
            if b is not None:
                return False
        elif isinstance(a, torch.Tensor):
            if not torch.equal(a, b[i]):
                return False
        elif isinstance(a, tuple):
            if not same_instance(a, b, i):
                return False
        elif not np.array_equal(np.asarray(a), np.asarray(b[i]),
                                equal_nan=True):
            return False
    return True


def drive_batch(row, probs, x0, cfg, algorithm, single):
    """``solve_batch`` of the row on the card's mesh with every counter
    set to 0 just before its first call, three timed calls, and every
    instance against ``single`` (its single-instance call).  Returns
    (result, record)."""
    import numpy as np
    import torch
    from interiorpoint_tpu_torch import parallel as par

    batch = par.stack_problems(probs)
    x0t = torch.as_tensor(x0, dtype=torch.float64, device="cuda")
    mesh = par.make_mesh(axis_names=("batch",), device="cuda")
    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = par.solve_batch(batch, x0t, cfg, mesh=mesh, algorithm=algorithm)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    first = diff(counters(), {})
    syncs_first = counters()["syncs"]
    for kname in PAR_ROW_KERNELS[row]:
        check(first["launches"][kname] > 0,
              f"{row}: kernel {kname} never launched")
    for kname, cnt in first["plain"].items():
        check(cnt == 0, f"{row}: plain version of {kname} ran")
    peak = torch.cuda.max_memory_allocated()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        par.solve_batch(batch, x0t, cfg, mesh=mesh, algorithm=algorithm)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    for kname, cnt in counters()["plain"].items():
        check(cnt == 0, f"{row}: plain version of {kname} ran")
    differ = [i for i in range(BATCH)
              if not same_instance(single(probs[i], x0t[i]), res, i)]
    pd = algorithm == "pd"
    rec = {"phase": "parallel", "row": row, "batch": BATCH,
           "algorithm": algorithm, "mesh": str(mesh),
           "first_solve_s": first_s, "solve_s_median": sorted(times)[1],
           "solve_s": times, "host_syncs_per_batch": syncs_first,
           "max_memory_allocated": peak,
           "iterations": (res.iters if pd else res.outer_iters).tolist(),
           "launches_first_solve": first["launches"],
           "entry_launches_first_solve": first["entries"],
           "instances_not_bitwise_single": differ}
    if not pd:
        rec["newton_steps"] = res.inner_iters.sum(axis=1).tolist()
        if res.phase1 is not None:
            rec["phase1_stages"] = res.phase1.outer_iters.tolist()
    check(not differ, f"{row}: instances {differ} differ from their "
          "single-instance calls")
    check(bool(np.isfinite((res.z if pd else res.x).cpu().numpy()).all()),
          f"{row}: non-finite x")
    return res, rec


def phase_parallel(results):
    """parallel/ on the card (module docstring, phase 6).  Returns the
    launches of its rows' first calls, by the keys of phase_main's."""
    import numpy as np
    import torch
    from scipy.optimize import linprog
    from types import SimpleNamespace
    from interiorpoint_tpu_torch import make_lp, make_socp
    from interiorpoint_tpu_torch import parallel as par
    from interiorpoint_tpu_torch.models.reduced import (full_space_pd_problem,
                                                        reduce_socp)
    from interiorpoint_tpu_torch.ops.barrier import (
        make_phase1_linear_oracle, make_qp_oracle)
    from interiorpoint_tpu_torch.ops.ipm import barrier_solve
    from interiorpoint_tpu_torch.ops.pd import pd_solve
    from interiorpoint_tpu_torch.ops.socp import (make_phase1_socp_oracle,
                                                  make_socp_oracle)
    from interiorpoint_tpu_torch.utils.config import SolverConfig

    refs = results[("refs",)]
    launches = {k: 0 for k in KERNELS + tuple(K2_PIECES) + MAIN_ENTRIES
                 + ("operator_passes",)}

    def add(rec):
        for k, n in rec["launches_first_solve"].items():
            launches[k] = launches.get(k, 0) + n
        for e in MAIN_ENTRIES:
            launches[e] += rec["entry_launches_first_solve"].get(e, 0)

    def barrier_single(cfg, eq_gate, socp=False):
        def run(prob, x0):
            if socp:
                oracle, p1 = (make_socp_oracle(prob),
                              make_phase1_socp_oracle(prob))
                A, b = prob.F, prob.g
            else:
                oracle, p1 = (make_qp_oracle(prob, try_diag=cfg.try_diag),
                              make_phase1_linear_oracle(prob))
                A, b = prob.A, prob.b
            return barrier_solve(oracle, A, b, x0, cfg,
                                 num_constraints=prob.num_ineq_constraints,
                                 eq_gate=eq_gate, t0=cfg.t0, p1_oracle=p1)
        return run

    def pd_single(cfg):
        def run(prob, x0):
            return pd_solve(full_space_pd_problem(prob, torch.float64), x0,
                            cfg, A=prob.A, b=prob.b)
        return run

    # batch8_lp_barrier and batch8_lp_pd: K2 (and K2 on [C | −1] in
    # instance 3's phase one), then K1, on the same eight LPs
    data, x0 = batch_lp_instances()
    highs = []
    for p in data:
        h = linprog(p["c"], A_ub=p["C"], b_ub=p["d"],
                    bounds=[(None, None)] * len(p["c"]), method="highs")
        check(h.status == 0, "HiGHS failed on a batch8_lp instance")
        highs.append(float(h.fun))
    probs = [make_lp(p["c"], C=p["C"], d=p["d"], device="cuda")
             for p in data]
    cfg = SolverConfig(**BATCH_LP_CFG)
    res, rec = drive_batch("batch8_lp_barrier", probs, x0, cfg, "barrier",
                           barrier_single(cfg, 1e-4 * x0.shape[1]))
    vals, gaps = res.value, res.dual_gap
    rec.update(values=vals.tolist(), highs=highs, dual_gaps=gaps.tolist(),
               abs_err_vs_highs=np.abs(vals - highs).tolist())
    emit(rec)
    add(rec)
    results[("parallel", rec["row"])] = rec
    ran = (res.phase1.outer_iters > 0).tolist()
    check(ran == [i == 3 for i in range(BATCH)],
          f"batch8_lp_barrier: phase one ran on {ran}")
    check(bool((np.abs(vals - highs)
                <= gaps + 1e-9 * np.abs(highs)).all()),
          f"batch8_lp_barrier: values {vals} against HiGHS {highs} above "
          f"the gaps {gaps}")
    del res

    cfg_pd = SolverConfig(**dict(BATCH_LP_CFG, dtype="float64"))
    res, rec = drive_batch("batch8_lp_pd", probs, x0, cfg_pd, "pd",
                           pd_single(cfg_pd))
    vals = np.array([float(p["c"] @ z) for p, z in
                     zip(data, res.z.cpu().numpy())])
    err = np.abs(vals - highs) / np.abs(highs)
    rec.update(values=vals.tolist(), highs=highs, gaps=res.gap.tolist(),
               rel_err_vs_highs=err.tolist(),
               converged=res.converged.tolist())
    emit(rec)
    add(rec)
    results[("parallel", rec["row"])] = rec
    check(bool(res.converged.all()), "batch8_lp_pd: not converged")
    check(bool((err <= 1e-6).all()),
          f"batch8_lp_pd: rel err vs HiGHS {err}")
    del res, probs

    # batch8_lp_pd_eq: bench_lp(1000)'s recipe at seeds 1..8 through K5
    data = [lp_recipe(1000, seed=1 + s) for s in range(BATCH)]
    probs = [make_lp(p["c"], p["A"], p["b"], p["C"], p["d"], -3.0, 3.0,
                     device="cuda") for p in data]
    cfg_eq = SolverConfig(dtype="float64", epsilon=1e-6)
    res, rec = drive_batch("batch8_lp_pd_eq", probs,
                           np.zeros((BATCH, len(data[0]["c"]))), cfg_eq,
                           "pd", pd_single(cfg_eq))
    zs = res.z.cpu().numpy()
    vals = np.array([float(p["c"] @ z) for p, z in zip(data, zs)])
    certs = []
    for p, z, g, v in zip(data, zs, res.gap, vals):
        certs.append(kkt_certificate(SimpleNamespace(
            xstar=z, optimality_gap=float(g), value=float(v)), p))
    rec.update(values=vals.tolist(), converged=res.converged.tolist(),
               lp1000_pd_eq=refs["lp1000_pd_eq"],
               highs_lp1000=refs["highs_lp1000"], certificates=certs,
               rel_err_vs_lp1000_pd_eq=abs(vals[0] - refs["lp1000_pd_eq"])
               / abs(refs["lp1000_pd_eq"]),
               rel_err_vs_highs=abs(vals[0] - refs["highs_lp1000"])
               / abs(refs["highs_lp1000"]))
    emit(rec)
    add(rec)
    results[("parallel", rec["row"])] = rec
    check(bool(res.converged.all()), "batch8_lp_pd_eq: not converged")
    check(rec["rel_err_vs_lp1000_pd_eq"] <= 1e-9,
          f"batch8_lp_pd_eq: instance 0 against lp1000_pd_eq: {rec}")
    check(rec["rel_err_vs_highs"] <= 1e-6,
          f"batch8_lp_pd_eq: instance 0 against HiGHS: {rec}")
    del res, probs
    torch.cuda.empty_cache()

    # batch8_socp_barrier: K4 on every main-stage step of the reduced
    # problems
    data, x0 = batch_socp_instances()
    rfs = [reduce_socp(make_socp(**p, device="cuda")) for p in data]
    z0 = torch.stack([rf.basis.N.T @ (torch.as_tensor(
        x, dtype=torch.float64, device="cuda") - rf.basis.x_p)
        for rf, x in zip(rfs, x0)]).cpu().numpy()
    cfg_s = SolverConfig(**BATCH_SOCP_CFG, t0=socp_auto_t0(data[0], x0[0]))
    res, rec = drive_batch("batch8_socp_barrier", [rf.prob for rf in rfs],
                           z0, cfg_s, "barrier",
                           barrier_single(cfg_s, 1e-3, socp=True))
    vals = res.value + np.array([float(rf.obj_offset) for rf in rfs])
    rec.update(values=vals.tolist(), dual_gaps=res.dual_gap.tolist())
    emit(rec)
    add(rec)
    results[("parallel", rec["row"])] = rec
    ran = (res.phase1.outer_iters > 0).tolist()
    check(ran == [i == 3 for i in range(BATCH)],
          f"batch8_socp_barrier: phase one ran on {ran}")
    xs = [rf.expand(z).cpu().numpy() for rf, z in zip(rfs, res.x)]
    rec["certificates"] = [socp_certificate(x, p)
                           for x, p in zip(xs, data)]
    emit({"phase": "parallel", "row": rec["row"],
          "certificates": rec["certificates"]})
    # instance 0 is socp1000_barrier's instance, at t0 = 1
    ref, ref_gap = refs["socp1000_full"], refs["socp1000_full_gap"]
    check(abs(vals[0] - ref) <= res.dual_gap[0] + ref_gap + 1e-8 * abs(ref),
          f"batch8_socp_barrier: instance 0 {vals[0]} against "
          f"socp1000_full {ref}")
    del res, rfs
    torch.cuda.empty_cache()

    rec = drive_lasso_sharded(results)
    add(rec)
    rec = phase_dist(results, refs)
    return launches


def drive_lasso_sharded(results):
    """lasso1000_sharded: lasso1000's data and settings through
    ``solve_lasso_sharded`` on a one-card mesh (``admm_core``: the ladder
    through K3a and K3b, then the iterations), against ``solve_lasso`` on
    the card and the lasso1000 row's iterations."""
    import numpy as np
    import torch
    from interiorpoint_tpu_torch import parallel as par
    from interiorpoint_tpu_torch.models.lasso import solve_lasso

    row = "lasso1000_sharded"
    p = lasso_recipe()
    A = np.hstack([np.ones((p["A"].shape[0], 1)), p["A"]])
    cfg = make_solver("lasso1000", "cuda").cfg
    mesh = par.make_mesh(axis_names=("batch",), device="cuda")
    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = par.solve_lasso_sharded(A, p["b"], p["reg"], cfg, mesh)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    first = diff(counters(), {})
    syncs = counters()["syncs"]
    peak = torch.cuda.max_memory_allocated()
    for kname in PAR_ROW_KERNELS[row]:
        check(first["launches"][kname] > 0,
              f"{row}: kernel {kname} never launched")
    for kname, cnt in first["plain"].items():
        check(cnt == 0, f"{row}: plain version of {kname} ran")
    single = solve_lasso(A, p["b"], p["reg"], cfg=cfg, device="cuda")
    x_err = float((res.X - single.X).abs().max() / single.X.abs().max())
    main = results[("main", "lasso1000")]
    rec = {"phase": "parallel", "row": row, "mesh": str(mesh),
           "iterations": res.iterations,
           "lasso1000_iterations": main["iterations"],
           "rel_err_vs_solve_lasso": x_err, "first_solve_s": first_s,
           "host_syncs": syncs, "max_memory_allocated": peak,
           "launches_first_solve": first["launches"],
           "entry_launches_first_solve": first["entries"]}
    emit(rec)
    results[("parallel", row)] = rec
    check(res.iterations == main["iterations"] == single.iterations,
          f"{row}: {res.iterations} iterations, lasso1000 "
          f"{main['iterations']}, solve_lasso {single.iterations}")
    check(x_err <= 1e-12, f"{row}: X rel err vs solve_lasso {x_err:.3g}")
    check(bool(torch.isfinite(res.X).all()) and tuple(res.X.shape)
          == (A.shape[1], p["b"].shape[1]),
          f"{row}: X of shape {tuple(res.X.shape)}")
    return rec


def barrier_gap(res, num_ineq, t0=1.0, mu=15.0):
    """m/t of a distributed barrier solve's last stage (its t multiplies
    by μ after each of its outer_iters stages)."""
    return num_ineq / (t0 * mu ** (res["outer_iters"] - 1))


def phase_dist(results, refs):
    """The row- and cone-sharded solves and dist_cholesky on a one-rank
    NCCL group that this script creates (``initialize`` is a no-op for one
    process): plain torch, the JAX programs reaching no Pallas kernel.
    Each row runs once after a warm-up on a small instance."""
    import socket
    from types import SimpleNamespace
    import numpy as np
    import torch
    import torch.distributed as dist
    from interiorpoint_tpu_torch import parallel as par
    from interiorpoint_tpu_torch.parallel import distributed as dist_mod
    from interiorpoint_tpu_torch.parallel.chol import dist_cholesky

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    par.initialize(f"localhost:{port}", 1, 0)
    check(not dist.is_initialized(), "initialize ran for one process")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl",
                            init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        check(dist.get_backend() == "nccl",
              f"backend {dist.get_backend()}")
        rows = par.make_mesh(axis_names=("rows",))
        cones = par.make_mesh(axis_names=("cones",))
        check(rows.shape == {"rows": 1}
              and rows.devices.flat[0].type == "cuda",
              f"mesh {rows}")

        def run(row, fn, warm, extra=None):
            warm()
            torch.cuda.synchronize()
            reset_counters()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            check(res["x"].device.type == "cuda"
                  and bool(torch.isfinite(res["x"]).all()),
                  f"{row}: x on {res['x'].device}, or not finite")
            rec = {"phase": "parallel", "row": row, "backend": "nccl",
                   "world_size": dist.get_world_size(),
                   "objective": res["objective"],
                   "outer_iters": res["outer_iters"],
                   "newton_iters": res["newton_iters"], "solve_s": secs,
                   "host_syncs": counters()["syncs"],
                   "max_memory_allocated": torch.cuda.max_memory_allocated()}
            for k in ("gap", "converged", "iterations"):
                if k in res:
                    rec[k] = res[k]
            return res, rec

        # dist_lp5000_barrier, dist_lp5000_pd (and the first n = 5000 H
        # of the barrier's main solve, for dist_cholesky)
        p = lp_recipe(5000)
        small = lp_recipe(200)
        args = (p["c"], p["A"], p["b"], p["C"], p["d"])
        sargs = (small["c"], small["A"], small["b"], small["C"], small["d"])
        kw = dict(lb=-3.0, ub=3.0, epsilon=1e-8)
        n = len(p["c"])
        first_H = []
        chol = dist_mod.cholesky_or_nan

        def recording(M):
            if not first_H and M.shape[0] == n:
                first_H.append(M.clone())
            return chol(M)

        dist_mod.cholesky_or_nan = recording
        try:
            rb, rec_b = run(
                "dist_lp5000_barrier",
                lambda: par.solve_lp_row_sharded(rows, *args, **kw),
                lambda: par.solve_lp_row_sharded(rows, *sargs, **kw))
        finally:
            dist_mod.cholesky_or_nan = chol
        rp, rec_p = run(
            "dist_lp5000_pd",
            lambda: par.solve_lp_row_sharded(rows, *args, **kw,
                                             algorithm="pd"),
            lambda: par.solve_lp_row_sharded(rows, *sargs, **kw,
                                             algorithm="pd"))
        # the barrier's deep stages end where no candidate lowers the
        # residual, short of centering, so its m/t is no bound on its
        # suboptimality: its certificate takes the bound the pd gives,
        # (barrier − pd) + the pd's gap
        gap_b = barrier_gap(rb, p["C"].shape[0] + 2 * n)
        bound_b = rb["objective"] - rp["objective"] + rp["gap"]
        ref, ref_gap = refs["lp5000_pd"], refs["lp5000_pd_gap"]
        for rec, res, gap, cert_gap in ((rec_b, rb, gap_b, bound_b),
                                        (rec_p, rp, rp["gap"], rp["gap"])):
            x = res["x"].cpu().numpy()
            rec.update(gap=gap, lp5000_pd=ref, lp5000_pd_gap=ref_gap,
                       abs_err_vs_lp5000_pd=abs(res["objective"] - ref),
                       certificate=kkt_certificate(SimpleNamespace(
                           xstar=x, optimality_gap=cert_gap,
                           value=res["objective"]), p))
        rel = abs(rb["objective"] - rp["objective"]) / abs(rp["objective"])
        rec_p["rel_diff_vs_barrier"] = rel
        for rec in (rec_b, rec_p):
            emit(rec)
            results[("parallel", rec["row"])] = rec
        check(rp["converged"], "dist_lp5000_pd: not converged")
        # the same off-centre end as the JAX program's: on this recipe at
        # n = 100 and 200 the port's barrier − pd difference is the JAX
        # package's (tests/test_torch_parallel.py
        # test_row_sharded_barrier_deep_end_matches_jax); 1.0675e-7 here
        # on an H100 at 700 W, held at 1.5e-7
        check(rel <= 1.5e-7,
              f"dist_lp5000: barrier and pd differ by {rel:.3g}")
        check(rec_p["abs_err_vs_lp5000_pd"] <= ref_gap + rp["gap"],
              f"dist_lp5000_pd: |objective − lp5000_pd| "
              f"{rec_p['abs_err_vs_lp5000_pd']:.3g} above the gaps "
              f"{ref_gap:.3g} + {rp['gap']:.3g}")
        check(rec_b["abs_err_vs_lp5000_pd"] <= ref_gap + bound_b,
              f"dist_lp5000_barrier: |objective − lp5000_pd| "
              f"{rec_b['abs_err_vs_lp5000_pd']:.3g} above the gaps "
              f"{ref_gap:.3g} + {bound_b:.3g}")

        # dist_qp1000_barrier
        q = qp_recipe(1000)
        qs = qp_recipe(100)
        qargs = (q["P"], q["q"], q["A"], q["b"], q["C"], q["d"])
        qsargs = (qs["P"], qs["q"], qs["A"], qs["b"], qs["C"], qs["d"])
        rq, rec = run(
            "dist_qp1000_barrier",
            lambda: par.solve_qp_row_sharded(rows, *qargs, **kw),
            lambda: par.solve_qp_row_sharded(rows, *qsargs, **kw))
        gap_q = barrier_gap(rq, q["C"].shape[0] + 2 * len(q["q"]))
        ref, ref_gap = refs["qp1000_pd"], refs["qp1000_pd_gap"]
        err = abs(rq["objective"] - ref)
        rec.update(gap=gap_q, qp1000_pd=ref, qp1000_pd_gap=ref_gap,
                   abs_err_vs_qp1000_pd=err)
        emit(rec)
        results[("parallel", rec["row"])] = rec
        check(err <= gap_q + ref_gap + 1e-8 * abs(ref),
              f"dist_qp1000_barrier: |objective − qp1000_pd| {err:.3g} "
              f"above the gaps {gap_q:.3g} + {ref_gap:.3g}")

        # dist_socp1000_barrier, dist_socp1000_pd: bench_socp(1000) with
        # F, g and P, cones sharded
        sp, sx0 = socp_recipe(1000)
        from interiorpoint_tpu_torch.utils.generators import generate_socp
        ss = generate_socp(60, rng=np.random.RandomState(1))
        ssx0 = ss.pop("x0")

        def cone_args(pp):
            return dict(A=np.stack(pp["A"]), b=np.stack(pp["b"]),
                        c=np.stack(pp["c"]), d=np.asarray(pp["d"]),
                        P_obj=pp["P"], q=pp["q"], F=pp["F"], g=pp["g"])

        outs = {}
        for algo in ("barrier", "pd"):
            row = f"dist_socp1000_{algo}"
            # the barrier from SOCP_KW's t0="auto"
            t0b, t0s = socp_auto_t0(sp, sx0), socp_auto_t0(ss, ssx0)
            res, rec = run(
                row,
                lambda: par.solve_socp_cone_sharded(
                    cones, **cone_args(sp), x0=sx0, algorithm=algo,
                    epsilon=1e-8, t0=t0b),
                lambda: par.solve_socp_cone_sharded(
                    cones, **cone_args(ss), x0=ssx0, algorithm=algo,
                    epsilon=1e-8, t0=t0s))
            gap = (res["gap"] if algo == "pd"
                   else barrier_gap(res, len(sp["A"]), t0=t0b))
            rec.update(gap=gap, certificate=socp_certificate(
                res["x"].cpu().numpy(), sp))
            outs[algo] = (res, rec, gap)
        (rb, rec_b, gb), (rp, rec_p, gp) = outs["barrier"], outs["pd"]
        ref, ref_gap = refs["socp1000_pd_full"], refs["socp1000_pd_full_gap"]
        diff_bp = abs(rb["objective"] - rp["objective"])
        for rec, res, gap in ((rec_b, rb, gb), (rec_p, rp, gp)):
            rec.update(socp1000_pd_full=ref, socp1000_pd_full_gap=ref_gap,
                       abs_err_vs_socp1000_pd_full=abs(res["objective"]
                                                       - ref),
                       abs_diff_barrier_pd=diff_bp)
            emit(rec)
            results[("parallel", rec["row"])] = rec
            check(abs(res["objective"] - ref) <= ref_gap + gap
                  + 1e-8 * abs(ref),
                  f"{rec['row']}: |objective − socp1000_pd_full| "
                  f"{abs(res['objective'] - ref):.3g} above the gaps")
        check(rp["converged"], "dist_socp1000_pd: not converged")
        check(diff_bp <= gb + gp + 1e-8 * abs(rp["objective"]),
              f"dist_socp1000: barrier and pd differ by {diff_bp:.3g}, "
              f"gaps {gb:.3g} + {gp:.3g}")

        # dist_cholesky on the barrier's first n = 5000 H
        check(bool(first_H), f"dist_lp5000_barrier: no n = {n} factor")
        H = first_H[0]
        dist_cholesky(H[:256, :256], block=64)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        L = dist_cholesky(H, block=256)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        t0 = time.perf_counter()
        Lref = torch.linalg.cholesky(H)
        torch.cuda.synchronize()
        secs_ref = time.perf_counter() - t0
        nH = float(torch.linalg.norm(H))
        be = float(torch.linalg.norm(H - L @ L.T)) / nH
        be_ref = float(torch.linalg.norm(H - Lref @ Lref.T)) / nH
        rec = {"phase": "parallel", "row": "dist_cholesky", "n": n,
               "block": 256, "backend": "nccl", "backward_error": be,
               "backward_error_torch": be_ref, "ratio_to_torch": be / be_ref,
               "seconds": secs, "seconds_torch_linalg_cholesky": secs_ref}
        emit(rec)
        results[("parallel", "dist_cholesky")] = rec
        # 4.5x on an H100 at 700 W: the block-cyclic factor's rank-256
        # trailing updates against cuSOLVER's factor
        check(be <= 8.0 * be_ref and bool(torch.isfinite(L).all()),
              f"dist_cholesky: backward error {be:.3g} above 8x "
              f"torch.linalg.cholesky's {be_ref:.3g}")
    finally:
        dist.destroy_process_group()
    return rec


# the kernels each example must launch on the card (demo: K2 in §1–§2's
# phase one and main stages, K4 in §3, K1 in §3b, K3a/K3b in the warm
# starts, the equality duals and §4's ladder; the phase-one demo: K2 on
# [G | −1]; the distributed demo: K3a/K3b in the batch's mixed KKT solves
# and the LASSO ladder; the sharded solves are plain torch)
HARNESS_KERNELS = {"demo_torch": ("K1", "K2", "K3a", "K3b", "K4"),
                   "phase_one_demo_torch": ("K2",),
                   "distributed_demo_torch": ("K3a", "K3b")}
# entry(): x', v' and resid of the step on the card against the same call
# on the CPU, relative (max-abs over max-abs), by dtype.  Read on an NVIDIA
# H100 80GB HBM3 at 700 W: float32 1.4e-4 / 4.6e-4 / 6.6e-6 (two fp32
# factorizations of H and of the Schur matrix), float64 2.4e-11 / 1.6e-11
# / 8.7e-12; about ten and twenty times those
ENTRY_TOL = {"float32": 5e-3, "float64": 5e-10}


def lasso_path_residual(la):
    """The largest LASSO optimality residual (``lasso_subgradient``, with
    a zero bias column) over the demo's λ sweep."""
    import numpy as np
    A0 = np.hstack([np.zeros((la["A"].shape[0], 1)), la["A"]])
    X = la["X"]
    return max(lasso_subgradient(A0, la["b"], lam,
                                 np.concatenate([[0.0], X[:, i]]))
               for i, lam in enumerate(la["lambdas"]))


def harness_run(name, fn):
    """Run ``fn`` with every counter set to 0 just before it; returns
    (its value, its seconds, its counter deltas, its standard output)."""
    import torch
    torch.cuda.synchronize()
    reset_counters()
    before = counters()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        val = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    d = diff(counters(), before)
    ran = {k: n for k, n in d["plain"].items() if n}
    check(not ran, f"harness {name}: plain versions ran on the card: {ran}")
    return val, secs, d, buf.getvalue()


def phase_harness(results, card):
    """The harness on the card (module docstring, phase 7): the single
    step of ``entry()`` in float32 and float64 against the same call on
    the CPU, ``dryrun_multichip(1)`` on a one-rank NCCL group, and the
    three examples' ``main()`` in this process, each held by its
    independent checks.  Returns the launches of the whole phase, by the
    keys of phase_main's."""
    import socket
    import torch
    import torch.distributed as dist
    from scipy.optimize import linprog
    from interiorpoint_tpu_torch import certify
    from interiorpoint_tpu_torch.entry import dryrun_multichip, entry

    launches = {}

    def add(d):
        for k, n in d["launches"].items():
            launches[k] = launches.get(k, 0) + n
        for e in MAIN_ENTRIES:
            launches[e] = launches.get(e, 0) + d["entries"].get(e, 0)

    # (a) the single step, float32 and a float64 copy of its arguments
    fn, args = entry()
    check(all(a.device.type == "cuda" and a.dtype == torch.float32
              for a in args), "entry(): arguments not float32 on the card")
    for dt in (torch.float32, torch.float64):
        a_dev = tuple(a.to(dt) for a in args)
        (x1, v1, r1), secs, d, _ = harness_run(
            "entry", lambda: fn(*a_dev))
        add(d)
        x0, v0, r0 = fn(*(a.cpu() for a in a_dev))
        name = str(dt).split(".")[-1]
        rec = {"phase": "harness", "run": "entry", "dtype": name,
               "seconds": secs, "resid": float(r1), "resid_cpu": float(r0),
               "x_rel_err": rel_err(x1.cpu(), x0),
               "v_rel_err": rel_err(v1.cpu(), v0),
               "resid_rel_err": rel_err(r1.cpu(), r0),
               "launches": {k: n for k, n in d["launches"].items() if n},
               "entries": {k: n for k, n in d["entries"].items() if n}}
        emit(rec)
        results[("harness", "entry", name)] = rec
        check(all(t.device.type == "cuda" and t.dtype == dt
                  and bool(torch.isfinite(t).all()) for t in (x1, v1, r1)),
              f"entry() {name}: outputs not finite {name} on the card")
        tol = ENTRY_TOL[name]
        check(max(rec["x_rel_err"], rec["v_rel_err"],
                  rec["resid_rel_err"]) <= tol,
              f"entry() {name}: card against CPU above {tol}: {rec}")

    # (b) the dry run of every parallel surface on a one-rank NCCL group
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    check(not dist.is_initialized(), "a process group is left over")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        outs, secs, d, _ = harness_run("dryrun_multichip",
                                       lambda: dryrun_multichip(1))
    finally:
        dist.destroy_process_group()
    add(d)
    rec = {"phase": "harness", "run": "dryrun_multichip(1)",
           "backend": "nccl", "seconds": secs, "surfaces": sorted(outs),
           "devices": sorted({str(v.device) for v in outs.values()})}
    emit(rec)
    check(len(outs) == 7 and rec["devices"] == ["cuda:0"],
          f"dryrun_multichip(1): {rec}")

    # (c) the three examples, in this process, on the card
    sys.path.insert(0, str(ROOT / "examples"))
    import demo_torch
    import distributed_demo_torch
    import phase_one_demo_torch

    def highs(c, A, b, C, d, lb, ub):
        h = linprog(c, A_ub=C, b_ub=d, A_eq=A, b_eq=b,
                    bounds=[(lb, ub)] * len(c), method="highs")
        check(h.status == 0, "HiGHS failed on a harness LP")
        return float(h.fun)

    def near(v, ref, tol=1e-6):
        return abs(v - ref) <= tol * max(1.0, abs(ref))

    for mod in (demo_torch, phase_one_demo_torch, distributed_demo_torch):
        name = mod.__name__
        out = {}
        rc, secs, d, text = harness_run(name, lambda: mod.main([], out))
        add(d)
        lch = {k: n for k, n in d["launches"].items() if n}
        rec = {"phase": "harness", "run": name, "seconds": secs,
               "card": card, "launches": lch,
               "entries": {k: n for k, n in d["entries"].items() if n},
               "k2": {k: n for k, n in d["k2"].items() if n},
               "output": text}
        emit(rec)
        print(json.dumps({"phase": "harness", "example": name,
                          "seconds": secs, "card": card}), flush=True)
        check(rc == 0, f"{name}: main() returned {rc}")
        missing = [k for k in HARNESS_KERNELS[name] if not lch.get(k)]
        check(not missing, f"{name}: kernels not launched: {missing}")
        chk = {}
        if name == "demo_torch":
            lp, pd = out["lp"], out["lp_pd"]
            chk["lp_highs"] = highs(*out["lp_data"], -3.0, 3.0)
            chk["lp_rel_err"] = abs(lp["value"] - chk["lp_highs"]) / abs(
                chk["lp_highs"])
            chk["pd_rel_err"] = abs(pd["value"] - chk["lp_highs"]) / abs(
                chk["lp_highs"])
            chk["pd_minus_barrier"] = pd["value"] - lp["value"]
            qp, so, la = out["qp"], out["socp"], out["lasso"]
            cert = certify(qp["solver"])
            chk.update(qp_cert_ok=bool(cert.ok(1e-6)),
                       qp_stationarity=float(cert.stationarity),
                       qp_eq_residual=qp["eq_residual"],
                       socp_cone_excess=so["cone_norm"] - 3.0,
                       socp_sum_residual=abs(so["sum_x"] - 1.0),
                       lasso_nnz=[la["nnz"][0], la["nnz"][-1]],
                       lasso_subgradient=lasso_path_residual(la))
            emit({"phase": "harness", "run": name, "checks": chk})
            check(near(lp["value"], chk["lp_highs"])
                  and abs(lp["value"] - chk["lp_highs"])
                  <= lp["gap"] + 1e-9 * abs(chk["lp_highs"]),
                  f"demo LP against HiGHS: {chk}")
            check(near(pd["value"], chk["lp_highs"]),
                  f"demo LP pd against HiGHS: {chk}")
            check(abs(chk["pd_minus_barrier"]) <= lp["gap"] + pd["gap"],
                  f"demo LP pd and barrier beyond their gaps: {chk}")
            check(lp["cert_ok"] and chk["qp_cert_ok"]
                  and chk["qp_eq_residual"] <= 1e-6,
                  f"demo certificates: {out['lp']}, {chk}")
            check(chk["socp_cone_excess"] <= 1e-6
                  and chk["socp_sum_residual"] <= 1e-6,
                  f"demo SOCP residuals: {chk}")
            check(chk["lasso_nnz"][0] > chk["lasso_nnz"][1]
                  and chk["lasso_subgradient"] <= 1e-5,
                  f"demo LASSO path: {chk}")
        elif name == "phase_one_demo_torch":
            s = [out[k]["s"] for k in ("triangle", "empty", "random",
                                       "bounded")]
            chk.update(s=s, random_max_viol=out["random"]["max_viol"],
                       bounded_max_viol=out["bounded"]["max_viol"],
                       bounded_x_absmax=out["bounded"]["x_absmax"])
            emit({"phase": "harness", "run": name, "checks": chk})
            check(s[0] < 0 and s[1] > 0 and s[2] < 0 and s[3] < 0,
                  f"phase-one demo: the signs of s {s}")
            check(chk["random_max_viol"] < 0 and chk["bounded_max_viol"] < 0
                  and chk["bounded_x_absmax"] < 3.0,
                  f"phase-one demo: points not strictly feasible: {chk}")
        else:
            b, r, rp, rs = (out["batch"], out["rows"], out["rows_pd"],
                            out["resume"])
            cn, cp = out["cones"], out["cones_pd"]
            chk.update(
                batch_abs_err=b["max_abs_err"],
                rows_rel_err=abs(r["value"] - r["highs"]) / abs(r["highs"]),
                rows_pd_rel_err=abs(rp["value"] - rp["highs"])
                / abs(rp["highs"]),
                resume_rel_err=abs(rs["value"] - rs["highs"])
                / abs(rs["highs"]),
                cone_worst=cn["worst_cone"], cone_eq=cn["eq_residual"],
                cone_pd_minus_barrier=cp["value"] - cn["value"])
            emit({"phase": "harness", "run": name, "checks": chk})
            check(all(near(v, h) for v, h in zip(b["values"], b["highs"])),
                  f"distributed demo batch against HiGHS: {b}")
            check(near(r["value"], r["highs"]) and near(rp["value"],
                                                       rp["highs"])
                  and near(rs["value"], rs["highs"]),
                  f"distributed demo rows against HiGHS: {chk}")
            check(rs["stages_first"] == 3
                  and rs["stages_total"] == rs["uninterrupted_stages"],
                  f"distributed demo resume: {rs}")
            check(cn["worst_cone"] <= 1e-6 and cn["eq_residual"] <= 1e-6
                  and near(cp["value"], cn["value"]),
                  f"distributed demo cones: {chk}")
        results[("harness", name)] = dict(rec, checks=chk)

    # (d) the kernels at the examples' shapes: each example once more,
    # untimed, with every K3a factor of the mixed KKT solves and the first
    # K1, K2, K4 step and K3b solve at each shape recorded, then each held
    # against its plain version on those inputs
    for mod in (demo_torch, phase_one_demo_torch, distributed_demo_torch):
        name = mod.__name__
        store = {"K3a": [], "K3b": {}, "K1": {}, "K2": {}, "K4": {}}
        with harness_recording(store), \
                contextlib.redirect_stdout(io.StringIO()):
            check(mod.main([], {}) == 0, f"{name}: main() failed when "
                  "recorded")
        harness_kernel_checks(name, store, results)
    return launches


# K3a at the mixed KKT solves' factors: the CUDA factor and the plain one
# (on the card: cuSOLVER) on the same input, the same flag, and where both
# pass a backward error at most 4x the plain one's + 1e-6, as phase_k3
# holds it.  At the distributed demo's batch LP both pass with a pivot at
# rounding level (κ(Hs)·u32 ≈ 2) and the refinement diverges from either;
# the mixed solve then takes its fp64 factor, also when the residual is no
# longer finite (ops/kkt.py)
K3A_BACKWARD_FACTOR = 4.0


def k3a_pivot2_ratio(H, jitter):
    """How far H + jitter·I (fp32, lower triangle read) is from singular:
    the smallest pivot² of its fp64 factor over its largest diagonal
    entry (0 where the fp64 factor fails).  Recorded beside each mixed
    solve's factor that K3a and the plain factor flag apart."""
    import torch
    n = H.shape[0]
    Hd = torch.tril(H.double())
    Hd = Hd + torch.tril(Hd, -1).T + jitter * torch.eye(
        n, dtype=torch.float64, device=H.device)
    scale = float(torch.diagonal(Hd).max())
    L, info = torch.linalg.cholesky_ex(Hd)
    return (float(torch.diagonal(L).min()) ** 2 / scale if int(info) == 0
            else 0.0)


# the seeds of the symmetric permutations P H Pᵀ under which the plain
# factor runs again on a mixed solve's matrix that it and K3a flag apart
# (``k3a_flag_spread``)
K3A_FLAG_PERMS = tuple(range(8))


def k3a_flag_spread(H, jitter):
    """The plain factor's flags on H + jitter·I (fp32, lower triangle
    read) under the symmetric permutations of ``K3A_FLAG_PERMS``.  On a
    matrix at the fp32 floor whether the last pivots come out positive
    depends on the order of the sums, and the plain factor's own decision
    moves with the order of the rows; on a matrix that a backward-stable
    fp32 factor must accept, it does not."""
    import numpy as np
    import torch
    from interiorpoint_tpu_torch.ops import chol
    n = H.shape[0]
    Hs = torch.tril(H) + torch.tril(H, -1).T
    flags = []
    for seed in K3A_FLAG_PERMS:
        p = torch.as_tensor(np.random.default_rng(seed).permutation(n),
                            device=H.device)
        Hp = Hs[p][:, p].contiguous()
        flags.append(int(chol.factor_plain(
            Hp, n, chol.padded(n, chol.PLAIN_BLK), jitter)[2]))
    return flags


# the fixed number of K2 steps driven along the route where H = CᵀWC is
# singular (r > k: the phase-one demo's 200 × 1000 system, [G | −1] 200 ×
# 1001, rank ≤ 200, and a phase-one cost outside its row space, so no
# Newton system there has a solution); the solve itself stops after 2
# (s < 0).  Each step's direction and x' are held against the plain
# step's on the same state within K2_SINGULAR_FACTOR times what a change
# of the fp32 Gram's summation order alone moves the plain step (its
# rows permuted, the largest of two permutations), as the direction there
# is mostly the jittered factor's null-space part
K2_SINGULAR_STEPS = 4
K2_SINGULAR_FACTOR = 4.0


@contextlib.contextmanager
def harness_recording(store):
    """While the examples run, record into ``store``: every fp32 factor
    of the mixed KKT solves (ops/kkt.py: input, jitter, factor, flag),
    the first K3b solve at each (n, p), and the first K1, K2 and K4 step
    at each shape (its inputs and the solve's config, read from the
    engine's frame).  Restores the wrappers on exit."""
    from interiorpoint_tpu_torch.ops import kkt as kkt_mod
    from interiorpoint_tpu_torch.ops import newton as newton_mod
    from interiorpoint_tpu_torch.ops import pd as pd_mod
    k3a, k3b = kkt_mod.cholesky_blocked, kkt_mod.cholesky_solve_blocked
    k2, k4, k1 = (newton_mod.newton_step, newton_mod.socp_newton_step,
                  pd_mod.pd_step)

    def k3a_rec(H, jitter=0.0):
        L, D, bad = k3a(H, jitter)
        store["K3a"].append((H.clone(), jitter, L, bad))
        return L, D, bad

    def k3b_rec(L, Dinv, B):
        X = k3b(L, Dinv, B)
        key = (B.shape[0], 1 if B.ndim == 1 else B.shape[1])
        store["K3b"].setdefault(key, (L, Dinv, B.clone(), X))
        return X

    def newton_rec(kernel, fn):
        def rec(cs, tc, z, tP, sig, **kw):
            key = (tuple(cs.A.shape) if kernel == "K4" else (cs.k, cs.r),
                   tP is not None)
            if key not in store[kernel]:
                store[kernel][key] = (cs, tc.clone(), z.clone(), tP,
                                      sys._getframe(1).f_locals["cfg"])
            return fn(cs, tc, z, tP, sig, **kw)
        return rec

    def k1_rec(cs, q, z, s, lam, **kw):
        key = (cs.k, cs.r, cs.P is not None)
        if key not in store["K1"]:
            store["K1"][key] = (cs, q.clone(), z.clone(), s.clone(),
                                lam.clone(), kw["dir_tol"])
        return k1(cs, q, z, s, lam, **kw)

    kkt_mod.cholesky_blocked, kkt_mod.cholesky_solve_blocked = (k3a_rec,
                                                                k3b_rec)
    newton_mod.newton_step = newton_rec("K2", k2)
    newton_mod.socp_newton_step = newton_rec("K4", k4)
    pd_mod.pd_step = k1_rec
    try:
        yield store
    finally:
        kkt_mod.cholesky_blocked, kkt_mod.cholesky_solve_blocked = k3a, k3b
        newton_mod.newton_step, newton_mod.socp_newton_step = k2, k4
        pd_mod.pd_step = k1


def harness_kernel_checks(name, store, results):
    """Hold what ``harness_recording`` recorded against the plain
    versions: every K3a factor (``K3A_BACKWARD_FACTOR``), the first K3b
    solve at each (n, p) by its backward error on the factor's own L Lᵀ
    (as ``phase_k3b_widest``), the first K1, K2 and K4 step at each shape
    (``k1_check``, ``k2_check``, ``k4_check``) and, where K2's H is
    singular, ``k2_singular_drive``."""
    import torch
    from interiorpoint_tpu_torch.ops import chol

    splits = {}
    for H, jitter, L, bad in store["K3a"]:
        n = H.shape[0]
        Lp, _, bad_p = chol.factor_plain(H, n, chol.padded(n, chol.PLAIN_BLK),
                                         jitter)
        key = f"{int(bad)}{int(bad_p)}"
        rec = splits.setdefault(key, {"n": 0, "worst_backward": None})
        rec["n"] += 1
        if key in ("01", "10"):
            # flags apart: held by the plain factor's own spread under row
            # orders, [n, jitter, pivot² ratio, the plain flags of the
            # permuted copies]
            rec.setdefault("apart", []).append(
                [n, jitter, k3a_pivot2_ratio(H, jitter),
                 k3a_flag_spread(H, jitter)])
        if key == "00":
            Hj = H.double() + jitter * torch.eye(n, dtype=torch.float64,
                                                 device=H.device)
            scale = float(Hj.abs().max())
            be = [float((F.double() @ F.double().T - Hj).abs().max())
                  / scale for F in (L, Lp[:n, :n])]
            w = rec["worst_backward"]
            f = K3A_BACKWARD_FACTOR
            if w is None or be[0] - f * be[1] > w[0] - f * w[1]:
                rec["worst_backward"] = be + [n, jitter,
                                              float(torch.diagonal(L).min())]
    k3b_recs = []
    for (n, p), (L, Dinv, B, X) in sorted(store["K3b"].items()):
        Lt = torch.tril(L.double())
        Xp = chol.cholesky_solve_blocked_plain(L, Dinv, B)
        be = [k3b_backward(Lt @ Lt.T, Y, B) for Y in (X, Xp)]
        k3b_recs.append({"n": n, "p": p, "backward": be})
        check(be[0] <= 4.0 * be[1] + 1e-7,
              f"{name}: K3b at (n, p) = ({n}, {p}): backward error "
              f"{be[0]:.3g} against the plain version's {be[1]:.3g}")
    rec = {"phase": "harness", "run": name, "kernel_checks": {
        "K3a_factors": splits, "K3b": k3b_recs,
        "K1": sorted(store["K1"]), "K2": sorted(store["K2"]),
        "K4": sorted(store["K4"])}}
    emit(rec)
    check(all(int(key[0]) in a[3] for key in ("01", "10")
              for a in splits.get(key, {}).get("apart", [])),
          f"{name}: K3a flags a mixed solve's factor apart from the plain "
          f"factor, which takes the same decision under none of "
          f"{len(K3A_FLAG_PERMS)} row orders: {splits}")
    w = splits.get("00", {}).get("worst_backward")
    check(w is None or w[0] <= K3A_BACKWARD_FACTOR * w[1] + 1e-6,
          f"{name}: a mixed solve's K3a factor has backward error {w} "
          f"against the plain version's")
    for (k, r, qp), (cs, q, z, s, lam, dtol) in store["K1"].items():
        row = f"{name} {k}x{r}{' + P' if qp else ''}"
        results[("harness", "K1", row)] = k1_check(row, cs, q, z, s, lam,
                                                   dtol, ladder=True)
    for ((k, r), qp), (cs, tc, z, tP, cfg) in store["K2"].items():
        row = f"{name} {k}x{r}{' + P' if qp else ''}"
        if r > k:
            results[("harness", "K2", row)] = k2_singular_drive(
                row, cs, tc, z, tP, cfg)
        else:
            results[("harness", "K2", row)] = k2_check(row, "first", cs, tc,
                                                      z, tP, cfg)
    for (shape, qp), (cs, tq, z, tP, cfg) in store["K4"].items():
        row = f"{name} {shape[0]}x{shape[1]}{' + P' if qp else ''}"
        results[("harness", "K4", row)] = k4_check(row, "first", cs, tq, z,
                                                  tP, cfg)
    results[("harness", "kernel_checks", name)] = rec


def k2_singular_drive(row, cs, tc, z, tP, cfg):
    """K2 where H = CᵀWC is singular (r > k): the preconditioner on the
    first state's shared inputs (``k2_preconditioner``: the same LDL
    flags, the same Cholesky fallback rungs, ‖I − WᵀW·Hs‖_F within 1.25x
    the plain one's), then ``K2_SINGULAR_STEPS`` steps along the CUDA
    route, each held against the plain step on the same state: the same
    candidate, and dx and x' within ``K2_SINGULAR_FACTOR`` times the plain
    step's own change under row permutations of C."""
    from interiorpoint_tpu_torch.ops import newton_step as ns
    from interiorpoint_tpu_torch.ops.newton import sigmas
    from interiorpoint_tpu_torch.ops.pd import dir_stall_tol
    from interiorpoint_tpu_torch.ops.pd_step import _Plain

    sig = sigmas(cfg, device=cs.C.device)
    dtol = dir_stall_tol(cfg.epsilon)
    kw = dict(alpha=cfg.alpha, refine=cfg.pallas_refine, dir_tol=dtol)
    dkw = dict(refine=cfg.pallas_refine, dir_tol=dtol)
    perms = [q for _, q in permuted_consts(cs, (1, 2))]
    err, tol, info = {}, {}, {}
    w0 = ns._Plain.nt_pass1(cs.C, z, cs.d)[2]
    x1 = ns.newton_step_plain(cs, tc, z, tP, sig, **kw)[0]
    w1 = ns._Plain.nt_pass1(cs.C, x1, cs.d)[2]
    k2_preconditioner(f"K2 {row}", _Plain.gram(cs.C32, w0, None),
                      _Plain.gram(cs.C32, w1, None), err, tol, info, {})
    steps = []
    for i in range(K2_SINGULAR_STEPS):
        dx_c = ns.newton_dir(cs, tc, z, tP, **dkw)[0]
        dx_p = ns.newton_dir_plain(cs, tc, z, tP, **dkw)[0]
        x_c, st_c = ns.newton_step(cs, tc, z, tP, sig, **kw)
        x_p, st_p = ns.newton_step_plain(cs, tc, z, tP, sig, **kw)
        spread_dx = max(rel_err(ns.newton_dir_plain(q, tc, z, tP, **dkw)[0],
                                dx_p) for q in perms)
        spread_x = max(rel_err(ns.newton_step_plain(q, tc, z, tP, sig,
                                                    **kw)[0], x_p)
                       for q in perms)
        st_c, st_p = st_c.tolist(), st_p.tolist()
        step = {"step": i, "dx_rel_err": rel_err(dx_c, dx_p),
                "dx_spread": spread_dx, "x_rel_err": rel_err(x_c, x_p),
                "x_spread": spread_x,
                "index": [st_c[ns.ST_INDEX], st_p[ns.ST_INDEX]],
                "nd": [st_c[ns.ST_ND], st_p[ns.ST_ND]],
                "dir_ok": [st_c[ns.ST_DIR_OK], st_p[ns.ST_DIR_OK]],
                "s": [float(x_c[-1]), float(x_p[-1])]}
        steps.append(step)
        err[f"step{i}.dx"] = step["dx_rel_err"]
        tol[f"step{i}.dx"] = K2_SINGULAR_FACTOR * spread_dx
        err[f"step{i}.x_new"] = step["x_rel_err"]
        tol[f"step{i}.x_new"] = K2_SINGULAR_FACTOR * spread_x
        check(st_c[ns.ST_INDEX] == st_p[ns.ST_INDEX]
              and st_c[ns.ST_ANY] == st_p[ns.ST_ANY],
              f"K2 {row}: step {i}: candidate {step['index']} (CUDA, "
              f"plain)")
        z = x_c.contiguous()
    bad = {p: (err[p], tol[p]) for p in err if not err[p] <= tol[p]}
    rec = {"phase": "kernel", "kernel": "K2", "row": row,
           "state": "singular drive", "shape": [cs.k, cs.r],
           "steps": steps, "pieces_err": err, "pieces_tol": tol,
           "pieces_info": info}
    emit(rec)
    check(not bad, f"K2 {row}: off against plain along the route: {bad}")
    return rec


def main(argv):
    if not (ROOT / "interiorpoint_tpu_torch" / "csrc").is_dir():
        fail("run from a checkout of the repository (no "
             "interiorpoint_tpu_torch/csrc beside this script)")
    sys.path.insert(0, str(ROOT))
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    card = phase_device()
    phase_build()
    if argv[:1] == ["--profile"]:
        rows = argv[1:] or ["lp1000_barrier", "lp5000_barrier"]
        for row in rows:
            check(row in ROWS + BARRIER_ROWS + SOCP_ROWS + K5_ROWS
                  + LASSO_ROWS,
                  f"unknown row {row!r}")
        phase_profile(rows)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    check(not argv, f"unknown arguments {argv}")
    results = {}
    phase_k3(results)
    phase_k3b_wide(results)
    phase_column_solve(results)
    phase_gram(results)
    phase_k2_synthetic(results)
    phase_h_apply_wide(results)
    phase_k1(results)
    launches, k3b_shapes = phase_main(results)
    par_launches = phase_parallel(results)
    for k, n in par_launches.items():
        launches[k] = launches.get(k, 0) + n
    phase_utils()
    harness_launches = phase_harness(results, card)
    for k, n in harness_launches.items():
        launches[k] = launches.get(k, 0) + n
    phase_k3b_widest(results, k3b_shapes)
    results[("k3b_shapes",)] = k3b_shapes
    kern = summary(results, launches)
    # the batch rows' and the harness's shares of each kernel's launches,
    # listed apart
    for entry in kern["kernels"]:
        key = PAR_ENTRY_KEYS.get(entry["name"])
        if key is not None:
            # (a counter, and those of its launches listed on another line)
            key, *minus = key if isinstance(key, tuple) else (key,)
            for field, cnt in (("launches_parallel", par_launches),
                               ("launches_harness", harness_launches)):
                entry[field] = cnt.get(key, 0) - sum(cnt.get(m, 0)
                                                     for m in minus)
    print(card, flush=True)
    print(json.dumps(kern), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
