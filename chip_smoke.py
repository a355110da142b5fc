#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (interiorpoint_tpu_torch) on one NVIDIA
H100 and check it.

    python3 chip_smoke.py            # needs one GPU and nvcc

Phases, in order; any failure raises and exits non-zero:

1. Device: a CUDA device of capability (9, 0); prints its name and power
   limit as nvidia-smi gives them.
2. Build: compiles csrc/*.cu with nvcc for sm_90a (kernels/_build.py).
3. Kernel against plain version on the card, from seeded numpy inputs:
   the blocked Cholesky factor (K3a) and solve (K3b) at n = 200, 800,
   1000, 1100 (the main path's warm-start and dual-recovery sizes, none a
   multiple of the 64-wide block), and, at the three main-path row shapes
   from each row's own first state, every piece of the primal-dual step
   (K1: the fp64 passes over C, the fp32 Gram, equilibration, factor,
   inverse and W-solve) on shared inputs, then one whole step; CUDA
   kernels against their plain PyTorch versions on the same GPU.  The
   whole step must also take as many host-read rounds (jitter rungs,
   refinement and PCG rounds) as its plain version at the main path's
   own direction gate, so that a worse preconditioner fails even where
   the fp64 refinement would pull its answer back.
   Times are CUDA-event medians of 7 runs after a warm-up.
4. Main path: the three benchmark recipes (lp1000_auto, qp1000_pd,
   lp5000_pd) through LPSolver/QPSolver on device="cuda".  Every kernel
   counter is zeroed first and read after: each kernel must have launched
   and no plain version may have run.  Each solution is cross-checked
   (HiGHS for the LP at n=1000, the port's own CPU solve for the QP, an
   fp64 KKT certificate for the LP at n=5000).

Output: one JSON line per kernel comparison and per recipe, then the
card line as nvidia-smi prints it, the kernel summary
``{"kernels": [...]}`` and, last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
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


def lp_recipe(n):
    """bench.py bench_lp: the reference LP recipe, seed 1."""
    import numpy as np
    m, k = int(0.8 * n), int(0.2 * n)
    np.random.seed(1)
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


def make_solver(row: str, device: str):
    from interiorpoint_tpu_torch import LPSolver, QPSolver
    if row == "lp1000_auto":
        return LPSolver(**lp_recipe(1000), **LP_KW, algorithm="auto",
                        get_dual_variables=True, device=device)
    if row == "qp1000_pd":
        return QPSolver(**qp_recipe(1000), **QP_KW, algorithm="pd",
                        device=device)
    if row == "lp5000_pd":
        return LPSolver(**lp_recipe(5000), **LP_KW, algorithm="pd",
                        device=device)
    raise KeyError(row)


ROWS = ("lp1000_auto", "qp1000_pd", "lp5000_pd")
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


def phase_k3(results):
    import numpy as np
    import torch
    from interiorpoint_tpu_torch.ops import chol

    for n in (200, 800, 1000, 1100):
        rng = np.random.default_rng(n)
        M = rng.standard_normal((n, n))
        H = torch.as_tensor(M @ M.T / n + np.eye(n), dtype=torch.float32,
                            device="cuda")
        B = torch.as_tensor(rng.standard_normal((n,)), dtype=torch.float32,
                            device="cuda")
        L, D, bad = chol.cholesky_blocked(H)
        Lp, Dp, badp = chol.cholesky_blocked_plain(H)
        X = chol.cholesky_solve_blocked(L, D, B)
        Xp = chol.cholesky_solve_blocked_plain(Lp, Dp, B)
        torch.cuda.synchronize()
        check(int(bad) == 0 and int(badp) == 0, f"K3a n={n}: factor failed")
        eL, eX = rel_err(L, Lp), rel_err(X, Xp)
        t_fac = time_ms(lambda: chol.cholesky_blocked(H))
        t_fac_p = time_ms(lambda: chol.cholesky_blocked_plain(H))
        t_sol = time_ms(lambda: chol.cholesky_solve_blocked(L, D, B))
        t_sol_p = time_ms(lambda: chol.cholesky_solve_blocked_plain(
            Lp, Dp, B))
        rec = {"phase": "kernel", "kernel": "K3", "n": n,
               "factor_rel_err": eL, "solve_rel_err": eX,
               "factor_abs_err": abs_err(L, Lp),
               "solve_abs_err": abs_err(X, Xp),
               "factor_ms": t_fac, "factor_plain_ms": t_fac_p,
               "solve_ms": t_sol, "solve_plain_ms": t_sol_p}
        emit(rec)
        check(eL <= 1e-5, f"K3a n={n}: L rel err {eL:.3g} > 1e-5")
        check(eX <= 1e-4, f"K3b n={n}: X rel err {eX:.3g} > 1e-4")
        results[("K3", n)] = rec


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


def k1_pieces(row, cs, z, s, lam):
    """Every CUDA piece of the step against its plain version on the same
    inputs (this row's own first state).  Returns {piece: err},
    {piece: tolerance} and {name: value} of what is reported, not held."""
    import numpy as np
    import torch
    from interiorpoint_tpu_torch.ops.pd_step import _Cuda, _Plain

    C, k, r = cs.C, cs.k, cs.r
    rng = np.random.default_rng(k + r)
    dev = dict(dtype=torch.float64, device=C.device)
    x = torch.as_tensor(rng.standard_normal(r), **dev)
    dz = torch.as_tensor(rng.standard_normal(r), **dev) * 1e-2 * (
        1.0 + float(z.abs().max()))
    err, tol, info = {}, {}, {}

    def cmp(name, a, b, t, floor=0.0):
        a, b = a.double(), b.double()
        den = max(float(b.abs().max()), floor, 1e-300)
        # equal entries (the step ratios may both be +inf) differ by 0
        diff = torch.where(a == b, torch.zeros_like(a), a - b)
        err[name] = float(diff.abs().max()) / den
        tol[name] = t

    # fp64 passes over C; ‖rp‖ of the exactly feasible warm start is
    # rounding noise, so rp is held relative to 1 + ‖d‖∞
    d_floor = 1.0 + float(cs.d.abs().max())
    oc, op = _Cuda.pass1(C, z, s, lam, cs.d), _Plain.pass1(C, z, s, lam, cs.d)
    for name, a, b, fl in zip(("rp", "inv_s", "w", "gap", "rp_inf"), oc, op,
                              (d_floor, 0, 0, 0, d_floor)):
        cmp("pass1." + name, a, b, PIECE_TOL64, fl)
    rp, inv_s, w = op[:3]
    cmp("ct_matvec", _Cuda.ct_matvec(C, lam), _Plain.ct_matvec(C, lam),
        PIECE_TOL64)
    cmp("c_matvec_w", _Cuda.c_matvec(C, x, w), _Plain.c_matvec(C, x, w),
        PIECE_TOL64)
    if cs.P is not None:
        cmp("p_matvec", _Cuda.p_matvec(cs.P, x), _Plain.p_matvec(cs.P, x),
            PIECE_TOL64)
    sig_mu = (s @ lam) / k * 0.1
    rc, t = _Plain.rhs(s, lam, rp, inv_s, None, None, sig_mu, False)
    for name, a, b in zip(("rc", "t"), _Cuda.rhs(s, lam, rp, inv_s, s, s,
                                                  sig_mu, False), (rc, t)):
        cmp("rhs." + name, a, b, PIECE_TOL64)
    dc = _Cuda.ds_pass(C, dz, rp, rc, lam, s, inv_s)
    dp = _Plain.ds_pass(C, dz, rp, rc, lam, s, inv_s)
    for name, a, b in zip(("ds", "dl", "ap", "ad"), dc, dp):
        cmp("ds_pass." + name, a, b, PIECE_TOL64)
    for name, a, b in zip(
            ("rc", "t"),
            _Cuda.rhs(s, lam, rp, inv_s, dp[0], dp[1], sig_mu, True),
            _Plain.rhs(s, lam, rp, inv_s, dp[0], dp[1], sig_mu, True)):
        cmp("rhs_corrector." + name, a, b, PIECE_TOL64)
    ap = torch.clamp(0.99995 * dp[2], max=1.0)
    ad = torch.clamp(0.99995 * dp[3], max=1.0)
    for name, a, b in zip(("s", "lam", "gap"),
                          _Cuda.update(s, lam, dp[0], dp[1], ap, ad),
                          _Plain.update(s, lam, dp[0], dp[1], ap, ad)):
        cmp("update." + name, a, b, PIECE_TOL64)

    # fp32 preconditioner, each piece on the plain version's input.  The
    # Gram, the factor and the inverse are held by their own accuracy
    # against the plain version's: the Gram against the fp64 product of
    # the same fp32 inputs, the factor and the inverse by their backward
    # errors ‖LLᵀ−Hs‖ and ‖WL−I‖, which the conditioning of Hs does not
    # inflate (it does inflate the forward difference of L, reported in
    # `info` and not held).
    Hp = _Plain.gram(cs.C32, w, cs.P32)
    Hc = _Cuda.gram(cs.C32, w, cs.P32)
    C64 = cs.C32.double()
    H64 = (C64 * w.float().double()[:, None]).T @ C64
    if cs.P32 is not None:
        H64 = H64 + cs.P32.double()
    del C64
    cmp("gram", Hc, Hp, GRAM_TOL)
    own = {}
    for name, H in (("cuda", Hc), ("plain", Hp)):
        own[name] = float((H.double() - H64).abs().max()) / float(
            H64.abs().max())
    err["gram.vs_fp64"], tol["gram.vs_fp64"] = own["cuda"], (
        4.0 * own["plain"] + 1e-6)
    info["gram.vs_fp64_plain"] = own["plain"]
    Hs_c, dsc_c = _Cuda.equilibrate(Hp)
    Hs, dsc = _Plain.equilibrate(Hp)
    cmp("equilibrate.Hs", Hs_c[:r, :r], Hs[:r, :r], PIECE_TOL32)
    cmp("equilibrate.dsc", dsc_c[:r], dsc[:r], PIECE_TOL32)
    Hs = Hs_c     # the CUDA padding from here on (identity either way)
    for delta in (0.0, 1e-6, 3e-3, 1.0):
        Lc, Dc, bad_c = _Cuda.factor(Hs, delta)
        Lp, _, bad_p = _Plain.factor(Hs, delta)
        check(int(bad_c) == int(bad_p),
              f"K1 {row}: factor flags differ at jitter {delta}")
        if int(bad_p) == 0:
            break
    Lf = Lp.double()
    info["factor.L_vs_plain"] = float((Lc.double() - Lf).abs().max()) / float(
        Lf.abs().max())
    eye = torch.eye(Hs.shape[0], dtype=torch.float64, device=C.device)
    Hs_j = Hs.double() + delta * eye

    def back_factor(L):
        L = L.double()
        return float((L @ L.T - Hs_j).abs().max()) / float(
            Hs_j.abs().max())

    err["factor.backward"] = back_factor(Lc)
    tol["factor.backward"] = 4.0 * back_factor(Lp) + 1e-6
    Wc, Wp = _Cuda.invert(Lc, Dc), _Plain.invert(Lc, Dc).contiguous()
    cmp("invert.W", Wc, Wp, PIECE_TOL32)

    def back_invert(W):
        return float((W.double() @ Lc.double() - eye).abs().max())

    err["invert.backward"] = back_invert(Wc)
    tol["invert.backward"] = 4.0 * back_invert(Wp) + 1e-6
    b = torch.as_tensor(rng.standard_normal(r), dtype=torch.float32,
                        device=C.device)
    cmp("w_solve", _Cuda.w_solve(Wp, b), _Plain.w_solve(Wp, b), PIECE_TOL32)
    torch.cuda.synchronize()
    return err, tol, info


def step_rounds(fn, *args, **kw):
    """Host reads (jitter rungs, refinement and PCG rounds) of one step."""
    from interiorpoint_tpu_torch.ops import sync
    c0 = sync.count
    out = fn(*args, **kw)
    return out, sync.count - c0


def phase_k1(results):
    import torch
    from interiorpoint_tpu_torch.ops.pd_step import pd_step, pd_step_plain

    for row in ROWS:
        cs, q, z, s, lam, dtol = k1_inputs(row)
        perr, ptol, pinfo = k1_pieces(row, cs, z, s, lam)
        bad = {p: (perr[p], ptol[p]) for p in perr if not perr[p] <= ptol[p]}
        # the whole step at the main path's own gate: same rounds, and the
        # corrector residual srn2 of the same grade
        (_, _, _, st_c), n_c = step_rounds(pd_step, cs, q, z, s, lam,
                                           dir_tol=dtol)
        (_, _, _, st_p), n_p = step_rounds(pd_step_plain, cs, q, z, s, lam,
                                           dir_tol=dtol)
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
        rec = {"phase": "kernel", "kernel": "K1", "row": row,
               "shape": list(cs.C.shape), "qp": cs.P is not None,
               "dir_tol_compared": K1_COMPARE_TOL, "dir_tol_timed": dtol,
               "z_rel_err": errs[0], "s_rel_err": errs[1],
               "lam_rel_err": errs[2], "stats_rel_err": st_err,
               "stats": st, "stats_plain": stp,
               "pieces_err": perr, "pieces_tol": ptol,
               "pieces_info": pinfo,
               "host_reads_at_dir_tol": [n_c, n_p],
               "srn2_over_sbn2_at_dir_tol": srn2,
               "max_abs_err": max(abs_err(a, b)
                                  for a, b in zip(out[:3], ref[:3])),
               "ms": t, "plain_ms": tp}
        emit(rec)
        check(not bad, f"K1 {row}: pieces off against plain: {bad}")
        check(n_c == n_p, f"K1 {row}: {n_c} host-read rounds against the "
              f"plain version's {n_p} at dir_tol {dtol:.3g}")
        check(srn2[0] <= max(dtol ** 2, srn2[1]),
              f"K1 {row}: corrector residual {srn2} at dir_tol {dtol:.3g}")
        check(max(errs) <= 1e-5, f"K1 {row}: state rel err {errs}")
        check(st_err <= 1e-5, f"K1 {row}: stats rel err {st_err:.3g}")
        results[("K1", row)] = rec


def kkt_certificate(solver, p):
    """fp64 KKT certificate of an LP solution (bounds ±3)."""
    import numpy as np
    x = solver.xstar
    A, b, C, d, c = p["A"], p["b"], p["C"], p["d"], p["c"]
    scale = 1.0 + max(np.abs(b).max(), np.abs(d).max(), 3.0)
    eq = float(np.abs(A @ x - b).max())
    bnd = float(max(0.0, (x - 3.0).max(), (-3.0 - x).max()))
    row = float(max(0.0, (C @ x - d).max()))
    gap = float(solver.optimality_gap)
    out = {"eq_inf": eq, "bound_viol": bnd, "row_viol": row, "gap": gap,
           "scale": scale}
    for key in ("eq_inf", "bound_viol", "row_viol"):
        check(out[key] <= 1e-6 * scale, f"lp5000 certificate {key}: {out}")
    check(gap <= 1e-6 * (1.0 + abs(solver.value)),
          f"lp5000 certificate gap: {out}")
    return out


def counters():
    from interiorpoint_tpu_torch.ops import chol, pd_step, sync
    from interiorpoint_tpu_torch.kernels import _build
    return {
        "launches": {"K1": pd_step.pd_step.launches,
                     "K3a": chol.cholesky_blocked.launches,
                     "K3b": chol.cholesky_solve_blocked.launches},
        "plain": {"K1": pd_step.pd_step_plain.calls,
                  "K3a": chol.cholesky_blocked_plain.calls,
                  "K3b": chol.cholesky_solve_blocked_plain.calls},
        "entries": dict(_build.LAUNCHES),
        "syncs": sync.count,
    }


def reset_counters():
    from interiorpoint_tpu_torch.ops import chol, pd_step, sync
    from interiorpoint_tpu_torch.kernels import _build
    pd_step.pd_step.launches = 0
    chol.cholesky_blocked.launches = 0
    chol.cholesky_solve_blocked.launches = 0
    pd_step.pd_step_plain.calls = 0
    chol.cholesky_blocked_plain.calls = 0
    chol.cholesky_solve_blocked_plain.calls = 0
    _build.reset_launches()
    sync.count = 0


def diff(after, before):
    return {g: {k: after[g].get(k, 0) - before[g].get(k, 0)
                for k in after[g]}
            for g in ("launches", "plain", "entries")}


def phase_main(results):
    import numpy as np
    import torch
    from scipy.optimize import linprog

    # references that are not the main path (the QP's CPU solve runs the
    # plain versions, so it comes before the counters are zeroed)
    p = lp_recipe(1000)
    ref_lp = linprog(p["c"], A_ub=p["C"], b_ub=p["d"], A_eq=p["A"],
                     b_eq=p["b"], bounds=[(-3, 3)] * 1000, method="highs")
    check(ref_lp.status == 0, "HiGHS failed on lp1000")
    cpu_qp = make_solver("qp1000_pd", "cpu")
    cpu_qp_val = cpu_qp.solve()

    reset_counters()
    total_before = counters()
    for row in ROWS:
        before = counters()
        t0 = time.perf_counter()
        solver = make_solver(row, "cuda")
        val = solver.solve()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        first = diff(counters(), before)
        check(bool(solver.last_metrics["converged"]), f"{row}: not converged")
        for kname, cnt in first["launches"].items():
            check(cnt > 0, f"{row}: kernel {kname} never launched")
        for kname, cnt in first["plain"].items():
            check(cnt == 0, f"{row}: plain version of {kname} ran")
        times, syncs = [], []
        for _ in range(3):
            s0 = counters()["syncs"]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            solver.solve()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            syncs.append(counters()["syncs"] - s0)
        rec = {"phase": "main", "row": row, "value": val,
               "iterations": solver.outer_iters,
               "converged": bool(solver.last_metrics["converged"]),
               "first_solve_s": first_s,
               "solve_s_median": sorted(times)[1], "solve_s": times,
               "host_syncs_per_solve": syncs[-1],
               "launches_first_solve": first["launches"],
               "entry_launches_first_solve": first["entries"]}
        if row == "lp1000_auto":
            rel = abs(val - ref_lp.fun) / abs(ref_lp.fun)
            rec["highs"] = float(ref_lp.fun)
            rec["rel_err_vs_highs"] = rel
            check(solver.v_star is not None and solver.lam_star is not None,
                  "lp1000_auto: duals missing")
            check(rel <= 1e-6, f"lp1000_auto: rel err vs HiGHS {rel:.3g}")
        elif row == "qp1000_pd":
            rel = abs(val - cpu_qp_val) / abs(cpu_qp_val)
            rec["cpu_value"] = cpu_qp_val
            rec["rel_err_vs_cpu"] = rel
            check(rel <= 1e-8, f"qp1000_pd: rel err vs CPU solve {rel:.3g}")
        else:
            rec["certificate"] = kkt_certificate(solver, lp_recipe(5000))
        check(np.all(np.isfinite(solver.xstar)), f"{row}: non-finite x")
        emit(rec)
        results[("main", row)] = rec
        del solver
        torch.cuda.empty_cache()
    total = diff(counters(), total_before)
    for kname, cnt in total["plain"].items():
        check(cnt == 0, f"main path ran the plain version of {kname}")
    return total


def summary(results, total):
    k1 = results[("K1", "lp5000_pd")]
    k3 = results[("K3", 800)]
    src = "interiorpoint_tpu_torch/csrc/"
    return {"kernels": [
        # K1 is a sequence of launches from three sources; "source" names
        # the one with its own passes, "sources" all three
        {"name": "K1 pd_step", "route": "cuda", "source": src + "rows.cu",
         "sources": [src + "rows.cu", src + "gram.cu", src + "chol.cu"],
         "replaces": "interiorpoint_tpu/ops/pallas_pd.py:368",
         "launches": total["launches"]["K1"],
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"], "shape": k1["shape"]},
        {"name": "K3a cholesky_blocked", "route": "cuda",
         "source": src + "chol.cu",
         "replaces": "interiorpoint_tpu/ops/pallas_chol.py:143",
         "launches": total["launches"]["K3a"],
         "max_abs_err": k3["factor_abs_err"], "ms": k3["factor_ms"],
         "plain_ms": k3["factor_plain_ms"], "shape": [800, 800]},
        {"name": "K3b cholesky_solve_blocked", "route": "cuda",
         "source": src + "chol.cu",
         "replaces": "interiorpoint_tpu/ops/pallas_chol.py:172",
         "launches": total["launches"]["K3b"],
         "max_abs_err": k3["solve_abs_err"], "ms": k3["solve_ms"],
         "plain_ms": k3["solve_plain_ms"], "shape": [800, 1]},
    ], "entry_launches": total["entries"]}


def main():
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
    results = {}
    phase_k3(results)
    phase_k1(results)
    total = phase_main(results)
    kern = summary(results, total)
    print(card, flush=True)
    print(json.dumps(kern), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
