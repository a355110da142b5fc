#!/usr/bin/env python3
"""Compare two trees of the port on one NVIDIA H100, in one process per
tree and mode so that both run on the same card.

    python3 chip_ab.py TREE TAG                 # solve seconds of every row
    python3 chip_ab.py TREE TAG --rows ROW ...  # ... of these rows
    python3 chip_ab.py TREE TAG --steps         # K2 and K5 step times
    python3 chip_ab.py TREE TAG --pieces        # K2's factor and carry
    python3 chip_ab.py TREE TAG --k3a           # K3a's factor and inverse
    python3 chip_ab.py TREE TAG --k3a-flags FILE  # K3a's flags, mixed solves
    python3 chip_ab.py TREE TAG --k3b           # the solve at p > 1
    python3 chip_ab.py TREE TAG --k3b1          # the solve at p = 1
    python3 chip_ab.py TREE TAG --hop           # K1/K4's refined solve
    python3 chip_ab.py TREE TAG --k2-decisions ROW ...
    python3 chip_ab.py TREE TAG --syncs ROW ...  # host reads by site
    python3 chip_ab.py TREE TAG --batch         # batch8_lp_barrier
    python3 chip_ab.py TREE TAG --harness       # the three examples
    python3 chip_ab.py TREE TAG --launches      # K2's launches, each timed
    python3 chip_ab.py TREE TAG --waits         # waits for the device
    python3 chip_ab.py TREE TAG --trace ROW [--plain]
    python3 chip_ab.py --split LOG              # where --trace runs part
    python3 chip_ab.py --summary LOG ...        # rows, steps, k3a/k3b/k3b1/hop

TREE is a checkout holding chip_smoke.py; each mode runs TREE's own
chip_smoke.py functions with their checks reported, not raised.

* Default: the main path (``drive_row``: one first solve, then three timed
  solves of each row); one JSON line per row: the tag, the three solve
  seconds and their median, the steps, phase-one steps, host syncs per
  solve, ms per Newton step (phase one's included), the first solve's
  K1/K4 refined solves (``refined``: solves, operator passes, rounds,
  PCG rounds, stalled solves) and K2's preconditioner branches (lasso1000: ADMM iterations for steps, and the
  ladder's seconds).  ``--rows ROW ...`` drives only those rows.
* ``--steps``: K2's and K5's whole-step times as the kernels line of
  chip_smoke.py takes them: ``k2_check`` at lp5000_barrier's first and
  last states (with its CUDA pieces, the C entries one step launches, and
  the step's wall, device time by kernel and host syncs per call under
  torch.profiler; where the tree's K2 decides on the device also the host
  reads inside its timed steps, the branch, and the form, counts and
  device ms of its refined solve), one whole solve of the row under the
  profiler (its steps, wall, device time by kernel, syncs, syncs per step
  and busy share = device / wall) with the K2 branches of the row's first
  solve (``solve_branches``, ops/newton_step.py ``COUNTS``), and
  ``k5_check`` at socp1000_pd_full's first K5 direction (with its prepare
  and direction); CUDA-event medians of 7; one JSON line.
* ``--pieces``: K2's LDL factor and carry trial on the seeded inputs of
  the tree's ``phase_k2_synthetic``, as it times them (CUDA events per
  call and, where the tree has them, the device's time per call with the
  calls queued); one JSON line.
* ``--k3a``: K3a's factor and inverse in fp32 and fp64 at the widths of
  the tree's ``phase_k3``, as it times them (CUDA events per call; the
  library's factor beside them; where the tree has them, the device's
  time per call with the calls queued, the skipped rung and K2's
  Cholesky fallback at np = 256 and 1024); one JSON line.
* ``--k3b``: the solve at p > 1 through the tree's own wrappers, on
  seeded inputs alike in every tree: K3b (``cholesky_solve_blocked``) at
  (n, p) = (1001, 1001) with B = diag(d) (the LASSO ladder's first
  solve) and a dense B, at (1001, p) for p = 2, 3 and 256 and at (61,
  61), beside ``torch.cholesky_solve``; K2's LDL solve (``_Cuda.ldl_solve``)
  of the identity (the carry reseed) at np = 256 and 1024.  CUDA events
  per call (``time_ms``) and, where the tree has it, the device's time
  per call with the calls queued (``queued_ms``).  A tree whose solve at
  p > 1 is chol.cu's 8-column kernel (the parent of csrc/wsolve.cu) times
  that kernel: alternated with a tree that has wsolve.cu, the readings
  behind ``chol.solve_route``'s crossover.  One JSON line.
* ``--k3b1``: the solve at p = 1 through the tree's own wrappers, on
  seeded inputs alike in every tree: K3b (``cholesky_solve_blocked``) at
  n = 61, 200, 800, 1001 and 1100, beside ``torch.cholesky_solve``, and
  K2's LDL solve (``_Cuda.ldl_solve``, the preconditioner apply M⁻¹v, the
  tile inverses of the plain factor of a seeded Hs) at np = 256, 512,
  1024 and 1152 (n = 1100 and np = 1152: past csolve.cu's rows, on
  chol.cu's one-column tasks); and the host's microseconds per call of
  the two stream-handle queries a launch may use
  (``torch.cuda.current_stream().cuda_stream`` and PyTorch's raw query).
  CUDA events per call (``time_ms``) and the device's time per call with
  the calls queued (``queued_ms``), the library's both ways.  A tree
  without csrc/csolve.cu (its parent) times chol.cu's one-column kernel
  there.  One JSON line.
* ``--hop``: K1's and K4's refined solve (``_Cuda.refined_solve``, both
  paths of chip_smoke.py's ``operator_pieces``: ``solve`` on the step's
  own preconditioner, ``solve_pcg`` on a worse one that drives the PCG)
  and the fused operator (``_Cuda.h_apply``) through the tree's own
  wrappers at three first states, alike in every tree: lp1000_auto
  (2200×200), socp1000_barrier's K4 state (the stacked 4010×950 matrix
  with P) and lp5000_pd (11000×1000; with the whole K1 step there).  Per
  entry CUDA events per call (``ms``, ``time_ms``), the device's time per
  call with the calls queued (``device_ms``, ``queued_ms``), their
  difference (``host_ms``), the bound (``solve_bound``, the operator's
  bytes and operations) and the solve's counts [rounds, stalled, PCG
  rounds, kept].  One JSON line.
* ``--k3a-flags FILE``: K3a's flag on every fp32 factor of the
  distributed demo's mixed KKT solves against the plain factor's
  (``torch.linalg.cholesky_ex`` on the card), on the same inputs: where
  FILE does not exist yet, the demo runs first (under the tree's
  ``harness_recording``, which needs ``k3a_pivot2_ratio``) and saves
  every factor's input and jitter there; one JSON line: the count of each
  split (CUDA flag, plain flag) and, for each split apart, the factor's
  index, n, jitter and smallest fp64 pivot² / max diagonal.  Run it in
  the other trees on the same FILE.
* ``--k2-decisions ROW ...``: each row's first solve with every K2
  preconditioner call held against the plain backend on the same Hs
  (the carry's hit, both LDL rungs' flags, ``ldl_dispute`` where the
  flags differ); one JSON line per row (``k2_decisions``).
* ``--syncs ROW ...``: each row's second solve (the first builds and
  warms) with every host read (ops/sync.py) counted by the line that made
  it; one JSON line per row: the main-stage and phase-one Newton steps,
  the outer iterations, the reads by site and in all, and the reads per
  Newton step.
* ``--batch``: batch8_lp_barrier as the tree's ``phase_parallel`` builds
  it (``batch_lp_instances``, ``BATCH_LP_CFG``): one first
  ``solve_batch``, then three timed; one JSON line: the seconds, the
  Newton steps per instance and the host syncs of a timed call.
* ``--harness``: the tree's three examples (``examples/demo_torch.py``,
  ``phase_one_demo_torch.py``, ``distributed_demo_torch.py``), each
  ``main()`` run twice in this process with nothing patched (the first
  call builds and warms); one JSON line: the seconds of both calls and
  the host syncs of the second, per example.
* ``--launches``: one K2 step's launches, each timed, at the first K2
  state of ``examples/demo_torch.py`` at each shape (recorded by the
  tree's ``harness_recording``; 440×40 and 440×41: the harness's r) with
  a carry that hits and without a carry, and at lp5000_barrier's K2
  states (no carry at r > 512).  The step runs queued behind a sleep on
  the stream, so each launch's device µs (CUDA events around it) is the
  card's time for it alone and its host µs (the host's clock around
  ``_build.launch``) the cost of issuing it; each launch is marked
  ``skipped`` where its branch was not the step's (it exits on the
  device).  Beside them the step's host µs unpatched (the host's clock
  around one ``newton_step`` queued behind a sleep: a step that waits
  for the device inside shows the sleep here), its device ms
  (``queued_ms``), medians of 7, and the sites of the operations inside
  one step that wait for the device (the tree's ``hidden_syncs``, where
  it has it).  One JSON line per state.
* ``--waits``: the operations that wait for the device inside a K2 step
  (the tree's ``hidden_syncs``) at a seeded 440×40 LP state, its first
  step in the process (cold) and two more, with and without a carry;
  then lp1000_auto, qp1000_pd and socp1000_barrier solved in this one
  process with the ladder of ``refine.factor_jittered_device`` as it is
  (A) and followed by a wait for the stream (B), in the order A B B A
  three times: the solve seconds of each.  One JSON line.
* ``--trace ROW``: one solve of a primal-dual row (lp1000_auto,
  qp1000_pd, lp5000_pd) on the card with every K1 step's stats row and
  its refined solves' counts [rounds, stalled, PCG rounds, kept] kept
  (host reads after each step); with ``--plain`` the steps are
  ``pd_step_plain`` on the card's tensors: the same rules with PyTorch's
  sums.  One JSON line: the iterations, the stats rows and the counts.
* ``--split LOG``: reads the ``--trace`` lines of LOG and prints, for
  each pair of traces of one row, the iterations of both, per step
  the largest relative difference of the pre-step gap, ‖rp‖∞ and ‖rd‖∞
  (stats entries 8-10), up to the shorter trace, and each trace's PCG
  rounds per step.
* ``--summary LOG ...``: reads the lines of the default (rows),
  ``--steps``, ``--k3a``, ``--k3b``, ``--k3b1`` and ``--hop`` runs in the
  logs and prints, per record (a row, ``steps``, or a ``--k3a``,
  ``--k3b``, ``--k3b1`` or ``--hop`` record) and number (a row's solve seconds, ms per step,
  steps, host syncs per solve, ladder seconds and refined-solve counts; K2's and K5's step ms;
  every number of a ``--k3a``, ``--k3b``, ``--k3b1`` or ``--hop`` record)
  and per tag, the values in log order, their median
  and quartiles; and over adjacent runs of two tags (parent, change,
  change, parent, ...) the pairs, in how many the first tag
  (alphabetically) read higher, and the median ratio of its median to
  the other's.

Compare two trees with alternating runs, for example parent, change,
change, parent:

    python3 chip_ab.py parent_checkout parent; python3 chip_ab.py . change
    python3 chip_ab.py . change; python3 chip_ab.py parent_checkout parent
"""

from __future__ import annotations

import contextlib
import json
import os
import sys


def _setup(tree):
    os.chdir(tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs

    cs.check = lambda ok, msg: None if ok else print(
        "CHECK FAILED:", msg[:300], flush=True)
    cs.emit = lambda rec: None
    cs.phase_device()
    cs.phase_build()
    return cs


def rows(cs, tag, names=()):
    """The main path's rows (``names``, in their order; every row when
    empty), each as ``drive_row`` drives it."""
    import torch
    from scipy.optimize import linprog

    names = tuple(names) or (cs.ROWS + cs.BARRIER_ROWS + cs.SOCP_ROWS
                             + cs.K5_ROWS)
    p = cs.lp_recipe(1000)
    ref = linprog(p["c"], A_ub=p["C"], b_ub=p["d"], A_eq=p["A"],
                  b_eq=p["b"], bounds=[(-3, 3)] * 1000, method="highs")
    refs = {"highs_lp1000": float(ref.fun)}
    if "qp1000_pd" in names:
        refs["cpu_qp1000"] = cs.make_solver("qp1000_pd", "cpu").solve()
    if set(names) & set(cs.SOCP_ROWS + cs.K5_ROWS):
        cs.socp_reference(refs)
    if "lasso1000" in names:
        X, _, _, it = cs.make_solver("lasso1000", "cpu").solve()
        refs["cpu_lasso1000"] = {"X": X, "iterations": it}
    # the pd values a barrier row is held to, where its pd row does not
    # run before it
    for row, pd in (("qp1000_barrier", "qp1000_pd"),
                    ("lp5000_barrier", "lp5000_pd")):
        if row in names and pd not in names[:names.index(row)]:
            refs[pd] = cs.make_solver(pd, "cuda").solve()
    # socp1000_pd_full is held to socp1000_pd's value and gap
    if "socp1000_pd_full" in names and "socp1000_pd" not in names[
            :names.index("socp1000_pd_full")]:
        cs.drive_row("socp1000_pd", refs)
    for row in names:
        rungs = None
        if row == "lasso1000":
            with k3_per_rung() as rungs:
                solver, rec = None, cs.drive_lasso(row, refs, {})
        else:
            solver, rec = cs.drive_row(row, refs)
        steps = rec.get("newton_steps", rec.get("iterations"))
        p1 = rec.get("phase1_newton_steps")
        print(json.dumps({
            "tag": tag, "row": row, "solve_s": rec["solve_s"],
            "median": rec["solve_s_median"], "steps": steps, "p1": p1,
            "ms_per_step": 1e3 * rec["solve_s_median"] / (steps + (p1 or 0)),
            "syncs": rec["host_syncs_per_solve"],
            "k2": rec.get("k2_preconditioner"),
            "ladder_s": rec.get("ladder_s"),
            "k3b_per_rung": rungs and rungs[:5],
            "entries": rec.get("entry_launches_first_solve"),
            "refined": refined_counts(rec)}), flush=True)
        del solver
        torch.cuda.empty_cache()


def refined_counts(rec):
    """The first solve's K1/K4 refined solves (``drive_row``'s device
    tally): solves, operator passes, refinement rounds, PCG rounds, and
    the stalled solves (passes − rounds − PCG rounds: a stalled solve
    makes one pass for the PCG's result); None for other rows."""
    t = rec.get("refined_solves_first_solve")
    if not t or not t.get("solves"):
        return None
    return {**t, "stalled": t["operator_passes"] - t["rounds"]
            - t["pcg_rounds"]}


@contextlib.contextmanager
def k3_per_rung():
    """Record ops/kkt.py's K3a factors and K3b solves while the block runs;
    yields a list that then holds the K3b solves after each factor run
    (a LASSO ladder's rung: the first solve and its refinement rounds;
    the first five are the main path's ladder)."""
    from interiorpoint_tpu_torch.ops import kkt as kkt_mod

    fac, sol, events, rungs = (kkt_mod.cholesky_blocked,
                               kkt_mod.cholesky_solve_blocked, [], [])

    def fac_rec(*a, **kw):
        events.append("F")
        return fac(*a, **kw)

    def sol_rec(*a, **kw):
        events.append("S")
        return sol(*a, **kw)

    kkt_mod.cholesky_blocked, kkt_mod.cholesky_solve_blocked = (fac_rec,
                                                                sol_rec)
    try:
        yield rungs
    finally:
        kkt_mod.cholesky_blocked, kkt_mod.cholesky_solve_blocked = fac, sol
        for e, prev in zip(events, ["S"] + events):
            if e == "F" and prev == "S":
                rungs.append(0)
            elif e == "S" and rungs:
                rungs[-1] += 1


def profiled(fn, reps=7):
    """fn's wall ms per call (host clock over ``reps`` calls, synchronized),
    the device ms per call of its kernels and copies (torch.profiler) with
    the twelve of most device time (name, launches and ms per call), its
    host syncs per call (ops/sync.py), and its Python function calls per
    call with the five functions of most own time (cProfile)."""
    import cProfile
    import pstats
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile
    from interiorpoint_tpu_torch.ops import sync

    fn()
    torch.cuda.synchronize()
    s0 = sync.count
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    syncs = (sync.count - s0) / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = sorted(((e.key, e.count, e.self_device_time_total)
                      for e in prof.key_averages()
                      if e.self_device_time_total > 0
                      and not e.key.startswith("aten::")),
                     key=lambda k: -k[2])
    dev = sum(k[2] for k in kernels) / 1e3 / reps
    pr = cProfile.Profile()
    pr.enable()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    pr.disable()
    st = pstats.Stats(pr)
    top = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:5]
    return {"wall_ms": wall, "device_ms": dev, "syncs": syncs,
            "by_kernel": [[k[:60], c / reps, t / 1e3 / reps]
                          for k, c, t in kernels[:12]],
            "py_calls": st.total_calls / reps,
            "py_top": [[f"{f}:{n}:{name}", c / reps, tt * 1e3 / reps]
                       for (f, n, name), (_, c, tt, _, _) in top]}


def steps(cs, tag):
    import torch
    from interiorpoint_tpu_torch.ops import newton_step as ns
    from interiorpoint_tpu_torch.ops.newton import sigmas
    from interiorpoint_tpu_torch.ops.pd import dir_stall_tol

    row = "lp5000_barrier"
    solver = cs.make_solver(row, "cuda")
    row_kw = cs.solve_kwargs(row)
    before = dict(ns.COUNTS)
    solver.solve(**row_kw)
    branches = {k: v - before.get(k, 0) for k, v in ns.COUNTS.items()
                if v != before.get(k, 0)}
    m = solver.last_metrics
    n_steps = int(m["newton_iters"]) + (solver._result.phase1.newton_iters
                                        if m["phase1_ran"] else 0)
    solve_prof = profiled(lambda: solver.solve(**row_kw), reps=1)
    solve_prof["busy"] = solve_prof["device_ms"] / solve_prof["wall_ms"]
    solve_prof["syncs_per_step"] = solve_prof["syncs"] / max(n_steps, 1)
    cfg = solver.cfg
    k2 = {}
    for label, consts, tc, z, tP in cs.k2_states(row, solver):
        chk = cs.k2_check(row, label, consts, tc, z, tP, cfg)
        sig = sigmas(cfg, device=z.device)
        kw = dict(dir_tol=dir_stall_tol(cfg.epsilon), alpha=cfg.alpha,
                  refine=cfg.pallas_refine,
                  tP32=None if tP is None else tP.float())
        info = chk["pieces_info"]
        k2[label] = {
            "shape": chk["shape"], "ms": chk["ms"],
            "plain_ms": chk["plain_ms"], "dir_ms": chk["dir_ms"],
            "pieces_ms": {k: v[0] for k, v in chk["pieces_ms"].items()},
            "entries": chk["step_entries"],
            # trees with K2's decisions on the device: host reads inside
            # the timed steps, the form and counts of the refined solve at
            # the strict gate, its device ms
            "syncs_inside_steps": info.get("syncs_inside_steps"),
            "solve_form": info.get("solve.form"),
            "solve_counts": info.get("solve.counts"),
            "refined_solve_device_ms": info.get("refined_solve.device_ms"),
            "branch": chk.get("branch_at_dir_tol",
                              chk.get("preconditioner_at_dir_tol")),
            "profiled": profiled(lambda: ns.newton_step(
                consts, tc, z, tP, sig, **kw))}
    del solver, consts, tc, z, tP
    torch.cuda.empty_cache()
    row = "socp1000_pd_full"
    solver = cs.make_solver(row, "cuda")
    solver.solve(**cs.solve_kwargs(row))
    k5 = cs.k5_check(row, "first", *cs.k5_states(solver)["first"])
    first, last = k2[min(k2)], k2.get("last", {})
    print(json.dumps({"tag": tag, "mode": "steps",
                      "k2_state": [min(k2)] + first["shape"],
                      "k2_ms": first["ms"], "k2_last_ms": last.get("ms"),
                      "k2_by_state": k2,
                      "solve_steps": n_steps,
                      "solve_branches": branches,
                      "solve_profiled": solve_prof,
                      "k5_shape": k5["shape"], "k5_ms": k5["ms"],
                      "k5_plain_ms": k5["plain_ms"],
                      "k5_prepare_ms": k5["prepare_ms"],
                      "k5_direction_ms": k5["direction_ms"]}),
          flush=True)


def pieces(cs, tag):
    """K2's LDL factor and carry trial as the tree's own
    ``phase_k2_synthetic`` times them on its seeded inputs; one JSON line:
    every time (each key ending in ``ms``) of its records, by np."""
    def times(v):
        if isinstance(v, dict):
            out = {k: times(x) for k, x in v.items()
                   if k.endswith("ms") or isinstance(x, dict)}
            return {k: x for k, x in out.items() if x != {}}
        return v

    results = {}
    cs.phase_k2_synthetic(results)
    print(json.dumps({"tag": tag, "mode": "pieces",
                      "synthetic": {str(np_): times(v) for (kind, np_), v
                                    in results.items()
                                    if kind == "K2 synthetic"}}),
          flush=True)


def k3a(cs, tag):
    """K3a as the tree's own ``phase_k3`` times it; one JSON line: every
    time (each key ending in ``ms``) of its K3a records, by dtype and n,
    and of its K2 fallback records, by np."""
    results = {}
    cs.phase_k3(results)
    out = {}
    for key, rec in results.items():
        if key[0] in ("K3a", "K2 fallback"):
            out[" ".join(str(k) for k in key)] = {
                k: v for k, v in rec.items() if k.endswith("ms")}
    print(json.dumps({"tag": tag, "mode": "k3a", "times": out}), flush=True)


def k3b(cs, tag):
    """The solve at p > 1 as the tree's wrappers launch it (module
    docstring, ``--k3b``); one JSON line: every time by record."""
    import numpy as np
    import torch
    from interiorpoint_tpu_torch.ops import chol, hybrid
    from interiorpoint_tpu_torch.ops.newton_step import _Cuda, _Plain

    queued = getattr(cs, "queued_ms", None)
    out = {}

    def timed(key, fn):
        out[key] = {"ms": cs.time_ms(fn)}
        if queued is not None:
            out[key]["device_ms"] = queued(fn)

    spd = {}
    for n, p, kind in ((1001, 1001, "diag"), (1001, 1001, "dense"),
                       (1001, 2, "dense"), (1001, 3, "dense"),
                       (1001, 256, "dense"), (61, 61, "dense")):
        if n not in spd:
            rng = np.random.default_rng(n)
            M = rng.standard_normal((n, n))
            H = torch.as_tensor(M @ M.T / n + np.eye(n),
                                dtype=torch.float32, device="cuda")
            L, D, _ = chol.cholesky_blocked(H)
            spd[n] = (H, L, D, torch.linalg.cholesky(H))
        H, L, D, Llib = spd[n]
        if kind == "diag":
            B = torch.diag(1.0 / torch.sqrt(torch.diagonal(H))).contiguous()
        else:
            B = torch.as_tensor(
                np.random.default_rng(n * 7 + p).standard_normal((n, p)),
                dtype=torch.float32, device="cuda")
        key = f"k3b {n}x{p} {kind}"
        timed(key, lambda: chol.cholesky_solve_blocked(L, D, B))
        out[key]["library_ms"] = cs.time_ms(
            lambda: torch.cholesky_solve(B, Llib))
    b = hybrid.LDL_BLK
    for n in (200, 1001):
        rng = np.random.default_rng(n)
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        Hs = _Plain.equilibrate(torch.as_tensor(
            (Q * np.logspace(0, 3, n)) @ Q.T, dtype=torch.float32,
            device="cuda"), b)[0]
        np_ = Hs.shape[0]
        Lt, Dinv, _ = _Plain.ldl_factor(Hs, 0.0)
        eye = torch.eye(np_, dtype=Hs.dtype, device="cuda")
        key = f"ldl reseed np={np_}"
        timed(key, lambda: _Cuda.ldl_solve(Lt, Dinv, eye))
    print(json.dumps({"tag": tag, "mode": "k3b", "times": out}), flush=True)


def k3b1(cs, tag):
    """The solve at p = 1 as the tree's wrappers launch it (module
    docstring, ``--k3b1``); one JSON line: every time by record."""
    import numpy as np
    import torch
    from interiorpoint_tpu_torch.ops import chol, hybrid
    from interiorpoint_tpu_torch.ops.newton_step import _Cuda, _Plain

    out = {}

    def timed(key, fn):
        out[key] = {"ms": cs.time_ms(fn), "device_ms": cs.queued_ms(fn)}

    for n in (61, 200, 800, 1001, 1100):
        rng = np.random.default_rng(n)
        M = rng.standard_normal((n, n))
        H = torch.as_tensor(M @ M.T / n + np.eye(n), dtype=torch.float32,
                            device="cuda")
        L, D, _ = chol.cholesky_blocked(H)
        Llib = torch.linalg.cholesky(H)
        b = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32,
                            device="cuda")
        b2 = b[:, None]
        key = f"k3b {n}x1"
        timed(key, lambda: chol.cholesky_solve_blocked(L, D, b))
        out[key]["library_ms"] = cs.time_ms(
            lambda: torch.cholesky_solve(b2, Llib))
        out[key]["library_device_ms"] = cs.queued_ms(
            lambda: torch.cholesky_solve(b2, Llib))
    for n in (200, 400, 1001, 1100):
        rng = np.random.default_rng(n + 1)
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        Hs = _Plain.equilibrate(torch.as_tensor(
            (Q * np.logspace(0, 3, n)) @ Q.T, dtype=torch.float32,
            device="cuda"), hybrid.LDL_BLK)[0]
        np_ = Hs.shape[0]
        Lt, Dinv, _ = _Plain.ldl_factor(Hs, 0.0)
        v = torch.as_tensor(rng.standard_normal(np_), dtype=torch.float32,
                            device="cuda")
        timed(f"ldl solve np={np_}", lambda: _Cuda.ldl_solve(Lt, Dinv, v))
    # the host's cost of the stream handle every launch passes
    dev = torch.cuda.current_device()
    out["stream query"] = {
        "current_stream_us": host_us(
            lambda: torch.cuda.current_stream().cuda_stream),
        "raw_us": host_us(lambda: torch._C._cuda_getCurrentRawStream(dev))}
    print(json.dumps({"tag": tag, "mode": "k3b1", "times": out}),
          flush=True)


# the states of --hop: (label, row, kind), K1 at its rows' first states,
# K4 at socp1000_barrier's first state (the stacked 4010 x 950 matrix)
HOP_STATES = (("lp1000_auto 2200x200", "lp1000_auto", "K1"),
              ("socp1000_barrier 4010x950+P", "socp1000_barrier", "K4"),
              ("lp5000_pd 11000x1000", "lp5000_pd", "K1"))


def hop_state(cs, row, kind):
    """(M, wt, P, b, W, dsc, refine, stall2, step) of one --hop state: the
    operator of the row's first step, the preconditioner the step builds
    (``factor_inverse_device`` on the CUDA Gram), the predictor's
    right-hand side (K1) or −g (K4), and the whole step as a callable."""
    import torch
    from interiorpoint_tpu_torch.ops import refine as rf
    from interiorpoint_tpu_torch.ops import socp_step as ks
    from interiorpoint_tpu_torch.ops.pd import dir_stall_tol
    from interiorpoint_tpu_torch.ops.pd_step import _Cuda, _Plain, pd_step

    if kind == "K1":
        c1, q, z, s, lam, dtol = cs.k1_inputs(row)
        rp, inv_s, w, _, _, rd, _ = _Plain.pass1(c1.C, z, s, lam, c1.d, q,
                                                 c1.P)
        sig_mu = (s @ lam) / c1.k * 0.1
        b = _Plain.rhs(c1.C, s, lam, rp, inv_s, None, None, sig_mu, False,
                       rd)[2]
        W, dsc, _ = rf.factor_inverse_device(_Cuda, _Cuda.gram(c1.C32, w,
                                                               c1.P32))
        return (c1.C, w, c1.P, b, W, dsc, 3, dtol ** 2,
                lambda: pd_step(c1, q, z, s, lam, dir_tol=dtol))
    solver = cs.make_solver(row, "cuda")
    prob = solver._reduced.prob
    c4 = solver._oracle_fn_z(prob).socp_consts()
    t0 = solver._t0(None)
    tq = (t0 * prob.q if prob.q is not None
          else torch.zeros(c4.r, dtype=c4.A.dtype, device="cuda"))
    tP = None if prob.P is None else (t0 * prob.P).contiguous()
    z = solver._default_z0().contiguous()
    wt = torch.empty(c4.K * c4.M + 2 * c4.K, dtype=c4.A.dtype, device="cuda")
    g = ks._gradient(ks._Cuda, c4, tq.contiguous(), z, tP, wt)[0]
    W, dsc, _ = rf.factor_inverse_device(
        _Cuda, _Cuda.gram(c4.Ast32, wt, None if tP is None else tP.float()))
    return (c4.Ast, wt, tP, -g, W, dsc, solver.cfg.pallas_refine,
            dir_stall_tol(solver.cfg.epsilon) ** 2, None)


def hop(cs, tag):
    """The refined solve and the fused operator through the tree's own
    wrappers at HOP_STATES (module docstring, ``--hop``); one JSON line."""
    import numpy as np
    import torch
    from interiorpoint_tpu_torch.ops import refine as rf
    from interiorpoint_tpu_torch.ops.pd_step import _Cuda, _Plain

    out = {}

    def timed(key, fn, **extra):
        ms, dev = cs.time_ms(fn), cs.queued_ms(fn)
        out[key] = {"ms": ms, "device_ms": dev, "host_ms": ms - dev, **extra}

    for label, row, kind in HOP_STATES:
        M, wt, P, b, W, dsc, refine, st2, step = hop_state(cs, row, kind)
        m, r = M.shape
        qp = P is not None
        x = torch.as_tensor(np.random.default_rng(m + r).standard_normal(r),
                            dtype=M.dtype, device="cuda")
        hb = cs.bound(8 * m * r + 16 * m + 16 * r + (8 * r * r if qp else 0),
                      f64=4.0 * m * r + (2.0 * r * r if qp else 0.0))
        timed(f"{label} h_apply", lambda: _Cuda.h_apply(M, wt, x, P),
              bound_ms=hb["bound_ms"])
        # the worse preconditioner of chip_smoke.operator_pieces (the
        # Gram's diagonal raised by up to 30%, one round, stall gate 1e-24)
        bump = torch.as_tensor(
            np.random.default_rng(m + r).uniform(0.0, 0.3, r),
            dtype=torch.float32, device="cuda")
        Wbad, dbad, _ = rf.factor_inverse_device(
            _Cuda, _Plain.gram(M.float(), wt, None if P is None
                               else P.float()) * (1.0 + torch.diag(bump)))
        for tag_, Wt, dt, nref, s2 in (("solve", W, dsc, refine, st2),
                                       ("solve_pcg", Wbad, dbad, 1, 1e-24)):
            counts = _Cuda.refined_solve(M, wt, P, Wt, dt, b, nref,
                                         s2)[4].tolist()
            timed(f"{label} {tag_}",
                  lambda: _Cuda.refined_solve(M, wt, P, Wt, dt, b, nref, s2),
                  bound_ms=cs.solve_bound(m, r, qp, counts)["bound_ms"],
                  counts=counts)
        if step is not None and row == "lp5000_pd":
            timed(f"{label} K1 step", step)
        del M, W, Wbad
        torch.cuda.empty_cache()
    print(json.dumps({"tag": tag, "mode": "hop", "times": out}), flush=True)


def host_us(fn, reps=20000):
    """Host microseconds per call of ``fn`` (median of 5 loops)."""
    import statistics
    import time

    loops = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        loops.append((time.perf_counter() - t0) * 1e6 / reps)
    return statistics.median(loops)


def k3a_flags(cs, tag, path):
    """K3a's flags against the plain factor's on the mixed KKT solves'
    fp32 factors of the distributed demo, recorded once into ``path``."""
    import contextlib
    import io

    import torch
    from interiorpoint_tpu_torch.ops import chol

    if not os.path.exists(path):
        sys.path.insert(0, os.path.join(os.getcwd(), "examples"))
        import distributed_demo_torch

        store = {"K3a": [], "K3b": {}, "K1": {}, "K2": {}, "K4": {}}
        with cs.harness_recording(store), \
                contextlib.redirect_stdout(io.StringIO()):
            distributed_demo_torch.main([], {})
        torch.save([(H.cpu(), jitter, cs.k3a_pivot2_ratio(H, jitter))
                    for H, jitter, _, _ in store["K3a"]], path)
    saved = torch.load(path)
    splits, apart = {}, []
    for i, (H, jitter, ratio) in enumerate(saved):
        H, n = H.cuda(), H.shape[0]
        bad = chol.cholesky_blocked(H, jitter)[2]
        bad_p = chol.factor_plain(H, n, chol.padded(n, chol.PLAIN_BLK),
                                  jitter)[2]
        key = f"{int(bad)}{int(bad_p)}"
        splits[key] = splits.get(key, 0) + 1
        if key in ("01", "10"):
            apart.append([i, key, n, jitter, ratio])
    print(json.dumps({"tag": tag, "mode": "k3a_flags",
                      "factors": len(saved), "splits": splits,
                      "apart": apart}), flush=True)


def k2_decisions(cs, tag, row):
    """ROW's first solve with every K2 preconditioner call of the CUDA
    backend held against the plain one on the call's own Hs: the carry
    trial's hit and each LDL rung's flag (both rungs run); where the two
    factors' flags differ, ``ldl_dispute`` says whether the CUDA one's
    decision stands on its own (a tile at its fp32 floor).  The solve
    itself is the tree's (the comparisons only read its inputs).  One
    JSON line: the steps, the calls, and every call where a decision
    differs."""
    import torch
    from interiorpoint_tpu_torch.ops import hybrid
    from interiorpoint_tpu_torch.ops import newton_step as ns

    b = hybrid.LDL_BLK
    calls, differ = [0], []
    orig = ns.preconditioner

    def traced(ops, H32, carry=None):
        if ops is ns._Cuda:
            Hs = ops.equilibrate(H32, b)[0]
            entry = {}
            if carry is not None and carry.ok:
                hc = int(ns._Cuda.ns_refresh(Hs, carry.X)[1])
                hp = int(ns._Plain.ns_refresh(Hs, carry.X)[1])
                if hc != hp:
                    entry["carry_hit"] = [hc, hp]
            for rung, delta in enumerate(hybrid.LDL_JITTERS):
                nt = Hs.shape[0] // b
                st_c = torch.full((nt, 2), float("nan"), device=Hs.device)
                st_p = torch.full((nt, 2), float("nan"), device=Hs.device)
                work = torch.empty_like(Hs)
                fc = ns._Cuda.ldl_factor(Hs, delta, stats=st_c, work=work)
                fp = ns._Plain.ldl_factor(Hs, delta, stats=st_p)
                if int(fc[2]) != int(fp[2]):
                    d, ok = cs.ldl_dispute(Hs, delta, work, fc, st_p)
                    entry[f"rung{rung}"] = {
                        "flags": [int(fc[2]), int(fp[2])], "tile": d["tile"],
                        "stands": ok,
                        "plain_on_cuda_schur": d.get("plain_on_cuda_schur")}
            if entry:
                differ.append({"call": calls[0], **entry})
            calls[0] += 1
        return orig(ops, H32, carry)

    ns.preconditioner = traced
    try:
        solver = cs.make_solver(row, "cuda")
        solver.solve(**cs.solve_kwargs(row))
    finally:
        ns.preconditioner = orig
    m = solver.last_metrics
    p1 = solver._result.phase1
    print(json.dumps({"tag": tag, "mode": "k2_decisions", "row": row,
                      "steps": int(m["newton_iters"]),
                      "phase1_steps": (int(p1.newton_iters)
                                       if m["phase1_ran"] else 0),
                      "k2_calls": calls[0], "differ": differ}), flush=True)


def syncs(cs, tag, row):
    """ROW's host reads by site (module docstring, ``--syncs``)."""
    import collections

    from interiorpoint_tpu_torch.ops import sync

    solver = cs.make_solver(row, "cuda")
    kw = cs.solve_kwargs(row)
    solver.solve(**kw)
    sites = collections.Counter()
    orig = sync.read, sync.read_list

    def at(f):
        def counted(t):
            fr = sys._getframe(1)
            sites[f"{os.path.relpath(fr.f_code.co_filename)}:"
                  f"{fr.f_lineno}"] += 1
            return f(t)
        return counted

    sync.read, sync.read_list = at(orig[0]), at(orig[1])
    try:
        solver.solve(**kw)
    finally:
        sync.read, sync.read_list = orig
    m = solver.last_metrics
    p1 = solver._result.phase1
    steps = int(m["newton_iters"])
    p1_steps = int(p1.newton_iters) if m["phase1_ran"] else 0
    total = sum(sites.values())
    print(json.dumps({"tag": tag, "mode": "syncs", "row": row,
                      "steps": steps, "phase1_steps": p1_steps,
                      "outer": solver.outer_iters, "syncs": total,
                      "per_step": total / max(steps + p1_steps, 1),
                      "by_site": dict(sites.most_common())}), flush=True)


def batch(cs, tag):
    """batch8_lp_barrier's solve seconds (module docstring, ``--batch``)."""
    import time

    import torch
    from interiorpoint_tpu_torch import make_lp
    from interiorpoint_tpu_torch import parallel as par
    from interiorpoint_tpu_torch.ops import sync
    from interiorpoint_tpu_torch.utils.config import SolverConfig

    data, x0 = cs.batch_lp_instances()
    probs = [make_lp(p["c"], C=p["C"], d=p["d"], device="cuda")
             for p in data]
    stacked = par.stack_problems(probs)
    x0t = torch.as_tensor(x0, dtype=torch.float64, device="cuda")
    mesh = par.make_mesh(axis_names=("batch",), device="cuda")
    cfg = SolverConfig(**cs.BATCH_LP_CFG)
    res = par.solve_batch(stacked, x0t, cfg, mesh=mesh, algorithm="barrier")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        s0 = sync.count
        t0 = time.perf_counter()
        par.solve_batch(stacked, x0t, cfg, mesh=mesh, algorithm="barrier")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        syncs = sync.count - s0
    print(json.dumps({"tag": tag, "mode": "batch", "row": "batch8_lp_barrier",
                      "solve_s": times, "median": sorted(times)[1],
                      "steps": res.inner_iters.sum(axis=1).tolist(),
                      "syncs": syncs}), flush=True)


def harness(cs, tag):
    """The examples' seconds (module docstring, ``--harness``)."""
    import importlib
    import io
    import time

    import torch
    from interiorpoint_tpu_torch.ops import sync

    sys.path.insert(0, os.path.join(os.getcwd(), "examples"))
    out = {}
    for name in ("demo_torch", "phase_one_demo_torch",
                 "distributed_demo_torch"):
        mod = importlib.import_module(name)
        secs = []
        for _ in range(2):
            torch.cuda.synchronize()
            s0 = sync.count
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                mod.main([], {})
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        out[name] = {"seconds": secs, "syncs": sync.count - s0}
    print(json.dumps({"tag": tag, "mode": "harness", "examples": out}),
          flush=True)


def skipped_launches(branch, names):
    """Which of one K2 step's launches (``names``, in order) exit on the
    device because their branch is not the step's (``branch`` in
    ST_BRANCH's numbering: 0 hit, 1 / 2 LDL rung 0 / 1, 3 + i the
    Cholesky fallback at jitter rung i)."""
    out, ldl, rung = [], 0, 0
    for name in names:
        if name == "ip_ldl_factor":
            # rung 1 runs only after rung 0 failed
            out.append(branch == 0 or (ldl == 1 and branch == 1))
            ldl += 1
        elif name == "ip_block_solve_wide":       # the re-seed M⁻¹I
            out.append(branch not in (1, 2))
        elif name == "ip_chol_factor":
            out.append(branch < 3 or rung > branch - 3)
            rung += 1
        elif name in ("ip_pivot_floor", "ip_chol_invert", "ip_gram_tn"):
            out.append(branch < 3)
        else:
            out.append(False)
    return out


def launches(cs, tag):
    """K2's launches, each timed (module docstring, ``--launches``)."""
    import importlib
    import io
    import statistics
    import time

    import torch
    from interiorpoint_tpu_torch.kernels import _build
    from interiorpoint_tpu_torch.ops import hybrid
    from interiorpoint_tpu_torch.ops import newton_step as ns
    from interiorpoint_tpu_torch.ops.newton import sigmas
    from interiorpoint_tpu_torch.ops.pd import dir_stall_tol

    states = []
    store = {"K3a": [], "K3b": {}, "K1": {}, "K2": {}, "K4": {}}
    sys.path.insert(0, os.path.join(os.getcwd(), "examples"))
    mod = importlib.import_module("demo_torch")
    with cs.harness_recording(store), \
            contextlib.redirect_stdout(io.StringIO()):
        mod.main([], {})
    for ((k, r), qp), (consts, tc, z, tP, cfg) in store["K2"].items():
        states.append((f"demo_torch {k}x{r}" + (" + P" if qp else ""),
                       consts, tc, z, tP, cfg))
    row = "lp5000_barrier"
    solver = cs.make_solver(row, "cuda")
    solver.solve(**cs.solve_kwargs(row))
    for label, consts, tc, z, tP in cs.k2_states(row, solver):
        states.append((f"{row} {label}", consts, tc, z, tP, solver.cfg))

    orig = _build.launch

    def one(step):
        """[branch, [[name, host µs, device µs], ...]] of one step queued
        behind a sleep."""
        rec = []

        def timed(name, *args):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            t0 = time.perf_counter()
            out = orig(name, *args)
            t1 = time.perf_counter()
            e1.record()
            rec.append((name, 1e6 * (t1 - t0), e0, e1))
            return out

        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)
        _build.launch = timed
        try:
            st = step()[1]
        finally:
            _build.launch = orig
        torch.cuda.synchronize()
        return int(st[ns.ST_BRANCH]), [
            [n, h, 1e3 * e0.elapsed_time(e1)] for n, h, e0, e1 in rec]

    def host_us(step):
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)
        t0 = time.perf_counter()
        step()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return 1e6 * (t1 - t0)

    for label, consts, tc, z, tP, cfg in states:
        sig = sigmas(cfg, device=z.device)
        kw = dict(dir_tol=dir_stall_tol(cfg.epsilon), alpha=cfg.alpha,
                  refine=cfg.pallas_refine,
                  tP32=None if tP is None else tP.float())
        variants = [("no carry", None)]
        if hybrid.ns_carry_supported(consts.r):
            # seeded by one step at the same state: the timed steps try
            # it (a hit where it passes its gate)
            seed = ns.NSCarry()
            ns.newton_step(consts, tc, z, tP, sig, carry=seed, **kw)
            variants.append(("carry", seed.X))

        for name, X0 in variants:
            def step(X0=X0):
                carry = (None if X0 is None
                         else ns.NSCarry(X=X0.clone(), ok=True))
                return ns.newton_step(consts, tc, z, tP, sig, carry=carry,
                                      **kw)
            runs = [(one(step), host_us(step)) for _ in range(7)]
            hidden = (cs.hidden_syncs(step)[1]
                      if hasattr(cs, "hidden_syncs") else None)
            branch = runs[0][0][0]
            names = [e[0] for e in runs[0][0][1]]
            skip = skipped_launches(branch, names)
            per = [[names[i], skip[i],
                    statistics.median(r[0][1][i][1] for r in runs),
                    statistics.median(r[0][1][i][2] for r in runs)]
                   for i in range(len(names))]
            skipped = [p for p in per if p[1]]
            print(json.dumps({
                "tag": tag, "mode": "launches", "state": label,
                "shape": [consts.k, consts.r], "carry": name,
                "branch": branch,
                "branches": sorted({r[0][0] for r in runs}),
                "launches": per, "n_launches": len(per),
                "n_skipped": len(skipped),
                "skipped_host_us": sum(p[2] for p in skipped),
                "skipped_device_us": sum(p[3] for p in skipped),
                "launch_host_us": sum(p[2] for p in per),
                "step_host_us": statistics.median(r[1] for r in runs),
                "hidden_syncs": hidden,
                "step_device_ms": cs.queued_ms(step, n=16)}), flush=True)
    del solver


def waits(cs, tag):
    """Waits for the device inside a step (module docstring, ``--waits``)."""
    import statistics
    import time

    import numpy as np
    import torch
    from interiorpoint_tpu_torch.ops import newton_step as ns
    from interiorpoint_tpu_torch.ops import refine

    rng = np.random.default_rng(0)
    k, r = 440, 40
    C = torch.as_tensor(rng.standard_normal((k, r)), device="cuda")
    z = torch.zeros(r, dtype=torch.float64, device="cuda")
    d = C @ z + torch.as_tensor(rng.uniform(0.5, 2.0, k), device="cuda")
    tc = torch.as_tensor(rng.standard_normal(r), device="cuda")
    consts = ns.prep_newton_consts(C, d)
    sig = torch.as_tensor(0.6 ** np.arange(40), device="cuda")
    carry = ns.NSCarry()
    sites = {}
    for name, kw in (("no carry", {}), ("carry", {"carry": carry})):
        sites[name] = [cs.hidden_syncs(lambda: ns.newton_step(
            consts, tc, z, None, sig, alpha=0.2, **kw))[1]
            for _ in range(3)]

    orig = refine.factor_jittered_device

    def waiting(*a, **kw):
        out = orig(*a, **kw)
        torch.cuda.current_stream().synchronize()
        return out

    rows = ("lp1000_auto", "qp1000_pd", "socp1000_barrier")
    solvers = {}
    for row in rows:
        solvers[row] = cs.make_solver(row, "cuda")
        solvers[row].solve(**cs.solve_kwargs(row))
    secs = {row: {"A": [], "B": []} for row in rows}
    try:
        for v in "ABBA" * 3:
            refine.factor_jittered_device = orig if v == "A" else waiting
            for row in rows:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                solvers[row].solve(**cs.solve_kwargs(row))
                torch.cuda.synchronize()
                secs[row][v].append(time.perf_counter() - t0)
    finally:
        refine.factor_jittered_device = orig
    print(json.dumps({
        "tag": tag, "mode": "waits", "sites": sites,
        "ladder_wait": {row: {"as_is": v["A"], "waiting": v["B"],
                              "as_is_median": statistics.median(v["A"]),
                              "waiting_median": statistics.median(v["B"])}
                        for row, v in secs.items()}}), flush=True)


def trace(cs, tag, row, plain):
    from interiorpoint_tpu_torch.ops import pd as pd_mod
    from interiorpoint_tpu_torch.ops import pd_step as ps

    step = ps.pd_step_plain if plain else ps.pd_step
    ops = ps._Plain if plain else ps._Cuda
    solve = ops.refined_solve
    kept, solves, per_step = [], [], []

    def counted(*a, **kw):
        out = solve(*a, **kw)
        solves.append(out[4])
        return out

    def traced(*a, **kw):
        n = len(solves)
        out = step(*a, **kw)
        kept.append(out[3].tolist())
        per_step.append([c.tolist() for c in solves[n:]])
        return out

    pd_mod.pd_step = traced
    ops.refined_solve = staticmethod(counted)
    try:
        solver = cs.make_solver(row, "cuda")
        solver.solve(**cs.solve_kwargs(row))
    finally:
        ops.refined_solve = staticmethod(solve)
    print(json.dumps({"tag": tag, "mode": "trace", "row": row,
                      "plain": plain, "iterations": solver.outer_iters,
                      "stats": kept, "solves": per_step}), flush=True)


def split(log):
    traces = []
    with open(log) as f:
        for line in f:
            if line.startswith("{") and '"mode": "trace"' in line:
                traces.append(json.loads(line))
    for i, t in enumerate(traces):
        for ref in traces[:i]:
            if ref["row"] != t["row"]:
                continue
            d = [max(abs(a[j] - b[j]) / max(abs(b[j]), 1e-300)
                     for j in (8, 9, 10))
                 for a, b in zip(t["stats"], ref["stats"])]
            print(json.dumps({"row": t["row"],
                              "trace": [t["tag"], t["plain"]],
                              "against": [ref["tag"], ref["plain"]],
                              "iterations": [t["iterations"],
                                             ref["iterations"]],
                              "rel_diff_per_step": d,
                              "pcg_rounds_per_step": [pcg_per_step(t),
                                                      pcg_per_step(ref)]}),
                  flush=True)


def pcg_per_step(trace):
    """PCG rounds of each step's refined solves in a --trace record (its
    ``solves``: [rounds, stalled, PCG rounds, kept] per solve); None for a
    record without them."""
    if "solves" not in trace:
        return None
    return [sum(c[2] for c in step) for step in trace["solves"]]


def _numbers(r):
    """{(record, number): [values]} of one output line: a row's solve
    seconds, ms per step, steps, syncs and ladder seconds; the batch's
    seconds and syncs; each example's seconds (its second call); K2's
    and K5's step ms, the lp5000_barrier solve's steps, wall and device
    ms, syncs, busy share and syncs per step, and K2's profiled wall,
    device ms and syncs at each state; the numbers of each ``--k3a``,
    ``--k3b``, ``--k3b1`` or ``--hop`` record (not its lists: the
    counts); empty for other lines."""
    if r.get("mode") == "batch":
        return {(r["row"], "solve_s"): r["solve_s"],
                (r["row"], "syncs"): [r["syncs"]]}
    if r.get("mode") == "harness":
        return {(name, "seconds"): [v["seconds"][-1]]
                for name, v in r["examples"].items()}
    if "solve_s" in r:
        out = {(r["row"], "solve_s"): r["solve_s"],
               (r["row"], "ms_per_step"): [r["ms_per_step"]],
               (r["row"], "steps"): [r["steps"] + (r["p1"] or 0)],
               (r["row"], "syncs"): [r["syncs"]]}
        if r.get("ladder_s") is not None:
            out[(r["row"], "ladder_s")] = [r["ladder_s"]]
        for k, v in (r.get("refined") or {}).items():
            out[(r["row"], "refined " + k)] = [v]
        return out
    if r.get("mode") == "steps":
        out = {("steps", k): [r[k]] for k in ("k2_ms", "k2_last_ms",
                                              "k5_ms", "solve_steps")
               if r.get(k)}
        prof = r["solve_profiled"]
        for k in ("wall_ms", "device_ms", "syncs", "busy",
                  "syncs_per_step"):
            if prof.get(k) is not None:
                out[("steps", "solve " + k)] = [prof[k]]
        for label, v in r["k2_by_state"].items():
            for k in ("wall_ms", "device_ms", "syncs"):
                out[("steps", f"k2 {label} profiled {k}")] = [
                    v["profiled"][k]]
        return out
    if r.get("mode") in ("k3a", "k3b", "k3b1", "hop"):
        return {(rec, k): [v] for rec, t in r["times"].items()
                for k, v in t.items()
                if v is not None and not isinstance(v, list)}
    return {}


def summary(logs):
    import statistics

    runs = []       # (tag, {(record, number): [values]}) per process
    for log in logs:
        with open(log) as f:
            for line in f:
                if not line.startswith("{"):
                    continue
                r = json.loads(line)
                vals = _numbers(r)
                if not vals:
                    continue
                if not runs or runs[-1][0] != r["tag"] or \
                        vals.keys() & runs[-1][1].keys():
                    runs.append((r["tag"], {}))
                runs[-1][1].update(vals)
    tags = sorted({t for t, _ in runs})
    for key in dict.fromkeys(k for _, rv in runs for k in rv):
        out = {"record": key[0], "number": key[1]}
        for tag in tags:
            v = [x for t, rv in runs if t == tag for x in rv.get(key, [])]
            if v:
                out[tag] = {"values": v, "median": statistics.median(v)}
                if len(v) > 1:
                    out[tag]["quartiles"] = statistics.quantiles(v, n=4)
        ratios = []
        for (ta, ra), (tb, rb) in zip(runs[::2], runs[1::2]):
            if ta != tb and key in ra and key in rb:
                first, other = (ra, rb) if ta == tags[0] else (rb, ra)
                den = statistics.median(other[key])
                if den:
                    ratios.append(statistics.median(first[key]) / den)
        if ratios:
            out.update({"pairs": len(ratios),
                        tags[0] + "_higher": sum(x > 1 for x in ratios),
                        "ratio_median": statistics.median(ratios)})
        print(json.dumps(out), flush=True)


def main(argv) -> int:
    if argv[:1] == ["--split"] and len(argv) == 2:
        split(argv[1])
        return 0
    if argv[:1] == ["--summary"] and len(argv) >= 2:
        summary(argv[1:])
        return 0
    if len(argv) < 2:
        raise SystemExit(__doc__)
    tree, tag, mode = os.path.abspath(argv[0]), argv[1], argv[2:]
    if mode == []:
        rows(_setup(tree), tag)
    elif mode[:1] == ["--rows"] and len(mode) >= 2:
        rows(_setup(tree), tag, mode[1:])
    elif mode == ["--steps"]:
        steps(_setup(tree), tag)
    elif mode == ["--pieces"]:
        pieces(_setup(tree), tag)
    elif mode == ["--k3a"]:
        k3a(_setup(tree), tag)
    elif mode == ["--k3b"]:
        k3b(_setup(tree), tag)
    elif mode == ["--k3b1"]:
        k3b1(_setup(tree), tag)
    elif mode == ["--hop"]:
        hop(_setup(tree), tag)
    elif mode[:1] == ["--k3a-flags"] and len(mode) == 2:
        path = os.path.abspath(mode[1])
        k3a_flags(_setup(tree), tag, path)
    elif mode[:1] == ["--k2-decisions"] and len(mode) >= 2:
        cs = _setup(tree)
        for row in mode[1:]:
            k2_decisions(cs, tag, row)
    elif mode == ["--batch"]:
        batch(_setup(tree), tag)
    elif mode == ["--harness"]:
        harness(_setup(tree), tag)
    elif mode == ["--launches"]:
        launches(_setup(tree), tag)
    elif mode == ["--waits"]:
        waits(_setup(tree), tag)
    elif mode[:1] == ["--syncs"] and len(mode) >= 2:
        cs = _setup(tree)
        for row in mode[1:]:
            syncs(cs, tag, row)
    elif mode[:1] == ["--trace"] and len(mode) in (2, 3) and \
            mode[2:] in ([], ["--plain"]):
        trace(_setup(tree), tag, mode[1], mode[2:] == ["--plain"])
    else:
        raise SystemExit(__doc__)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
