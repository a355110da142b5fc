#!/usr/bin/env python3
"""Compare two trees of the port on one NVIDIA H100, in one process per
tree and mode so that both run on the same card.

    python3 chip_ab.py TREE TAG                 # solve seconds of every row
    python3 chip_ab.py TREE TAG --steps         # K2 and K5 step times
    python3 chip_ab.py TREE TAG --trace ROW [--plain]
    python3 chip_ab.py --split LOG              # where --trace runs part
    python3 chip_ab.py --summary LOG ...        # --steps runs per tree

TREE is a checkout holding chip_smoke.py; each mode runs TREE's own
chip_smoke.py functions with their checks reported, not raised.

* Default: the main path (``drive_row``: one first solve, then three timed
  solves of each row); one JSON line per row: the tag, the three solve
  seconds and their median, the steps, phase-one steps, host syncs per
  solve and K2's preconditioner branches.
* ``--steps``: K2's and K5's whole-step times as the kernels line of
  chip_smoke.py takes them: ``k2_check`` at lp5000_barrier's first state
  (with its CUDA pieces, the C entries one step launches, and the step's
  wall, device time and host syncs per call under torch.profiler) and
  ``k5_check`` at socp1000_pd_full's first K5 direction (with its prepare
  and direction); CUDA-event medians of 7; one JSON line.
* ``--trace ROW``: one solve of a primal-dual row (lp1000_auto,
  qp1000_pd, lp5000_pd) on the card with every K1 step's stats row kept
  (one host read per step, after it); with ``--plain`` the steps are
  ``pd_step_plain`` on the card's tensors: the same rules with PyTorch's
  sums.  One JSON line: the iterations and the stats rows.
* ``--split LOG``: reads the ``--trace`` lines of LOG and prints, for
  each pair of traces of one row, the iterations of both, and per step
  the largest relative difference of the pre-step gap, ‖rp‖∞ and ‖rd‖∞
  (stats entries 8-10), up to the shorter trace.
* ``--summary LOG ...``: reads the ``--steps`` lines of the logs and
  prints, per tag, the runs, median and quartiles of K2's and K5's step
  ms, and in how many adjacent (parent, change) pairs of one log the
  second tag's K2 read slower.

Compare two trees with alternating runs, for example parent, change,
change, parent:

    python3 chip_ab.py parent_checkout parent; python3 chip_ab.py . change
"""

from __future__ import annotations

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


def rows(cs, tag):
    import torch
    from scipy.optimize import linprog

    p = cs.lp_recipe(1000)
    ref = linprog(p["c"], A_ub=p["C"], b_ub=p["d"], A_eq=p["A"],
                  b_eq=p["b"], bounds=[(-3, 3)] * 1000, method="highs")
    refs = {"highs_lp1000": float(ref.fun),
            "cpu_qp1000": cs.make_solver("qp1000_pd", "cpu").solve()}
    cs.socp_reference(refs)
    for row in cs.ROWS + cs.BARRIER_ROWS + cs.SOCP_ROWS + cs.K5_ROWS:
        solver, rec = cs.drive_row(row, refs)
        print(json.dumps({
            "tag": tag, "row": row, "solve_s": rec["solve_s"],
            "median": rec["solve_s_median"],
            "steps": rec.get("newton_steps", rec.get("iterations")),
            "p1": rec.get("phase1_newton_steps"),
            "syncs": rec["host_syncs_per_solve"],
            "k2": rec.get("k2_preconditioner")}), flush=True)
        del solver
        torch.cuda.empty_cache()


def profiled(fn, reps=7):
    """fn's wall ms per call (host clock over ``reps`` calls, synchronized),
    the device ms per call of its kernels and copies (torch.profiler), its
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
    dev = sum(e.self_device_time_total for e in prof.key_averages()
              if e.self_device_time_total > 0
              and not e.key.startswith("aten::")) / 1e3 / reps
    pr = cProfile.Profile()
    pr.enable()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    pr.disable()
    st = pstats.Stats(pr)
    top = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:5]
    return {"wall_ms": wall, "device_ms": dev, "syncs": syncs,
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
    solver.solve(**cs.solve_kwargs(row))
    label, consts, tc, z, tP = cs.k2_states(row, solver)[0]
    k2 = cs.k2_check(row, label, consts, tc, z, tP, solver.cfg)
    cfg = solver.cfg
    sig = sigmas(cfg, device=z.device)
    kw = dict(dir_tol=dir_stall_tol(cfg.epsilon), alpha=cfg.alpha,
              refine=cfg.pallas_refine,
              tP32=None if tP is None else tP.float())
    k2_prof = profiled(lambda: ns.newton_step(consts, tc, z, tP, sig, **kw))
    del solver, consts, tc, z, tP
    torch.cuda.empty_cache()
    row = "socp1000_pd_full"
    solver = cs.make_solver(row, "cuda")
    solver.solve(**cs.solve_kwargs(row))
    k5 = cs.k5_check(row, "first", *cs.k5_states(solver)["first"])
    print(json.dumps({"tag": tag, "mode": "steps",
                      "k2_state": [label] + k2["shape"],
                      "k2_ms": k2["ms"], "k2_plain_ms": k2["plain_ms"],
                      "k2d_ms": k2["dir_ms"],
                      "k2_pieces_ms": {k: v[0] for k, v in
                                       k2["pieces_ms"].items()},
                      "k2_entries": k2["step_entries"],
                      "k2_profiled": k2_prof,
                      "k5_shape": k5["shape"], "k5_ms": k5["ms"],
                      "k5_plain_ms": k5["plain_ms"],
                      "k5_prepare_ms": k5["prepare_ms"],
                      "k5_direction_ms": k5["direction_ms"]}),
          flush=True)


def trace(cs, tag, row, plain):
    from interiorpoint_tpu_torch.ops import pd as pd_mod
    from interiorpoint_tpu_torch.ops import pd_step as ps

    step = ps.pd_step_plain if plain else ps.pd_step
    kept = []

    def traced(*a, **kw):
        out = step(*a, **kw)
        kept.append(out[3].tolist())
        return out

    pd_mod.pd_step = traced
    solver = cs.make_solver(row, "cuda")
    solver.solve(**cs.solve_kwargs(row))
    print(json.dumps({"tag": tag, "mode": "trace", "row": row,
                      "plain": plain, "iterations": solver.outer_iters,
                      "stats": kept}), flush=True)


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
                              "rel_diff_per_step": d}), flush=True)


def summary(logs):
    import statistics

    runs, slower, pairs = {}, 0, 0
    for log in logs:
        seq = []
        with open(log) as f:
            for line in f:
                if line.startswith("{") and '"mode": "steps"' in line:
                    seq.append(json.loads(line))
        for r in seq:
            runs.setdefault(r["tag"], []).append(r)
        tags = sorted(runs)
        for a, b in zip(seq[::2], seq[1::2]):
            if a["tag"] != b["tag"]:
                pairs += 1
                ch = a if a["tag"] == tags[0] else b
                pa = b if ch is a else a
                slower += ch["k2_ms"] > pa["k2_ms"]
    for tag, rs in sorted(runs.items()):
        out = {"tag": tag, "runs": len(rs)}
        for key in ("k2_ms", "k5_ms"):
            v = [r[key] for r in rs]
            out[key] = {"values": v, "median": statistics.median(v),
                        "quartiles": statistics.quantiles(v, n=4)}
        print(json.dumps(out), flush=True)
    print(json.dumps({"pairs": pairs, "k2_slower_in_" + sorted(runs)[0]:
                      slower}), flush=True)


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
    elif mode == ["--steps"]:
        steps(_setup(tree), tag)
    elif mode[:1] == ["--trace"] and len(mode) in (2, 3) and \
            mode[2:] in ([], ["--plain"]):
        trace(_setup(tree), tag, mode[1], mode[2:] == ["--plain"])
    else:
        raise SystemExit(__doc__)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
