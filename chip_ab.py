#!/usr/bin/env python3
"""Compare two trees of the port on one NVIDIA H100, in one process per
tree and mode so that both run on the same card.

    python3 chip_ab.py TREE TAG                 # solve seconds of every row
    python3 chip_ab.py TREE TAG --rows ROW ...  # ... of these rows
    python3 chip_ab.py TREE TAG --steps         # K2 and K5 step times
    python3 chip_ab.py TREE TAG --pieces        # K2's factor and carry
    python3 chip_ab.py TREE TAG --k2-decisions ROW ...
    python3 chip_ab.py TREE TAG --trace ROW [--plain]
    python3 chip_ab.py --split LOG              # where --trace runs part
    python3 chip_ab.py --summary LOG ...        # --steps runs per tree
    python3 chip_ab.py --rows-summary LOG ...   # row runs per tree

TREE is a checkout holding chip_smoke.py; each mode runs TREE's own
chip_smoke.py functions with their checks reported, not raised.

* Default: the main path (``drive_row``: one first solve, then three timed
  solves of each row); one JSON line per row: the tag, the three solve
  seconds and their median, the steps, phase-one steps, host syncs per
  solve, ms per Newton step (phase one's included) and K2's
  preconditioner branches.  ``--rows ROW ...`` drives only those rows.
* ``--steps``: K2's and K5's whole-step times as the kernels line of
  chip_smoke.py takes them: ``k2_check`` at lp5000_barrier's first state
  (with its CUDA pieces, the C entries one step launches, and the step's
  wall, device time and host syncs per call under torch.profiler) and
  ``k5_check`` at socp1000_pd_full's first K5 direction (with its prepare
  and direction); CUDA-event medians of 7; one JSON line.
* ``--pieces``: K2's LDL factor and carry trial on the seeded inputs of
  the tree's ``phase_k2_synthetic``, as it times them (CUDA events per
  call and, where the tree has them, the device's time per call with the
  calls queued); one JSON line.
* ``--k2-decisions ROW ...``: each row's first solve with every K2
  preconditioner call held against the plain backend on the same Hs
  (the carry's hit, both LDL rungs' flags, ``ldl_dispute`` where the
  flags differ); one JSON line per row (``k2_decisions``).
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
* ``--rows-summary LOG ...``: reads the row lines of the logs and prints,
  per row and tag, the median and quartiles of the solve seconds, the
  steps and the median ms per step, and over adjacent runs of the two
  tags the pairs, how often the first tag read slower and the median
  ratio of its medians to the other's.

Compare two trees with alternating runs, for example parent, change,
change, parent:

    python3 chip_ab.py parent_checkout parent; python3 chip_ab.py . change
    python3 chip_ab.py . change; python3 chip_ab.py parent_checkout parent
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
    # the pd values a barrier row is held to, where its pd row does not
    # run before it
    for row, pd in (("qp1000_barrier", "qp1000_pd"),
                    ("lp5000_barrier", "lp5000_pd")):
        if row in names and pd not in names[:names.index(row)]:
            refs[pd] = cs.make_solver(pd, "cuda").solve()
    for row in names:
        solver, rec = cs.drive_row(row, refs)
        steps = rec.get("newton_steps", rec.get("iterations"))
        p1 = rec.get("phase1_newton_steps")
        print(json.dumps({
            "tag": tag, "row": row, "solve_s": rec["solve_s"],
            "median": rec["solve_s_median"], "steps": steps, "p1": p1,
            "ms_per_step": 1e3 * rec["solve_s_median"] / (steps + (p1 or 0)),
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


def rows_summary(logs):
    """Per row of the logs' ``rows`` lines and per tag: the solves, the
    median and quartiles of their seconds, the step counts, the median
    ms per Newton step and the syncs; and over the adjacent runs of two
    tags (parent, change, change, parent, ...), how many pairs there
    were, in how many the first tag (alphabetically) read slower, and the
    median of its ratio to the other's median."""
    import statistics

    runs = []       # (tag, {row: record}) per process, in log order
    for log in logs:
        with open(log) as f:
            for line in f:
                if not (line.startswith("{") and '"solve_s"' in line):
                    continue
                r = json.loads(line)
                if not runs or runs[-1][0] != r["tag"] or \
                        r["row"] in runs[-1][1]:
                    runs.append((r["tag"], {}))
                runs[-1][1][r["row"]] = r
    tags = sorted({t for t, _ in runs})
    names = list(dict.fromkeys(row for _, rs in runs for row in rs))
    for row in names:
        out = {"row": row}
        for tag in tags:
            recs = [rs[row] for t, rs in runs if t == tag and row in rs]
            v = [x for r in recs for x in r["solve_s"]]
            out[tag] = {
                "solves": len(v), "median_s": statistics.median(v),
                "quartiles_s": statistics.quantiles(v, n=4),
                "steps": sorted({(r["steps"], r["p1"]) for r in recs}),
                "median_ms_per_step": statistics.median(
                    r["ms_per_step"] for r in recs),
                "syncs": sorted({r["syncs"] for r in recs})}
        ratios = []
        for (ta, ra), (tb, rb) in zip(runs[::2], runs[1::2]):
            if ta != tb and row in ra and row in rb:
                first, other = (ra, rb) if ta == tags[0] else (rb, ra)
                ratios.append(first[row]["median"] / other[row]["median"])
        if ratios:
            out.update({"pairs": len(ratios),
                        tags[0] + "_slower": sum(x > 1 for x in ratios),
                        "ratio_median": statistics.median(ratios)})
        print(json.dumps(out), flush=True)


def main(argv) -> int:
    if argv[:1] == ["--split"] and len(argv) == 2:
        split(argv[1])
        return 0
    if argv[:1] == ["--summary"] and len(argv) >= 2:
        summary(argv[1:])
        return 0
    if argv[:1] == ["--rows-summary"] and len(argv) >= 2:
        rows_summary(argv[1:])
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
    elif mode[:1] == ["--k2-decisions"] and len(mode) >= 2:
        cs = _setup(tree)
        for row in mode[1:]:
            k2_decisions(cs, tag, row)
    elif mode[:1] == ["--trace"] and len(mode) in (2, 3) and \
            mode[2:] in ([], ["--plain"]):
        trace(_setup(tree), tag, mode[1], mode[2:] == ["--plain"])
    else:
        raise SystemExit(__doc__)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
