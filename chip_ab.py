#!/usr/bin/env python3
"""Solve seconds of every chip_smoke.py row for two trees of the port, on
one NVIDIA H100, in one process each so that both run on the same card.

    python3 chip_ab.py TREE TAG     # TREE: a checkout holding chip_smoke.py

Runs TREE's own chip_smoke.py main path (its ``drive_row``: one first
solve, then three timed solves of each row) with its checks reported, not
raised, and prints one JSON line per row: the tag, the three solve
seconds and their median, the steps, phase-one steps, host syncs per
solve and K2's preconditioner branches.  Compare two trees with
alternating runs, for example parent, change, change, parent:

    python3 chip_ab.py parent_checkout parent; python3 chip_ab.py . change
"""

from __future__ import annotations

import json
import os
import sys


def main(argv) -> int:
    if len(argv) != 2:
        raise SystemExit("usage: chip_ab.py TREE TAG")
    tree, tag = os.path.abspath(argv[0]), argv[1]
    os.chdir(tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs
    import torch
    from scipy.optimize import linprog

    cs.check = lambda ok, msg: None if ok else print(
        "CHECK FAILED:", msg[:300], flush=True)
    cs.emit = lambda rec: None
    cs.phase_device()
    cs.phase_build()
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
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
