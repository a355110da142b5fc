#!/usr/bin/env python3
"""The JAX package's row-sharded LP solves on bench.py's LP recipe (seed 1,
bounds ±3, ε = 1e-8): the reference for chip_smoke.py's dist_lp5000 rows,
showing how far the JAX barrier ends from the primal-dual solve of the
same LP.

    python3 jax_dist_reference.py [N ...]       # default: 5000

One JSON line per N: JAX's platform, each algorithm's objective, stage
and Newton counts and seconds, the relative barrier − pd difference and
the barrier's m/t, both relative to |pd objective|.  It runs on JAX's
default device, on a one-device mesh, in fp64.  This script imports the
JAX package; the PyTorch port never does.
"""

import json
import sys
import time

import numpy as np


def lp_recipe(n):
    """bench.py bench_lp: A (0.8n × n), C (0.2n × n), x_feas, c, seed 1."""
    m, k = int(0.8 * n), int(0.2 * n)
    np.random.seed(1)
    A = np.random.uniform(-2, 2, (m, n))
    C = np.random.uniform(-2, 2, (k, n))
    x_feas = np.random.uniform(-2, 2, n)
    c = np.random.uniform(-2, 2, n)
    return c, A, A @ x_feas, C, C @ x_feas


def main(argv):
    import jax
    jax.config.update("jax_enable_x64", True)
    from interiorpoint_tpu.parallel import make_mesh, solve_lp_row_sharded

    mesh = make_mesh(1, ("rows",))
    for n in [int(a) for a in argv] or [5000]:
        args = lp_recipe(n)
        out = {"n": n, "platform": jax.devices()[0].platform}
        for algo in ("barrier", "pd"):
            t0 = time.perf_counter()
            res = solve_lp_row_sharded(mesh, *args, lb=-3.0, ub=3.0,
                                       epsilon=1e-8, algorithm=algo)
            obj = float(res["objective"])
            out[algo] = {"objective": obj,
                         "outer_iters": int(res["outer_iters"]),
                         "newton_iters": int(res["newton_iters"]),
                         "seconds": time.perf_counter() - t0}
        scale = abs(out["pd"]["objective"])
        num_ineq = args[3].shape[0] + 2 * n
        out["barrier_minus_pd_rel"] = (out["barrier"]["objective"]
                                       - out["pd"]["objective"]) / scale
        out["m_over_t_rel"] = (num_ineq / 15.0 ** (
            out["barrier"]["outer_iters"] - 1)) / scale
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
