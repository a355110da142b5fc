"""One Newton step and its example arguments, and a dry run of every
parallel surface (counterpart of the JAX package's single-step entry and
multi-device dry run, ``entry`` and ``dryrun_multichip`` beside
interiorpoint_tpu/).

    from interiorpoint_tpu_torch.entry import entry, dryrun_multichip
    fn, args = entry()            # on the card; entry(device="cpu")
    x1, v1, resid = fn(*args)
    dryrun_multichip(1)           # one card, or dryrun_multichip(
                                  # n, device="cpu") under n gloo ranks

Both run on the card unless the caller passes ``device="cpu"``; without
a GPU and without it they raise, as every entry point of the port does.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.base import default_device
from .ops.step import lp_newton_step


def entry(device=None):
    """(fn, args): ``lp_newton_step`` and the example instance it is run
    on, n, m, k = 256, 200, 64 from ``default_rng(0)`` (uniform data in
    the JAX entry's order, the box ±3, the start x_feas with Ax = b and
    Cx < d, v = 0, t = 2), float32 tensors on ``device``."""
    dev = torch.device(device) if device is not None else default_device()
    rng = np.random.default_rng(0)
    n, m, k = 256, 200, 64
    A = rng.uniform(-2, 2, (m, n))
    C = rng.uniform(-2, 2, (k, n))
    x_feas = rng.uniform(-1, 1, n)
    c = rng.uniform(-2, 2, n)
    b = A @ x_feas
    d = C @ x_feas + 1.0
    lb = np.full(n, -3.0)
    ub = np.full(n, 3.0)
    args = tuple(
        torch.as_tensor(np.asarray(v), dtype=torch.float32, device=dev)
        for v in (c, A, b, C, d, lb, ub, x_feas, np.zeros(m), 2.0))
    return lp_newton_step, args


def _finite(name, t):
    if not bool(torch.isfinite(torch.as_tensor(t)).all()):
        raise RuntimeError(f"dryrun_multichip: {name} is not finite")


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run every parallel surface once on tiny shapes with tiny budgets,
    in the JAX dry run's order, shapes and seeds, and check that the
    iterates are finite (the target is that each runs, not convergence):

      * ``solve_batch`` over ``stack_problems`` of n_devices float32 LPs
        on a ("batch",) mesh;
      * ``row_sharded_lp_newton_step`` on rows split by ``shard_rows``;
      * ``solve_lp_row_sharded`` with the distributed factor (block 8);
      * ``solve_pd_row_sharded``;
      * ``solve_socp_cone_sharded``, barrier and ``algorithm="pd"``, on
        K = n_devices + 1 cones (so the padding is inert);
      * ``solve_lasso_sharded`` on the ("batch",) mesh.

    The batch and LASSO meshes are ``make_mesh(n_devices, ...)``: the
    ranks of the default ``torch.distributed`` group when there is one,
    else this process's cards or, with ``device="cpu"``, n_devices CPU
    entries.  The row- and cone-sharded surfaces run one rank per
    position of the default group, which must have n_devices ranks; with
    no group, n_devices must be 1.  Returns {surface: its x}."""
    from .models.problem import make_lp
    from .parallel import comm
    from .parallel.batch import (solve_batch, solve_lasso_sharded,
                                 stack_problems)
    from .parallel.distributed import (row_sharded_lp_newton_step,
                                       shard_rows, solve_lp_row_sharded)
    from .parallel.mesh import make_mesh
    from .parallel.pd_dist import solve_pd_row_sharded
    from .parallel.socp_dist import solve_socp_cone_sharded
    from .utils.config import AdmmConfig, SolverConfig

    world = comm.world_size()
    if world != n_devices:
        raise ValueError(
            f"dryrun_multichip({n_devices}): the row- and cone-sharded "
            f"surfaces run as {n_devices} ranks of torch.distributed, but "
            f"the default group has {world}"
            + ("" if comm.active() else " (no process group)"))
    dt = "float32"
    f32 = torch.float32
    rng = np.random.default_rng(0)
    out = {}

    # --- a batch of LP instances over the "batch" axis -------------------
    mesh_b = make_mesh(n_devices, ("batch",), device=device)
    dev_b = mesh_b.devices.flat[0]
    n = 8
    probs = []
    for _ in range(n_devices):
        A = rng.uniform(-2, 2, (6, n))
        C = rng.uniform(-2, 2, (3, n))
        xf = rng.uniform(-1, 1, n)
        c = rng.uniform(-2, 2, n)
        probs.append(make_lp(c, A, A @ xf, C, C @ xf + 1.0, -3.0, 3.0,
                             dtype=f32, device=dev_b))
    batch = stack_problems(probs)
    x0 = torch.zeros((n_devices, n), dtype=f32, device=dev_b)
    cfg = SolverConfig(epsilon=1e-2, t0=1.0, max_outer_iters=3,
                       max_inner_iters=5, dtype=dt)
    res = solve_batch(batch, x0, cfg, mesh=mesh_b)
    # the target is that it runs, not convergence: iterates must be finite
    # (best_obj may remain +inf under the tiny iteration budget)
    _finite("solve_batch x", res.x)
    out["solve_batch"] = res.x

    # --- constraint rows split over the ranks, with collectives ----------
    mesh_r = make_mesh(n_devices, ("rows",), device=device)
    dev_r = mesh_r.position_device("rows", comm.axis_index())
    m, k = 2 * n_devices, 3 * n_devices
    n2 = 16
    A = rng.uniform(-2, 2, (m, n2))
    C = rng.uniform(-2, 2, (k, n2))
    xf = rng.uniform(-1, 1, n2)
    c = rng.uniform(-2, 2, n2)
    step = row_sharded_lp_newton_step(mesh_r)

    def t32(v):
        return torch.as_tensor(np.asarray(v), dtype=f32, device=dev_r)

    x1, v1, resid = step(
        t32(c), shard_rows(mesh_r, t32(A)), shard_rows(mesh_r, t32(A @ xf)),
        shard_rows(mesh_r, t32(C)), shard_rows(mesh_r, t32(C @ xf + 1.0)),
        t32(np.full(n2, -3.0)), t32(np.full(n2, 3.0)), t32(xf),
        torch.zeros(m, dtype=f32, device=dev_r), t32(2.0))
    _finite("row_sharded_lp_newton_step x", x1)
    out["row_sharded_lp_newton_step"] = x1

    # --- the whole row-sharded barrier solve, with the distributed
    # mixed-precision factor ----------------------------------------------
    res_d = solve_lp_row_sharded(
        mesh_r, c, A, A @ xf, C, C @ xf + 1.0, lb=-3.0, ub=3.0, x0=xf,
        epsilon=1e-2, max_outer_iters=3, max_inner_iters=5,
        factor_dtype="float32", distributed_factor=True, chol_block=8)
    _finite("solve_lp_row_sharded x", res_d["x"])
    out["solve_lp_row_sharded"] = res_d["x"]

    # --- the row-sharded Mehrotra solve on the same split ----------------
    res_pd = solve_pd_row_sharded(
        mesh_r, c, A, A @ xf, C, C @ xf + 1.0, lb=-3.0, ub=3.0, x0=xf,
        epsilon=1e-2, max_iters=5, factor_dtype="float32")
    _finite("solve_pd_row_sharded x", res_pd["x"])
    out["solve_pd_row_sharded"] = res_pd["x"]

    # --- one SOCP with its cones split over the ranks --------------------
    mesh_c = make_mesh(n_devices, ("cones",), device=device)
    K, M, n3 = n_devices + 1, 3, 12   # K not divisible: inert padding
    As = rng.standard_normal((K, M, n3))
    bs = rng.standard_normal((K, M))
    cs = rng.standard_normal((K, n3))
    xs0 = 0.1 * rng.standard_normal(n3)
    ds = np.array([np.linalg.norm(As[j] @ xs0 + bs[j]) - cs[j] @ xs0 + 1.0
                   for j in range(K)])
    Fs = rng.standard_normal((2, n3))
    res_s = solve_socp_cone_sharded(
        mesh_c, As, bs, cs, ds, None, rng.standard_normal(n3),
        Fs, Fs @ xs0, -3.0, 3.0, x0=xs0, epsilon=1e-2,
        max_outer_iters=3, max_inner_iters=5)
    _finite("solve_socp_cone_sharded x", res_s["x"])
    out["solve_socp_cone_sharded"] = res_s["x"]

    # --- the conic Mehrotra solve on the same cone split -----------------
    res_sp = solve_socp_cone_sharded(
        mesh_c, As, bs, cs, ds, None, rng.standard_normal(n3),
        Fs, Fs @ xs0, -3.0, 3.0, x0=xs0, epsilon=1e-2,
        algorithm="pd", pd_max_iters=5)
    _finite("solve_socp_cone_sharded(algorithm='pd') x", res_sp["x"])
    out["solve_socp_cone_sharded_pd"] = res_sp["x"]

    # --- batched LASSO over the samples -----------------------------------
    Al = rng.random((12, 6))
    bl = rng.random((12, n_devices))
    reg = np.full(n_devices, 0.1)
    lres = solve_lasso_sharded(Al, bl, reg, AdmmConfig(max_iters=20,
                                                       dtype=dt), mesh_b)
    _finite("solve_lasso_sharded solutions", lres.solutions)
    out["solve_lasso_sharded"] = lres.X
    return out
