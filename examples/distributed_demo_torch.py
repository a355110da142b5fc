"""Multi-card walkthrough of the PyTorch port: every parallel surface
(counterpart of examples/distributed_demo.py:25-175, the same sections,
instances, seeds and settings).

  1. a batch of LP instances split over a ("batch",) mesh
  2. ONE LP with its constraint rows split over the ranks
  3. ONE SOCP with its stacked cone tensors split over the ranks
  4. batched-ADMM LASSO over the samples

Instances are sized from ndev, the number of positions:

* on the card, ndev is the world size of the NCCL group that torchrun
  starts (one rank per card); run alone, ndev = 1, on a one-rank NCCL
  group the demo creates and destroys;
* with ``--cpu``, ndev = 8: the batch and LASSO sections run on a mesh
  of 8 CPU entries, and the sharded sections on one gloo rank, or on the
  ranks of a group that torchrun starts.

    python examples/distributed_demo_torch.py [--cpu]
    torchrun --nproc-per-node=N examples/distributed_demo_torch.py
"""

import argparse
import os
import shutil
import socket
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _join_group(backend):
    """The default process group: torchrun's (its environment), else a
    one-rank group on a free local port.  Returns whether this call
    created it."""
    import torch.distributed as dist
    if dist.is_initialized():
        return False
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://")
        return True
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    return True


def main(argv=None, out=None):
    """Run the walkthrough; ``out`` (a dict), when given, receives the
    printed quantities by section."""
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true",
                   help="an 8-entry CPU mesh and gloo ranks")
    args = p.parse_args(argv)
    out = {} if out is None else out

    import torch
    import torch.distributed as dist
    from scipy.optimize import linprog

    from interiorpoint_tpu_torch import default_device, make_lp
    from interiorpoint_tpu_torch.parallel import (
        make_mesh, solve_batch, solve_lasso_sharded,
        solve_lp_row_sharded, solve_socp_cone_sharded, stack_problems)
    from interiorpoint_tpu_torch.utils.config import (AdmmConfig,
                                                      SolverConfig)

    if args.cpu:
        ndev = 8
        # built before the group: a mesh under a group spans its ranks
        mesh_b = make_mesh(ndev, ("batch",), device="cpu")
        created = _join_group("gloo")
    else:
        if "LOCAL_RANK" in os.environ:
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        default_device()
        created = _join_group("nccl")
        ndev = dist.get_world_size()
        mesh_b = make_mesh(ndev, ("batch",))
    rank = dist.get_rank()

    def say(*a):
        if rank == 0:
            print(*a, flush=True)

    ckpt_dir = None
    try:
        rng = np.random.default_rng(0)
        dev_b = mesh_b.devices.flat[0]
        say(f"devices: {ndev} × {dev_b.type}, "
            f"{dist.get_world_size()} {dist.get_backend()} rank(s)")

        # --------------------------------------------------------------
        # 1. a batch of LP instances, one per position
        # --------------------------------------------------------------
        say("\n[1] instance-parallel LP batch")
        n = 40
        probs, starts, refs = [], [], []
        for _ in range(ndev):
            A = rng.uniform(-2, 2, (10, n))
            C = rng.uniform(-2, 2, (16, n))
            xf = rng.uniform(-1, 1, n)
            c = rng.uniform(-2, 2, n)
            probs.append(make_lp(c, A, A @ xf, C, C @ xf + 0.5, -3.0, 3.0,
                                 dtype=torch.float64, device=dev_b))
            starts.append(xf)
            refs.append(linprog(c, A_ub=C, b_ub=C @ xf + 0.5, A_eq=A,
                                b_eq=A @ xf, bounds=[(-3, 3)] * n,
                                method="highs").fun)
        res = solve_batch(stack_problems(probs),
                          torch.as_tensor(np.stack(starts), device=dev_b),
                          SolverConfig(epsilon=1e-6, dtype="float64"),
                          mesh=mesh_b)
        vals = np.asarray(res.value)
        err = float(np.max(np.abs(vals - np.asarray(refs))))
        say(f"    {ndev} instances solved; max |obj - HiGHS| = {err:.2e}")
        out["batch"] = dict(values=vals.tolist(), highs=refs,
                            gaps=np.asarray(res.dual_gap).tolist(),
                            max_abs_err=err)

        # --------------------------------------------------------------
        # 2. one LP with its constraint rows split over the ranks
        # --------------------------------------------------------------
        say("\n[2] row-sharded single LP")
        mesh = make_mesh(axis_names=("rows",))
        n, m, k = 96, 60, 200
        A = rng.uniform(-2, 2, (m, n))
        C = rng.uniform(-2, 2, (k, n))
        xf = rng.uniform(-1, 1, n)
        c = rng.uniform(-2, 2, n)
        res2 = solve_lp_row_sharded(mesh, c, A, A @ xf, C, C @ xf + 0.5,
                                    lb=-3.0, ub=3.0, epsilon=1e-8,
                                    factor_dtype="float32")
        ref = linprog(c, A_ub=C, b_ub=C @ xf + 0.5, A_eq=A, b_eq=A @ xf,
                      bounds=[(-3, 3)] * n, method="highs").fun
        say(f"    {k} inequality + {m} equality rows sharded over "
            f"{mesh.shape['rows']} rank(s) (mixed-precision factors);")
        say(f"    objective {float(res2['objective']):.6f} vs HiGHS "
            f"{ref:.6f}  ({res2['newton_iters']} Newton iters)")
        out["rows"] = dict(value=float(res2["objective"]), highs=ref,
                           newton_iters=res2["newton_iters"])

        # --------------------------------------------------------------
        # 3. one SOCP with its cone axis split over the ranks
        # --------------------------------------------------------------
        say("\n[3] cone-sharded single SOCP")
        mesh = make_mesh(axis_names=("cones",))
        n, K, M, meq = 48, 2 * ndev + 1, 12, 6   # K not divisible
        Pp = rng.uniform(-1, 1, (n, n))
        P = Pp.T @ Pp + np.eye(n)
        q = rng.uniform(-1, 1, n)
        x0 = 0.1 * rng.standard_normal(n)
        As = rng.standard_normal((K, M, n))
        bs = rng.standard_normal((K, M))
        cs = rng.standard_normal((K, n))
        ds = np.array([np.linalg.norm(As[j] @ x0 + bs[j]) - cs[j] @ x0 + 1.0
                       for j in range(K)])
        F = rng.standard_normal((meq, n))
        res3 = solve_socp_cone_sharded(mesh, As, bs, cs, ds, P, q, F,
                                       F @ x0, -3.0, 3.0, x0=x0,
                                       epsilon=1e-9)
        x = res3["x"].cpu().numpy()
        worst = max(np.linalg.norm(As[j] @ x + bs[j]) - cs[j] @ x - ds[j]
                    for j in range(K))
        eq_res = float(np.linalg.norm(F @ x - F @ x0))
        say(f"    {K} cones sharded over {mesh.shape['cones']} rank(s) "
            f"(inert padding); objective {float(res3['objective']):.6f}")
        say(f"    worst cone violation {worst:.2e}, equality residual "
            f"{eq_res:.2e}")
        out["cones"] = dict(value=float(res3["objective"]),
                            worst_cone=float(worst), eq_residual=eq_res)

        # --------------------------------------------------------------
        # 3b. the same sharded solves with the Mehrotra engines
        # --------------------------------------------------------------
        say("\n[3b] distributed Mehrotra (algorithm='pd') on both splits")
        mesh = make_mesh(axis_names=("rows",))
        out_pd = solve_lp_row_sharded(mesh, c, A, A @ xf, C, C @ xf + 0.5,
                                      lb=-3.0, ub=3.0, epsilon=1e-8,
                                      algorithm="pd")
        say(f"    row-sharded LP: objective "
            f"{float(out_pd['objective']):.6f} vs HiGHS {ref:.6f} in "
            f"{out_pd['iterations']} pd iterations")
        mesh = make_mesh(axis_names=("cones",))
        out_spd = solve_socp_cone_sharded(mesh, As, bs, cs, ds, P, q, F,
                                          F @ x0, -3.0, 3.0, x0=x0,
                                          epsilon=1e-9, algorithm="pd")
        say(f"    cone-sharded SOCP: objective "
            f"{float(out_spd['objective']):.6f} in "
            f"{out_spd['iterations']} pd iterations")
        out["rows_pd"] = dict(value=float(out_pd["objective"]), highs=ref,
                              iterations=out_pd["iterations"])
        out["cones_pd"] = dict(value=float(out_spd["objective"]),
                               iterations=out_spd["iterations"])

        # --------------------------------------------------------------
        # 4. batched-ADMM LASSO over the samples
        # --------------------------------------------------------------
        say("\n[4] sample-sharded LASSO (batched ADMM)")
        Al = rng.random((64, 12))
        bl = rng.random((64, ndev))
        reg = np.full(ndev, 0.1)
        lres = solve_lasso_sharded(Al, bl, reg, AdmmConfig(dtype="float64"),
                                   mesh_b)
        mean_obj = float(lres.solutions.mean())
        say(f"    {ndev} targets sharded; mean objective {mean_obj:.6f}")
        out["lasso"] = dict(mean_objective=mean_obj,
                            iterations=int(lres.iterations))

        # --------------------------------------------------------------
        # 5. mid-solve checkpoint/resume on the distributed solve
        # --------------------------------------------------------------
        say("\n[5] checkpoint/resume (simulated preemption)")
        mesh = make_mesh(axis_names=("rows",))
        # one path for every rank; rank 0 writes the file
        box = [tempfile.mkdtemp() if rank == 0 else None]
        dist.broadcast_object_list(box, src=0)
        ckpt_dir = box[0]
        ckpt = os.path.join(ckpt_dir, "lp.npz")
        # "job killed" after 3 barrier stages...
        part = solve_lp_row_sharded(mesh, c, A, A @ xf, C, C @ xf + 0.5,
                                    lb=-3.0, ub=3.0, epsilon=1e-8,
                                    max_outer_iters=3, checkpoint_path=ckpt)
        # ...a fresh call picks up from the last completed stage
        out2 = solve_lp_row_sharded(mesh, c, A, A @ xf, C, C @ xf + 0.5,
                                    lb=-3.0, ub=3.0, epsilon=1e-8,
                                    checkpoint_path=ckpt, resume=True)
        say(f"    killed after {part['outer_iters']} stages, resumed to "
            f"{out2['outer_iters']} total; objective "
            f"{float(out2['objective']):.6f} vs HiGHS {ref:.6f}")
        out["resume"] = dict(stages_first=part["outer_iters"],
                             stages_total=out2["outer_iters"],
                             value=float(out2["objective"]), highs=ref,
                             uninterrupted_stages=res2["outer_iters"])

        say("\nall five schemes ran on the same mesh API.")
    finally:
        if ckpt_dir is not None:
            dist.barrier()
            if rank == 0:
                shutil.rmtree(ckpt_dir, ignore_errors=True)
        if created:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
