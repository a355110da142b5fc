"""Worker process of tests/test_torch_multihost.py (not collected by
pytest): one rank of a two-rank gloo group.

    python tests/torch_multihost_worker.py RANK WORLD PORT OUTDIR

Each rank joins the group through ``parallel.initialize`` (device
"cpu": gloo), runs every distributed solve of the port on the instances
below and prints one line per solve,

    RESULT name rank objective outer_iters newton_iters

saving the solve's x as OUTDIR/name_RANK.npy (and the factor of
``dist_cholesky`` as OUTDIR/chol_RANK.npy), then runs
``dryrun_multichip(WORLD)`` and prints one line per surface,

    DRYRUN surface rank shape sum

It imports no JAX."""
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from interiorpoint_tpu_torch import parallel as par  # noqa: E402
from interiorpoint_tpu_torch.parallel.chol import dist_cholesky  # noqa


def lp_instance():
    """n = 24 with 11 equality and 13 inequality rows (neither divides
    2), bounds ±3; the default start (the bound midpoint) violates rows of
    Cx ≤ d, so phase one runs."""
    rng = np.random.default_rng(21)
    n, m, k = 24, 11, 13
    A = rng.uniform(-2, 2, (m, n))
    C = rng.uniform(-2, 2, (k, n))
    xf = rng.uniform(-1, 1, n)
    c = rng.uniform(-2, 2, n)
    return c, A, A @ xf, C, C @ xf + 0.5


def qp_instance():
    """tests/test_parallel.py:196-228's QP (P replicated, 10 and 13 rows)."""
    rng = np.random.default_rng(31)
    n, m, k = 24, 10, 13
    M = rng.uniform(-1, 1, (n, n))
    P = M @ M.T + np.eye(n)
    A = rng.uniform(-2, 2, (m, n))
    C = rng.uniform(-2, 2, (k, n))
    xf = rng.uniform(-1, 1, n)
    c = rng.uniform(-2, 2, n)
    return P, c, A, A @ xf, C, C @ xf + 0.5, xf


def socp_instance():
    """tests/multihost_worker.py's SOCP family with K = 5 cones (padded to
    6 on two ranks), q, bounds ±3 and a strictly feasible x0."""
    rng = np.random.default_rng(23)
    K, M, n = 5, 3, 10
    A = rng.standard_normal((K, M, n))
    b = rng.standard_normal((K, M))
    c = rng.standard_normal((K, n))
    x0 = rng.standard_normal(n) * 0.1
    d = np.array([np.linalg.norm(A[j] @ x0 + b[j]) - c[j] @ x0 + 1.0
                  for j in range(K)])
    q = rng.uniform(-1, 1, n)
    return A, b, c, d, q, x0


def chol_instance():
    rng = np.random.default_rng(5)
    n = 37
    M = rng.standard_normal((n, n))
    return M @ M.T + n * np.eye(n)


LP_KW = dict(lb=-3.0, ub=3.0, epsilon=1e-8)


def main():
    rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    par.initialize(f"localhost:{port}", world, rank, device="cpu",
                   timeout=120)
    rows = par.make_mesh(axis_names=("rows",))
    cones = par.make_mesh(axis_names=("cones",))
    assert rows.shape == {"rows": world}

    def emit(name, res):
        np.save(os.path.join(out, f"{name}_{rank}.npy"),
                res["x"].cpu().numpy())
        print(f"RESULT {name} {rank} {float(res['objective']).hex()} "
              f"{res['outer_iters']} {res['newton_iters']}", flush=True)

    c, A, b, C, d = lp_instance()
    emit("lp", par.solve_lp_row_sharded(rows, c, A, b, C, d, **LP_KW))
    emit("lppd", par.solve_lp_row_sharded(rows, c, A, b, C, d, **LP_KW,
                                          algorithm="pd"))
    # a checkpoint written after 3 stages (rank 0 writes; phase one's
    # sidecar too), then resumed in a fresh call
    path = os.path.join(out, "lp_ck.npz")
    part = par.solve_lp_row_sharded(rows, c, A, b, C, d, **LP_KW,
                                    max_outer_iters=3, checkpoint_path=path)
    assert part["outer_iters"] == 3
    emit("lpck", par.solve_lp_row_sharded(rows, c, A, b, C, d, **LP_KW,
                                          checkpoint_path=path,
                                          resume=True))
    # dist_cholesky inside a two-rank solve: the pd engine's factors
    emit("lpdf", par.solve_lp_row_sharded(rows, c, A, b, C, d, **LP_KW,
                                          algorithm="pd",
                                          distributed_factor=True,
                                          chol_block=8))
    P, c, A, b, C, d, xf = qp_instance()
    emit("qp", par.solve_qp_row_sharded(rows, P, c, A, b, C, d, x0=xf,
                                        **LP_KW))
    A, b, c, d, q, x0 = socp_instance()
    for algo in ("barrier", "pd"):
        emit("socp" + ("pd" if algo == "pd" else ""),
             par.solve_socp_cone_sharded(cones, A, b, c, d, q=q, lb=-3.0,
                                         ub=3.0, x0=x0, epsilon=1e-8,
                                         algorithm=algo))
    L = dist_cholesky(torch.as_tensor(chol_instance()), block=8)
    np.save(os.path.join(out, f"chol_{rank}.npy"), L.numpy())
    # the dry run of every parallel surface on the two ranks
    from interiorpoint_tpu_torch.entry import dryrun_multichip
    for name, x in sorted(dryrun_multichip(world, device="cpu").items()):
        print(f"DRYRUN {name} {rank} {tuple(x.shape)} "
              f"{float(x.double().sum()).hex()}", flush=True)
    print(f"DONE {rank}", flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
