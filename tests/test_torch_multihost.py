"""The port's distributed solves across two processes: two gloo ranks of
tests/torch_multihost_worker.py (one spawn, every solve in it) against
each other and against the JAX package's solves of the same instances on
a 2-device mesh (tests/test_multihost.py's counterpart), and
``dryrun_multichip(2)`` on the same two ranks.

The ranks start first; the JAX references run in this process while
they work.  The process group waits 120 s at most on a collective and
the workers 240 s, so a deadlock fails the test instead of the run."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from interiorpoint_tpu.parallel import chol as chol_j
from interiorpoint_tpu.parallel import distributed as dist_j
from interiorpoint_tpu.parallel import socp_dist as socp_j
from interiorpoint_tpu.parallel.mesh import make_mesh

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_multihost_worker as W  # noqa: E402

NAMES = ("lp", "lppd", "lpck", "lpdf", "qp", "socp", "socppd")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_references(tmp):
    """The same solves through the JAX package on 2 devices."""
    rows, cones = make_mesh(2, ("rows",)), make_mesh(2, ("cones",))
    ref = {}
    c, A, b, C, d = W.lp_instance()
    ref["lp"] = dist_j.solve_lp_row_sharded(rows, c, A, b, C, d, **W.LP_KW)
    ref["lppd"] = dist_j.solve_lp_row_sharded(rows, c, A, b, C, d,
                                              **W.LP_KW, algorithm="pd")
    path = os.path.join(tmp, "jax_ck.npz")
    dist_j.solve_lp_row_sharded(rows, c, A, b, C, d, **W.LP_KW,
                                max_outer_iters=3, checkpoint_path=path)
    ref["lpck"] = dist_j.solve_lp_row_sharded(
        rows, c, A, b, C, d, **W.LP_KW, checkpoint_path=path, resume=True)
    ref["lpdf"] = dist_j.solve_lp_row_sharded(
        rows, c, A, b, C, d, **W.LP_KW, algorithm="pd",
        distributed_factor=True, chol_block=8)
    Pm, c, A, b, C, d, xf = W.qp_instance()
    ref["qp"] = dist_j.solve_qp_row_sharded(rows, Pm, c, A, b, C, d, x0=xf,
                                            **W.LP_KW)
    A, b, c, d, q, x0 = W.socp_instance()
    for algo in ("barrier", "pd"):
        ref["socp" + ("pd" if algo == "pd" else "")] = \
            socp_j.solve_socp_cone_sharded(cones, A, b, c, d, q=q, lb=-3.0,
                                           ub=3.0, x0=x0, epsilon=1e-8,
                                           algorithm=algo)
    f = jax.jit(shard_map(lambda H: chol_j.dist_cholesky(H, "rows", 2, 8),
                          mesh=rows, in_specs=(P(),), out_specs=P(),
                          check_vma=False))
    ref["chol"] = np.asarray(f(jnp.asarray(W.chol_instance())))
    return ref


def test_two_rank_distributed_solves(tmp_path):
    nproc = 2
    port = _free_port()
    worker = os.path.join(HERE, "torch_multihost_worker.py")
    out = tmp_path / "ranks"
    out.mkdir()
    procs = [subprocess.Popen(
        [sys.executable, worker, str(r), str(nproc), str(port), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(nproc)]
    try:
        ref = _jax_references(str(tmp_path))
        outs = []
        for p in procs:
            text, _ = p.communicate(timeout=240)
            outs.append(text)
            assert p.returncode == 0, text
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()

    res = {}
    for text in outs:
        for line in text.splitlines():
            if line.startswith("RESULT "):
                _, name, rank, obj, outer, newton = line.split()
                res[(name, int(rank))] = (float.fromhex(obj), int(outer),
                                          int(newton))
    assert set(res) == {(n, r) for n in NAMES for r in range(nproc)}, outs
    # the dry run: every surface on both ranks, the same replicated result
    dry = {}
    for text in outs:
        for line in text.splitlines():
            if line.startswith("DRYRUN "):
                _, name, rank, rest = line.split(" ", 3)
                dry[(name, int(rank))] = rest
    surfaces = {n for n, _ in dry}
    assert len(surfaces) == 7 and set(dry) == {
        (n, r) for n in surfaces for r in range(nproc)}, outs
    for name in surfaces:
        assert dry[(name, 0)] == dry[(name, 1)], name
        assert "nan" not in dry[(name, 0)] and "inf" not in dry[(name, 0)]

    for name in NAMES:
        (o0, out0, nt0), (o1, out1, nt1) = res[(name, 0)], res[(name, 1)]
        x0 = np.load(out / f"{name}_0.npy")
        x1 = np.load(out / f"{name}_1.npy")
        # the two ranks hold the same replicated result...
        assert (o0, out0, nt0) == (o1, out1, nt1), name
        assert np.array_equal(x0, x1), name
        # ...which is the JAX package's on two devices
        r = ref[name]
        assert o0 == pytest.approx(float(r["objective"]), rel=1e-9), name
        assert out0 == int(r["outer_iters"]), name
        assert nt0 == int(r["newton_iters"]), name
        assert np.abs(x0 - np.asarray(r["x"])).max() < 1e-6, name
    # the resumed solve ends where the uninterrupted one does
    assert res[("lpck", 0)][1:] == res[("lp", 0)][1:]
    assert res[("lpck", 0)][0] == pytest.approx(res[("lp", 0)][0],
                                                rel=1e-9)
    assert os.path.exists(out / "lp_ck.npz.p1")   # phase one checkpointed
    L0, L1 = np.load(out / "chol_0.npy"), np.load(out / "chol_1.npy")
    assert np.array_equal(L0, L1)
    assert np.abs(L0 - ref["chol"]).max() / np.abs(ref["chol"]).max() \
        < 1e-12
