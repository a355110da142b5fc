"""Constraint-row sharding of one large LP/QP over torch.distributed
(counterpart of interiorpoint_tpu/parallel/distributed.py).

Each rank holds the rows of C and A that fall to it (``shard_rows``;
rows padded to a multiple of the world size with inert entries) and runs
the same program on them, one process per device:

  * its partial Hessian C_dᵀ D_d² C_d and gradient, summed by an
    all-reduce into the replicated H and g;
  * the Schur complement from the per-rank panels Y_d = H⁻¹A_dᵀ, joined
    by all-gathers;
  * a replicated (or cooperative, ``parallel/chol.py``) factorization.

The JAX package compiles each solve into one ``shard_map`` program of
``lax.while_loop``s; here the loops run on the host, as in every other
engine of the port, and the collectives are those of ``comm.py`` (one
for one with ``psum``/``all_gather``/``pmax``).  Every branch is decided
from a replicated value, one that came out of an all-reduce or was
computed from such values alike on every rank, read to the host once per
Newton step through ``ops/sync.py``: a rank-local decision would let the
ranks part ways and hang the next collective.  The work is plain torch
(``torch.linalg`` factors, ``torch.matmul``): the JAX programs reach no
Pallas kernel.

``initialize`` starts the process group: NCCL for the card, gloo for the
CPU, never one in place of the other.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..models.base import default_device
from ..ops import sync
from ..ops.barrier import SLACK_EPS
from ..utils.checkpoint import _atomic_savez
from . import comm
from .chol import cholesky_or_nan, dist_cholesky

_F64 = torch.float64


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, *, device=None, timeout=None):
    """Join ``num_processes`` processes into the default process group
    (``torch.distributed.init_process_group`` at
    ``tcp://{coordinator_address}``, rank ``process_id``): NCCL when
    ``device`` is CUDA (default ``default_device()``), gloo for
    ``device="cpu"``.  No-op for one process or when a group exists.
    ``timeout``: seconds a collective may wait."""
    if num_processes is None or num_processes <= 1:
        return
    if dist.is_initialized():
        return  # already initialized (retrying launchers call this twice)
    dev = torch.device(device) if device is not None else default_device()
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(timeout))
    if dev.type == "cuda":
        local = int(os.environ.get(
            "LOCAL_RANK", process_id % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id), **kw)


def _layout(mesh, axis):
    """(positions, this rank's position, its device) of a sharded solve:
    one rank per position of ``axis``."""
    ndev = mesh.shape[axis]
    if ndev != comm.world_size():
        raise ValueError(
            f"a sharded solve over {ndev} positions of {axis!r} runs as "
            f"{ndev} ranks of torch.distributed, not "
            f"{comm.world_size()}: call initialize() in each process and "
            "build the mesh with make_mesh()")
    rank = comm.axis_index()
    return ndev, rank, mesh.position_device(axis, rank)


def _t(v, dev, dtype=_F64):
    if isinstance(v, torch.Tensor):
        return v.to(dtype=dtype, device=dev)
    return torch.as_tensor(np.asarray(v), dtype=dtype, device=dev)


def shard_rows(mesh, arr, axis: str = "rows"):
    """This rank's block of the rows of ``arr`` (the row count must
    divide the axis), on its device."""
    ndev = mesh.shape[axis]
    rank = comm.axis_index()
    dev = mesh.position_device(axis, rank)
    arr = arr if isinstance(arr, torch.Tensor) else torch.as_tensor(
        np.asarray(arr))
    if arr.shape[0] % ndev:
        raise ValueError(f"{arr.shape[0]} rows do not divide {ndev} "
                         "positions")
    rows = arr.shape[0] // ndev
    return arr[rank * rows:(rank + 1) * rows].to(dev)


def _pad_rows(arr, rows, fill=0.0):
    out = torch.full((rows,) + tuple(arr.shape[1:]), fill, dtype=arr.dtype,
                     device=arr.device)
    out[:arr.shape[0]] = arr
    return out


def _trisolve(L, B, upper):
    vec = B.ndim == 1
    out = torch.linalg.solve_triangular(L, B[:, None] if vec else B,
                                        upper=upper)
    return out[:, 0] if vec else out


def make_factor_tools(distributed_factor: bool, chol_block: int):
    """A ``_make_solve(M, dtype, f32_factor=False)`` factory for SPD solves
    of the sharded programs: it factors M (replicated, or cooperatively
    with ``dist_cholesky`` when ``distributed_factor``) and returns
    ``solve(B)`` in the iterate type.  With ``f32_factor`` the factor and
    the triangular solves run in fp32 on the Jacobi-scaled matrix (unit
    diagonal); the callers' refinement restores the accuracy."""

    def _chol(M):
        if distributed_factor:
            return dist_cholesky(M, block=chol_block)
        return cholesky_or_nan(M)

    def _make_solve(M, dtype, f32_factor=False):
        if f32_factor and dtype != torch.float32:
            dsc = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(M),
                                               min=1e-300))
            Lf = _chol((dsc[:, None] * M * dsc[None, :]).float())

            def solve(B):
                vec = B.ndim == 1
                B2 = B[:, None] if vec else B
                Y = _trisolve(Lf, (dsc[:, None] * B2).float(), False)
                Z = _trisolve(Lf.T, Y, True)
                out = dsc[:, None] * Z.to(dtype)
                return out[:, 0] if vec else out
        else:
            Lf = _chol(M)

            def solve(B):
                return _trisolve(Lf.T, _trisolve(Lf, B, False), True)
        return solve

    return _make_solve


def row_sharded_lp_newton_step(mesh, axis: str = "rows"):
    """The infeasible-start LP Newton step with the rows of C and A
    sharded over ``axis``: returns step(c, A, b, C, d, lb, ub, x, v, t)
    -> (x_new, v_new, resid), with A, b, C, d this rank's row blocks
    (``shard_rows``) and the rest replicated.  As the JAX package's
    single-step demo: finite bounds, row counts that divide the axis, a
    fixed damped step (the full solve is ``solve_lp_row_sharded``)."""
    _layout(mesh, axis)

    def step(c, A, b, C, d, lb, ub, x, v, t):
        psum = comm.psum
        gather0 = comm.all_gather0
        # slacks and gradient: per-shard inequality rows, summed
        s_C = d - C @ x
        inv_C = 1.0 / (s_C + SLACK_EPS)
        g = psum(C.T @ inv_C)
        g = g + t * c + 1.0 / (ub - x + SLACK_EPS) \
            - 1.0 / (x - lb + SLACK_EPS)
        # Hessian: partial CᵀD²C summed, replicated bound diagonal
        H = psum(C.T @ (inv_C[:, None] ** 2 * C))
        db = 1.0 / (ub - x + SLACK_EPS) ** 2 + 1.0 / (x - lb + SLACK_EPS) ** 2
        H = H + torch.diag(db)
        L = cholesky_or_nan(H)

        def solve(B):
            return _trisolve(L.T, _trisolve(L, B, False), True)

        # Schur panels: local solve, all-gather
        rpri_local = A @ x - b
        Y = comm.all_gather1(solve(A.T))
        Hinv_g = solve(g)
        S = gather0(A @ Y)
        S = 0.5 * (S + S.T)
        rhs = gather0(rpri_local) - gather0(A @ Hinv_g)
        Ls = cholesky_or_nan(S)
        w = _trisolve(Ls.T, _trisolve(Ls, rhs, False), True)
        # back-substitution: Aᵀw sums over the sharded rows
        m_local = A.shape[0]
        idx = comm.axis_index() * m_local
        w_local = w[idx:idx + m_local]
        dx = -solve(g + psum(A.T @ w_local))
        dv = w - v
        # fixed damped step: the largest σ keeping every slack positive
        ds_C = C @ dx
        inf = torch.full_like(s_C, float("inf"))
        limit_local = torch.where(ds_C > 0, s_C / ds_C, inf).amin()
        infx = torch.full_like(x, float("inf"))
        limit_bound = torch.minimum(
            torch.where(dx > 0, (ub - x) / dx, infx).amin(),
            torch.where(dx < 0, (lb - x) / dx, infx).amin())
        limit = torch.minimum(comm.pmin(limit_local), limit_bound)
        sigma = torch.clamp(0.99 * limit, max=1.0)
        x_new = x + sigma * dx
        v_new = v + sigma * dv
        # KKT residual at the new iterate
        s_C_new = d - C @ x_new
        g_new = psum(C.T @ (1.0 / (s_C_new + SLACK_EPS)))
        g_new = g_new + t * c + 1.0 / (ub - x_new + SLACK_EPS) \
            - 1.0 / (x_new - lb + SLACK_EPS)
        r_dual = g_new + psum(A.T @ v_new[idx:idx + m_local])
        rpri_sq = psum(((A @ x_new - b) ** 2).sum())
        resid = torch.sqrt((r_dual ** 2).sum() + rpri_sq)
        return x_new, v_new, resid

    return step


def _row_sharded_barrier(*, m_true: int, num_ineq: int, mu: float,
                         eps: float, inner_eps: float, alpha: float,
                         beta: float, J: int, max_inner: int,
                         has_P: bool = False, distributed_factor=False,
                         factor_dtype: str = "float64",
                         chol_block: int = 256):
    """The distributed LP/QP barrier program as a function
    prog(c, Pm, A, b, C, d, lb, ub, x0, v0, t0, max_outer) ->
    (x, v, objective, outer_iters, newton_iters, t_final, done), run by
    every rank on its row blocks: the outer t-loop and the inner
    infeasible-start Newton loop with the residual-backtracking candidate
    sweep of ops/newton.py ``newton_infeasible``.

    Row padding is inert: padded C rows are zero with slack 1, padded A
    rows zero with b = 0 and +1 on the Schur diagonal.  Absent bounds are
    ±inf vectors whose IEEE limits make every bound term a no-op.
    ``has_P``: the QP objective ½xᵀPx + cᵀx, P replicated.
    ``distributed_factor``: the factors by ``dist_cholesky``;
    ``factor_dtype="float32"``: the Jacobi-scaled fp32 factor, one more
    refinement round, and the fp64 factor when the refined residual
    stalls above 1e-16 of the right-hand side."""
    mixed = factor_dtype == "float32"
    _make_solve = make_factor_tools(distributed_factor, chol_block)
    psum = comm.psum
    gather0 = comm.all_gather0

    def prog(c, Pm, A, b, C, d, lb, ub, x0, v0, t0, max_outer):
        dtype, dev = x0.dtype, x0.device
        sig = beta ** torch.arange(J, dtype=dtype, device=dev)
        m_local = A.shape[0]
        idx = comm.axis_index() * m_local
        zero = torch.zeros((), dtype=dtype, device=dev)

        def newton_step(t, x, v):
            s_C = d - C @ x
            inv_C = 1.0 / (s_C + SLACK_EPS)
            g = psum(C.T @ inv_C)
            grad0 = (Pm @ x + c) if has_P else c
            g = g + t * grad0 + 1.0 / (ub - x + SLACK_EPS) \
                - 1.0 / (x - lb + SLACK_EPS)
            H = psum(C.T @ (inv_C[:, None] ** 2 * C))
            db = (1.0 / (ub - x + SLACK_EPS) ** 2
                  + 1.0 / (x - lb + SLACK_EPS) ** 2)
            H = H + torch.diag(db)
            if has_P:
                H = H + t * Pm
            rpri_local = A @ x - b

            def kkt_apply(dx, w_l):
                """The KKT operator at (dx, w): (H dx + Aᵀw, A dx)."""
                Hdx = psum(C.T @ (inv_C ** 2 * (C @ dx))) + db * dx
                if has_P:
                    Hdx = Hdx + t * (Pm @ dx)
                return Hdx + psum(A.T @ w_l), A @ dx

            def direction(f32_factor):
                """Factor H and the Schur complement, eliminate for
                (dx, w), refine against the true residuals."""
                solve = _make_solve(H, dtype, f32_factor)
                Y = comm.all_gather1(solve(A.T))     # (n, m) panels
                S = gather0(A @ Y)
                S = 0.5 * (S + S.T)
                mg = S.shape[0]
                # +1 on padded rows; a trace-relative jitter keeps the
                # factor finite where A·H⁻¹·Aᵀ turns indefinite
                pad_diag = (torch.arange(mg, device=dev)
                            >= m_true).to(dtype)
                jit_s = 1e-13 * torch.diagonal(S).amax()
                S = S + torch.diag(pad_diag + jit_s)
                solve_S = _make_solve(S, dtype, f32_factor)
                rhs = gather0(rpri_local) - gather0(A @ solve(g))
                w = solve_S(rhs)
                dx = -solve(g + psum(A.T @ w[idx:idx + m_local]))
                for _ in range(3 if f32_factor else 2):
                    dual, Adx = kkt_apply(dx, w[idx:idx + m_local])
                    r1 = -g - dual
                    r2_local = -rpri_local - Adx
                    f = solve_S(gather0(A @ solve(r1)) - gather0(r2_local))
                    e = solve(r1 - psum(A.T @ f[idx:idx + m_local]))
                    dx = dx + e
                    w = w + f
                return dx, w

            if mixed:
                dx, w = direction(True)
                dual, _ = kkt_apply(dx, w[idx:idx + m_local])
                r1n = ((g + dual) ** 2).sum()
                r2n = psum(((rpri_local + A @ dx) ** 2).sum())
                scale = ((g ** 2).sum() + psum((rpri_local ** 2).sum())
                         + 1e-300)
                if not sync.read((r1n + r2n) < 1e-16 * scale):
                    dx, w = direction(False)
            else:
                dx, w = direction(False)
            dv = w - v

            # the residual-backtracking candidate sweep
            ATv = psum(A.T @ v[idx:idx + m_local])
            ATdv = psum(A.T @ dv[idx:idx + m_local])
            Adx_local = A @ dx
            ds_C = C @ dx
            r0 = torch.sqrt(((g + ATv) ** 2).sum()
                            + psum((rpri_local ** 2).sum()))
            inf = torch.full_like(s_C, float("inf"))
            umax = comm.pmax(torch.where(s_C > 0, ds_C / (s_C + SLACK_EPS),
                                         inf).amax())
            zx = torch.zeros_like(x)
            ub_u = torch.where(dx > 0, dx / (ub - x + SLACK_EPS), zx).amax()
            lb_u = torch.where(dx < 0, -dx / (x - lb + SLACK_EPS), zx).amax()
            umax = torch.maximum(umax, torch.maximum(ub_u, lb_u))
            domain = sig * umax < 1.0 - 1e-9
            cand_inv = 1.0 / (s_C[:, None] - sig[None, :] * ds_C[:, None]
                              + SLACK_EPS)                    # (k_l, J)
            gb_cand = psum(C.T @ cand_inv)                     # (n, J)
            xc = x[:, None] + sig[None, :] * dx[:, None]       # (n, J)
            if has_P:
                grad0_cand = grad0[:, None] + sig[None, :] * (Pm @ dx)[:,
                                                                       None]
            else:
                grad0_cand = c[:, None]
            g_cand = (gb_cand + t * grad0_cand
                      + 1.0 / (ub[:, None] - xc + SLACK_EPS)
                      - 1.0 / (xc - lb[:, None] + SLACK_EPS))
            r_dual = g_cand + ATv[:, None] + sig[None, :] * ATdv[:, None]
            pri_sq = psum(((rpri_local[:, None]
                            + sig[None, :] * Adx_local[:, None]) ** 2
                           ).sum(dim=0))
            rn = torch.sqrt((r_dual ** 2).sum(dim=0) + pri_sq)
            accept = domain & (rn <= (1.0 - alpha * sig) * r0)
            any_acc = accept.any()
            j = torch.argmax(accept.to(torch.int8))
            sigma = torch.where(any_acc, sig[j], zero)
            # a failed factor must stall the stage, not poison the iterate
            x_new = torch.where(any_acc, x + sigma * dx, x)
            v_new = torch.where(any_acc, v + sigma * dv, v)
            res_new = torch.where(any_acc, rn[j], r0)
            acc, res = sync.read_list(torch.stack([any_acc.to(dtype),
                                                   res_new]))
            return x_new, v_new, acc != 0.0, res

        def newton_loop(x, v, t):
            it, done = 0, False
            while not done and it < max_inner:
                x, v, acc, res = newton_step(t, x, v)
                done = (not acc) or res < inner_eps
                it += 1
            return x, v, it

        x, v, t = x0, v0, float(t0)
        it, total_nt, done = 0, 0, False
        while not done and it < max_outer:
            x, v, nt = newton_loop(x, v, t)
            # duality gap after centering at t
            done = num_ineq / t < eps
            t, it, total_nt = t * mu, it + 1, total_nt + nt
        obj = c @ x + (0.5 * x @ (Pm @ x) if has_P else 0.0)
        return x, v, sync.read(obj), it, total_nt, t, done

    return prog


def solve_lp_row_sharded(mesh, c, A, b, C, d, lb=None, ub=None, *,
                         x0=None, t0=1.0, mu=15.0, epsilon=1e-8,
                         inner_epsilon=1e-8, alpha=0.2, beta=0.6,
                         max_linesearch_steps=40, max_outer_iters=30,
                         max_inner_iters=60, axis: str = "rows",
                         distributed_factor=False,
                         factor_dtype="float64", chol_block=256,
                         phase1="auto", checkpoint_path=None,
                         checkpoint_every=1, resume=False,
                         algorithm="barrier", pd_max_iters=60):
    """Distributed LP solve with the constraint rows sharded over the
    mesh's ranks: min cᵀx s.t. Ax = b, Cx ≤ d, lb ≤ x ≤ ub.

    Every rank calls it with the same data and gets the same replicated
    result.  ``algorithm="pd"`` dispatches to the distributed Mehrotra
    solve (``pd_dist.solve_pd_row_sharded``; no phase one, no
    checkpoints).  The barrier: row counts need not divide the mesh
    (inert padding), bounds are optional; ``x0`` defaults to the bound
    midpoint or zeros, and with ``phase1="auto"`` (or True) a start that
    is not strictly feasible goes through the distributed phase one,
    which raises ValueError when the problem is infeasible.
    ``distributed_factor``/``factor_dtype``: see ``_row_sharded_barrier``.
    ``checkpoint_path``: the outer loop runs in chunks of
    ``checkpoint_every`` stages, rank 0 writing the state after each;
    ``resume=True`` continues from it (a job killed in phase one resumes
    phase one from the ``.p1`` sidecar).  Returns a dict with x, v (the
    true equality rows), objective, outer_iters, newton_iters."""
    if algorithm == "pd":
        if checkpoint_path is not None:
            raise ValueError("algorithm='pd' does not support mid-solve "
                             "checkpointing (solves are 15-40 iterations)")
        from .pd_dist import solve_pd_row_sharded
        return solve_pd_row_sharded(
            mesh, c, A, b, C, d, lb, ub, x0=x0, epsilon=epsilon,
            max_iters=pd_max_iters, axis=axis,
            distributed_factor=distributed_factor,
            factor_dtype=factor_dtype, chol_block=chol_block)
    if algorithm != "barrier":
        raise ValueError(f"unknown algorithm {algorithm!r}")
    return _solve_row_sharded(
        mesh, None, c, A, b, C, d, lb, ub, x0=x0, t0=t0, mu=mu,
        epsilon=epsilon, inner_epsilon=inner_epsilon, alpha=alpha,
        beta=beta, max_linesearch_steps=max_linesearch_steps,
        max_outer_iters=max_outer_iters, max_inner_iters=max_inner_iters,
        axis=axis, distributed_factor=distributed_factor,
        factor_dtype=factor_dtype, chol_block=chol_block, phase1=phase1,
        checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume)


def solve_qp_row_sharded(mesh, P_obj, c, A, b, C, d, lb=None, ub=None, *,
                         x0=None, t0=1.0, mu=15.0, epsilon=1e-8,
                         inner_epsilon=1e-8, alpha=0.2, beta=0.6,
                         max_linesearch_steps=40, max_outer_iters=30,
                         max_inner_iters=60, axis: str = "rows",
                         distributed_factor=False,
                         factor_dtype="float64", chol_block=256,
                         phase1="auto", checkpoint_path=None,
                         checkpoint_every=1, resume=False,
                         algorithm="barrier", pd_max_iters=60):
    """Distributed QP solve: min ½xᵀPx + cᵀx s.t. Ax = b, Cx ≤ d,
    lb ≤ x ≤ ub, P (PSD) replicated; otherwise as
    ``solve_lp_row_sharded``."""
    if algorithm == "pd":
        if checkpoint_path is not None:
            raise ValueError("algorithm='pd' does not support mid-solve "
                             "checkpointing (solves are 15-40 iterations)")
        from .pd_dist import solve_pd_row_sharded
        return solve_pd_row_sharded(
            mesh, c, A, b, C, d, lb, ub, P_obj=P_obj, x0=x0,
            epsilon=epsilon, max_iters=pd_max_iters, axis=axis,
            distributed_factor=distributed_factor,
            factor_dtype=factor_dtype, chol_block=chol_block)
    if algorithm != "barrier":
        raise ValueError(f"unknown algorithm {algorithm!r}")
    return _solve_row_sharded(
        mesh, P_obj, c, A, b, C, d, lb, ub, x0=x0, t0=t0, mu=mu,
        epsilon=epsilon, inner_epsilon=inner_epsilon, alpha=alpha,
        beta=beta, max_linesearch_steps=max_linesearch_steps,
        max_outer_iters=max_outer_iters, max_inner_iters=max_inner_iters,
        axis=axis, distributed_factor=distributed_factor,
        factor_dtype=factor_dtype, chol_block=chol_block, phase1=phase1,
        checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume)


def _row_sharded_phase1(mesh, A, b, C, d, lb_v, ub_v, x0, *, axis,
                        distributed_factor, factor_dtype, chol_block,
                        checkpoint_path=None, checkpoint_every=1,
                        resume=False):
    """Distributed phase one: a strictly feasible point of Cx ≤ d (within
    the box) from the extended LP  min s  s.t.  Ax = b, Cx − s·1 ≤ d,
    lb ≤ x ≤ ub, s ≥ −1,  solved by the same row-sharded barrier from
    the strictly feasible start (x₀ clamped into the box,
    s₀ = max(Cx₀ − d) + 1).  Raises ValueError when s* ≥ 0 certifies
    infeasibility."""
    n = x0.shape[0]
    dtype, dev = x0.dtype, x0.device
    lo = torch.clamp(lb_v, min=-1e12)
    hi = torch.clamp(ub_v, max=1e12)
    x0c = torch.clamp(x0, lo + 1e-6 * (hi - lo), hi - 1e-6 * (hi - lo))
    s0 = torch.clamp((C @ x0c - d).amax() + 1.0, min=0.0)

    c_ext = torch.zeros(n + 1, dtype=dtype, device=dev)
    c_ext[n] = 1.0
    A_ext = torch.cat([A, torch.zeros((A.shape[0], 1), dtype=dtype,
                                      device=dev)], dim=1)
    C_ext = torch.cat([C, -torch.ones((C.shape[0], 1), dtype=dtype,
                                      device=dev)], dim=1)
    lb_ext = torch.cat([lb_v, torch.full((1,), -1.0, dtype=dtype,
                                         device=dev)])
    ub_ext = torch.cat([ub_v, torch.full((1,), float("inf"), dtype=dtype,
                                         device=dev)])
    z0 = torch.cat([x0c, s0.reshape(1)])

    res = _solve_row_sharded(
        mesh, None, c_ext, A_ext, b, C_ext, d, lb_ext, ub_ext, x0=z0,
        t0=1.0, mu=15.0, epsilon=1e-6, inner_epsilon=1e-8, alpha=0.2,
        beta=0.6, max_linesearch_steps=40, max_outer_iters=30,
        max_inner_iters=60, axis=axis,
        distributed_factor=distributed_factor, factor_dtype=factor_dtype,
        chol_block=chol_block, phase1=False,
        checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume)
    z = res["x"].cpu().numpy()
    if not np.isfinite(z).all() or z[n] >= 0:
        raise ValueError(
            "Phase 1 did not find a strictly feasible point (optimal "
            f"infeasibility s* = {z[n]:.3e} >= 0): problem infeasible")
    x1 = z[:n]
    # re-validate: a stalled deep-barrier stage can still return a
    # boundary-grazing iterate
    Cn, dn = C.cpu().numpy(), d.cpu().numpy()
    slack_min = min(
        float(np.min(dn - Cn @ x1)) if Cn.shape[0] else np.inf,
        float(np.min(ub_v.cpu().numpy() - x1)),
        float(np.min(x1 - lb_v.cpu().numpy())))
    if not slack_min > 0:
        raise ValueError(
            "Phase 1 terminated with s* < 0 but a non-positive slack "
            f"(min slack {slack_min:.3e}); the problem is feasible but "
            "barely — tighten phase-1 epsilon or supply a feasible x0")
    return torch.as_tensor(x1, dtype=dtype, device=dev)


def _bound_vectors(lb, ub, n, dtype, dev):
    lb_v = (torch.full((n,), -float("inf"), dtype=dtype, device=dev)
            if lb is None else _t(lb, dev, dtype).expand(n).clone())
    ub_v = (torch.full((n,), float("inf"), dtype=dtype, device=dev)
            if ub is None else _t(ub, dev, dtype).expand(n).clone())
    return lb_v, ub_v


def _solve_row_sharded(mesh, P_obj, c, A, b, C, d, lb, ub, *, x0, t0, mu,
                       epsilon, inner_epsilon, alpha, beta,
                       max_linesearch_steps, max_outer_iters,
                       max_inner_iters, axis, distributed_factor=False,
                       factor_dtype="float64", chol_block=256,
                       phase1="auto", checkpoint_path=None,
                       checkpoint_every=1, resume=False):
    ndev, rank, dev = _layout(mesh, axis)
    c = _t(c, dev)
    n = c.shape[0]
    dtype = c.dtype
    A, b, C, d = (_t(v, dev) for v in (A, b, C, d))
    m_true, k_true = A.shape[0], C.shape[0]
    num_ineq = k_true + (n if lb is not None else 0) \
        + (n if ub is not None else 0)

    # at least one (inert) row per shard: no equalities or no
    # inequalities must not give empty shards
    mp = max(-(-m_true // ndev) * ndev, ndev)
    kp = max(-(-k_true // ndev) * ndev, ndev)
    A_p, b_p = _pad_rows(A, mp), _pad_rows(b, mp)
    C_p, d_p = _pad_rows(C, kp), _pad_rows(d, kp, fill=1.0)

    lb_v, ub_v = _bound_vectors(lb, ub, n, dtype, dev)
    if x0 is None:
        x0 = (0.5 * (lb_v + ub_v) if lb is not None and ub is not None
              else torch.zeros(n, dtype=dtype, device=dev))
    x0 = _t(x0, dev, dtype)

    # a resumed iterate replaces x0 before the feasibility gate (it is
    # strictly feasible for the data it was written against)
    ck_state = _load_checkpoint(checkpoint_path, resume)
    if ck_state is not None:
        x0 = _t(ck_state["x"], dev, dtype)

    # strict-feasibility gate (phase1=True behaves as "auto")
    if phase1 == "auto" or phase1 is True:
        parts = [ub_v - x0, x0 - lb_v]
        if k_true:
            parts.insert(0, d - C @ x0)
        slack_min = sync.read(torch.cat(parts).amin())
        if not slack_min > 0:
            x0 = _row_sharded_phase1(
                mesh, A, b, C, d, lb_v, ub_v, x0, axis=axis,
                distributed_factor=distributed_factor,
                factor_dtype=factor_dtype, chol_block=chol_block,
                checkpoint_path=(None if checkpoint_path is None
                                 else checkpoint_path + ".p1"),
                checkpoint_every=checkpoint_every, resume=resume)
            # the gate firing on a resumed iterate means the data changed
            # since the checkpoint: restart the schedule from phase one's
            # point
            ck_state = None
    v0 = torch.zeros(mp, dtype=dtype, device=dev)

    has_P = P_obj is not None
    Pm = _t(P_obj, dev, dtype) if has_P else torch.zeros((1, 1),
                                                         dtype=dtype,
                                                         device=dev)
    prog = _row_sharded_barrier(
        m_true=m_true, num_ineq=num_ineq, mu=float(mu), eps=float(epsilon),
        inner_eps=float(inner_epsilon), alpha=float(alpha),
        beta=float(beta), J=int(max_linesearch_steps),
        max_inner=int(max_inner_iters), has_P=has_P,
        distributed_factor=bool(distributed_factor),
        factor_dtype=factor_dtype, chol_block=int(chol_block))
    ml, kl = mp // ndev, kp // ndev
    operands = (c, Pm, A_p[rank * ml:(rank + 1) * ml],
                b_p[rank * ml:(rank + 1) * ml],
                C_p[rank * kl:(rank + 1) * kl],
                d_p[rank * kl:(rank + 1) * kl], lb_v, ub_v)

    def prog_call(x, v, t, max_outer):
        return prog(*operands, x, v, t, max_outer)

    x, v, obj, outer_it, total_nt = _dispatch_barrier(
        prog_call, x0, v0, float(t0), int(max_outer_iters),
        checkpoint_path, int(checkpoint_every), ck_state)
    return dict(x=x, v=v[:m_true], objective=obj, outer_iters=outer_it,
                newton_iters=total_nt)


def _load_checkpoint(path, resume):
    """The mid-solve checkpoint's arrays, or None when not resuming or
    absent.  Every rank waits for the others first, so that rank 0's last
    write is in place before any rank reads."""
    if path is None or not resume:
        return None
    comm.barrier()
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _dispatch_barrier(prog_call, x0, v0, t0, max_outer, path,
                      checkpoint_every, ck_state):
    """Run the distributed barrier program: in one call without a
    checkpoint path, else in chunks of min(``checkpoint_every``,
    remaining budget) stages with the state (x, v, t, counters,
    objective, done) written by rank 0 after each chunk.  Shared by the
    row-sharded LP/QP and the cone-sharded SOCP solves."""
    if path is None:
        x, v, obj, outer_it, total_nt, _, _ = prog_call(x0, v0, t0,
                                                        max_outer)
        return x, v, obj, outer_it, total_nt
    if checkpoint_every < 1:
        raise ValueError(
            f"checkpoint_every must be >= 1, got {checkpoint_every}")
    outer_it, total_nt, t_cur = 0, 0, t0
    obj, done = None, False
    x, v = x0, v0
    if ck_state is not None:
        x = torch.as_tensor(ck_state["x"], device=x0.device)
        v = torch.as_tensor(ck_state["v"], device=x0.device)
        t_cur = float(ck_state["t"])
        outer_it = int(ck_state["outer_iters"])
        total_nt = int(ck_state["newton_iters"])
        obj = float(ck_state["objective"])
        done = bool(ck_state["done"])
    is_writer = comm.axis_index() == 0
    while not done and outer_it < max_outer:
        stages = min(checkpoint_every, max_outer - outer_it)
        x, v, obj, oit, nt, t_cur, done = prog_call(x, v, t_cur, stages)
        outer_it += oit
        total_nt += nt
        if is_writer:
            _atomic_savez(path, dict(
                x=x.cpu().numpy(), v=v.cpu().numpy(), t=np.asarray(t_cur),
                outer_iters=np.asarray(outer_it),
                newton_iters=np.asarray(total_nt),
                objective=np.asarray(float(obj)), done=np.asarray(done)))
    if obj is None:
        # the loop never ran (max_outer_iters=0, no earlier checkpoint):
        # the objective of the start from a zero-stage call
        x, v, obj, _, _, _, _ = prog_call(x, v, t_cur, 0)
    return x, v, obj, outer_it, total_nt
