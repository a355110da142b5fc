"""Cone-axis sharding of one large SOCP over torch.distributed
(counterpart of interiorpoint_tpu/parallel/socp_dist.py).

The stacked cone tensors A (K, M, n), b (K, M), c (K, n), d (K,) are
split over the ranks on the cone axis (``shard_cones``), so each rank
evaluates its cones' share of the barrier oracle: the curvature
Σ_k w_k(A_kᵀA_k + c_kc_kᵀ) and the (K, M, n) contractions, summed by an
all-reduce at the gradient, Hessian and candidate-gradient points.  The
equality block F stays replicated and feeds a replicated (or
cooperative, ``parallel/chol.py``) factorization.  The outer t-loop and
the infeasible-start Newton loop with its residual-backtracking sweep
run on the host, one replicated host read per Newton step, as in
``distributed.py``; the work is plain torch (the JAX program reaches no
Pallas kernel).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import sync
from ..ops.barrier import SLACK_EPS, SOCP_SLACK_EPS
from . import comm
from .distributed import (_bound_vectors, _dispatch_barrier, _layout,
                          _load_checkpoint, _t, make_factor_tools)


def shard_cones(mesh, arr, axis: str = "cones"):
    """This rank's block of the cone axis of a stacked cone tensor (the
    cone count must divide the axis), on its device."""
    from .distributed import shard_rows
    return shard_rows(mesh, arr, axis)


def _pad_cones(A, b, c, d, Kp):
    """Pad the stacked cone tensors to Kp cones with inert entries:
    A = 0, b = 0, c = 0, d = 1 keeps the slack at 1 (no gradient force,
    no curvature, every candidate positive)."""
    K, M, n = A.shape
    kw = dict(dtype=A.dtype, device=A.device)
    A_p = torch.zeros((Kp, M, n), **kw)
    b_p = torch.zeros((Kp, M), **kw)
    c_p = torch.zeros((Kp, n), **kw)
    d_p = torch.ones((Kp,), **kw)
    A_p[:K], b_p[:K], c_p[:K], d_p[:K] = A, b, c, d
    return A_p, b_p, c_p, d_p


def _cone_sharded_barrier(*, m_true: int, num_ineq: int, mu: float,
                          eps: float, inner_eps: float, alpha: float,
                          beta: float, J: int, max_inner: int, has_P: bool,
                          has_q: bool, distributed_factor=False,
                          factor_dtype: str = "float64",
                          chol_block: int = 256):
    """The distributed SOCP barrier program as a function
    prog(q, Pm, A, b, c, d, F, g, lb, ub, x0, v0, t0, max_outer) ->
    (x, v, objective, outer_iters, newton_iters, t_final, done) over this
    rank's cones.  The squared-cone barrier of ops/socp.py:
    slack_k = (c_kᵀx + d_k)² − ‖A_kx + b_k‖², the rhs c_kᵀx + d_k in the
    domain only, the curvature with the reference's +c_kc_kᵀ sign.  The
    equality block is padded to ≥ 1 row with zero rows carrying +1 on the
    Schur diagonal, so no F runs the same program.  ``factor_dtype`` and
    ``distributed_factor`` as in the row-sharded LP program."""
    mixed = factor_dtype == "float32"
    _make_solve = make_factor_tools(distributed_factor, chol_block)
    psum = comm.psum

    def prog(q, Pm, A, b, cv, d, F, g_eq, lb, ub, x0, v0, t0, max_outer):
        dtype, dev = x0.dtype, x0.device
        n = x0.shape[0]
        mg = F.shape[0]
        sig = beta ** torch.arange(J, dtype=dtype, device=dev)
        pad_diag = (torch.arange(mg, device=dev) >= m_true).to(dtype)
        zero = torch.zeros((), dtype=dtype, device=dev)

        def lin_grad(x):
            g0 = torch.zeros(n, dtype=dtype, device=dev)
            if has_P:
                g0 = g0 + Pm @ x
            if has_q:
                g0 = g0 + q
            return g0

        def newton_step(t, x, v):
            # the local cone oracle over this rank's cones
            lhs = torch.einsum("kmn,n->km", A, x) + b          # (K_l, M)
            rhs = cv @ x + d                                   # (K_l,)
            slack = rhs ** 2 - (lhs ** 2).sum(dim=-1)
            w = 2.0 / (slack + SOCP_SLACK_EPS)
            G0 = torch.einsum("kmn,km->kn", A, lhs) - cv * rhs[:, None]
            g = psum(w @ G0)
            g = g + t * lin_grad(x) + 1.0 / (ub - x + SLACK_EPS) \
                - 1.0 / (x - lb + SLACK_EPS)
            # Σ_k w_k (A_kᵀA_k + c_kc_kᵀ) + Σ_k outer(w_k G_k)
            sw = torch.sqrt(w)
            B = (sw[:, None, None] * A).reshape(-1, n)
            cw = sw[:, None] * cv
            Gw = w[:, None] * G0
            H = psum(B.T @ B + cw.T @ cw + Gw.T @ Gw)
            db = (1.0 / (ub - x + SLACK_EPS) ** 2
                  + 1.0 / (x - lb + SLACK_EPS) ** 2)
            H = H + torch.diag(db)
            if has_P:
                H = H + t * Pm
            rpri = F @ x - g_eq                                # replicated

            def direction(f32_factor):
                """Block elimination on the replicated KKT system and
                refinement against the true residuals."""
                solve = _make_solve(H, dtype, f32_factor)
                S = F @ solve(F.T)
                S = 0.5 * (S + S.T)
                jit_s = 1e-13 * (torch.diagonal(S) + pad_diag).amax()
                S = S + torch.diag(pad_diag + jit_s)
                solve_S = _make_solve(S, dtype, f32_factor)
                wv = solve_S(rpri - F @ solve(g))
                dx = -solve(g + F.T @ wv)
                for _ in range(3 if f32_factor else 2):
                    r1 = -g - (H @ dx + F.T @ wv)
                    r2 = -rpri - F @ dx
                    f = solve_S(F @ solve(r1) - r2)
                    dx = dx + solve(r1 - F.T @ f)
                    wv = wv + f
                return dx, wv

            if mixed:
                dx, wv = direction(True)
                r1n = ((g + H @ dx + F.T @ wv) ** 2).sum()
                r2n = ((rpri + F @ dx) ** 2).sum()
                scale = (g ** 2).sum() + (rpri ** 2).sum() + 1e-300
                if not sync.read((r1n + r2n) < 1e-16 * scale):
                    dx, wv = direction(False)
            else:
                dx, wv = direction(False)
            dv = wv - v

            # the residual-backtracking sweep; cone slacks are quadratic
            # in σ: slack(σ) = s0 + σ·p1 + σ²·p2
            lhsdx = torch.einsum("kmn,n->km", A, dx)
            cdx = cv @ dx
            p1 = 2.0 * (rhs * cdx - (lhs * lhsdx).sum(dim=-1))
            p2 = cdx ** 2 - (lhsdx ** 2).sum(dim=-1)
            cone_c = (slack[:, None] + sig[None, :] * p1[:, None]
                      + (sig ** 2)[None, :] * p2[:, None])    # (K_l, J)
            rhs_c = rhs[:, None] + sig[None, :] * cdx[:, None]
            ok_l = (cone_c > 0.0).all(dim=0) & (rhs_c > 0.0).all(dim=0)
            ok = comm.pmin(ok_l.to(torch.int32)) > 0
            xc = x[:, None] + sig[None, :] * dx[:, None]     # (n, J)
            ok = ok & (xc < ub[:, None]).all(dim=0) \
                & (xc > lb[:, None]).all(dim=0)
            r0 = torch.sqrt(((g + F.T @ v) ** 2).sum() + (rpri ** 2).sum())
            W = 2.0 / (cone_c + SOCP_SLACK_EPS)              # (K_l, J)
            G1 = torch.einsum("kmn,km->kn", A, lhsdx) - cv * cdx[:, None]
            gc = psum(G0.T @ W + G1.T @ (W * sig[None, :]))
            gc = gc + t * lin_grad(x)[:, None]
            if has_P:
                gc = gc + t * sig[None, :] * (Pm @ dx)[:, None]
            gc = gc + 1.0 / (ub[:, None] - xc + SLACK_EPS) \
                - 1.0 / (xc - lb[:, None] + SLACK_EPS)
            vc = v[:, None] + sig[None, :] * dv[:, None]     # (mg, J)
            r_dual = gc + F.T @ vc
            r_pri_c = rpri[:, None] + sig[None, :] * (F @ dx)[:, None]
            rn = torch.sqrt((r_dual ** 2).sum(dim=0)
                            + (r_pri_c ** 2).sum(dim=0))
            accept = ok & (rn <= (1.0 - alpha * sig) * r0)
            any_acc = accept.any()
            j = torch.argmax(accept.to(torch.int8))
            sigma = torch.where(any_acc, sig[j], zero)
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
            done = num_ineq / t < eps
            t, it, total_nt = t * mu, it + 1, total_nt + nt
        obj = zero
        if has_P:
            obj = obj + 0.5 * x @ (Pm @ x)
        if has_q:
            obj = obj + q @ x
        return x, v, sync.read(obj), it, total_nt, t, done

    return prog


def solve_socp_cone_sharded(mesh, A, b, c, d, P_obj=None, q=None, F=None,
                            g=None, lb=None, ub=None, *, x0=None, t0=1.0,
                            mu=15.0, epsilon=1e-8, inner_epsilon=1e-8,
                            alpha=0.2, beta=0.6, max_linesearch_steps=40,
                            max_outer_iters=30, max_inner_iters=60,
                            axis: str = "cones", distributed_factor=False,
                            factor_dtype="float64", chol_block=256,
                            phase1="auto", checkpoint_path=None,
                            checkpoint_every=1, resume=False,
                            algorithm="barrier", pd_max_iters=60):
    """Distributed SOCP solve with the cone axis sharded over the mesh's
    ranks:

        min ½xᵀPx + qᵀx  s.t.  ‖A_k x + b_k‖₂ ≤ c_kᵀx + d_k (k < K),
                               Fx = g,  lb ≤ x ≤ ub

    with the stacked cone tensors A (K, M, n), b (K, M), c (K, n), d (K,)
    (cones zero-padded to a common M).  K need not divide the mesh; F/g,
    bounds, P and q are optional.  ``algorithm="pd"`` dispatches to the
    distributed conic Mehrotra solve (``socp_pd_dist``).  The barrier
    needs a strictly cone-feasible ``x0``, or with ``phase1="auto"`` runs
    the distributed phase one (min s over the rhs-shifted cones), which
    raises ValueError when the problem is strictly infeasible.
    Checkpoints as in ``solve_lp_row_sharded``.  Returns a dict with x,
    v (equality multipliers, empty without F), objective, outer_iters,
    newton_iters."""
    if algorithm == "pd":
        if checkpoint_path is not None:
            raise ValueError("algorithm='pd' does not support mid-solve "
                             "checkpointing (solves are 10-30 iterations)")
        from .socp_pd_dist import solve_socp_pd_cone_sharded
        return solve_socp_pd_cone_sharded(
            mesh, A, b, c, d, P_obj=P_obj, q=q, F=F, g=g, lb=lb, ub=ub,
            x0=x0, epsilon=epsilon, max_iters=pd_max_iters, axis=axis,
            distributed_factor=distributed_factor,
            factor_dtype=factor_dtype, chol_block=chol_block)
    if algorithm != "barrier":
        raise ValueError(f"unknown algorithm {algorithm!r}")
    ndev, rank, dev = _layout(mesh, axis)
    A = _t(A, dev)
    dtype = A.dtype
    K, M, n = A.shape
    b, c, d = (_t(v, dev) for v in (b, c, d))
    num_ineq = K + (n if lb is not None else 0) \
        + (n if ub is not None else 0)
    Kp = -(-K // ndev) * ndev
    A_p, b_p, c_p, d_p = _pad_cones(A, b, c, d, Kp)
    F_p, g_p, m_true = _pad_equalities(F, g, n, dtype, dev)
    lb_v, ub_v = _bound_vectors(lb, ub, n, dtype, dev)
    if x0 is None:
        x0 = (0.5 * (lb_v + ub_v) if lb is not None and ub is not None
              else torch.zeros(n, dtype=dtype, device=dev))
    x0 = _t(x0, dev, dtype)

    # a resumed iterate replaces x0 before the cone-feasibility gate
    ck_state = _load_checkpoint(checkpoint_path, resume)
    if ck_state is not None:
        x0 = _t(ck_state["x"], dev, dtype)
    if phase1 == "auto" or phase1 is True:
        lhs = torch.einsum("kmn,n->km", A, x0) + b
        rhs = c @ x0 + d
        slack_min = sync.read(torch.cat([
            rhs ** 2 - (lhs ** 2).sum(dim=-1), rhs, ub_v - x0,
            x0 - lb_v]).amin())
        if not slack_min > 0:
            x0 = _cone_sharded_phase1(
                mesh, A, b, c, d, F_p[:m_true] if m_true else None,
                g_p[:m_true] if m_true else None, lb_v, ub_v, x0,
                axis=axis, distributed_factor=distributed_factor,
                factor_dtype=factor_dtype, chol_block=chol_block,
                checkpoint_path=(None if checkpoint_path is None
                                 else checkpoint_path + ".p1"),
                checkpoint_every=checkpoint_every, resume=resume)
            # the gate firing on a resumed iterate: the data changed, so
            # the schedule restarts (see _solve_row_sharded)
            ck_state = None

    has_P, has_q = P_obj is not None, q is not None
    Pm = _t(P_obj, dev, dtype) if has_P else torch.zeros(
        (1, 1), dtype=dtype, device=dev)
    qv = _t(q, dev, dtype) if has_q else torch.zeros(1, dtype=dtype,
                                                     device=dev)
    v0 = torch.zeros(F_p.shape[0], dtype=dtype, device=dev)
    prog = _cone_sharded_barrier(
        m_true=m_true, num_ineq=num_ineq, mu=float(mu), eps=float(epsilon),
        inner_eps=float(inner_epsilon), alpha=float(alpha),
        beta=float(beta), J=int(max_linesearch_steps),
        max_inner=int(max_inner_iters), has_P=has_P, has_q=has_q,
        distributed_factor=bool(distributed_factor),
        factor_dtype=factor_dtype, chol_block=int(chol_block))
    kl = Kp // ndev
    sl = slice(rank * kl, (rank + 1) * kl)
    operands = (qv, Pm, A_p[sl], b_p[sl], c_p[sl], d_p[sl], F_p, g_p, lb_v,
                ub_v)

    def prog_call(x, v, t, max_outer):
        return prog(*operands, x, v, t, max_outer)

    x, v, obj, outer_it, total_nt = _dispatch_barrier(
        prog_call, x0, v0, float(t0), int(max_outer_iters),
        checkpoint_path, int(checkpoint_every), ck_state)
    return dict(x=x, v=v[:m_true], objective=obj, outer_iters=outer_it,
                newton_iters=total_nt)


def _pad_equalities(F, g, n, dtype, dev):
    """(F, g) padded to at least one row with zero rows, and the true row
    count."""
    m_true = 0 if F is None else int(np.shape(F)[0])
    F_p = torch.zeros((max(m_true, 1), n), dtype=dtype, device=dev)
    g_p = torch.zeros(max(m_true, 1), dtype=dtype, device=dev)
    if m_true:
        F_p[:m_true] = _t(F, dev, dtype)
        g_p[:m_true] = _t(g, dev, dtype)
    return F_p, g_p, m_true


def _cone_sharded_phase1(mesh, A, b, c, d, F, g, lb_v, ub_v, x0, *, axis,
                         distributed_factor, factor_dtype, chol_block,
                         checkpoint_path=None, checkpoint_every=1,
                         resume=False):
    """Distributed SOCP phase one over z = [x, s]: min s subject to the
    rhs-shifted cones ‖A_k x + b_k‖ ≤ c_kᵀx + s + d_k ([A | 0],
    [c | 1]), Fx = g, the box and s ≥ −1, strictly feasible at
    s₀ = max_k(‖A_kx₀ + b_k‖ − c_kᵀx₀ − d_k) + 1.  s* < 0 certifies a
    strictly feasible x of the original cones."""
    K, M, n = A.shape
    dtype, dev = A.dtype, A.device
    lo = torch.clamp(lb_v, min=-1e12)
    hi = torch.clamp(ub_v, max=1e12)
    x0c = torch.clamp(x0, lo + 1e-6 * (hi - lo), hi - 1e-6 * (hi - lo))
    lhs = torch.einsum("kmn,n->km", A, x0c) + b
    s0 = torch.clamp((torch.sqrt((lhs ** 2).sum(dim=-1)) - c @ x0c
                      - d).amax() + 1.0, min=0.0)
    kw = dict(dtype=dtype, device=dev)
    A_ext = torch.cat([A, torch.zeros((K, M, 1), **kw)], dim=2)
    c_ext = torch.cat([c, torch.ones((K, 1), **kw)], dim=1)
    q_ext = torch.zeros(n + 1, **kw)
    q_ext[n] = 1.0
    F_ext = (torch.cat([F, torch.zeros((F.shape[0], 1), **kw)], dim=1)
             if F is not None else None)
    lb_ext = torch.cat([lb_v, torch.full((1,), -1.0, **kw)])
    ub_ext = torch.cat([ub_v, torch.full((1,), float("inf"), **kw)])
    z0 = torch.cat([x0c, s0.reshape(1)])
    res = solve_socp_cone_sharded(
        mesh, A_ext, b, c_ext, d, None, q_ext, F_ext, g, lb_ext, ub_ext,
        x0=z0, epsilon=1e-6, axis=axis,
        distributed_factor=distributed_factor, factor_dtype=factor_dtype,
        chol_block=chol_block, phase1=False,
        checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume)
    z = res["x"].cpu().numpy()
    if not np.isfinite(z).all() or z[n] >= 0:
        raise ValueError(
            "Phase 1 did not find a strictly cone-feasible point "
            f"(optimal shift s* = {z[n]:.3e} >= 0): problem infeasible")
    x1 = z[:n]
    An, bn, cn, dn = (v.cpu().numpy() for v in (A, b, c, d))
    lhs1 = np.einsum("kmn,n->km", An, x1) + bn
    rhs1 = cn @ x1 + dn
    slack_min = min(
        float(np.min(rhs1 ** 2 - np.sum(lhs1 ** 2, axis=-1))),
        float(np.min(rhs1)),
        float(np.min(ub_v.cpu().numpy() - x1)),
        float(np.min(x1 - lb_v.cpu().numpy())))
    if not slack_min > 0:
        raise ValueError(
            "Phase 1 terminated with s* < 0 but a non-positive slack "
            f"(min slack {slack_min:.3e}); the problem is feasible but "
            "barely — tighten phase-1 epsilon or supply a feasible x0")
    return torch.as_tensor(x1, dtype=dtype, device=dev)
