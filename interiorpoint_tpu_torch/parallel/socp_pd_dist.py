"""Cone-sharded distributed conic Mehrotra solve over torch.distributed
(counterpart of interiorpoint_tpu/parallel/socp_pd_dist.py).

The multi-rank form of ops/socp_pd.py, as ``pd_dist.py`` is of ops/pd.py:
the stacked cone tensors are split on the cone axis, each rank runs the
Jordan/NT algebra of its own cones (scalings, arrow solves, steps to the
boundary), and the reductions are an all-reduce sum at the Hessian,
gradient and gap points and an all-reduce minimum for the step lengths.
The loop runs on the host, one replicated read per iteration.

Padded cones (A = 0, b = 0, c = 0, d = 1, ``socp_dist._pad_cones``) are
trivial cones: their slack stays at e, their dual follows σμ·e → 0, and
they count in the complementarity degree, which rescales μ by Kp/K.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import sync
from ..ops.pd import _max_step as _max_step_lin
from ..ops.socp_pd import (_arrow_solve, _jmul, _jreflect, max_step_cone,
                           nt_scaling, w_inv_mul, w_mul)
from . import comm
from .distributed import _bound_vectors, _layout, _t, make_factor_tools
from .socp_dist import _pad_cones, _pad_equalities

_GAMMA = 0.99
_STALL_STEP = 1e-10


def _cone_sharded_pd(*, m_true: int, Kp: int, eps: float, max_iters: int,
                     has_P: bool, has_q: bool, distributed_factor=False,
                     factor_dtype: str = "float64", chol_block: int = 256):
    """The conic predictor-corrector program as a function
    prog(q, Pm, A, b, c, d, F, g, lb, ub, x0) ->
    (x, y, objective, iterations, gap, converged, z gathered, λ_ub, λ_lb)
    over this rank's cones."""
    mixed = factor_dtype == "float32"
    _make_solve = make_factor_tools(distributed_factor, chol_block)
    psum, pmin = comm.psum, comm.pmin

    def prog(qv, Pm, A, b, cv, d, F, g_eq, lb, ub, x0):
        dtype, dev = x0.dtype, x0.device
        n = x0.shape[0]
        Kl, M = A.shape[0], A.shape[1]
        G = torch.cat([cv[:, None, :], A], dim=1)          # (Kl, 1+M, n)
        h = torch.cat([d[:, None], b], dim=1)              # (Kl, 1+M)
        e = torch.zeros((Kl, M + 1), dtype=dtype, device=dev)
        e[:, 0] = 1.0
        jsign = torch.cat([torch.ones(1, dtype=dtype, device=dev),
                           -torch.ones(M, dtype=dtype, device=dev)])
        JG = torch.einsum("m,kmn,kmo->kno", jsign, G, G)
        mg = F.shape[0]
        pad_diag = (torch.arange(mg, device=dev) >= m_true).to(dtype)

        q = qv if has_q else torch.zeros(n, dtype=dtype, device=dev)
        fub = torch.isfinite(ub).to(dtype)
        flb = torch.isfinite(lb).to(dtype)
        zx, onex = torch.zeros_like(x0), torch.ones_like(x0)
        ubf = torch.where(fub > 0, ub, zx)
        lbf = torch.where(flb > 0, lb, zx)
        kcnt = Kp + fub.sum() + flb.sum()
        gap_tol = float(eps)
        feas_tol = max(1e-9, min(1e-6, gap_tol))
        # the dual tolerance floors at 1e-8 relative (ops/socp_pd.py)
        feas_tol_d = max(1e-8, feas_tol)
        h_scale = 1.0 + comm.pmax(h.abs().amax())
        h_scale = torch.maximum(h_scale, 1.0 + g_eq.abs().amax())
        h_scale = torch.maximum(h_scale, 1.0 + torch.cat(
            [ubf * fub, lbf * flb]).abs().amax())
        q_scale = 1.0 + q.abs().amax()

        # start (ops/socp_pd.py)
        u0 = torch.einsum("kmn,n->km", G, x0) + h
        lam_min = u0[:, 0] - torch.linalg.vector_norm(u0[:, 1:], dim=-1)
        shift = torch.clamp(0.1 * h_scale - lam_min, min=0.0)
        s0 = u0 + shift[:, None] * e
        z0 = e * torch.clamp(0.1 * q_scale, min=1.0)
        floor = 1e-4 * h_scale
        su0 = torch.where(fub > 0, torch.maximum(ubf - x0, floor), onex)
        lu0 = torch.where(fub > 0, torch.clamp(1.0 / su0, 1e-6, 1e6), zx)
        sl0 = torch.where(flb > 0, torch.maximum(x0 - lbf, floor), onex)
        ll0 = torch.where(flb > 0, torch.clamp(1.0 / sl0, 1e-6, 1e6), zx)
        y0 = torch.zeros(mg, dtype=dtype, device=dev)

        def gap_of(s, z, su, lu, sl, ll):
            return (psum((s * z).sum())
                    + (su * lu * fub).sum() + (sl * ll * flb).sum())

        def dual_res(x, y, z, lu, ll):
            rd = q - psum(torch.einsum("kmn,km->n", G, z)) \
                + lu * fub - ll * flb + F.T @ y
            return rd + Pm @ x if has_P else rd

        def iteration(x, y, s, z, su, lu, sl, ll):
            rd = dual_res(x, y, z, lu, ll)
            rp = torch.einsum("kmn,n->km", G, x) + h - s
            rpu = (x + su - ubf) * fub
            rpl = (-x + sl + lbf) * flb
            rpe = F @ x - g_eq

            uw, eta = nt_scaling(s, z)
            w = _jmul(uw, uw)
            lam = w_mul(uw, eta, z)
            eta1 = eta[:, 0]
            wt = _jreflect(w)
            qk = torch.einsum("kmn,km->kn", G, wt)
            H = psum(2.0 * torch.einsum("kn,ko->no", qk / eta1[:, None], qk)
                     - torch.einsum("k,kno->no", 1.0 / eta1, JG))
            db = fub * lu / su + flb * ll / sl
            H = H + torch.diag(db)
            if has_P:
                H = H + Pm
            H = 0.5 * (H + H.T)
            # factor-only per-row relative regularization (pd_dist.py)
            H_fac = H + torch.diag(1e-13 * torch.diagonal(H).abs() + 1e-30)

            def winv2(vv):
                coef = 2.0 * (wt * vv).sum(dim=-1, keepdim=True)
                return (coef * wt - _jreflect(vv)) / eta1[:, None]

            def h_op(dx):
                out = psum(torch.einsum(
                    "kmn,km->n", G,
                    winv2(torch.einsum("kmn,n->km", G, dx)))) + db * dx
                return out + Pm @ dx if has_P else out

            def make_dir(f32_factor):
                solve = _make_solve(H_fac, dtype, f32_factor)
                Hinv_FT = solve(F.T)
                S = F @ Hinv_FT
                S = 0.5 * (S + S.T)
                S = S + torch.diag(pad_diag
                                   + 1e-13 * torch.diagonal(S).amax())
                solve_S = _make_solve(S, dtype, f32_factor)

                def direction(r1, r2):
                    t1 = solve(r1)
                    dy = solve_S(F @ t1 - r2)
                    dx = t1 - Hinv_FT @ dy
                    for _ in range(3 if f32_factor else 2):
                        e1 = r1 - (h_op(dx) + F.T @ dy)
                        e2 = r2 - F @ dx
                        f = solve_S(F @ solve(e1) - e2)
                        dx = dx + solve(e1 - F.T @ f)
                        dy = dy + f
                    return dx, dy
                return direction

            if mixed:
                dir32 = make_dir(True)

                def direction(r1, r2):
                    dx, dy = dir32(r1, r2)
                    e1 = r1 - (h_op(dx) + F.T @ dy)
                    e2 = r2 - F @ dx
                    ok = ((e1 ** 2).sum() + (e2 ** 2).sum()) < 1e-16 * (
                        (r1 ** 2).sum() + (r2 ** 2).sum() + 1e-300)
                    if sync.read(ok):
                        return dx, dy
                    return make_dir(False)(r1, r2)
            else:
                direction = make_dir(False)

            def full_dir(dcomp, rcu, rcl):
                t = -_arrow_solve(lam, dcomp)
                zc = w_inv_mul(uw, eta, t) - winv2(rp)
                r1 = (-rd + psum(torch.einsum("kmn,km->n", G, zc))
                      + fub * (rcu - lu * rpu) / su
                      - flb * (rcl - ll * rpl) / sl)
                dx, dy = direction(r1, -rpe)
                ds = torch.einsum("kmn,n->km", G, dx) + rp
                dz = w_inv_mul(uw, eta, t) - winv2(ds)
                dsu = (-rpu - dx) * fub
                dlu = torch.where(fub > 0, (-rcu - lu * dsu) / su, zx)
                dsl = (-rpl + dx) * flb
                dll = torch.where(flb > 0, (-rcl - ll * dsl) / sl, zx)
                return dx, dy, ds, dz, dsu, dlu, dsl, dll

            mu = gap_of(s, z, su, lu, sl, ll) / kcnt
            dx_a, dy_a, ds_a, dz_a, dsu_a, dlu_a, dsl_a, dll_a = full_dir(
                _jmul(lam, lam), su * lu * fub, sl * ll * flb)
            ap_a = torch.minimum(pmin(max_step_cone(s, ds_a)), torch.minimum(
                _max_step_lin(su, dsu_a), _max_step_lin(sl, dsl_a)))
            ad_a = torch.minimum(pmin(max_step_cone(z, dz_a)), torch.minimum(
                _max_step_lin(lu, dlu_a), _max_step_lin(ll, dll_a)))
            mu_aff = gap_of(s + ap_a * ds_a, z + ad_a * dz_a,
                            su + ap_a * dsu_a, lu + ad_a * dlu_a,
                            sl + ap_a * dsl_a, ll + ad_a * dll_a) / kcnt
            sigma = torch.clamp((mu_aff / mu) ** 3, 0.0, 1.0)
            corr = _jmul(w_inv_mul(uw, eta, ds_a), w_mul(uw, eta, dz_a))
            dcomp = _jmul(lam, lam) - sigma * mu * e + corr
            rcu = (su * lu - sigma * mu + dsu_a * dlu_a) * fub
            rcl = (sl * ll - sigma * mu + dsl_a * dll_a) * flb
            dx, dy, ds, dz, dsu, dlu, dsl, dll = full_dir(dcomp, rcu, rcl)
            ap = torch.clamp(_GAMMA * torch.minimum(
                pmin(max_step_cone(s, ds)), torch.minimum(
                    _max_step_lin(su, dsu), _max_step_lin(sl, dsl))),
                max=1.0)
            ad = torch.clamp(_GAMMA * torch.minimum(
                pmin(max_step_cone(z, dz)), torch.minimum(
                    _max_step_lin(lu, dlu), _max_step_lin(ll, dll))),
                max=1.0)
            x2, y2 = x + ap * dx, y + ad * dy
            s2, z2 = s + ap * ds, z + ad * dz
            su2 = torch.where(fub > 0, su + ap * dsu, onex)
            lu2 = lu + ad * dlu
            sl2 = torch.where(flb > 0, sl + ap * dsl, onex)
            ll2 = ll + ad * dll
            rd2 = dual_res(x2, y2, z2, lu2, ll2)
            rp2 = torch.einsum("kmn,n->km", G, x2) + h - s2
            rpn2 = comm.pmax(rp2.abs().amax())
            rpn2 = torch.maximum(rpn2, ((x2 + su2 - ubf) * fub).abs().amax())
            rpn2 = torch.maximum(rpn2, ((-x2 + sl2 + lbf) * flb).abs().amax())
            rpn2 = torch.maximum(rpn2, (F @ x2 - g_eq).abs().amax())
            stats = torch.stack([
                gap_of(s2, z2, su2, lu2, sl2, ll2), rpn2, rd2.abs().amax(),
                ((ap < _STALL_STEP) & (ad < _STALL_STEP)).to(dtype),
                torch.isfinite(x2).all().to(dtype)])
            return (x2, y2, s2, z2, su2, lu2, sl2, ll2), stats

        rd0 = q - psum(torch.einsum("kmn,km->n", G, z0)) \
            + lu0 * fub - ll0 * flb
        if has_P:
            rd0 = rd0 + Pm @ x0
        rpn0 = torch.maximum(comm.pmax((u0 - s0).abs().amax()),
                             (F @ x0 - g_eq).abs().amax())
        gap, rpn, rdn, h_sc, q_sc = sync.read_list(torch.stack([
            gap_of(s0, z0, su0, lu0, sl0, ll0), rpn0, rd0.abs().amax(),
            h_scale, q_scale]))

        def done(gap, rpn, rdn):
            return (gap < gap_tol and rpn < feas_tol * h_sc
                    and rdn < feas_tol_d * q_sc)

        st = (x0, y0, s0, z0, su0, lu0, sl0, ll0)
        it, stalled = 0, False
        while (it < max_iters and not done(gap, rpn, rdn) and not stalled
               and math.isfinite(gap)):
            new, stats = iteration(*st)
            g2, rpn2, rdn2, stl, fin = sync.read_list(stats)
            # a non-finite iterate keeps the old state and stops
            bad = not (math.isfinite(g2) and math.isfinite(rpn2)
                       and math.isfinite(rdn2) and fin == 1.0)
            if not bad:
                st, gap, rpn, rdn = new, g2, rpn2, rdn2
            stalled = stl != 0.0 or bad
            it += 1
        x, y, s, z, su, lu, sl, ll = st
        obj = torch.zeros((), dtype=dtype, device=dev)
        if has_q:
            obj = obj + q @ x
        if has_P:
            obj = obj + 0.5 * x @ (Pm @ x)
        return (x, y, sync.read(obj), it, gap, done(gap, rpn, rdn),
                comm.all_gather0(z), lu, ll)

    return prog


def solve_socp_pd_cone_sharded(mesh, A, b, c, d, P_obj=None, q=None,
                               F=None, g=None, lb=None, ub=None, *,
                               x0=None, epsilon=1e-8, max_iters: int = 60,
                               axis: str = "cones",
                               distributed_factor=False,
                               factor_dtype: str = "float64",
                               chol_block: int = 256):
    """Distributed conic Mehrotra solve with the cone axis sharded over the
    mesh's ranks: min ½xᵀPx + qᵀx s.t. ‖A_k x + b_k‖ ≤ c_kᵀx + d_k,
    Fx = g, bounds.  Infeasible start (a cone-infeasible x0 enters by the
    shifted slack start); K need not divide the mesh.  Returns a dict with
    x, y (equality multipliers), z (cone duals, (K, 1+M)), lam_ub/lam_lb,
    objective, iterations, gap, converged, and the barrier result's
    v/outer_iters/newton_iters aliases."""
    ndev, rank, dev = _layout(mesh, axis)
    A = _t(A, dev)
    dtype = A.dtype
    K, M, n = A.shape
    b, c, d = (_t(v, dev) for v in (b, c, d))
    Kp = -(-K // ndev) * ndev
    A_p, b_p, c_p, d_p = _pad_cones(A, b, c, d, Kp)
    F_p, g_p, m_true = _pad_equalities(F, g, n, dtype, dev)
    lb_v, ub_v = _bound_vectors(lb, ub, n, dtype, dev)
    if x0 is None:
        x0 = (0.5 * (lb_v + ub_v) if lb is not None and ub is not None
              else torch.zeros(n, dtype=dtype, device=dev))
    x0 = _t(x0, dev, dtype)
    has_P, has_q = P_obj is not None, q is not None
    Pm = _t(P_obj, dev, dtype) if has_P else torch.zeros(
        (1, 1), dtype=dtype, device=dev)
    qv = _t(q, dev, dtype) if has_q else torch.zeros(1, dtype=dtype,
                                                     device=dev)
    prog = _cone_sharded_pd(
        m_true=m_true, Kp=Kp, eps=float(epsilon), max_iters=int(max_iters),
        has_P=has_P, has_q=has_q,
        distributed_factor=bool(distributed_factor),
        factor_dtype=factor_dtype, chol_block=int(chol_block))
    kl = Kp // ndev
    sl = slice(rank * kl, (rank + 1) * kl)
    x, y, obj, it, gap, conv, z_g, lu, ll = prog(
        qv, Pm, A_p[sl], b_p[sl], c_p[sl], d_p[sl], F_p, g_p, lb_v, ub_v, x0)
    y_true = y[:m_true].cpu().numpy()
    return dict(x=x, y=y_true, objective=obj, iterations=it, gap=gap,
                converged=bool(conv), z=z_g[:K].cpu().numpy(),
                lam_ub=lu.cpu().numpy() if ub is not None else None,
                lam_lb=ll.cpu().numpy() if lb is not None else None,
                # the barrier result's keys, for callers that dispatch
                # through solve_socp_cone_sharded(algorithm="pd")
                v=y_true, outer_iters=it, newton_iters=it)
