"""Distributed primal-dual Mehrotra solve with the constraint rows
sharded over torch.distributed (counterpart of
interiorpoint_tpu/parallel/pd_dist.py).

The multi-rank form of ops/pd.py: the inequality rows C and equality
rows A of one LP/QP are split over the ranks, and each
predictor-corrector iteration reduces with the row-sharded barrier's
pattern (``distributed.py``): the partial Hessian summed, the Schur
panels gathered, the step lengths by an all-reduce of the minimum, at
15–40 iterations instead of the barrier's Newton steps.  The loop runs
on the host and reads (gap, residuals, stall) once per iteration; every
such value is replicated.

Bounds are replicated diagonal slack/multiplier segments, not stacked
rows: their Hessian term is diagonal, their complementarity elementwise,
and ±inf bounds are masked out (s = 1, λ = 0, no contribution).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import sync
from . import comm
from .distributed import (_bound_vectors, _layout, _pad_rows, _t,
                          make_factor_tools)

_GAMMA = 0.99995
_STALL_STEP = 1e-10


def _row_sharded_pd(*, m_true: int, k_true: int, eps: float,
                    max_iters: int, has_P: bool, distributed_factor=False,
                    factor_dtype: str = "float64", chol_block: int = 256):
    """The predictor-corrector program as a function
    prog(c, Pm, A, b, C, d, lb, ub, x0) ->
    (x, v, objective, iterations, gap, converged, λ gathered, λ_ub, λ_lb)
    over this rank's row blocks.  Padded C rows are zero with d = 1 (their
    slack stays at 1 with λ = 0), padded A rows zero with b = 0 and +1 on
    the Schur diagonal."""
    mixed = factor_dtype == "float32"
    _make_solve = make_factor_tools(distributed_factor, chol_block)
    psum, pmax, gather0 = comm.psum, comm.pmax, comm.all_gather0

    def prog(c, Pm, A, b, C, d, lb, ub, x0):
        dtype, dev = x0.dtype, x0.device
        ndev = comm.world_size()
        k_local, m_local = C.shape[0], A.shape[0]
        idx_m = comm.axis_index() * m_local
        row0 = comm.axis_index() * k_local
        mask = (row0 + torch.arange(k_local, device=dev)
                < k_true).to(dtype)
        fub = torch.isfinite(ub).to(dtype)
        flb = torch.isfinite(lb).to(dtype)
        # finite bound values for arithmetic; masked terms are zeroed
        ubf = torch.where(fub > 0, ub, torch.zeros_like(ub))
        lbf = torch.where(flb > 0, lb, torch.zeros_like(lb))
        kcnt = k_true + fub.sum() + flb.sum()
        zero = torch.zeros((), dtype=dtype, device=dev)

        d_max = pmax((d * mask).abs().amax())
        b_max = pmax(b.abs().amax())
        bscale = torch.cat([ubf * fub, lbf * flb]).abs().amax()
        d_scale = 1.0 + torch.maximum(torch.maximum(d_max, b_max), bscale)
        q_scale = 1.0 + c.abs().amax()
        gap_tol = float(eps)
        feas_tol = max(1e-9, min(1e-6, gap_tol))

        # start (ops/pd.py), segment-wise, with the global slack shift on
        # violated starts: the worst violation reduces over the ranks
        floor = 1e-4 * d_scale
        s_hat = d - C @ x0
        smin = -pmax(torch.where(mask > 0, -s_hat,
                                 torch.full_like(s_hat, -float("inf")))
                     .amax())
        delta = torch.where(smin < floor,
                            -1.5 * torch.clamp(smin, max=0.0) + floor, zero)
        one = torch.ones_like(s_hat)
        s0 = torch.where(mask > 0, torch.maximum(s_hat + delta, floor), one)
        lam0 = torch.where(mask > 0, torch.clamp(1.0 / s0, 1e-6, 1e6),
                           torch.zeros_like(s0))
        onex, zx = torch.ones_like(x0), torch.zeros_like(x0)
        su0 = torch.where(fub > 0, torch.maximum(ubf - x0, floor), onex)
        lu0 = torch.where(fub > 0, torch.clamp(1.0 / su0, 1e-6, 1e6), zx)
        sl0 = torch.where(flb > 0, torch.maximum(x0 - lbf, floor), onex)
        ll0 = torch.where(flb > 0, torch.clamp(1.0 / sl0, 1e-6, 1e6), zx)
        v0 = torch.zeros(m_local * ndev, dtype=dtype, device=dev)

        def residuals(x, v, s, lam, su, lu, sl, ll):
            v_loc = v[idx_m:idx_m + m_local]
            rd = c + psum(C.T @ lam) + lu * fub - ll * flb \
                + psum(A.T @ v_loc)
            if has_P:
                rd = rd + Pm @ x
            rp = (C @ x + s - d) * mask
            rpu = (x + su - ubf) * fub
            rpl = (-x + sl + lbf) * flb
            rpe = A @ x - b
            return rd, rp, rpu, rpl, rpe

        def gap_of(s, lam, su, lu, sl, ll):
            return (psum((s * lam * mask).sum())
                    + (su * lu * fub).sum() + (sl * ll * flb).sum())

        def max_step_local(vv, dv):
            r = torch.where(dv < 0, -vv / torch.where(dv < 0, dv, -1.0),
                            torch.full_like(vv, float("inf")))
            return r.amin()

        def primal_norm(rp, rpe, rpu, rpl):
            rpn = pmax(torch.maximum(rp.abs().amax(), rpe.abs().amax()))
            return torch.maximum(rpn, torch.maximum(rpu.abs().amax(),
                                                    rpl.abs().amax()))

        def step_min(a, b_, c_):
            return comm.pmin(torch.minimum(torch.minimum(a, b_), c_))

        def iteration(x, v, s, lam, su, lu, sl, ll):
            rd, rp, rpu, rpl, rpe = residuals(x, v, s, lam, su, lu, sl, ll)
            w_C = torch.where(mask > 0, lam / s, torch.zeros_like(s))
            db = fub * lu / su + flb * ll / sl
            H = psum(C.T @ (w_C[:, None] * C)) + torch.diag(db)
            if has_P:
                H = H + Pm
            # factor-only per-row relative regularization; the operator
            # kkt_apply stays unshifted, so refinement removes it
            H_fac = H + torch.diag(1e-13 * torch.diagonal(H).abs() + 1e-30)

            def kkt_apply(dz, dv_loc):
                Hdz = psum(C.T @ (w_C * (C @ dz))) + db * dz
                if has_P:
                    Hdz = Hdz + Pm @ dz
                return Hdz + psum(A.T @ dv_loc), A @ dz

            def make_dir(f32_factor):
                solve = _make_solve(H_fac, dtype, f32_factor)
                Y = comm.all_gather1(solve(A.T))
                S = gather0(A @ Y)
                S = 0.5 * (S + S.T)
                mg = S.shape[0]
                pad_diag = (torch.arange(mg, device=dev)
                            >= m_true).to(dtype)
                S = S + torch.diag(pad_diag
                                   + 1e-13 * torch.diagonal(S).amax())
                solve_S = _make_solve(S, dtype, f32_factor)

                def direction(r1, r2_local):
                    """[[H Aᵀ], [A 0]]·[dz, dv] = [r1, r2] by block
                    elimination and true-residual refinement."""
                    t1 = solve(r1)
                    dv = solve_S(gather0(A @ t1) - gather0(r2_local))
                    dz = t1 - solve(psum(A.T @ dv[idx_m:idx_m + m_local]))
                    for _ in range(3 if f32_factor else 2):
                        dual, Adz = kkt_apply(dz,
                                              dv[idx_m:idx_m + m_local])
                        e1 = r1 - dual
                        e2_local = r2_local - Adz
                        f = solve_S(gather0(A @ solve(e1))
                                    - gather0(e2_local))
                        dz = dz + solve(e1 - psum(
                            A.T @ f[idx_m:idx_m + m_local]))
                        dv = dv + f
                    return dz, dv
                return direction

            if mixed:
                dir32 = make_dir(True)

                def direction(r1, r2_local):
                    dz, dv = dir32(r1, r2_local)
                    dual, Adz = kkt_apply(dz, dv[idx_m:idx_m + m_local])
                    r1n = ((r1 - dual) ** 2).sum()
                    r2n = psum(((r2_local - Adz) ** 2).sum())
                    scale = ((r1 ** 2).sum() + psum((r2_local ** 2).sum())
                             + 1e-300)
                    if sync.read((r1n + r2n) < 1e-16 * scale):
                        return dz, dv
                    # the fp64 factor only on an fp32 refinement stall
                    return make_dir(False)(r1, r2_local)
            else:
                direction = make_dir(False)

            def full_dir(rc, rcu, rcl):
                r1 = (-rd
                      + psum(C.T @ torch.where(mask > 0, (rc - lam * rp) / s,
                                               torch.zeros_like(s)))
                      + fub * (rcu - lu * rpu) / su
                      - flb * (rcl - ll * rpl) / sl)
                dz, dv = direction(r1, -rpe)
                ds = (-rp - C @ dz) * mask
                dlam = torch.where(mask > 0, (-rc - lam * ds) / s,
                                   torch.zeros_like(s))
                dsu = (-rpu - dz) * fub
                dlu = torch.where(fub > 0, (-rcu - lu * dsu) / su, zx)
                dsl = (-rpl + dz) * flb
                dll = torch.where(flb > 0, (-rcl - ll * dsl) / sl, zx)
                return dz, dv, ds, dlam, dsu, dlu, dsl, dll

            mu = gap_of(s, lam, su, lu, sl, ll) / kcnt
            # predictor (affine scaling)
            dz_a, dv_a, ds_a, dl_a, dsu_a, dlu_a, dsl_a, dll_a = full_dir(
                s * lam * mask, su * lu * fub, sl * ll * flb)
            ap_a = torch.clamp(step_min(max_step_local(s, ds_a),
                                        max_step_local(su, dsu_a),
                                        max_step_local(sl, dsl_a)), max=1.0)
            ad_a = torch.clamp(step_min(max_step_local(lam, dl_a),
                                        max_step_local(lu, dlu_a),
                                        max_step_local(ll, dll_a)), max=1.0)
            mu_aff = gap_of(s + ap_a * ds_a, lam + ad_a * dl_a,
                            su + ap_a * dsu_a, lu + ad_a * dlu_a,
                            sl + ap_a * dsl_a, ll + ad_a * dll_a) / kcnt
            sigma = torch.clamp((mu_aff / mu) ** 3, 0.0, 1.0)
            # corrector (factors reused inside ``direction``)
            rc = (s * lam - sigma * mu + ds_a * dl_a) * mask
            rcu = (su * lu - sigma * mu + dsu_a * dlu_a) * fub
            rcl = (sl * ll - sigma * mu + dsl_a * dll_a) * flb
            dz, dv, ds, dlam, dsu, dlu, dsl, dll = full_dir(rc, rcu, rcl)
            ap = torch.clamp(_GAMMA * step_min(max_step_local(s, ds),
                                               max_step_local(su, dsu),
                                               max_step_local(sl, dsl)),
                             max=1.0)
            ad = torch.clamp(_GAMMA * step_min(max_step_local(lam, dlam),
                                               max_step_local(lu, dlu),
                                               max_step_local(ll, dll)),
                             max=1.0)
            x2 = x + ap * dz
            v2 = v + ad * dv
            s2 = torch.where(mask > 0, s + ap * ds, one)
            lam2 = lam + ad * dlam
            su2 = torch.where(fub > 0, su + ap * dsu, onex)
            lu2 = lu + ad * dlu
            sl2 = torch.where(flb > 0, sl + ap * dsl, onex)
            ll2 = ll + ad * dll
            rd2, rp2, rpu2, rpl2, rpe2 = residuals(
                x2, v2, s2, lam2, su2, lu2, sl2, ll2)
            stats = torch.stack([
                gap_of(s2, lam2, su2, lu2, sl2, ll2),
                primal_norm(rp2, rpe2, rpu2, rpl2), rd2.abs().amax(),
                ((ap < _STALL_STEP) & (ad < _STALL_STEP)).to(dtype)])
            return (x2, v2, s2, lam2, su2, lu2, sl2, ll2), stats

        st = (x0, v0, s0, lam0, su0, lu0, sl0, ll0)
        rd0, rp0, rpu0, rpl0, rpe0 = residuals(*st)
        gap, rpn, rdn, d_sc, q_sc = sync.read_list(torch.stack([
            gap_of(*st[2:]), primal_norm(rp0, rpe0, rpu0, rpl0),
            rd0.abs().amax(), d_scale, q_scale]))

        def done(gap, rpn, rdn):
            return (gap < gap_tol and rpn < feas_tol * d_sc
                    and rdn < feas_tol * q_sc)

        it, stalled = 0, False
        while (it < max_iters and not done(gap, rpn, rdn) and not stalled
               and np.isfinite(gap)):
            st, stats = iteration(*st)
            gap, rpn, rdn, stl = sync.read_list(stats)
            stalled = stl != 0.0
            it += 1
        x, v, s, lam, su, lu, sl, ll = st
        obj = c @ x + (0.5 * x @ (Pm @ x) if has_P else 0.0)
        return (x, v, sync.read(obj), it, gap, done(gap, rpn, rdn),
                gather0(lam), lu, ll)

    return prog


def solve_pd_row_sharded(mesh, c, A, b, C, d, lb=None, ub=None, *,
                         P_obj=None, x0=None, epsilon=1e-8,
                         max_iters: int = 60, axis: str = "rows",
                         distributed_factor=False,
                         factor_dtype: str = "float64",
                         chol_block: int = 256):
    """Distributed Mehrotra solve of one LP/QP with the constraint rows
    sharded over the mesh's ranks: min cᵀx (+½xᵀPx) s.t. Ax = b, Cx ≤ d,
    lb ≤ x ≤ ub.  Infeasible start (no phase one; x0 defaults to the
    bound midpoint or zeros); row counts need not divide the mesh; bounds
    are optional (masked).  Returns a dict with x, v (true equality rows),
    lam (inequality multipliers in the order [Cx ≤ d, ub, lb]),
    objective, iterations, gap, converged, and the barrier result's
    outer_iters/newton_iters aliases."""
    ndev, rank, dev = _layout(mesh, axis)
    c = _t(c, dev)
    n = c.shape[0]
    dtype = c.dtype

    def empty(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    A = empty(0, n) if A is None else _t(A, dev)
    b = empty(0) if b is None else _t(b, dev)
    C = empty(0, n) if C is None else _t(C, dev)
    d = empty(0) if d is None else _t(d, dev)
    m_true, k_true = A.shape[0], C.shape[0]
    if k_true == 0 and lb is None and ub is None:
        raise ValueError("pd requires inequality constraints or bounds")
    mp = max(-(-m_true // ndev) * ndev, ndev)
    kp = max(-(-k_true // ndev) * ndev, ndev)
    A_p, b_p = _pad_rows(A, mp), _pad_rows(b, mp)
    C_p, d_p = _pad_rows(C, kp), _pad_rows(d, kp, fill=1.0)
    lb_v, ub_v = _bound_vectors(lb, ub, n, dtype, dev)
    if x0 is None:
        x0 = (0.5 * (lb_v + ub_v) if lb is not None and ub is not None
              else torch.zeros(n, dtype=dtype, device=dev))
    x0 = _t(x0, dev, dtype)
    has_P = P_obj is not None
    Pm = _t(P_obj, dev, dtype) if has_P else empty(1, 1)

    prog = _row_sharded_pd(
        m_true=m_true, k_true=k_true, eps=float(epsilon),
        max_iters=int(max_iters), has_P=has_P,
        distributed_factor=bool(distributed_factor),
        factor_dtype=factor_dtype, chol_block=int(chol_block))
    ml, kl = mp // ndev, kp // ndev
    x, v, obj, it, gap, conv, lam_g, lu, ll = prog(
        c, Pm, A_p[rank * ml:(rank + 1) * ml], b_p[rank * ml:(rank + 1) * ml],
        C_p[rank * kl:(rank + 1) * kl], d_p[rank * kl:(rank + 1) * kl],
        lb_v, ub_v, x0)
    lam_parts = [lam_g[:k_true].cpu().numpy()]
    if ub is not None:
        lam_parts.append(lu.cpu().numpy())
    if lb is not None:
        lam_parts.append(ll.cpu().numpy())
    return dict(x=x, v=v[:m_true], objective=obj, iterations=it, gap=gap,
                converged=bool(conv), lam=np.concatenate(lam_parts),
                # the barrier result's keys, for callers that dispatch
                # through solve_lp_row_sharded(algorithm="pd")
                outer_iters=it, newton_iters=it)
