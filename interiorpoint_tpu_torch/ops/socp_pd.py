"""Conic primal-dual Mehrotra engine for SOCP with Nesterov–Todd scaling
(counterpart of interiorpoint_tpu/ops/socp_pd.py) on

    min ½xᵀPx + qᵀx
    s.t.  F x = g,
          u_k := G_k x + h_k ∈ Q^{1+M}   (G_k = [c_kᵀ; A_k], h_k = [d_k; b_k])
          lb ≤ x ≤ ub

All K cones live in stacked (K, 1+M) tensors, and every Jordan-algebra
and NT operation is a batched elementwise sweep over them.  The loop runs
on the host, one read of the iteration's stats per iteration
(ops/sync.py), where the JAX package runs one ``lax.while_loop``.

Each iteration assembles H = P + Σ(1/η_k)(2 q_k q_kᵀ − GᵀJG_k) + the
bound diagonal, with GᵀJG computed once per solve (``torch.einsum``: an
XLA product outside any Pallas kernel in the JAX package too), and solves
the predictor's and the corrector's Newton systems:

* ``kkt_kernel`` None (``cfg.mixed_precision`` and ``cfg.use_pallas``,
  fp64) or True: every direction is one dense-KKT direction K5
  (ops/kkt_step.py) at the engine's tolerances (dir 1e-6, cg 1e-13, 24
  rounds; ``kkt_tols`` overrides them), the equality block handed over
  in the exact augmented-Lagrangian form, factored once per iteration in
  fp64 for the predictor, the corrector and the directions on the
  residual while they stall (``kkt_step.augment``, ``kkt_prepare`` and
  ``kkt_solve``, the port's repair of the reference, ROADMAP.md §3);
* ``kkt_kernel=False``: the block elimination over ops/kkt.py
  ``posdef_solver`` with ``exact_fallback`` (default True: a native fp64
  factor is cheap off the TPU) and its four KKT refinement rounds; with
  ``exact_fallback=False`` the H-solves are the matrix-free accurate
  solves of ops/kkt.py and the multipliers come from a Schur-CG (the
  JAX package's TPU configuration).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import sync
from .kkt import (matrix_free_prepare, matrix_free_prepared_solve,
                  posdef_solver)
from .kkt_step import augment, kkt_prepare, kkt_solve, prep_kkt_consts
from .pd import _max_step as _max_step_lin
from .pd import dir_stall_tol

_GAMMA = 0.99
_STALL_STEP = 1e-10


# ---------------------------------------------------------------------------
# Second-order-cone Jordan algebra, batched over the leading cone axis.
# Vectors live in R^{1+M} as (v0, v̄); J = diag(1, −I).
# ---------------------------------------------------------------------------

def _jmul(u, v):
    """Jordan product u∘v = (uᵀv; u₀v̄ + v₀ū), batched (K, 1+M)."""
    head = (u * v).sum(dim=-1, keepdim=True)
    tail = u[..., :1] * v[..., 1:] + v[..., :1] * u[..., 1:]
    return torch.cat([head, tail], dim=-1)


def _jdet(u):
    """det(u) = u₀² − ‖ū‖² (the cone residual), batched → (K,)."""
    return u[..., 0] ** 2 - (u[..., 1:] ** 2).sum(dim=-1)


def _jreflect(u):
    """J u = (u₀; −ū)."""
    return torch.cat([u[..., :1], -u[..., 1:]], dim=-1)


def _arrow_solve(lam, r):
    """Solve L_λ x = r, L_λ = [[λ₀, λ̄ᵀ], [λ̄, λ₀ I]] (the Jordan
    multiplication operator), batched, in closed form:
    x₀ = (λ₀ r₀ − λ̄ᵀr̄)/det(λ), x̄ = (r̄ − x₀ λ̄)/λ₀."""
    lam0 = lam[..., :1]
    lbar = lam[..., 1:]
    det = _jdet(lam)[..., None]
    x0 = (lam0 * r[..., :1]
          - (lbar * r[..., 1:]).sum(dim=-1, keepdim=True)) / det
    xbar = (r[..., 1:] - x0 * lbar) / lam0
    return torch.cat([x0, xbar], dim=-1)


def nt_scaling(s, z):
    """NT scaling of each cone: (u, η) with u = w^{1/2} the Jordan square
    root of the normalised scaling point w = (s̄ + Jz̄)/(2γ),
    γ² = (1 + s̄ᵀz̄)/2, and η = sqrt(det s/det z).  W = √η·Q_u satisfies
    W z = W⁻¹ s = λ."""
    ds = _jdet(s)[..., None]
    dz = _jdet(z)[..., None]
    sb = s / torch.sqrt(ds)
    zb = z / torch.sqrt(dz)
    gamma = torch.sqrt((1.0 + (sb * zb).sum(dim=-1, keepdim=True)) / 2.0)
    w = (sb + _jreflect(zb)) / (2.0 * gamma)
    u0 = torch.sqrt((w[..., :1] + 1.0) / 2.0)
    u = torch.cat([u0, w[..., 1:] / (2.0 * u0)], dim=-1)
    return u, torch.sqrt(ds / dz)


def _hyp_mul(u, v):
    """Q_u v = 2(uᵀv)u − Jv for det(u) = 1, batched."""
    return 2.0 * (u * v).sum(dim=-1, keepdim=True) * u - _jreflect(v)


def w_mul(u, eta, v):
    """W v = √η · Q_u v."""
    return torch.sqrt(eta) * _hyp_mul(u, v)


def w_inv_mul(u, eta, v):
    """W⁻¹ v = η^{−1/2} · Q_{u⁻¹} v, with u⁻¹ = Ju (det u = 1)."""
    return _hyp_mul(_jreflect(u), v) / torch.sqrt(eta)


def max_step_cone(s, ds):
    """Largest α ∈ (0, 1] with s + α·ds in every cone (s strictly inside):
    the smallest positive root of det(s + α ds) = det s + 2α⟨s, J ds⟩ +
    α² det ds, and of (s + α ds)₀ = 0, over the cones."""
    a = _jdet(ds)
    b = 2.0 * (s * _jreflect(ds)).sum(dim=-1)
    c = _jdet(s)
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    inf = torch.full_like(a, float("inf"))
    big_a = a.abs() > 1e-300
    r1 = torch.where(big_a, (-b - sq) / (2.0 * a),
                     -c / torch.where(b.abs() > 1e-300, b,
                                      torch.full_like(b, -1e-300)))
    r2 = torch.where(big_a, (-b + sq) / (2.0 * a), inf)
    roots = torch.minimum(torch.where((disc >= 0) & (r1 > 0), r1, inf),
                          torch.where((disc >= 0) & (r2 > 0), r2, inf))
    neg = ds[..., 0] < 0
    head = torch.where(neg, -s[..., 0] / torch.where(neg, ds[..., 0], -1.0),
                       inf)
    return torch.clamp(torch.minimum(roots.amin(), head.amin()), max=1.0)


def cone_operator(prob):
    """(G, h, q) of ``socp_pd_solve`` from an SOCPProblem:
    G_k = [c_kᵀ; A_k], h_k = [d_k; b_k], q (zeros without q)."""
    G = torch.cat([prob.c[:, None, :], prob.A], dim=1)
    h = torch.cat([prob.d[:, None], prob.b], dim=1)
    q = (prob.q if prob.q is not None
         else torch.zeros(prob.n, dtype=G.dtype, device=G.device))
    return G, h, q


class SOCPPDResult(NamedTuple):
    x: torch.Tensor       # primal iterate
    y: torch.Tensor       # equality multipliers (empty when no F)
    z: torch.Tensor       # cone duals (K, 1+M)
    s: torch.Tensor       # cone slacks (K, 1+M)
    lam_ub: torch.Tensor  # upper-bound multipliers (masked)
    lam_lb: torch.Tensor  # lower-bound multipliers (masked)
    iters: int
    converged: bool
    gap: float            # Σ s_kᵀz_k + Σ bound s·λ
    rp_norm: float
    rd_norm: float


def socp_pd_solve(G, h, q, x0, cfg, *, P=None, F=None, g=None, lb=None,
                  ub=None, max_iters=None, kkt_kernel=None,
                  exact_fallback=None, kkt_tols=None) -> SOCPPDResult:
    """Conic Mehrotra predictor-corrector solve (module docstring).

    G (K, 1+M, n), h (K, 1+M), q (n,), x0 (n,); P, (F, g), lb, ub
    optional (±inf bound entries are masked out).  ``kkt_kernel``: None =
    K5 when mixed-precision fp64 and ``use_pallas``, True = K5, False =
    the block elimination.  ``exact_fallback``: the elimination's fp64
    stall fallback (None = True).  ``kkt_tols``: (dir_tol, cg_tol,
    cg_rounds) of the K5 directions."""
    dtype, dev = G.dtype, G.device
    K, M1, n = G.shape
    has_P = P is not None
    has_eq = F is not None
    mixed = bool(cfg.mixed_precision) and dtype == torch.float64
    if max_iters is None:
        max_iters = int(cfg.pd_max_iters)
    e = torch.zeros((K, M1), dtype=dtype, device=dev)
    e[:, 0] = 1.0

    if kkt_kernel is None:
        use_kkt = mixed and bool(cfg.use_pallas)
    else:
        use_kkt = bool(kkt_kernel) and dtype == torch.float64
    if use_kkt:
        kc = prep_kkt_consts(F if has_eq else None, n)
        kkt_dir_tol, kkt_cg_tol, kkt_cg_rounds = (
            (1e-6, 1e-13, 24) if kkt_tols is None else kkt_tols)
    exact_fb = True if exact_fallback is None else bool(exact_fallback)
    if not use_kkt and not exact_fb:
        mf_dir_tol = dir_stall_tol(float(cfg.epsilon), cap=1e-4)
        mf_cg_tol = max(1e-12, 1e-2 * mf_dir_tol)

    inf = torch.full((n,), float("inf"), dtype=dtype, device=dev)
    ub_v = inf if ub is None else ub
    lb_v = -inf if lb is None else lb
    fub = torch.isfinite(ub_v).to(dtype)
    flb = torch.isfinite(lb_v).to(dtype)
    ubf = torch.where(fub > 0, ub_v, 0.0)
    lbf = torch.where(flb > 0, lb_v, 0.0)
    # complementarity degree: one per cone plus one per finite bound
    kcnt = K + fub.sum() + flb.sum()

    # cone-Gram constant GᵀJG = c_kc_kᵀ − A_kᵀA_k per cone
    jsign = torch.ones(M1, dtype=dtype, device=dev)
    jsign[1:] = -1.0
    JG = torch.einsum("m,kmn,kmo->kno", jsign, G, G)

    gap_tol = float(cfg.epsilon)
    feas_tol = max(1e-9, min(1e-6, gap_tol))
    # the dual test floors at 1e-8 relative: NT-scaling roundoff in the
    # recomputed rd keeps it there while the gap closes
    feas_tol_d = max(1e-8, feas_tol)
    scales = [h.abs().amax(), q.abs().amax(),
              torch.cat([ubf * fub, lbf * flb]).abs().amax()]
    if has_eq:
        scales.append(g.abs().amax())
    scales = sync.read_list(torch.stack(scales))
    h_scale = max([1.0 + scales[0], 1.0 + scales[2]]
                  + ([1.0 + scales[3]] if has_eq else []))
    q_scale = 1.0 + scales[1]

    def cone_map(x):
        return torch.einsum("kmn,n->km", G, x)

    def cone_adj(zz):
        return torch.einsum("kmn,km->n", G, zz)

    # ---- initialisation --------------------------------------------------
    x0 = x0.to(dtype)
    u0 = cone_map(x0) + h
    lam_min = u0[:, 0] - torch.linalg.norm(u0[:, 1:], dim=-1)
    shift = torch.clamp(0.1 * h_scale - lam_min, min=0.0)
    s0 = u0 + shift[:, None] * e
    z0 = e * max(1.0, 0.1 * q_scale)
    floor = 1e-4 * h_scale
    su0 = torch.where(fub > 0, torch.clamp(ubf - x0, min=floor), 1.0)
    lu0 = torch.where(fub > 0, torch.clamp(1.0 / su0, 1e-6, 1e6), 0.0)
    sl0 = torch.where(flb > 0, torch.clamp(x0 - lbf, min=floor), 1.0)
    ll0 = torch.where(flb > 0, torch.clamp(1.0 / sl0, 1e-6, 1e6), 0.0)
    y0 = torch.zeros(F.shape[0] if has_eq else 0, dtype=dtype, device=dev)

    def dual_res(x, y, z, lu, ll):
        rd = q - cone_adj(z) + lu * fub - ll * flb
        if has_P:
            rd = rd + P @ x
        if has_eq:
            rd = rd + F.T @ y
        return rd

    def gap_of(ss, zz, ssu, llu, ssl, lll):
        return ((ss * zz).sum() + (ssu * llu * fub).sum()
                + (ssl * lll * flb).sum())

    def primal_norm(x, s, su, sl):
        rp = cone_map(x) + h - s
        rpn = torch.maximum(
            rp.abs().amax(),
            torch.maximum(((x + su - ubf) * fub).abs().amax(),
                          ((-x + sl + lbf) * flb).abs().amax()))
        if has_eq:
            rpn = torch.maximum(rpn, (F @ x - g).abs().amax())
        return rpn

    def iteration(x, y, s, z, su, lu, sl, ll):
        rd = dual_res(x, y, z, lu, ll)
        rp = cone_map(x) + h - s
        rpu = (x + su - ubf) * fub
        rpl = (-x + sl + lbf) * flb
        rpe = (F @ x - g).contiguous() if has_eq else None

        # NT scaling per cone; λ = W z = W⁻¹ s
        uw, eta = nt_scaling(s, z)
        w = _jmul(uw, uw)
        lam = w_mul(uw, eta, z)
        eta1 = eta[:, 0]

        # H = P + Σ (1/η)(2 q_k q_kᵀ − GᵀJG_k) + bound diagonal
        wt = _jreflect(w)                     # w⁻¹ (det w = 1)
        qk = torch.einsum("kmn,km->kn", G, wt)
        H = (2.0 * torch.einsum("kn,ko->no", qk / eta1[:, None], qk)
             - torch.einsum("k,kno->no", 1.0 / eta1, JG))
        db = fub * lu / su + flb * ll / sl
        H = H + torch.diag(db)
        if has_P:
            H = H + P
        H = 0.5 * (H + H.T)

        def winv2(vv):
            """W⁻² v = (1/η)(2(w⁻¹ᵀv)w⁻¹ − Jv) per cone."""
            coef = 2.0 * (wt * vv).sum(dim=-1, keepdim=True)
            return (coef * wt - _jreflect(vv)) / eta1[:, None]

        def h_op(dx):
            """H·dx matrix-free in fp64 (the refinement's operator)."""
            out = cone_adj(winv2(cone_map(dx))) + db * dx
            return out + P @ dx if has_P else out

        if use_kkt:
            Hk, rho = augment(H, kc)
            fac = kkt_prepare(Hk, kc)   # shared by both directions
        else:
            solve_h = posdef_solver(H, mixed, exact_fallback=exact_fb)
            if not exact_fb:
                mf_fac = matrix_free_prepare(H, dtype)

                def solve_h_acc(bb):
                    return matrix_free_prepared_solve(
                        mf_fac, h_op, bb, rtol=mf_dir_tol)[0]
            if has_eq:
                Hinv_FT = solve_h(F.T)
                S = F @ Hinv_FT
                solve_s = posdef_solver(0.5 * (S + S.T), mixed,
                                        exact_fallback=exact_fb)

        def direction(dcomp, rcu, rcl):
            """Newton direction for the complementarity targets: cone
            dcomp (K, 1+M), bounds rcu/rcl (n,)."""
            t = -_arrow_solve(lam, dcomp)
            zc = w_inv_mul(uw, eta, t) - winv2(rp)
            r1 = (-rd + cone_adj(zc) + fub * (rcu - lu * rpu) / su
                  - flb * (rcl - ll * rpl) / sl)
            if use_kkt:
                dx, dy, _, _ = kkt_solve(
                    fac, rho, r1.contiguous(), rpe, dir_tol=kkt_dir_tol,
                    cg_tol=kkt_cg_tol, rounds=kkt_cg_rounds)
            elif has_eq and exact_fb:
                t1 = solve_h(r1)
                dy = solve_s(F @ t1 + rpe)
                dx = t1 - Hinv_FT @ dy
                # true-residual KKT refinement, factors reused
                for _ in range(4):
                    e1 = r1 - (h_op(dx) + F.T @ dy)
                    e2 = -rpe - F @ dx
                    f = solve_s(F @ solve_h(e1) - e2)
                    dx = dx + solve_h(e1 - F.T @ f)
                    dy = dy + f
            elif has_eq:
                # Schur-CG: operator applications through the accurate
                # H-solves, the fp32-grade solve_s only preconditions
                t1 = solve_h_acc(r1)
                u = F @ t1 + rpe
                un = torch.linalg.norm(u)
                dy = torch.zeros_like(u)
                res = u
                zz = solve_s(u)
                p, rz = zz, u @ zz
                for _ in range(16):
                    if not sync.read((torch.linalg.norm(res) > mf_cg_tol * un)
                                     & torch.isfinite(rz)):
                        break
                    sp = F @ solve_h_acc(F.T @ p)
                    den = p @ sp
                    a = rz / torch.where(den.abs() > 1e-300, den, 1e-300)
                    dy = dy + a * p
                    res = res - a * sp
                    zz = solve_s(res)
                    rz2 = res @ zz
                    beta = rz2 / torch.where(rz.abs() > 1e-300, rz, 1e-300)
                    p, rz = zz + beta * p, rz2
                dx = solve_h_acc(r1 - F.T @ dy)
            else:
                dy = y0
                if exact_fb:
                    dx = solve_h(r1)
                    for _ in range(3):
                        dx = dx + solve_h(r1 - h_op(dx))
                else:
                    dx = solve_h_acc(r1)
            ds = cone_map(dx) + rp
            dz = w_inv_mul(uw, eta, t) - winv2(ds)
            dsu = (-rpu - dx) * fub
            dlu = torch.where(fub > 0, (-rcu - lu * dsu) / su, 0.0)
            dsl = (-rpl + dx) * flb
            dll = torch.where(flb > 0, (-rcl - ll * dsl) / sl, 0.0)
            return dx, dy, ds, dz, dsu, dlu, dsl, dll

        mu = gap_of(s, z, su, lu, sl, ll) / kcnt

        # predictor: dcomp = λ∘λ, bound rc = s·λ
        dx_a, _, ds_a, dz_a, dsu_a, dlu_a, dsl_a, dll_a = direction(
            _jmul(lam, lam), su * lu * fub, sl * ll * flb)
        ap_a = torch.minimum(torch.minimum(max_step_cone(s, ds_a),
                                           _max_step_lin(su, dsu_a)),
                             _max_step_lin(sl, dsl_a))
        ad_a = torch.minimum(torch.minimum(max_step_cone(z, dz_a),
                                           _max_step_lin(lu, dlu_a)),
                             _max_step_lin(ll, dll_a))
        mu_aff = gap_of(s + ap_a * ds_a, z + ad_a * dz_a,
                        su + ap_a * dsu_a, lu + ad_a * dlu_a,
                        sl + ap_a * dsl_a, ll + ad_a * dll_a) / kcnt
        sigma = torch.clamp((mu_aff / mu) ** 3, 0.0, 1.0)

        # corrector: dcomp = λ∘λ − σμe + (W⁻¹ds_aff)∘(W dz_aff)
        corr = _jmul(w_inv_mul(uw, eta, ds_a), w_mul(uw, eta, dz_a))
        dcomp = _jmul(lam, lam) - sigma * mu * e + corr
        rcu = (su * lu - sigma * mu + dsu_a * dlu_a) * fub
        rcl = (sl * ll - sigma * mu + dsl_a * dll_a) * flb
        dx, dy, ds, dz, dsu, dlu, dsl, dll = direction(dcomp, rcu, rcl)
        ap = torch.clamp(_GAMMA * torch.minimum(
            torch.minimum(max_step_cone(s, ds), _max_step_lin(su, dsu)),
            _max_step_lin(sl, dsl)), max=1.0)
        ad = torch.clamp(_GAMMA * torch.minimum(
            torch.minimum(max_step_cone(z, dz), _max_step_lin(lu, dlu)),
            _max_step_lin(ll, dll)), max=1.0)

        x2 = x + ap * dx
        y2 = y + ad * dy
        s2 = s + ap * ds
        z2 = z + ad * dz
        su2 = torch.where(fub > 0, su + ap * dsu, 1.0)
        lu2 = lu + ad * dlu
        sl2 = torch.where(flb > 0, sl + ap * dsl, 1.0)
        ll2 = ll + ad * dll
        stats = torch.stack([
            gap_of(s2, z2, su2, lu2, sl2, ll2), primal_norm(x2, s2, su2, sl2),
            dual_res(x2, y2, z2, lu2, ll2).abs().amax(), ap, ad,
            (torch.isfinite(x2).all() & torch.isfinite(z2).all()).to(dtype)])
        return (x2, y2, s2, z2, su2, lu2, sl2, ll2), stats

    def done(gap, rpn, rdn):
        return (gap < gap_tol and rpn < feas_tol * h_scale
                and rdn < feas_tol_d * q_scale)

    st = (x0, y0, s0, z0, su0, lu0, sl0, ll0)
    gap, rpn, rdn = sync.read_list(torch.stack([
        gap_of(s0, z0, su0, lu0, sl0, ll0), primal_norm(x0, s0, su0, sl0),
        dual_res(x0, y0, z0, lu0, ll0).abs().amax()]))
    it, stalled = 0, False
    while (it < max_iters and not done(gap, rpn, rdn) and not stalled
           and math.isfinite(gap)):
        st2, stats = iteration(*st)
        g2, rpn2, rdn2, ap, ad, fin = sync.read_list(stats)
        # non-finite guard: at μ near machine precision the NT scaling's
        # cone determinants underflow and the step degenerates; keep the
        # previous iterate and stop
        bad = not (math.isfinite(g2) and math.isfinite(rpn2)
                   and math.isfinite(rdn2) and fin == 1.0)
        stalled = (ap < _STALL_STEP and ad < _STALL_STEP) or bad
        if not bad:
            st, gap, rpn, rdn = st2, g2, rpn2, rdn2
        it += 1
    x, y, s, z, su, lu, sl, ll = st
    return SOCPPDResult(x=x, y=y, z=z, s=s, lam_ub=lu, lam_lb=ll, iters=it,
                        converged=done(gap, rpn, rdn), gap=gap, rp_norm=rpn,
                        rd_norm=rdn)
