"""SOCP barrier oracles over stacked, zero-padded cone tensors (counterpart
of interiorpoint_tpu/ops/socp.py).

All K cones live in (K, M, n)/(K, M)/(K, n)/(K,) tensors; padded rows are
exact no-ops in the ‖·‖² sums.  fp64 torch on the problem's device.

Conventions of the reference, kept:
* the squared-cone slack sₖ = (cₖᵀx + dₖ)² − ‖Aₖx + bₖ‖², with the raw
  rhs values cₖᵀx + dₖ appended to the slack vector in the order
  [cones, ub, lb, rhs] so that the domain test also enforces rhs ≥ 0; in
  the main oracle the rhs entries are domain-only (not in the barrier
  sum), in phase one rhs + s are real barrier terms (every start is then
  valid, and an exit with s < 0 certifies rhs > 0);
* the Hessian's curvature term adds +cₖcₖᵀ where the analytic Hessian of
  −log(rhs² − ‖lhs‖²) has −cₖcₖᵀ: a Gauss–Newton-style PSD choice the
  reference makes and the JAX package reproduces.

The JAX package's double-float contractions (``_use_dd``, ``_dd_mv``,
``_dd_aty``, ``_split_gram``) exist because the TPU has no fp64; the port
computes in fp64 and is the JAX oracle with ``dd=False`` (what that
package runs on the CPU too).

The per-cone curvature cache Σ-ready AₖᵀAₖ + cₖcₖᵀ (K·n·n fp64: 36 MB at
K=5, n=950) is built on the first ``hess`` call, never before: the fused
step K4 (ops/socp_step.py) needs none of it, and a solve that runs only K4
never allocates it (``curvature_cache_builds`` counts the builds).
"""

from __future__ import annotations

import functools

import torch

from .barrier import Oracle, SLACK_EPS, SOCP_SLACK_EPS
from .socp_step import prep_socp_consts

# Cache the per-cone AᵀA + ccᵀ (K, n, n) up to this many elements, else
# recompute the weighted sum per call from the stacked (K·M, n) matrix.
_CACHE_LIMIT_ELEMENTS = 2 ** 28
# per-cone curvature caches built so far (the first ``hess`` of an oracle)
curvature_cache_builds = 0


def _Ax(prob, x):
    """Aₖx for every cone, (K, M)."""
    return torch.einsum("kmn,n->km", prob.A, x)


def _ATy(prob, y):
    """Aₖᵀyₖ for every cone, (K, n)."""
    return torch.einsum("kmn,km->kn", prob.A, y)


def _cone_parts(prob, x):
    lhs = _Ax(prob, x) + prob.b                       # (K, M)
    rhs = prob.c @ x + prob.d                         # (K,)
    slack = rhs ** 2 - (lhs ** 2).sum(dim=-1)         # (K,)
    return lhs, rhs, slack


def _bound_slack_parts(prob, x):
    parts = []
    if prob.ub is not None:
        parts.append(prob.ub - x)
    if prob.lb is not None:
        parts.append(x - prob.lb)
    return parts


def socp_full_slacks(prob, x):
    """The full slack vector in the order [cones, ub, lb, rhs] (for the
    dual recovery λ* = 1/(t·slacks))."""
    _, rhs, slack = _cone_parts(prob, x)
    parts = [slack] + _bound_slack_parts(prob, x) + [rhs]
    return torch.cat([p.reshape(-1) for p in parts])


def _curvature_fn(prob):
    """Σₖ wₖ(AₖᵀAₖ + cₖcₖᵀ) as a function of w, with the per-cone cache
    built on its first call."""
    K, M, n = prob.A.shape

    @functools.lru_cache(maxsize=1)
    def cache():
        global curvature_cache_builds
        if K * n * n > _CACHE_LIMIT_ELEMENTS:
            return None
        curvature_cache_builds += 1
        return (torch.einsum("kmn,kml->knl", prob.A, prob.A)
                + torch.einsum("kn,kl->knl", prob.c, prob.c))

    def curvature(w):
        ata_cct = cache()
        if ata_cct is not None:
            return torch.einsum("k,knl->nl", w, ata_cct)
        scaled = torch.sqrt(w)[:, None, None] * prob.A
        B = scaled.reshape(K * M, n)
        cw = torch.sqrt(w)[:, None] * prob.c
        return B.T @ B + cw.T @ cw

    return curvature


def _G(prob, lhs, rhs):
    """Per-cone ∇slack/(−2) = Aₖᵀlhsₖ − cₖ·rhsₖ, stacked (K, n)."""
    return _ATy(prob, lhs) - prob.c * rhs[:, None]


def make_socp_oracle(prob) -> Oracle:
    """Oracle of the SOCP barrier subproblem
    t·(½xᵀPx + qᵀx) − Σₖ log(sₖ + ε) − Σ log(bound slacks)."""
    n = prob.n
    bounded = prob.lb is not None or prob.ub is not None
    curvature = _curvature_fn(prob)

    def obj(x):
        val = torch.zeros((), dtype=x.dtype, device=x.device)
        if prob.P is not None:
            val = val + 0.5 * x @ (prob.P @ x)
        if prob.q is not None:
            val = val + prob.q @ x
        return val

    def _lin_grad(x):
        g = torch.zeros(n, dtype=x.dtype, device=x.device)
        if prob.P is not None:
            g = g + prob.P @ x
        if prob.q is not None:
            g = g + prob.q
        return g

    def grad(x, t):
        lhs, rhs, slack = _cone_parts(prob, x)
        w = 2.0 / (slack + SOCP_SLACK_EPS)
        g = t * _lin_grad(x) + w @ _G(prob, lhs, rhs)
        if prob.lb is not None:
            g = g - 1.0 / (x - prob.lb + SLACK_EPS)
        if prob.ub is not None:
            g = g + 1.0 / (prob.ub - x + SLACK_EPS)
        return g

    def hess(x, t):
        lhs, rhs, slack = _cone_parts(prob, x)
        w = 2.0 / (slack + SOCP_SLACK_EPS)
        Gw = w[:, None] * _G(prob, lhs, rhs)
        H = curvature(w) + Gw.T @ Gw
        if prob.P is not None:
            H = H + t * prob.P
        if bounded:
            db = torch.zeros(n, dtype=x.dtype, device=x.device)
            if prob.lb is not None:
                db = db + 1.0 / (x - prob.lb + SLACK_EPS) ** 2
            if prob.ub is not None:
                db = db + 1.0 / (prob.ub - x + SLACK_EPS) ** 2
            H = H + torch.diag(db)
        return H

    def newton_obj(x, t):
        """Cone and bound slacks only: the rhs entries are domain-only."""
        _, _, slack = _cone_parts(prob, x)
        val = t * obj(x) - torch.log(slack + SOCP_SLACK_EPS).sum()
        for p in _bound_slack_parts(prob, x):
            val = val - torch.log(p + SLACK_EPS).sum()
        return val

    def min_slack(x):
        _, rhs, slack = _cone_parts(prob, x)
        parts = [slack] + _bound_slack_parts(prob, x) + [rhs]
        return torch.cat([p.reshape(-1) for p in parts]).amin()

    def _cands(x, dx, sigmas):
        """Cone slacks along the step, quadratic in σ:
        s(σ) = s0 + σ·p1 + σ²·p2, p1 = 2(rhs·cdx − Σ lhs·Adx),
        p2 = cdx² − Σ Adx²; rhs and bound slacks affine in σ."""
        lhs, rhs, s0 = _cone_parts(prob, x)
        lhsdx = _Ax(prob, dx)
        cdx = prob.c @ dx
        p1 = 2.0 * (rhs * cdx - (lhs * lhsdx).sum(dim=-1))
        p2 = cdx ** 2 - (lhsdx ** 2).sum(dim=-1)
        cone_cands = (s0[:, None] + sigmas[None, :] * p1[:, None]
                      + (sigmas ** 2)[None, :] * p2[:, None])     # (K, J)
        rhs_cands = rhs[:, None] + sigmas[None, :] * cdx[:, None]
        bound_cands = []
        if prob.ub is not None:
            bound_cands.append((prob.ub - x)[:, None]
                               - sigmas[None, :] * dx[:, None])
        if prob.lb is not None:
            bound_cands.append((x - prob.lb)[:, None]
                               + sigmas[None, :] * dx[:, None])
        ok = (cone_cands > 0.0).all(dim=0) & (rhs_cands > 0.0).all(dim=0)
        for bc in bound_cands:
            ok = ok & (bc > 0.0).all(dim=0)
        return ok, cone_cands, bound_cands, (lhs, rhs, lhsdx, cdx)

    def ls_grads(x, dx, t, sigmas):
        ok, cone_cands, bound_cands, (lhs, rhs, lhsdx, cdx) = _cands(
            x, dx, sigmas)
        W = 2.0 / (cone_cands + SOCP_SLACK_EPS)                  # (K, J)
        G0 = _G(prob, lhs, rhs)
        G1 = _ATy(prob, lhsdx) - prob.c * cdx[:, None]
        grads = G0.T @ W + G1.T @ (W * sigmas[None, :])          # (n, J)
        grads = grads + (t * _lin_grad(x))[:, None]
        if prob.P is not None:
            grads = grads + sigmas[None, :] * (t * (prob.P @ dx))[:, None]
        it = iter(bound_cands)
        if prob.ub is not None:
            grads = grads + 1.0 / (next(it) + SLACK_EPS)
        if prob.lb is not None:
            grads = grads - 1.0 / (next(it) + SLACK_EPS)
        return ok, grads

    def ls_objs(x, dx, t, sigmas):
        ok, cone_cands, bound_cands, _ = _cands(x, dx, sigmas)
        vals = t * (obj(x) + sigmas * (_lin_grad(x) @ dx))
        if prob.P is not None:
            vals = vals + t * (0.5 * (dx @ (prob.P @ dx))) * sigmas ** 2
        vals = vals - torch.log(cone_cands + SOCP_SLACK_EPS).sum(dim=0)
        for bc in bound_cands:
            vals = vals - torch.log(bc + SLACK_EPS).sum(dim=0)
        return ok, vals

    # the pure-cone form (no bounds, no equality block) takes K4
    socp_form = prob if (not bounded and prob.F is None) else None
    socp_consts = None
    if socp_form is not None:
        socp_consts = functools.lru_cache(maxsize=1)(
            lambda: prep_socp_consts(prob))
    return Oracle(n=n, diag_hessian=False, obj=obj, grad=grad, hess=hess,
                  newton_obj=newton_obj, min_slack=min_slack,
                  ls_grads=ls_grads, ls_objs=ls_objs, socp_form=socp_form,
                  socp_consts=socp_consts)


def make_phase1_socp_oracle(prob) -> Oracle:
    """Phase-one oracle over z = [x, s]: min s s.t. squared-cone and bound
    slacks + s ≥ 0, with rhsₖ + s ≥ 0 as real barrier terms (see the
    module docstring).  No fused step applies (the engine's gate excludes
    phase one)."""
    n = prob.n
    curvature = _curvature_fn(prob)

    def _parts(z):
        x, s = z[:-1], z[-1]
        lhs, rhs, slack = _cone_parts(prob, x)
        bound_sl = [p + s for p in _bound_slack_parts(prob, x)]
        return x, s, lhs, rhs, slack + s, bound_sl

    def obj(z):
        return z[-1]

    def grad(z, t):
        x, s, lhs, rhs, cone_sl, bound_sl = _parts(z)
        inv_cone = 1.0 / (cone_sl + SLACK_EPS)
        w = 2.0 * inv_cone
        inv_rhs = 1.0 / (rhs + s + SLACK_EPS)
        gx = w @ _G(prob, lhs, rhs) - inv_rhs @ prob.c
        inv_sum = inv_cone.sum() + inv_rhs.sum()
        it = iter(bound_sl)
        if prob.ub is not None:
            iu = 1.0 / (next(it) + SLACK_EPS)
            gx = gx + iu
            inv_sum = inv_sum + iu.sum()
        if prob.lb is not None:
            il = 1.0 / (next(it) + SLACK_EPS)
            gx = gx - il
            inv_sum = inv_sum + il.sum()
        return torch.cat([gx, (t - inv_sum).reshape(1)])

    def hess(z, t):
        x, s, lhs, rhs, cone_sl, bound_sl = _parts(z)
        inv_cone = 1.0 / (cone_sl + SLACK_EPS)
        w = 2.0 * inv_cone
        Gw = w[:, None] * _G(prob, lhs, rhs)
        Hxx = curvature(w) + Gw.T @ Gw
        hxs = -(inv_cone @ Gw)
        hss = (inv_cone ** 2).sum()
        # rhs + s terms: c cᵀ/u², c/u², 1/u² with u = rhsₖ + s
        inv_rhs = 1.0 / (rhs + s + SLACK_EPS)
        Cw = inv_rhs[:, None] * prob.c
        Hxx = Hxx + Cw.T @ Cw
        hxs = hxs + inv_rhs ** 2 @ prob.c
        hss = hss + (inv_rhs ** 2).sum()
        db = torch.zeros(n, dtype=z.dtype, device=z.device)
        it = iter(bound_sl)
        if prob.ub is not None:
            iu2 = (1.0 / (next(it) + SLACK_EPS)) ** 2
            db = db + iu2
            hxs = hxs - iu2
            hss = hss + iu2.sum()
        if prob.lb is not None:
            il2 = (1.0 / (next(it) + SLACK_EPS)) ** 2
            db = db + il2
            hxs = hxs + il2
            hss = hss + il2.sum()
        Hxx = Hxx + torch.diag(db)
        top = torch.cat([Hxx, hxs[:, None]], dim=1)
        bot = torch.cat([hxs, hss.reshape(1)])[None, :]
        return torch.cat([top, bot], dim=0)

    def newton_obj(z, t):
        x, s, lhs, rhs, cone_sl, bound_sl = _parts(z)
        val = t * s - torch.log(cone_sl + SLACK_EPS).sum()
        val = val - torch.log(rhs + s + SLACK_EPS).sum()
        for p in bound_sl:
            val = val - torch.log(p + SLACK_EPS).sum()
        return val

    def min_slack(z):
        x, s, lhs, rhs, cone_sl, bound_sl = _parts(z)
        parts = [cone_sl] + bound_sl + [rhs + s]
        return torch.cat([p.reshape(-1) for p in parts]).amin()

    def ls_objs(z, dz, t, sigmas):
        x, s, lhs, rhs, cone_sl, bound_sl = _parts(z)
        dx, dsg = dz[:-1], dz[-1]
        lhsdx = _Ax(prob, dx)
        cdx = prob.c @ dx
        p1 = 2.0 * (rhs * cdx - (lhs * lhsdx).sum(dim=-1)) + dsg
        p2 = cdx ** 2 - (lhsdx ** 2).sum(dim=-1)
        cone_cands = (cone_sl[:, None] + sigmas[None, :] * p1[:, None]
                      + (sigmas ** 2)[None, :] * p2[:, None])
        rhs_cands = ((rhs + s)[:, None]
                     + sigmas[None, :] * (cdx + dsg)[:, None])
        ok = (cone_cands > 0.0).all(dim=0) & (rhs_cands > 0.0).all(dim=0)
        vals = t * (s + sigmas * dsg)
        vals = vals - torch.log(cone_cands + SLACK_EPS).sum(dim=0)
        vals = vals - torch.log(rhs_cands + SLACK_EPS).sum(dim=0)
        bound_d = []
        if prob.ub is not None:
            bound_d.append(-dx)
        if prob.lb is not None:
            bound_d.append(dx)
        for p, dp in zip(bound_sl, bound_d):
            bc = p[:, None] + sigmas[None, :] * (dp + dsg)[:, None]
            ok = ok & (bc > 0.0).all(dim=0)
            vals = vals - torch.log(bc + SLACK_EPS).sum(dim=0)
        return ok, vals

    def ls_grads(z, dz, t, sigmas):
        raise NotImplementedError(
            "SOCP phase-1 uses the feasible-start engine")

    return Oracle(n=n + 1, diag_hessian=False, obj=obj, grad=grad, hess=hess,
                  newton_obj=newton_obj, min_slack=min_slack,
                  ls_grads=ls_grads, ls_objs=ls_objs)
