"""Barrier oracles for LP/QP and phase one (counterpart of the LP/QP part
of interiorpoint_tpu/ops/barrier.py; the SOCP oracles are in ops/socp.py).

Pure functions of (x, t) over one problem: objective, gradient and Hessian
of t·f(x) − Σ log sᵢ(x), the slacks, and the closed-form line-search
sweeps ``ls_objs``/``ls_grads`` that evaluate all J candidate steps σⱼ at
once (slacks are affine in σ).  fp64 torch on the problem's device.

``lin_form`` = (C, d, c, P) marks the single-block form
min t·(cᵀz [+ ½zᵀPz]) − Σ log(d − Cz) (bounds folded into C, the reduced
problem of models/reduced.py); the feasible-start engine (ops/newton.py)
then runs the fused step K2 (ops/newton_step.py), whose constants
``nt_consts()`` (fp32 C) are made once per oracle.  The phase-one oracle's
form is the augmented [C | −1] block with cost e_s, built once.

``socp_form`` marks the pure-cone SOCP form (no bounds, no equality
block: the reduced SOCP of models/reduced.py); the feasible-start engine
then runs the fused SOCP step K4 (ops/socp_step.py), whose constants
``socp_consts()`` are made once per oracle.

Left out, by design: the double-float matvec split (``dd_override``) and
the matrix-free ``hess_op`` exist because the TPU has no fp64.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch

from ..models.problem import QPProblem
from .newton_step import prep_newton_consts

# 1e-15 added to slacks inside logs and reciprocals (the reference's
# constant, interiorpoint_tpu/ops/barrier.py SLACK_EPS).
SLACK_EPS = 1e-15
# added to the squared-cone slacks of the SOCP oracles (SOCP_SLACK_EPS of
# interiorpoint_tpu/ops/barrier.py)
SOCP_SLACK_EPS = 1e-12


class Oracle(NamedTuple):
    """Bundle of pure functions consumed by the Newton engines."""

    n: int                       # number of optimization variables
    diag_hessian: bool
    obj: Callable                # (x,) -> scalar objective
    grad: Callable               # (x, t) -> (n,) gradient of t·f − Σ log s
    hess: Callable               # (x, t) -> (n, n), or (n,) if diag_hessian
    newton_obj: Callable         # (x, t) -> scalar t·f(x) − Σ log s
    min_slack: Callable          # (x,) -> scalar min slack
    ls_grads: Callable           # (x, dx, t, sigmas) -> (domain_ok, grads)
    ls_objs: Callable            # (x, dx, t, sigmas) -> (domain_ok, nobjs)
    lin_form: Optional[tuple] = None
    # () -> NTConsts of lin_form (made on first call, then kept)
    nt_consts: Optional[Callable] = None
    socp_form: Optional[object] = None   # SOCPProblem, pure-cone form
    # () -> SOCPConsts of socp_form (made on first call, then kept)
    socp_consts: Optional[Callable] = None


def _linear_slack_parts(prob, x):
    """Slack segments in reference order [Cx≤d, ub, lb]."""
    parts = []
    if prob.C is not None:
        parts.append(prob.d - prob.C @ x)
    if prob.ub is not None:
        parts.append(prob.ub - x)
    if prob.lb is not None:
        parts.append(x - prob.lb)
    return parts


def _linear_dslack_parts(prob, dx):
    """d(slack)/dσ for the step x + σ·dx, slack(σ) = s0 − σ·ds."""
    parts = []
    if prob.C is not None:
        parts.append(prob.C @ dx)
    if prob.ub is not None:
        parts.append(dx)
    if prob.lb is not None:
        parts.append(-dx)
    return parts


def full_linear_slacks(prob, x):
    """Concatenated slack vector in reference order [Cx≤d, ub, lb] (for
    the dual recovery λ* = 1/(t·slacks))."""
    parts = _linear_slack_parts(prob, x)
    if not parts:
        return torch.zeros(0, dtype=x.dtype, device=x.device)
    return torch.cat([p.reshape(-1) for p in parts])


def _domain_ok(cands, J, like):
    ok = torch.ones(J, dtype=torch.bool, device=like.device)
    for cs in cands:
        ok = ok & (cs > 0.0).all(dim=0)
    return ok


def _consts_of(lin_form):
    return functools.lru_cache(maxsize=1)(
        lambda: prep_newton_consts(lin_form[0], lin_form[1]))


def make_qp_oracle(prob, try_diag: bool = True) -> Oracle:
    """Oracle for LP/QP barrier subproblems (LPProblem: cost c;
    QPProblem: ½xᵀPx + qᵀx)."""
    is_qp = isinstance(prob, QPProblem)
    P = prob.P if is_qp else None
    lin = prob.q if is_qp else prob.c
    n = prob.n
    bounded = prob.lb is not None or prob.ub is not None
    # Diagonal fast path: LP only, no dense inequality block, bounded.
    diag = (not is_qp) and try_diag and prob.C is None and bounded

    def obj(x):
        if is_qp:
            val = 0.5 * x @ (P @ x)
            if lin is not None:
                val = val + lin @ x
            return val
        return lin @ x

    def _lin_grad(x):
        if is_qp:
            g = P @ x
            if lin is not None:
                g = g + lin
            return g
        return lin

    def _inv_slacks(x):
        return [1.0 / (s + SLACK_EPS) for s in _linear_slack_parts(prob, x)]

    def grad(x, t):
        g = t * _lin_grad(x)
        invs = iter(_inv_slacks(x))
        if prob.C is not None:
            g = g + prob.C.T @ next(invs)
        if prob.ub is not None:
            g = g + next(invs)
        if prob.lb is not None:
            g = g - next(invs)
        return g

    def hess(x, t):
        invs = iter(_inv_slacks(x))
        if diag:
            h = torch.zeros(n, dtype=x.dtype, device=x.device)
            if prob.ub is not None:
                h = h + next(invs) ** 2
            if prob.lb is not None:
                h = h + next(invs) ** 2
            return h
        if is_qp:
            H = t * P
        else:
            H = torch.zeros((n, n), dtype=x.dtype, device=x.device)
        if prob.C is not None:
            ic = next(invs)
            H = H + prob.C.T @ (ic[:, None] ** 2 * prob.C)
        db = torch.zeros(n, dtype=x.dtype, device=x.device)
        if prob.ub is not None:
            db = db + next(invs) ** 2
        if prob.lb is not None:
            db = db + next(invs) ** 2
        if bounded:
            H = H + torch.diag(db)
        return H

    def newton_obj(x, t):
        val = t * obj(x)
        for s in _linear_slack_parts(prob, x):
            val = val - torch.log(s + SLACK_EPS).sum()
        return val

    def min_slack(x):
        parts = _linear_slack_parts(prob, x)
        if not parts:
            return torch.tensor(float("inf"), dtype=x.dtype,
                                device=x.device)
        return torch.cat([p.reshape(-1) for p in parts]).amin()

    def _cand_slacks(x, dx, sigmas):
        """Per-segment candidate slacks, shape (seg_len, J)."""
        s0 = _linear_slack_parts(prob, x)
        ds = _linear_dslack_parts(prob, dx)
        return [a[:, None] - sigmas[None, :] * b[:, None]
                for a, b in zip(s0, ds)]

    def ls_grads(x, dx, t, sigmas):
        """Candidate gradients for the infeasible-start residual search:
        grad(x+σdx) = t·(Px+q) + σ·t·P dx + Cᵀ(1/s_C(σ)) + 1/s_ub(σ)
        − 1/s_lb(σ)."""
        J = sigmas.shape[0]
        cands = _cand_slacks(x, dx, sigmas)
        ok = _domain_ok(cands, J, x)
        grads = (t * _lin_grad(x))[:, None].expand(n, J)
        if is_qp:
            grads = grads + sigmas[None, :] * (t * (P @ dx))[:, None]
        it = iter(cands)
        if prob.C is not None:
            grads = grads + prob.C.T @ (1.0 / (next(it) + SLACK_EPS))
        if prob.ub is not None:
            grads = grads + 1.0 / (next(it) + SLACK_EPS)
        if prob.lb is not None:
            grads = grads - 1.0 / (next(it) + SLACK_EPS)
        return ok, grads

    def ls_objs(x, dx, t, sigmas):
        """Candidate Newton objectives for the feasible-start Armijo
        search: t·f(x+σdx) is quadratic in σ, plus the logs of the affine
        candidate slacks."""
        J = sigmas.shape[0]
        cands = _cand_slacks(x, dx, sigmas)
        ok = _domain_ok(cands, J, x)
        vals = t * (obj(x) + sigmas * (_lin_grad(x) @ dx))
        if is_qp:
            vals = vals + t * (0.5 * (dx @ (P @ dx))) * sigmas ** 2
        for cs in cands:
            vals = vals - torch.log(cs + SLACK_EPS).sum(dim=0)
        return ok, vals

    lin_form = None
    nt_consts = None
    if prob.C is not None and prob.lb is None and prob.ub is None:
        lin_form = (prob.C, prob.d, lin, P)
        nt_consts = _consts_of(lin_form)

    return Oracle(n=n, diag_hessian=diag, obj=obj, grad=grad, hess=hess,
                  newton_obj=newton_obj, min_slack=min_slack,
                  ls_grads=ls_grads, ls_objs=ls_objs, lin_form=lin_form,
                  nt_consts=nt_consts)


def make_phase1_linear_oracle(prob) -> Oracle:
    """Phase-one oracle over z = [x, s] for linear inequalities and
    bounds: objective s, barrier slacks s + slackᵢ(x)."""
    n = prob.n
    nz = n + 1

    def _slack_parts(z):
        x, s = z[:-1], z[-1]
        return [p + s for p in _linear_slack_parts(prob, x)]

    def obj(z):
        return z[-1]

    def _inv(z):
        return [1.0 / (p + SLACK_EPS) for p in _slack_parts(z)]

    def grad(z, t):
        invs = _inv(z)
        it = iter(invs)
        gx = torch.zeros(n, dtype=z.dtype, device=z.device)
        if prob.C is not None:
            gx = gx + prob.C.T @ next(it)
        if prob.ub is not None:
            gx = gx + next(it)
        if prob.lb is not None:
            gx = gx - next(it)
        gs = t - sum(v.sum() for v in invs)
        return torch.cat([gx, gs.reshape(1)])

    def hess(z, t):
        """Bordered Hessian [[H_xx, h_xs], [h_xsᵀ, h_ss]]."""
        invs = _inv(z)
        it = iter(invs)
        dev = dict(dtype=z.dtype, device=z.device)
        Hxx = torch.zeros((n, n), **dev)
        hxs = torch.zeros(n, **dev)
        if prob.C is not None:
            ic2 = next(it) ** 2
            Hxx = Hxx + prob.C.T @ (ic2[:, None] * prob.C)
            hxs = hxs - prob.C.T @ ic2
        db = torch.zeros(n, **dev)
        if prob.ub is not None:
            iu2 = next(it) ** 2
            db = db + iu2
            hxs = hxs - iu2
        if prob.lb is not None:
            il2 = next(it) ** 2
            db = db + il2
            hxs = hxs + il2
        Hxx = Hxx + torch.diag(db)
        hss = sum((v ** 2).sum() for v in invs)
        top = torch.cat([Hxx, hxs[:, None]], dim=1)
        bot = torch.cat([hxs, hss.reshape(1)])[None, :]
        return torch.cat([top, bot], dim=0)

    def newton_obj(z, t):
        val = t * z[-1]
        for p in _slack_parts(z):
            val = val - torch.log(p + SLACK_EPS).sum()
        return val

    def min_slack(z):
        return torch.cat([p.reshape(-1) for p in _slack_parts(z)]).amin()

    def _cand_slacks(z, dz, sigmas):
        dx, dsg = dz[:-1], dz[-1]
        s0 = _slack_parts(z)
        ds = _linear_dslack_parts(prob, dx)  # slack(σ) = s0 − σ·ds + σ·dsg
        return [a[:, None] + sigmas[None, :] * (dsg - b)[:, None]
                for a, b in zip(s0, ds)]

    def ls_objs(z, dz, t, sigmas):
        cands = _cand_slacks(z, dz, sigmas)
        ok = _domain_ok(cands, sigmas.shape[0], z)
        vals = t * (z[-1] + sigmas * dz[-1])
        for cs in cands:
            vals = vals - torch.log(cs + SLACK_EPS).sum(dim=0)
        return ok, vals

    def ls_grads(z, dz, t, sigmas):
        raise NotImplementedError(
            "phase-1 uses the feasible-start engine (reference: "
            "PhaseOneSolver.py:91-110 always dispatches NewtonSolverCholesky)"
        )

    # The phase-one problem is an LP in z = [x, s]: rows [C | −1]·z ≤ d,
    # cost e_s, so the fused step applies to it too (same gate as the main
    # oracle: bounds already folded into C).  The block is built once.
    lin_form = None
    nt_consts = None
    if prob.C is not None and prob.lb is None and prob.ub is None:
        k = prob.C.shape[0]
        Cp = torch.cat([prob.C, -torch.ones((k, 1), dtype=prob.C.dtype,
                                            device=prob.C.device)], dim=1)
        cost = torch.zeros(nz, dtype=prob.C.dtype, device=prob.C.device)
        cost[-1] = 1.0
        lin_form = (Cp, prob.d, cost, None)
        nt_consts = _consts_of(lin_form)

    return Oracle(n=nz, diag_hessian=False, obj=obj, grad=grad, hess=hess,
                  newton_obj=newton_obj, min_slack=min_slack,
                  ls_grads=ls_grads, ls_objs=ls_objs, lin_form=lin_form,
                  nt_consts=nt_consts)
