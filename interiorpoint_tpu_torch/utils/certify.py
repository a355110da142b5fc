"""KKT certificates of solved LP/QP/SOCP drivers (counterpart of
interiorpoint_tpu/utils/certify.py).

Given a SOLVED driver of the port, evaluates the first-order KKT
conditions at (x*, λ*, v*) in fp64 numpy on the host, with no external
solver:

  * stationarity     ‖∇f + Σλ_j∇g_j + Aᵀv‖∞ / max(1, ‖∇f‖∞)
  * eq_residual      ‖Ax* − b‖∞  (Fx* − g for SOCP)
  * min_slack        min_j(−g_j(x*))
  * complementarity  max_j λ_j·(−g_j(x*))
  * dual_gap         m/t

``polish=True`` (default) fits (λ_active, v) to the stationarity
equation on the active set read from the slacks, clips negative λ and
refits once; ``polish=False`` certifies the barrier's analytic duals
λ = 1/(t·slacks).  SOCP uses the squared-cone form, slack_k =
(c_kᵀx+d_k)² − ‖A_kx+b_k‖², whose gradient is 2(A_kᵀlhs_k − c_k·rhs_k);
the rhs-domain entries carry no barrier force and are left out.

The driver's tensors (problem data, slacks) may live on the GPU: they
reach numpy through ``.cpu()``.

Usage::

    solver = LPSolver(..., device="cuda"); solver.solve()
    cert = certify(solver)
    assert cert.ok(1e-6), cert
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass(frozen=True)
class Certificate:
    """KKT residuals at the returned iterate; see the module docstring."""

    kind: str
    objective: float
    stationarity: float
    eq_residual: float
    min_slack: float
    complementarity: float
    dual_gap: float
    polished: bool

    def ok(self, tol: float = 1e-6, gap_tol: Optional[float] = None) -> bool:
        """True for a tol-accurate KKT point: primal feasible to ``tol``
        (primal-dual solutions sit on active constraints to rounding,
        hence ≥ −tol), stationary and equality-feasible to ``tol``
        (relative), complementarity below ``tol`` and the duality gap
        below ``gap_tol`` (default ``tol``)."""
        return (self.min_slack >= -tol
                and self.stationarity <= tol
                and self.eq_residual <= tol
                and self.complementarity <= tol
                and self.dual_gap <= (tol if gap_tol is None else gap_tol))


def _np(v):
    """fp64 numpy copy of a tensor (on any device) or an array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().to(torch.float64).numpy()
    return np.asarray(v, dtype=np.float64)


def _ineq_system(solver, x):
    """(G, slacks of G's rows, all slacks, ∇f): the stacked inequality
    gradients (rows ∇g_j of g_j ≤ 0) in the slack order of the driver,
    [Cx≤d, ub, lb] for LP/QP and [cones, ub, lb] for SOCP."""
    prob = solver._prob
    n = x.shape[0]
    x_t = torch.as_tensor(x, dtype=solver.cfg.torch_dtype,
                          device=solver.device)
    slacks = _np(solver._slacks_at(x_t))
    rows, segs = [], []

    if hasattr(prob, "num_cones"):
        Ak = _np(prob.A)                       # (K, M, n)
        ck = _np(prob.c)                       # (K, n)
        lhs = np.einsum("kmn,n->km", Ak, x) + _np(prob.b)
        rhs = ck @ x + _np(prob.d)
        rows.append(2.0 * (np.einsum("kmn,km->kn", Ak, lhs)
                           - ck * rhs[:, None]))
        segs.append(Ak.shape[0])
        grad_f = np.zeros_like(x)
        if prob.P is not None:
            grad_f += _np(prob.P) @ x
        if prob.q is not None:
            grad_f += _np(prob.q)
    else:
        if prob.C is not None:
            rows.append(_np(prob.C))
            segs.append(prob.C.shape[0])
        if getattr(prob, "P", None) is not None:
            grad_f = _np(prob.P) @ x
            if prob.q is not None:
                grad_f = grad_f + _np(prob.q)
        else:
            grad_f = _np(prob.c).copy()

    if prob.ub is not None:
        rows.append(np.eye(n))
        segs.append(n)
    if prob.lb is not None:
        rows.append(-np.eye(n))
        segs.append(n)

    used = sum(segs)
    G = np.concatenate(rows, axis=0) if rows else np.zeros((0, n))
    return G, slacks[:used], slacks, grad_f


def certify(solver, x=None, polish: bool = True) -> Certificate:
    """The KKT certificate of a solved LP/QP/SOCP driver, at its solution
    or at an explicit iterate ``x`` of the solved problem."""
    if not getattr(solver, "optimal", False):
        raise ValueError("certify() needs a solved problem — call "
                         "solver.solve() first")
    at_solution = x is None
    x = _np(solver.xstar if at_solution else x)

    t = float(solver._result.t)
    A, b = solver._eq
    A = None if A is None else _np(A)
    b = None if b is None else _np(b)
    has_eq = A is not None and A.shape[0] > 0

    G, sl, all_slacks, grad_f = _ineq_system(solver, x)
    min_slack = float(all_slacks.min()) if all_slacks.size else np.inf
    eq_residual = float(np.abs(A @ x - b).max()) if has_eq else 0.0

    if polish and G.shape[0]:
        # active set from the slack scale: at duality gap m/t the active
        # slacks are O(1/(t·λ_j)), the inactive ones O(1)
        gap = max(G.shape[0] / t, 1e-300)
        finite = sl[np.isfinite(sl)]
        scale = float(np.median(np.abs(finite))) if finite.size else 1.0
        tau = np.sqrt(gap) * max(1.0, scale)
        active = sl < tau
        lam = np.zeros(G.shape[0])
        for _ in range(2):          # fit, clip negatives, refit once
            na = int(active.sum())
            cols = [G[active].T] + ([A.T] if has_eq else [])
            M = np.concatenate(cols, axis=1)
            if M.shape[1] == 0:
                v = None
                break
            y, *_ = np.linalg.lstsq(M, -grad_f, rcond=None)
            lam_a, v = y[:na], (y[na:] if has_eq else None)
            if (lam_a >= 0).all():
                lam[active] = lam_a
                break
            keep = lam_a >= 0
            idx = np.where(active)[0]
            active = np.zeros_like(active)
            active[idx[keep]] = True
            lam[:] = 0.0
            lam[idx[keep]] = np.maximum(lam_a[keep], 0.0)
    else:
        lam = 1.0 / (t * np.maximum(sl, 1e-300))
        v = None

    r = grad_f + (G.T @ lam if G.shape[0] else 0.0)
    if has_eq:
        if v is None:
            v_solver = getattr(solver, "v_star", None)
            v = (_np(v_solver) if v_solver is not None
                 else np.linalg.lstsq(A.T, -r, rcond=None)[0])
        r = r + A.T @ v

    stationarity = float(np.abs(r).max() / max(1.0, np.abs(grad_f).max()))
    # an infinite slack (a ±inf bound kept as a vector) is a vacuous
    # constraint: λ = 0 there, and 0·inf reads as 0
    fin = np.isfinite(sl)
    comp = float((lam[fin] * sl[fin]).max()) if fin.any() else 0.0
    m_ineq = max(int(getattr(solver, "num_constraints", sl.size)), 0)
    return Certificate(
        kind=type(solver).__name__,
        objective=(float(solver.value) if at_solution
                   else _obj(solver._prob, x)),
        stationarity=stationarity,
        eq_residual=eq_residual,
        min_slack=min_slack,
        complementarity=comp,
        dual_gap=m_ineq / t if m_ineq else 0.0,
        polished=bool(polish and G.shape[0]),
    )


def _obj(prob, x):
    val = 0.0
    if getattr(prob, "P", None) is not None:
        val += 0.5 * x @ (_np(prob.P) @ x)
    if getattr(prob, "q", None) is not None:
        val += float(_np(prob.q) @ x)
    if (getattr(prob, "c", None) is not None
            and not hasattr(prob, "num_cones")):
        val += float(_np(prob.c) @ x)
    return float(val)
