"""External ground-truth oracles for feasibility checking and verification.

The reference uses CVXPY + CLARABEL as its oracle
(reference: LPSolver.py:471-505, QPSolver.py:457-491, SOCPSolver.py:557-607,
LassoSolver.py:545-581).  CVXPY is an *optional* dependency here: when it is
unavailable we fall back to ``scipy.optimize.linprog`` (HiGHS) for LPs and
report "unknown" for problem classes scipy cannot certify.  Tests rely on
the scipy path plus KKT-residual certificates (tests/test_lp.py,
tests/test_qp.py, tests/test_socp.py).
"""

from __future__ import annotations

import numpy as np

try:
    import cvxpy as _cvx
    HAS_CVXPY = True
except Exception:  # pragma: no cover - depends on environment
    _cvx = None
    HAS_CVXPY = False


def check_lp(c, A=None, b=None, C=None, d=None, lb=None, ub=None):
    """Feasibility + optimal value for an LP.

    Returns (status, value, solution) with status in
    {"optimal", "infeasible", "unbounded", "unknown"} — the strings the
    reference drivers branch on (reference: LPSolver.py:150-156).
    """
    if HAS_CVXPY:
        n = (len(c) if c is not None else
             A.shape[1] if A is not None else C.shape[1])
        x = _cvx.Variable(n)
        obj = _cvx.Minimize(c.T @ x if c is not None else _cvx.sum(x))
        constr = []
        if A is not None:
            constr.append(A @ x == b)
        if C is not None:
            constr.append(C @ x <= d)
        if lb is not None:
            constr.append(x >= lb)
        if ub is not None:
            constr.append(ub >= x)
        prob = _cvx.Problem(obj, constr)
        try:
            prob.solve(solver="CLARABEL")
        except Exception as e:  # pragma: no cover
            print(e)
        return prob.status, prob.value, x.value

    from scipy.optimize import linprog

    n = (len(c) if c is not None else
         A.shape[1] if A is not None else C.shape[1])
    c_vec = np.asarray(c) if c is not None else np.ones(n)
    bounds = list(zip(
        np.broadcast_to(lb, (n,)) if lb is not None else [None] * n,
        np.broadcast_to(ub, (n,)) if ub is not None else [None] * n,
    ))
    res = linprog(
        c_vec, A_ub=C, b_ub=d, A_eq=A, b_eq=b, bounds=bounds,
        method="highs",
    )
    if res.status == 0:
        return "optimal", float(res.fun), res.x
    if res.status == 2:
        return "infeasible", None, None
    if res.status == 3:
        return "unbounded", None, None
    return "unknown", None, None


def check_qp(P, q=None, A=None, b=None, C=None, d=None, lb=None, ub=None):
    """QP oracle (reference: QPSolver.py:457-491).  Without CVXPY there is
    no scipy QP solver; returns ("unknown", None, None)."""
    if not HAS_CVXPY:
        return "unknown", None, None
    n = P.shape[1]
    x = _cvx.Variable(n)
    obj_expr = 0.5 * _cvx.quad_form(x, _cvx.psd_wrap(P))
    if q is not None:
        obj_expr = obj_expr + q @ x
    constr = []
    if A is not None:
        constr.append(A @ x == b)
    if C is not None:
        constr.append(C @ x <= d)
    if lb is not None:
        constr.append(x >= lb)
    if ub is not None:
        constr.append(ub >= x)
    prob = _cvx.Problem(_cvx.Minimize(obj_expr), constr)
    try:
        prob.solve(solver="CLARABEL")
    except Exception as e:  # pragma: no cover
        print(e)
    return prob.status, prob.value, x.value


def check_socp(A_list, b_list, c_list, d_list, P=None, q=None, F=None,
               g=None, lb=None, ub=None):
    """SOCP oracle (reference: SOCPSolver.py:557-607)."""
    if not HAS_CVXPY:
        return "unknown", None, None
    n = A_list[0].shape[1] if A_list[0].ndim == 2 else A_list[0].shape[0]
    x = _cvx.Variable(n)
    constr = []
    for Ai, bi, ci, di in zip(A_list, b_list, c_list, d_list):
        Ai = np.diag(Ai) if np.asarray(Ai).ndim == 1 else Ai
        constr.append(_cvx.SOC(ci.T @ x + di, Ai @ x + bi))
    if F is not None:
        constr.append(F @ x == g)
    if lb is not None:
        constr.append(x >= lb)
    if ub is not None:
        constr.append(ub >= x)
    obj_expr = 0
    if P is not None:
        obj_expr = obj_expr + 0.5 * _cvx.quad_form(x, _cvx.psd_wrap(P))
    if q is not None:
        obj_expr = obj_expr + q @ x
    prob = _cvx.Problem(_cvx.Minimize(obj_expr), constr)
    try:
        prob.solve(solver="CLARABEL")
    except Exception as e:  # pragma: no cover
        print(e)
    return prob.status, prob.value, x.value


def check_lasso(A, b, reg):
    """Per-sample LASSO oracle (reference: LassoSolver.py:545-581).

    Without CVXPY, solves each sample to high accuracy with FISTA in
    float64 — an independent (non-ADMM) method, so it still serves as a
    cross-check for tests.
    """
    A = np.asarray(A, dtype=np.float64)
    b2 = np.asarray(b, dtype=np.float64)
    if b2.ndim < 2:
        b2 = b2[:, None]
    reg = np.atleast_1d(np.asarray(reg, dtype=np.float64))
    m = A.shape[0]
    B = max(b2.shape[1], reg.shape[0])

    if HAS_CVXPY:
        vals, sols = [], []
        n = A.shape[1]
        for i in range(B):
            x = _cvx.Variable(n)
            bi = b2[:, min(i, b2.shape[1] - 1)]
            ri = reg[min(i, reg.shape[0] - 1)]
            obj = _cvx.Minimize(
                1 / (2 * m) * _cvx.norm2(A @ x - bi) ** 2
                + ri * _cvx.norm(x, 1))
            prob = _cvx.Problem(obj, [])
            prob.solve(solver="CLARABEL")
            vals.append(prob.value)
            sols.append(x.value)
        return "optimal", np.array(vals), sols

    # FISTA fallback: min 1/(2m)||Ax-b||^2 + reg||x||_1
    n = A.shape[1]
    L = np.linalg.norm(A, 2) ** 2 / m  # Lipschitz constant of the gradient
    X = np.zeros((n, B))
    Y = X.copy()
    t_k = 1.0
    bi = np.broadcast_to(b2, (m, B))
    ri = np.broadcast_to(reg, (B,))
    for _ in range(5000):
        G = A.T @ (A @ Y - bi) / m
        X_new = Y - G / L
        thr = ri / L
        X_new = np.sign(X_new) * np.maximum(np.abs(X_new) - thr, 0.0)
        t_new = (1 + np.sqrt(1 + 4 * t_k**2)) / 2
        Y = X_new + ((t_k - 1) / t_new) * (X_new - X)
        if np.max(np.abs(X_new - X)) < 1e-12:
            X = X_new
            break
        X, t_k = X_new, t_new
    vals = (0.5 / m) * np.sum((A @ X - bi) ** 2, axis=0) + ri * np.sum(
        np.abs(X), axis=0)
    return "optimal", vals, [X[:, i] for i in range(B)]
