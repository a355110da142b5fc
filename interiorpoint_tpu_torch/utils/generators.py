"""Seeded random problem generators, feasible by construction.

Recipes match the reference benchmark exactly (SURVEY.md §4.3):
LP: testSolver.py:75-87; QP: :503-521; SOCP: :862-880; LASSO: :1096-1105.
"""

from __future__ import annotations

import numpy as np


def generate_lp(n, m=None, k=None, rng=None, lo=-2.0, hi=2.0):
    """Dense LP with m=0.8n equalities, k=0.2n inequalities, bounds ±3.
    b = A·x_feas and d = C·x_feas guarantee feasibility
    (reference: testSolver.py:75-87)."""
    rng = np.random if rng is None else rng
    m = int(0.8 * n) if m is None else m
    k = int(0.2 * n) if k is None else k
    A = rng.uniform(low=lo, high=hi, size=(m, n))
    C = rng.uniform(low=lo, high=hi, size=(k, n))
    x_feas = rng.uniform(low=lo, high=hi, size=n)
    c = rng.uniform(low=lo, high=hi, size=n)
    return dict(c=c, A=A, b=A @ x_feas, C=C, d=C @ x_feas,
                lower_bound=-3.0, upper_bound=3.0)


def generate_qp(n, m=None, k=20, rng=None, lo=-2.0, hi=2.0):
    """QP with P = MᵀM + I (reference: testSolver.py:503-521)."""
    rng = np.random if rng is None else rng
    m = int(0.8 * n) if m is None else m
    Pp = rng.uniform(low=lo, high=hi, size=(m, n))
    P = Pp.T @ Pp + np.eye(n)
    A = rng.uniform(low=lo, high=hi, size=(m, n))
    C = rng.uniform(low=lo, high=hi, size=(k, n))
    x_feas = rng.uniform(low=lo, high=hi, size=n)
    q = rng.uniform(low=lo, high=hi, size=n)
    return dict(P=P, q=q, A=A, b=A @ x_feas, C=C, d=C @ x_feas,
                lower_bound=-3.0, upper_bound=3.0)


def generate_socp(n, m=None, k=50, num_con=5, rng=None, lo=-2.0, hi=2.0,
                  interior_margin=1.0):
    """SOCP with num_con random cones of m rows each, k equalities
    (reference: testSolver.py:862-880; the cones are sized so a random x0
    is feasible, d = ‖Ax0+b‖ − cᵀx0 + interior_margin).

    ``interior_margin`` deviates from the reference recipe, which uses 0
    (testSolver.py:880) and therefore places x0 exactly ON the cone
    boundary — pass interior_margin=0.0 to reproduce the upstream
    instances byte-for-byte (the reference's own solver returns inf on
    them at n>=500; see BASELINE.md SOCP note).  Benchmark results in this
    repo are produced with the default margin and say so."""
    rng = np.random if rng is None else rng
    m = int(0.8 * n) if m is None else m
    Pp = rng.uniform(low=lo, high=hi, size=(m, n))
    P = Pp.T @ Pp + np.eye(n)
    q = rng.uniform(low=lo, high=hi, size=n)
    x0 = rng.standard_normal(n) if hasattr(rng, "standard_normal") \
        else rng.randn(n)
    randn = (rng.standard_normal if hasattr(rng, "standard_normal")
             else rng.randn)
    A, b, c, d = [], [], [], []
    for _ in range(num_con):
        A.append(randn((m, n)) if hasattr(rng, "standard_normal")
                 else randn(m, n))
        b.append(randn(m) if hasattr(rng, "standard_normal") else randn(m))
        c.append(randn(n) if hasattr(rng, "standard_normal") else randn(n))
        d.append(float(np.linalg.norm(A[-1] @ x0 + b[-1]) - c[-1] @ x0)
                 + interior_margin)
    F = randn((k, n)) if hasattr(rng, "standard_normal") else randn(k, n)
    g = F @ x0
    return dict(P=P, q=q, A=A, b=b, c=c, d=d, F=F, g=g,
                lower_bound=None, upper_bound=None, x0=x0)


def generate_lasso(n, m=None, num_problems=30, rng=None):
    """Batched LASSO with sparse ground truth and per-problem λ around 0.05
    (reference: testSolver.py:1096-1105)."""
    rng = np.random if rng is None else rng
    m = int(0.8 * n) if m is None else m
    num_rows = m * 3
    num_nonzero = int(n * num_problems / 4)
    A = rng.random((num_rows, n)) if hasattr(rng, "random") else rng.rand(
        num_rows, n)
    x_true = np.zeros((n, num_problems))
    randint = (rng.integers if hasattr(rng, "integers") else rng.randint)
    x_true[np.unravel_index(randint(0, n * num_problems, num_nonzero),
                            (n, num_problems))] = rng.uniform(0, 50,
                                                              num_nonzero)
    randn = (rng.standard_normal if hasattr(rng, "standard_normal")
             else rng.randn)
    reg = 0.05 + 0.01 * (randn(num_problems)
                         if hasattr(rng, "standard_normal")
                         else randn(num_problems))
    b = A @ x_true + (randn((num_rows, num_problems))
                      if hasattr(rng, "standard_normal")
                      else randn(num_rows, num_problems))
    return dict(A=A, b=b, reg=np.abs(reg), x_true=x_true)
