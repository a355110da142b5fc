"""Usage walkthrough of the PyTorch port: LP with phase one, QP, SOCP,
and batched LASSO (counterpart of examples/demo.py:17-128, the same
sections, instances, seeds and settings).

Each section builds a problem, solves it, and checks the optimum against
an independent oracle.  Runs on the GPU; ``--cpu`` solves on the CPU.

    python examples/demo_torch.py [--cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None, out=None):
    """Run the walkthrough; ``out`` (a dict), when given, receives the
    printed quantities by section."""
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    out = {} if out is None else out

    from interiorpoint_tpu_torch import (LassoSolver, LPSolver, QPSolver,
                                         SOCPSolver, certify,
                                         default_device)
    device = "cpu" if args.cpu else default_device()

    rng = np.random.default_rng(1)

    # ------------------------------------------------------------------
    # 1. LP with an infeasible default start (phase one runs automatically)
    # ------------------------------------------------------------------
    print("=== LP ===")
    n, m, k = 200, 160, 40
    A = rng.uniform(-2, 2, (m, n))
    C = rng.uniform(-2, 2, (k, n))
    x_feas = rng.uniform(-2, 2, n)
    c = rng.uniform(-2, 2, n)
    lp = LPSolver(c=c, A=A, b=A @ x_feas, C=C, d=C @ x_feas,
                  lower_bound=-3, upper_bound=3, suppress_print=True,
                  check_cvxpy=True, epsilon=1e-8, get_dual_variables=True,
                  device=device)
    val = lp.solve()
    print(f"optimal value  {val:.6f}")
    if lp.cvxpy_val is not None:
        print(f"oracle value   {lp.cvxpy_val:.6f}  "
              f"(|diff| {abs(val - lp.cvxpy_val):.2e})")
    print(f"duality gap    {lp.optimality_gap:.2e}")
    print(f"outer iters    {lp.outer_iters}, newton per center: "
          f"{lp.inner_iters}")
    print(f"min dual       {float(np.min(lp.lam_star)):.2e} (>= 0)")
    cert = certify(lp)   # in-framework KKT certificate (no oracle solve)
    print(f"KKT certified  stationarity {cert.stationarity:.2e}, "
          f"complementarity {cert.complementarity:.2e}, "
          f"ok(1e-6)={cert.ok(1e-6)}")
    out["lp_data"] = (c, A, A @ x_feas, C, C @ x_feas)
    out["lp"] = dict(value=val, oracle=lp.cvxpy_val,
                     gap=lp.optimality_gap, outer=lp.outer_iters,
                     inner=list(lp.inner_iters),
                     min_dual=float(np.min(lp.lam_star)),
                     cert_ok=bool(cert.ok(1e-6)),
                     stationarity=float(cert.stationarity),
                     complementarity=float(cert.complementarity))

    # ------------------------------------------------------------------
    # 2. QP
    # ------------------------------------------------------------------
    print("\n=== QP ===")
    Pp = rng.uniform(-2, 2, (m, n))
    P = Pp.T @ Pp + np.eye(n)
    q = rng.uniform(-2, 2, n)
    qp = QPSolver(P=P, q=q, A=A, b=A @ x_feas, C=C, d=C @ x_feas,
                  lower_bound=-3, upper_bound=3, suppress_print=True,
                  check_cvxpy=False, epsilon=1e-8, t0=0.01,
                  max_inner_iters=100, device=device)
    qval = qp.solve()
    eq_res = float(np.linalg.norm(A @ np.asarray(qp.xstar) - A @ x_feas))
    print(f"optimal value  {qval:.6f}")
    print(f"eq residual    {eq_res:.2e}")
    out["qp"] = dict(value=qval, gap=qp.optimality_gap, eq_residual=eq_res,
                     solver=qp)

    # ------------------------------------------------------------------
    # 3. SOCP: projection onto an ellipsoid intersected with a hyperplane
    # ------------------------------------------------------------------
    print("\n=== SOCP ===")
    n2 = 50
    target = rng.normal(size=n2) * 2
    scale = np.linspace(1, 2, n2)
    F = np.ones((1, n2))
    socp = SOCPSolver(
        P=np.eye(n2), q=-target,
        A=[np.diag(scale)], b=[np.zeros(n2)], c=[np.zeros(n2)], d=[3.0],
        F=F, g=np.array([1.0]), lower_bound=None, upper_bound=None,
        suppress_print=True, check_cvxpy=False, epsilon=1e-9,
        max_inner_iters=100, x0=np.zeros(n2), device=device)
    sval = socp.solve()
    print(f"optimal value  {sval:.6f}")
    x = np.asarray(socp.xstar)
    norm = float(np.linalg.norm(scale * x))
    print(f"||diag(s)x||   {norm:.6f} (<= 3)")
    print(f"sum(x)         {x.sum():.6f} (= 1)")
    out["socp"] = dict(value=sval, gap=socp.optimality_gap, cone_norm=norm,
                       sum_x=float(x.sum()))

    # ------------------------------------------------------------------
    # 3b. Same LP with the primal-dual Mehrotra engine (algorithm="pd"):
    #     a fraction of the barrier's factorizations, no phase one
    # ------------------------------------------------------------------
    print("\n=== LP, primal-dual Mehrotra (algorithm='pd') ===")
    lp_pd = LPSolver(c=c, A=A, b=A @ x_feas, C=C, d=C @ x_feas,
                     lower_bound=-3, upper_bound=3, suppress_print=True,
                     check_cvxpy=False, epsilon=1e-8, algorithm="pd",
                     device=device)
    val_pd = lp_pd.solve()
    print(f"optimal value  {val_pd:.6f}  (|diff vs barrier| "
          f"{abs(val_pd - val):.2e})")
    print(f"factorizations {lp_pd.outer_iters} "
          f"(barrier used {sum(lp.inner_iters)})")
    out["lp_pd"] = dict(value=val_pd, gap=lp_pd.optimality_gap,
                        iterations=lp_pd.outer_iters,
                        barrier_newton=sum(lp.inner_iters))

    # ------------------------------------------------------------------
    # 4. Batched LASSO: a 50-point regularization sweep in one solve
    # ------------------------------------------------------------------
    print("\n=== LASSO regularization sweep ===")
    mrows, nf = 300, 60
    Al = rng.random((mrows, nf))
    x_true = np.zeros(nf)
    x_true[rng.integers(0, nf, nf // 5)] = rng.uniform(0, 10, nf // 5)
    bl = Al @ x_true + rng.standard_normal(mrows)
    lambdas = np.logspace(-3, 0.5, 50)
    lasso = LassoSolver(Al, bl, reg=lambdas, rho=0.4, max_iters=5000,
                        eps_abs=1e-7, eps_rel=1e-7, check_cvxpy=False,
                        device=device)
    X, sols, gaps, iters = lasso.solve()
    nnz = (np.abs(X) > 1e-6).sum(axis=0)
    print(f"solved {len(lambdas)} lambdas in {iters} ADMM iterations "
          "(one batched solve)")
    print(f"sparsity path: nnz {nnz[0]} at λ={lambdas[0]:.3g}  →  "
          f"nnz {nnz[-1]} at λ={lambdas[-1]:.3g}")
    out["lasso"] = dict(iterations=iters, nnz=nnz.tolist(), X=X,
                        lambdas=lambdas, A=Al, b=bl)
    return 0


if __name__ == "__main__":
    sys.exit(main())
