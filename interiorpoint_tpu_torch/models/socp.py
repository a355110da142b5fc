"""SOCP driver: min ½xᵀPx + qᵀx s.t. ‖Aᵢx+bᵢ‖ ≤ cᵢᵀx+dᵢ, Fx = g, bounds
(counterpart of interiorpoint_tpu/models/socp.py).

Same constructor, validation and error strings as the JAX package, plus
``device=``.  The cone lists are packed into stacked, zero-padded tensors
(models/problem.py ``make_socp``); the equality pair (F, g) rides the
engine's (A, b) slots.  ``algorithm="barrier"`` (the default) and
``"auto"`` run the log-barrier engine: on the reduced problem when F has
fewer rows than n and there are no bounds (each Newton step then one
fused SOCP step K4, ops/socp_step.py), else in full space through the
infeasible-start engine.  ``"pd"`` runs the conic Mehrotra engine
(ops/socp_pd.py), each direction one dense-KKT direction K5
(ops/kkt_step.py): in z-space with no equality block when the reduction
applies, else in full space with F, g and the bounds.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from ..ops import sync
from ..ops.socp import make_phase1_socp_oracle, make_socp_oracle, \
    socp_full_slacks
from ..utils import metrics
from ..utils import oracle as oracle_check
from .base import BarrierDriver, default_device, default_dtype, \
    synthesize_x0
from .problem import make_socp


def _socp_pd_core(G, h, q, x0, cfg, P=None, F=None, g=None, lb=None,
                  ub=None):
    """The conic Mehrotra solve (ops/socp_pd.py) and its objective value
    (a device tensor, read by the caller with the iterate)."""
    from ..ops.socp_pd import socp_pd_solve
    res = socp_pd_solve(G, h, q, x0, cfg, P=P, F=F, g=g, lb=lb, ub=ub)
    val = q @ res.x
    if P is not None:
        val = val + 0.5 * res.x @ (P @ res.x)
    return res, val


def _normalize_socp_inputs(P, q, A, b, c, d, F, g, lb, ub):
    """List normalization and broadcasting; inputs are never modified, and
    1-D cone matrices are read as diagonals."""
    if P is not None:
        P = np.asarray(P)
        if P.ndim != 2 or P.shape[0] != P.shape[1]:
            raise ValueError("P must be a symmetric, square PSD matrix!")
    if q is not None:
        q = np.asarray(q)
        if q.ndim != 1:
            raise ValueError("q must be 1-dimensional!")
        if P is not None and P.shape[1] != len(q):
            raise ValueError("P and q must have the same dimension")
    if A is None:
        raise ValueError(
            "No cone contraints detected. Run with LPSolver or QPSolver for "
            "better performance.")
    if not isinstance(A, (list, tuple)):
        A = [A]
    A = [np.asarray(Ai) for Ai in A]
    for Ai in A:
        if Ai.ndim > 2:
            raise ValueError("A must be 1- or 2-dimensional!")
    n = A[0].shape[-1]
    if b is not None:
        if not isinstance(b, (list, tuple)):
            b = [b]
        b = [np.asarray(bi) for bi in b]
        if len(b) == 1:
            b = b * len(A)
        if len(A) != len(b):
            raise ValueError("Must provide an equal number of A and b")
    if c is not None:
        if not isinstance(c, (list, tuple)):
            c = [c]
        c = [np.asarray(ci) for ci in c]
        if len(A) != len(c):
            raise ValueError("Must provide equal number of c and A")
    if d is not None:
        if not isinstance(d, (list, tuple)):
            d = [d]
        d = [float(di) for di in d]
        if len(d) == 1:
            d = d * len(A)
        if len(d) != len(A):
            raise ValueError("Must provide equal number of A and d")
    if F is not None:
        F = np.asarray(F)
        if F.ndim != 2:
            raise ValueError("F must be 2-dimensional!")
        if F.shape[1] != n:
            raise ValueError("A and F must have the same number of columns!")
    if g is not None:
        g = np.asarray(g)
        if g.ndim != 1:
            raise ValueError("g must be 1-dimensional!")
        if F is not None and len(g) != F.shape[0]:
            raise ValueError("F and g must have agreeing dimensions!")
    if lb is not None and ub is not None:
        if np.any(np.asarray(ub) - np.asarray(lb) < 0):
            raise ValueError("Lower bound must be lower than upper bound")
    return P, q, A, b, c, d, F, g, n


class SOCPSolver(BarrierDriver):
    """Drop-in analogue of the JAX package's SOCPSolver."""

    def __init__(self, P=None, q=None, A=None, b=None, c=None, d=None,
                 F=None, g=None, lower_bound=0, upper_bound=None, t0=0.1,
                 phase1_t0=0.01, max_outer_iters=20, max_inner_iters=50,
                 phase1_max_inner_iters=500, epsilon=1e-10,
                 inner_epsilon=1e-5, check_cvxpy=True,
                 linear_solve_method="cholesky", max_cg_iters=50,
                 alpha=0.2, beta=0.6, mu=15, suppress_print=False,
                 use_gpu=False, try_diag=True, track_loss=False,
                 get_dual_variables=False, phase1_tol=0,
                 use_psd_condition=False, x0=None, update_slacks_every=0,
                 dtype=None, refine_steps=0, eq_gate=None, reduced=None,
                 staged_dispatch=None, algorithm="barrier",
                 pd_max_iters=60, device=None):
        del use_gpu
        P, q, A, b, c, d, F, g, self.n = _normalize_socp_inputs(
            P, q, A, b, c, d, F, g, lower_bound, upper_bound)
        self.equality_constrained = F is not None
        self.inequality_constrained = True

        self._init_common(
            t0=t0, max_outer_iters=max_outer_iters,
            max_inner_iters=max_inner_iters,
            phase1_max_inner_iters=phase1_max_inner_iters,
            epsilon=epsilon, inner_epsilon=inner_epsilon,
            linear_solve_method=linear_solve_method,
            max_cg_iters=max_cg_iters, alpha=alpha, beta=beta, mu=mu,
            suppress_print=suppress_print, try_diag=try_diag,
            track_loss=track_loss, get_dual_variables=get_dual_variables,
            phase1_tol=phase1_tol, phase1_t0=phase1_t0,
            update_slacks_every=update_slacks_every,
            use_psd_condition=use_psd_condition, dtype=dtype,
            refine_steps=refine_steps, eq_gate=eq_gate,
            staged_dispatch=staged_dispatch, algorithm=algorithm,
            pd_max_iters=pd_max_iters, device=device,
        )

        lb, ub = lower_bound, upper_bound
        lb_vec = None if lb is None else np.broadcast_to(
            np.asarray(lb, dtype=np.float64), (self.n,))
        ub_vec = None if ub is None else np.broadcast_to(
            np.asarray(ub, dtype=np.float64), (self.n,))
        self.x = (np.asarray(x0, dtype=np.float64) if x0 is not None
                  else synthesize_x0(lb_vec, ub_vec, self.n))

        if check_cvxpy:
            if not suppress_print:
                print("Testing CVXPY")
            self.feasible, self.cvxpy_val, self.cvxpy_sol = (
                oracle_check.check_socp(
                    A, b if b is not None else [np.zeros(Ai.shape[0])
                                                for Ai in A],
                    c if c is not None else [np.zeros(self.n)] * len(A),
                    d if d is not None else [0.0] * len(A),
                    P, q, F, g, lb_vec, ub_vec))
            if self.feasible == "infeasible":
                raise ValueError("Provided problem instance is infeasible!")
            if self.feasible == "unbounded":
                raise ValueError("Provided problem instance is unbounded!")

        self._prob = make_socp(A, b, c, d, P, q, F, g, lb, ub,
                               dtype=self.cfg.torch_dtype, device=self.device)
        self._eq = (self._prob.F, self._prob.g)
        self._oracle_fn = make_socp_oracle
        self._p1_oracle_fn = make_phase1_socp_oracle
        # equality gate 1e-3 on ‖Fx − g‖ (reference: SOCPSolver.py:700-704)
        self._eq_gate_default = 1e-3
        self.num_constraints = self._prob.num_ineq_constraints
        self.bounded = lb is not None or ub is not None

        # the reduced SOCP needs unbounded variables (models/reduced.py)
        want_reduced = reduced if reduced is not None else (
            self._prob.F is not None
            and self._prob.F.shape[0] < self.n
            and not self.bounded)
        if want_reduced and self._prob.F is not None:
            from .reduced import reduce_socp
            self._setup_reduced(reduce_socp, make_socp_oracle,
                                make_phase1_socp_oracle)

    def _slacks_at(self, x):
        return socp_full_slacks(self._prob, x)

    def _solve_pd(self, cfg, x0, explicit_x0, wall0):
        """Conic Mehrotra path (ops/socp_pd.py), with the barrier path's
        result surface.  With the null-space reduction (equalities, no
        bounds) the engine runs in z-space with no equality block and the
        equality dual comes from stationarity afterwards; else in full
        space with F, g and the bounds.  The conic duals z map to the
        squared-slack multipliers λ_k = z_k0/(2·rhs_k) (0 where a cone's
        rhs vanishes at the optimum); the rhs-domain entries carry 0."""
        from ..ops.socp_pd import cone_operator

        del explicit_x0
        prob = self._prob
        dtype = cfg.torch_dtype
        rf = self._reduced
        x0_t = torch.as_tensor(np.asarray(x0, dtype=np.float64), dtype=dtype,
                               device=self.device)
        if rf is not None:
            pprob = rf.prob
            G, h, qv = cone_operator(pprob)
            z0 = rf.basis.N.T @ (x0_t - rf.basis.x_p)
            res, val = _socp_pd_core(G, h, qv, z0, cfg, P=pprob.P)
            res = res._replace(x=rf.expand(res.x))
            val = val + rf.obj_offset
        else:
            G, h, qv = cone_operator(prob)
            res, val = _socp_pd_core(G, h, qv, x0_t, cfg, P=prob.P,
                                     F=prob.F, g=prob.g, lb=prob.lb,
                                     ub=prob.ub)
        # one host read of the value, the iterate and the cone heads
        host = sync.read_list(torch.cat([val.reshape(1), res.x,
                                         res.z[:, 0]]))
        n = res.x.shape[0]
        self.xstar = np.asarray(host[1:1 + n])
        z_head = np.asarray(host[1 + n:])
        self.value = float(host[0])
        self.optimal = True
        gap = res.gap
        self.optimality_gap = gap
        iters = res.iters
        self.outer_iters = iters
        self.inner_iters = [1] * iters
        self.objective_vals = []
        self.backtrack_hist = None
        if not res.converged and not self.suppress_print:
            print(f"pd: not converged after {iters} iterations "
                  f"(gap {gap:.3g}, rp {res.rp_norm:.3g}, "
                  f"rd {res.rd_norm:.3g})")

        m_ineq = max(self.num_constraints, 1)
        self._result = SimpleNamespace(
            x=self.xstar, v=None, t=m_ineq / max(gap, 1e-300),
            value=self.value, dual_gap=gap, phase1=None)

        if self.get_dual_variables:
            c_h = prob.c.cpu().numpy()
            d_h = prob.d.cpu().numpy()
            rhs = c_h @ self.xstar + d_h
            scale = 1.0 + float(np.abs(d_h).max())
            lam_cone = np.where(
                rhs > 1e-12 * scale,
                z_head / (2.0 * np.maximum(rhs, 1e-300)), 0.0)
            parts = [lam_cone]
            if prob.ub is not None:
                parts.append(res.lam_ub.cpu().numpy())
            if prob.lb is not None:
                parts.append(res.lam_lb.cpu().numpy())
            parts.append(np.zeros(lam_cone.shape[0]))  # rhs-domain block
            self.lam_star = np.concatenate(parts)
            if prob.F is not None:
                if rf is not None:
                    # the z-space engine carries no equality multiplier:
                    # from stationarity, q + Px − Σ G_kᵀz_k + Fᵀv = 0
                    from ..ops.nullspace import recover_equality_dual

                    Gf = cone_operator(prob)[0]
                    gf = -torch.einsum("kmn,km->n", Gf, res.z)
                    if prob.q is not None:
                        gf = gf + prob.q
                    if prob.P is not None:
                        gf = gf + prob.P @ res.x
                    self.v_star = recover_equality_dual(
                        rf.basis, prob.F, gf).cpu().numpy()
                else:
                    self.v_star = res.y.cpu().numpy()
                self.vstar = self.v_star

        self.last_metrics = metrics.solve_record(
            type(self).__name__,
            n=self.n, num_constraints=self.num_constraints,
            num_eq=(prob.F.shape[0] if prob.F is not None else 0),
            value=self.value, dual_gap=gap,
            outer_iters=iters, newton_iters=iters,
            backtrack_hist=None, wall_s=time.time() - wall0,
            phase1_ran=False,
            extra={"algorithm": "pd", "converged": bool(res.converged),
                   "rp_norm": res.rp_norm, "rd_norm": res.rd_norm,
                   "device": str(self.device)})
        metrics.emit(self.last_metrics)
        return self.value

    def _check_x0(self, x):
        prob = self._prob
        if prob.lb is not None and np.any(x <= prob.lb.cpu().numpy()):
            raise ValueError(
                "Initial x must be in domain of problem (all entries greater "
                "than lower bound)")
        if prob.ub is not None and np.any(x >= prob.ub.cpu().numpy()):
            raise ValueError(
                "Initial x must be in domain of problem (all entries less "
                "than upper bound)")
        if len(x) != self.n:
            raise ValueError("Initial x must have the correct dimension!")


def solve_socp(A, b=None, c=None, d=None, P=None, q=None, F=None, g=None,
               lb=None, ub=None, cfg=None, x0=None, algorithm="barrier",
               device=None, **cfg_overrides):
    """Functional one-shot SOCP solve returning the barrier engine's
    ``IPMResult`` (``algorithm="auto"`` resolves to the barrier engine),
    or an ``SOCPPDResult`` with ``algorithm="pd"`` (the conic Mehrotra
    engine, ops/socp_pd.py, in full space)."""
    from ..ops.ipm import barrier_solve
    from ..utils.config import SolverConfig

    if cfg is None:
        cfg = SolverConfig(**{"dtype": default_dtype(), **cfg_overrides})
    if algorithm == "auto":
        algorithm = "barrier"
    if algorithm not in ("barrier", "pd"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    device = torch.device(device) if device is not None \
        else default_device()
    dt = cfg.torch_dtype
    prob = make_socp(A, b, c, d, P, q, F, g, lb, ub, dtype=dt, device=device)
    if x0 is None:
        x0 = synthesize_x0(None if prob.lb is None else prob.lb.cpu().numpy(),
                           None if prob.ub is None else prob.ub.cpu().numpy(),
                           prob.n)
    if algorithm == "pd":
        from ..ops.socp_pd import cone_operator, socp_pd_solve

        G, h, qv = cone_operator(prob)
        return socp_pd_solve(G, h, qv,
                             torch.as_tensor(x0, dtype=dt, device=device),
                             cfg, P=prob.P, F=prob.F, g=prob.g, lb=prob.lb,
                             ub=prob.ub)
    eq_gate = cfg.eq_gate if cfg.eq_gate is not None else 1e-3
    return barrier_solve(
        make_socp_oracle(prob), prob.F, prob.g,
        torch.as_tensor(x0, dtype=dt, device=device), cfg,
        num_constraints=prob.num_ineq_constraints, eq_gate=float(eq_gate),
        t0=cfg.t0, p1_oracle=make_phase1_socp_oracle(prob))
