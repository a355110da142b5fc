"""LP driver: min cᵀx s.t. Ax = b, Cx ≤ d, lb ≤ x ≤ ub (counterpart of
interiorpoint_tpu/models/lp.py).

Same constructor, ``solve()`` signature, validation and error strings as
the JAX package, plus ``device=``: the barrier engine (the default
``algorithm="barrier"``) and the primal-dual path (``"pd"``/``"auto"``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.barrier import make_phase1_linear_oracle, make_qp_oracle
from ..utils import oracle as oracle_check
from .base import BarrierDriver, default_device, default_dtype, \
    synthesize_x0
from .problem import make_lp


def _oracle_try_diag(prob):
    return make_qp_oracle(prob, try_diag=True)


def _oracle_no_diag(prob):
    return make_qp_oracle(prob, try_diag=False)


def _validate_lp(c, A, b, C, d, lb, ub):
    """Dimension/type checks (reference: LPSolver.py:226-318)."""
    c_flag = c is not None
    n_A = n_C = None
    if c_flag and np.asarray(c).ndim != 1:
        raise ValueError("c must be 1-dimensional!")
    if (A is not None) ^ (b is not None):
        raise ValueError("Both A and b must be defined, or neither!")
    if A is not None:
        A = np.asarray(A)
        if A.ndim != 2:
            raise ValueError("A must be 2-dimensional!")
        m, n_A = A.shape
        if np.asarray(b).ndim != 1:
            raise ValueError("b must be 1-dimensional!")
        if len(b) != m:
            raise ValueError("A and b must have agreeing dimensions!")
        if c_flag and len(c) != n_A:
            raise ValueError(
                "c must have the same number of entries as A has columns!")
    if (C is not None) ^ (d is not None):
        raise ValueError("Both C and d must be defined, or neither!")
    if C is not None:
        C = np.asarray(C)
        if C.ndim != 2:
            raise ValueError("C must be 2-dimensional!")
        k, n_C = C.shape
        if np.asarray(d).ndim != 1:
            raise ValueError("d must be 1-dimensional!")
        if len(d) != k:
            raise ValueError("C and d must have agreeing dimensions!")
        if c_flag and len(c) != n_C:
            raise ValueError(
                "c must have the same number of entries as A has columns!")
    n = (len(c) if c_flag else n_A if n_A is not None else n_C)
    for name, bound in (("Lower", lb), ("Upper", ub)):
        if bound is not None and np.asarray(bound).ndim > 0:
            if len(np.asarray(bound)) != n:
                raise ValueError(
                    f"{name} bound must be a scalar or have the same number "
                    "of dimensions as other parameters!")
    if lb is not None and ub is not None:
        if np.any(np.asarray(ub) - np.asarray(lb) < 0):
            raise ValueError("Lower bound must be lower than upper bound")
    if n_C is not None and n_A is not None and n_C != n_A:
        raise ValueError("A and C must have the same number of columns!")
    return n


class LPSolver(BarrierDriver):
    """Drop-in analogue of the JAX package's LPSolver.  ``use_gpu`` is
    accepted for API compatibility and ignored: ``device`` chooses where
    the solve runs (default ``default_device()``)."""

    def __init__(self, c=None, A=None, b=None, C=None, d=None,
                 lower_bound=0, upper_bound=None, t0=0.1,
                 max_outer_iters=20, max_inner_iters=50,
                 phase1_max_inner_iters=500, epsilon=1e-10,
                 inner_epsilon=1e-5, check_cvxpy=True,
                 linear_solve_method="cholesky", max_cg_iters=50,
                 alpha=0.2, beta=0.6, mu=15, suppress_print=False,
                 use_gpu=False, try_diag=True, track_loss=False,
                 get_dual_variables=False, phase1_tol=0, phase1_t0=0.01,
                 x0=None, update_slacks_every=0, dtype=None,
                 refine_steps=0, eq_gate=None, reduced=None,
                 staged_dispatch=None, algorithm="barrier",
                 pd_max_iters=60, device=None):
        del use_gpu
        self.n = _validate_lp(c, A, b, C, d, lower_bound, upper_bound)
        self.equality_constrained = A is not None

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
            update_slacks_every=update_slacks_every, dtype=dtype,
            refine_steps=refine_steps, eq_gate=eq_gate,
            staged_dispatch=staged_dispatch, algorithm=algorithm,
            pd_max_iters=pd_max_iters, device=device,
        )

        lb = lower_bound
        ub = upper_bound
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
                oracle_check.check_lp(c, A, b, C, d, lb_vec, ub_vec))
            if self.feasible == "infeasible":
                raise ValueError("Provided problem instance is infeasible!")
            if self.feasible == "unbounded":
                raise ValueError("Provided problem instance is unbounded!")

        self._prob = make_lp(c, A, b, C, d, lb, ub,
                             dtype=self.cfg.torch_dtype, device=self.device)
        self._eq = (self._prob.A, self._prob.b)
        self._oracle_fn = _oracle_try_diag if try_diag else _oracle_no_diag
        # phase one exists only when there is a dense inequality block
        self._p1_oracle_fn = (make_phase1_linear_oracle
                              if self._prob.C is not None else None)
        # equality gate 1e-4·n (reference: LPSolver.py:600)
        self._eq_gate_default = 1e-4 * self.n
        self.num_constraints = self._prob.num_ineq_constraints
        self.bounded = lb is not None or ub is not None

        want_reduced = reduced if reduced is not None else (
            self._prob.A is not None
            and self._prob.A.shape[0] < self.n
            and self.num_constraints > 0
            and self.cfg.kkt_strategy != "full_kkt")
        if want_reduced and self._prob.A is not None:
            from .reduced import reduce_lp
            self._setup_reduced(reduce_lp, _oracle_no_diag,
                                make_phase1_linear_oracle)

    def _auto_algorithm(self) -> str:
        """The Mehrotra engine wherever it applies, as in the JAX
        package."""
        return "pd" if self._pd_applicable() else "barrier"

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
            raise ValueError("Initial x must be the same dimension as c!")


def solve_lp(c, A=None, b=None, C=None, d=None, lb=None, ub=None,
             cfg=None, x0=None, algorithm="barrier", device=None,
             **cfg_overrides):
    """Functional one-shot LP solve on the full-space problem: an
    ``IPMResult`` (ops/ipm.py) from the barrier engine, or a ``PDResult``
    (ops/pd.py) with ``algorithm="pd"``/``"auto"``: the bounds stacked
    into C and the equality pair handed to ``pd_solve``, whose every
    direction is then one dense-KKT direction K5 (ops/kkt_step.py)."""
    from ..utils.config import SolverConfig

    if cfg is None:
        cfg = SolverConfig(**{"dtype": default_dtype(), **cfg_overrides})
    device = torch.device(device) if device is not None \
        else default_device()
    dt = cfg.torch_dtype
    prob = make_lp(c, A, b, C, d, lb, ub, dtype=dt, device=device)
    n = prob.n
    if x0 is None:
        x0 = synthesize_x0(None if lb is None else prob.lb.cpu().numpy(),
                           None if ub is None else prob.ub.cpu().numpy(),
                           n)
    x0 = torch.as_tensor(x0, dtype=dt, device=device)
    if algorithm == "auto":
        algorithm = "pd"
    if algorithm == "pd":
        from ..ops.pd import pd_solve
        from .reduced import full_space_pd_problem

        return pd_solve(full_space_pd_problem(prob, dt), x0, cfg,
                        A=prob.A, b=prob.b)
    if algorithm != "barrier":
        raise ValueError(f"unknown algorithm {algorithm!r}")
    from ..ops.ipm import barrier_solve

    oracle_fn = _oracle_try_diag if cfg.try_diag else _oracle_no_diag
    eq_gate = cfg.eq_gate if cfg.eq_gate is not None else 1e-4 * n
    return barrier_solve(
        oracle_fn(prob), prob.A, prob.b, x0, cfg,
        num_constraints=prob.num_ineq_constraints, eq_gate=float(eq_gate),
        t0=cfg.t0, p1_oracle=(make_phase1_linear_oracle(prob)
                              if prob.C is not None else None))
