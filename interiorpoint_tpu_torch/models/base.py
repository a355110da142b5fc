"""Shared driver machinery of the LP/QP/SOCP solvers (counterpart of
interiorpoint_tpu/models/base.py).

The device is chosen once, at the API boundary (``device=``, default
``default_device()``, which is ``cuda`` and raises when no GPU is
present), and every tensor of a solve is created there.
``algorithm="barrier"`` (the default) runs the log-barrier engine
(ops/ipm.py) with phase one when the start is not strictly feasible;
``"pd"``, and ``"auto"`` where the primal-dual engine applies, run the
Mehrotra path (ops/pd.py).
"""

from __future__ import annotations

import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import torch

from ..ops import sync
from ..ops.barrier import full_linear_slacks
from ..ops.kkt import mixed_posdef_solve
from ..utils import metrics
from ..utils.config import SolverConfig
from .problem import LPProblem


def default_device() -> torch.device:
    """``cuda``: the port runs on the GPU unless the caller asks for the
    CPU.  Raises when no GPU is present, rather than carrying on on the
    CPU unasked."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "interiorpoint_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to solve on the CPU")
    return torch.device("cuda")


def default_dtype() -> str:
    """Solver default precision: float64, as in the JAX package."""
    return "float64"


def synthesize_x0(lb, ub, n, rng=None):
    """Initial point from bounds (reference: LPSolver.py:131-143)."""
    if lb is not None and ub is not None:
        return (np.maximum(lb, -1e2) + np.minimum(ub, 1e2)) / 2 * np.ones(n)
    if lb is not None:
        return (np.maximum(lb, -1e2) + 1e-1) * np.ones(n)
    if ub is not None:
        return (np.minimum(ub, 1e2) - 1e-1) * np.ones(n)
    rng = rng or np.random
    return rng.rand(n)


def _ls_interior_init(prob):
    """Least-squares interior warm start of a reduced problem:
    z = argmin‖Cz − (d−1)‖², and the minimum slack it leaves."""
    C, d = prob.C, prob.d
    r = C.shape[1]
    G = C.T @ C
    G = G + (1e-8 * torch.trace(G) / r) * torch.eye(r, dtype=G.dtype,
                                                   device=G.device)
    z = mixed_posdef_solve(G, C.T @ (d - 1.0))
    return z, (d - C @ z).amin()


def objective(prob, x: torch.Tensor) -> torch.Tensor:
    """cᵀx for an LP; ½xᵀPx + qᵀx for a QP or an SOCP (either term may be
    absent in an SOCP)."""
    if isinstance(prob, LPProblem):
        return prob.c @ x
    val = torch.zeros((), dtype=x.dtype, device=x.device)
    if prob.P is not None:
        val = val + 0.5 * (x @ (prob.P @ x))
    return val if prob.q is None else val + prob.q @ x


class BarrierDriver:
    """Common API surface of ``LPSolver``/``QPSolver``/``SOCPSolver`` (same
    attributes after ``solve()`` as the JAX package: value, xstar,
    optimal, optimality_gap, outer_iters, inner_iters, objective_vals,
    lam_star, v_star, last_metrics)."""

    def _init_common(self, *, t0, max_outer_iters, max_inner_iters,
                     phase1_max_inner_iters, epsilon, inner_epsilon,
                     linear_solve_method, max_cg_iters, alpha, beta, mu,
                     suppress_print, try_diag, track_loss,
                     get_dual_variables, phase1_tol, phase1_t0,
                     update_slacks_every, use_psd_condition=False,
                     dtype=None, refine_steps=0, eq_gate=None,
                     staged_dispatch=None, algorithm="barrier",
                     pd_max_iters=60, device=None):
        del update_slacks_every
        if algorithm not in ("barrier", "pd", "auto"):
            raise ValueError("algorithm must be 'barrier', 'pd' or "
                             f"'auto', got {algorithm!r}")
        self.algorithm = algorithm
        self.device = torch.device(device) if device is not None \
            else default_device()
        self._dtype_name = dtype or default_dtype()
        self._t0_auto = (isinstance(t0, str) and t0 == "auto")
        self.cfg = SolverConfig(
            t0=0.1 if self._t0_auto else float(t0), mu=float(mu),
            epsilon=float(epsilon),
            max_outer_iters=int(max_outer_iters),
            inner_epsilon=float(inner_epsilon),
            max_inner_iters=int(max_inner_iters),
            alpha=float(alpha), beta=float(beta),
            phase1_t0=float(phase1_t0),
            phase1_max_inner_iters=int(phase1_max_inner_iters),
            phase1_tol=float(phase1_tol),
            kkt_strategy=linear_solve_method,
            max_cg_iters=int(max_cg_iters),
            use_psd_condition=bool(use_psd_condition),
            try_diag=bool(try_diag),
            eq_gate=eq_gate,
            dtype=self._dtype_name,
            refine_steps=int(refine_steps),
            staged_dispatch=staged_dispatch,
            pd_max_iters=int(pd_max_iters),
        )
        self.suppress_print = suppress_print
        self.track_loss = track_loss
        self.get_dual_variables = get_dual_variables

        self.optimal = False
        self.value = None
        self.optimality_gap = None
        self.xstar = None
        self.lam_star = None
        self.v_star = None
        self.vstar = None
        self.outer_iters = 0
        self.inner_iters = []
        self.objective_vals = []
        self.backtrack_hist = None
        self.feasible = None
        self.cvxpy_val = None
        self.cvxpy_sol = None
        self._reduced = None
        self._oracle_fn_z = None
        self._p1_oracle_fn_z = None
        self._t0_auto_value = None

    def _setup_reduced(self, reduce_fn, oracle_fn_z, p1_oracle_fn_z):
        """Attempt the null-space elimination; keep the full-space form
        when the basis is unusable (rank-deficient A)."""
        try:
            rf = reduce_fn(self._prob)
        except ValueError:
            return
        if not sync.read(torch.isfinite(rf.basis.N).all()):
            return
        self._reduced = rf
        self._oracle_fn_z = oracle_fn_z
        self._p1_oracle_fn_z = p1_oracle_fn_z
        self._reduced_offset = sync.read(rf.obj_offset)
        self._z0_default = None
        self._z0_from = None

    def _default_z0(self):
        """Least-squares interior warm start when it lands strictly
        feasible, else the projection of self.x; cached per self.x."""
        rf = self._reduced
        x_now = np.asarray(self.x, dtype=np.float64)
        if (self._z0_default is not None and self._z0_from is not None
                and np.array_equal(self._z0_from, x_now)):
            return self._z0_default
        x_t = torch.as_tensor(x_now, dtype=self.cfg.torch_dtype,
                              device=self.device)
        z_proj = rf.basis.N.T @ (x_t - rf.basis.x_p)
        if getattr(rf.prob, "C", None) is not None:
            z_try, min_slack = _ls_interior_init(rf.prob)
            z0 = z_try if sync.read(min_slack) > 1e-6 else z_proj
        else:
            z0 = z_proj
        self._z0_default = z0
        self._z0_from = x_now.copy()
        return z0

    def _check_x0(self, x):
        raise NotImplementedError

    def _slacks_at(self, x):
        """The full slack vector at x, for the dual recovery
        λ* = 1/(t·slacks)."""
        return full_linear_slacks(self._prob, x)

    def _auto_algorithm(self) -> str:
        return "barrier"

    def _pd_applicable(self) -> bool:
        """Whether the Mehrotra engine can run this instance (at least one
        finite inequality row or bound)."""
        prob = self._reduced.prob if self._reduced is not None \
            else self._prob
        C = getattr(prob, "C", None)
        if C is not None and sync.read(torch.isfinite(prob.d).any()):
            return True
        lb = getattr(self._prob, "lb", None)
        ub = getattr(self._prob, "ub", None)
        return ((lb is not None and sync.read(torch.isfinite(lb).any()))
                or (ub is not None and sync.read(torch.isfinite(ub).any())))

    # -- solve ---------------------------------------------------------------

    def solve(self, resolve=True, **kwargs):
        """Run the interior-point solve.  ``resolve`` returns the cached
        optimum when False; kwargs may override ``t0``, ``x0``,
        ``max_outer_iters`` (the pd iteration cap under
        ``algorithm="pd"``) and ``track_loss``.  ``checkpoint_path`` and
        ``resume`` (mid-solve checkpoints of the barrier) need
        utils/checkpoint.py, which is not ported yet: they raise."""
        if not resolve and self.optimal:
            return self.value
        wall0 = time.time()
        self.track_loss = kwargs.get("track_loss", self.track_loss)
        cfg = self.cfg
        if "max_outer_iters" in kwargs:
            cfg = dataclasses.replace(
                cfg, max_outer_iters=int(kwargs["max_outer_iters"]))
        if "x0" in kwargs:
            x0 = np.asarray(kwargs["x0"], dtype=np.float64)
            self._check_x0(x0)
        else:
            x0 = self.x

        algorithm = self.algorithm
        if algorithm == "auto":
            algorithm = self._auto_algorithm()
        if algorithm == "pd":
            if kwargs.get("checkpoint_path") is not None:
                raise ValueError(
                    "algorithm='pd' does not support mid-solve "
                    "checkpointing (solves are 10-40 iterations); use "
                    "the barrier algorithm or utils.checkpoint.save_state "
                    "for terminal snapshots")
            if "max_outer_iters" in kwargs:
                cfg = dataclasses.replace(
                    cfg, pd_max_iters=int(kwargs["max_outer_iters"]))
            return self._solve_pd(cfg, x0, "x0" in kwargs, wall0)
        if kwargs.get("checkpoint_path") is not None or kwargs.get("resume"):
            raise NotImplementedError(
                "checkpoint_path/resume need interiorpoint_tpu/utils/"
                "checkpoint.py, which is not ported yet to "
                "interiorpoint_tpu_torch (ROADMAP item 11)")
        return self._solve_barrier(cfg, x0, "x0" in kwargs, kwargs.get("t0"),
                                   wall0)

    def _t0(self, t0):
        """The barrier parameter to start from: the caller's, else
        ``t0="auto"``'s m / max(|f(x)|, 1) (computed once, by the
        objective alone: building the oracle could allocate its caches),
        else cfg.t0."""
        if t0 is not None:
            return float(t0)
        if not self._t0_auto:
            return self.cfg.t0
        if self._t0_auto_value is None:
            x = torch.as_tensor(np.asarray(self.x, dtype=np.float64),
                                dtype=self.cfg.torch_dtype,
                                device=self.device)
            obj0 = sync.read(objective(self._prob, x))
            self._t0_auto_value = (max(self.num_constraints, 1)
                                   / max(abs(obj0), 1.0))
        return self._t0_auto_value

    def _solve_barrier(self, cfg, x0, explicit_x0, t0, wall0):
        """Log-barrier path (ops/ipm.py) on the reduced problem when the
        null-space reduction applies, else on the full-space problem with
        the infeasible-start engine for the equalities.  The loops are
        host-stepped already, so ``staged_dispatch`` has no effect."""
        from ..ops.ipm import barrier_solve

        t0 = self._t0(t0)
        dtype = cfg.torch_dtype
        A, b = self._eq
        eq_gate = (cfg.eq_gate if cfg.eq_gate is not None
                   else self._eq_gate_default)
        to_dev = lambda v: torch.as_tensor(  # noqa: E731
            v, dtype=dtype, device=self.device)
        if self._reduced is not None:
            rf = self._reduced
            if explicit_x0:
                z0 = rf.basis.N.T @ (to_dev(x0) - rf.basis.x_p)
            else:
                z0 = self._default_z0()
            pz = rf.prob
            res = barrier_solve(
                self._oracle_fn_z(pz), None, None, z0, cfg,
                num_constraints=self.num_constraints, eq_gate=float(eq_gate),
                t0=t0, p1_oracle=(self._p1_oracle_fn_z(pz)
                                  if self._p1_oracle_fn_z is not None
                                  else None))
            x_best = rf.expand(res.x)
            obj_offset = self._reduced_offset
        else:
            res = barrier_solve(
                self._oracle_fn(self._prob), A, b, to_dev(x0), cfg,
                num_constraints=self.num_constraints, eq_gate=float(eq_gate),
                t0=t0, p1_oracle=(self._p1_oracle_fn(self._prob)
                                  if self._p1_oracle_fn is not None
                                  else None))
            x_best = res.x
            obj_offset = 0.0

        p1 = res.phase1
        phase1_ran = p1 is not None and np.isfinite(p1.s)
        if phase1_ran:
            if p1.s > -self.cfg.phase1_tol:
                raise ValueError(
                    "Phase 1 Solver did not successfully find a feasible "
                    f"point (final slack {p1.s:.6g} after "
                    f"{p1.outer_iters} barrier stages) — the "
                    "problem may be infeasible, or needs more "
                    "max_outer_iters / a closer x0.")
            if not self.suppress_print:
                print(f"found a feasible point with slack {p1.s}")

        self._result = res._replace(x=x_best)
        self.outer_iters = int(res.outer_iters)
        self.inner_iters = [int(k) for k in res.inner_iters[:self.outer_iters]]
        # accepted-candidate histogram: bin j counts steps with σ = β^j
        self.backtrack_hist = np.asarray(res.bt_hist)
        self.objective_vals = [float(o) + obj_offset
                               for o in res.obj_vals[:self.outer_iters]
                               if np.isfinite(o)]
        self.xstar = x_best.cpu().numpy()
        self.optimal = True
        self.value = float(res.value) + obj_offset
        self.optimality_gap = float(res.dual_gap)
        t = float(res.t)

        if self.get_dual_variables:
            if self.num_constraints > 0:
                slacks = self._slacks_at(x_best)
                self.lam_star = (1.0 / (t * slacks)).cpu().numpy()
            if res.v is not None:
                self.v_star = (res.v / t).cpu().numpy()
                self.vstar = self.v_star
            elif self._reduced is not None and A is not None:
                # equality dual from stationarity at the final iterate
                from ..ops.nullspace import recover_equality_dual

                v = recover_equality_dual(self._reduced.basis, A,
                                          self._full_gradient(x_best, t))
                self.v_star = (v / t).cpu().numpy()
                self.vstar = self.v_star

        self.last_metrics = metrics.solve_record(
            type(self).__name__,
            n=self.n, num_constraints=self.num_constraints,
            num_eq=(A.shape[0] if A is not None else 0),
            value=self.value, dual_gap=self.optimality_gap,
            outer_iters=self.outer_iters,
            newton_iters=int(sum(self.inner_iters)),
            backtrack_hist=self.backtrack_hist,
            wall_s=time.time() - wall0, phase1_ran=bool(phase1_ran),
            extra={"algorithm": "barrier", "t_final": t,
                   "device": str(self.device)})
        metrics.emit(self.last_metrics)
        return self.value

    def _full_gradient(self, x, t):
        """Full-space barrier gradient at (x, t) for the dual recovery."""
        return self._oracle_fn(self._prob).grad(x, t)

    def _solve_pd(self, cfg, x0, explicit_x0, wall0):
        """Primal-dual Mehrotra path (ops/pd.py) on the reduced problem
        when the null-space reduction applies, else on the bound-stacked
        inequality form, with the equality pair (A, b) when there is one
        (the reduction refused: every direction is then one dense-KKT
        direction K5, ops/kkt_step.py)."""
        from ..ops.pd import pd_solve

        dtype = cfg.torch_dtype
        A, b_eq = self._eq
        eq_pair = (None, None)
        to_dev = lambda v: torch.as_tensor(  # noqa: E731
            v, dtype=dtype, device=self.device)

        if self._reduced is not None:
            rf = self._reduced
            pprob = rf.prob
            if getattr(pprob, "C", None) is None:
                raise ValueError(
                    "algorithm='pd' requires inequality constraints or "
                    "bounds")
            if explicit_x0:
                z0 = rf.basis.N.T @ (to_dev(x0) - rf.basis.x_p)
            else:
                z0 = self._default_z0()
            expand = rf.expand
        else:
            from .reduced import full_space_pd_problem

            pprob = full_space_pd_problem(self._prob, dtype)
            z0 = to_dev(x0)
            expand = lambda z: z  # noqa: E731
            if A is not None:
                eq_pair = (A, b_eq)

        # drop vacuous rows (d = +inf from infinite bounds), re-expanding
        # λ and s to the full slack order afterwards
        d_np = pprob.d.cpu().numpy()
        finite_rows = np.isfinite(d_np)
        if not finite_rows.all():
            if not finite_rows.any():
                raise ValueError(
                    "algorithm='pd' requires at least one finite "
                    "inequality constraint or bound")
            idx = torch.as_tensor(np.where(finite_rows)[0],
                                  device=self.device)
            pprob = dataclasses.replace(
                pprob, C=pprob.C[idx, :].contiguous(), d=pprob.d[idx])

        res = pd_solve(pprob, z0, cfg, A=eq_pair[0], b=eq_pair[1])
        x_full = expand(res.z)
        val = objective(self._prob, x_full)
        x_host = x_full.cpu().numpy()
        lam_h = res.lam.cpu().numpy()
        s_h = res.s.cpu().numpy()
        if not finite_rows.all():
            lam_full = np.zeros(d_np.shape[0])
            lam_full[finite_rows] = lam_h
            s_full = np.full(d_np.shape[0], np.inf)
            s_full[finite_rows] = s_h
            lam_h, s_h = lam_full, s_full
        self._pd_result = res._replace(lam=lam_h, s=s_h)

        self.xstar = x_host
        self.value = float(val.cpu())
        self.optimal = True
        gap = float(res.gap)
        self.optimality_gap = gap
        iters = int(res.iters)
        self.outer_iters = iters
        self.inner_iters = [1] * iters
        self.objective_vals = []
        self.backtrack_hist = None
        if not res.converged and not self.suppress_print:
            print(f"pd: not converged after {iters} iterations "
                  f"(gap {gap:.3g}, rp {float(res.rp_norm):.3g}, "
                  f"rd {float(res.rd_norm):.3g})")

        m_ineq = max(self.num_constraints, 1)
        self._result = SimpleNamespace(
            x=self.xstar, v=None, t=m_ineq / max(gap, 1e-300),
            value=self.value, dual_gap=gap, phase1=None)

        if self.get_dual_variables:
            lam = np.asarray(lam_h, dtype=np.float64)
            self.lam_star = lam  # order [Cx≤d, ub, lb] = slack order
            if A is not None:
                self.v_star = self._equality_dual(lam)
                self.vstar = self.v_star

        self.last_metrics = metrics.solve_record(
            type(self).__name__,
            n=self.n, num_constraints=self.num_constraints,
            num_eq=(A.shape[0] if A is not None else 0),
            value=self.value, dual_gap=gap,
            outer_iters=iters, newton_iters=iters,
            backtrack_hist=None, wall_s=time.time() - wall0,
            phase1_ran=False,
            extra={"algorithm": "pd", "converged": bool(res.converged),
                   "rp_norm": float(res.rp_norm),
                   "rd_norm": float(res.rd_norm),
                   "device": str(self.device)})
        metrics.emit(self.last_metrics)
        return self.value

    def _equality_dual(self, lam: np.ndarray) -> np.ndarray:
        """Stationarity-consistent equality dual:
        ∇f + Cᵀλ_C + λ_ub − λ_lb + Aᵀv = 0 (ops/nullspace.py)."""
        from ..ops.nullspace import recover_equality_dual

        prob = self._prob
        if getattr(prob, "P", None) is not None:
            g = prob.P.cpu().numpy() @ self.xstar
            if prob.q is not None:
                g = g + prob.q.cpu().numpy()
        else:
            g = prob.c.cpu().numpy().astype(np.float64).copy()
        ofs = 0
        if prob.C is not None:
            kC = prob.C.shape[0]
            g = g + prob.C.cpu().numpy().T @ lam[:kC]
            ofs = kC
        if prob.ub is not None:
            g = g + lam[ofs:ofs + self.n]
            ofs += self.n
        if prob.lb is not None:
            g = g - lam[ofs:ofs + self.n]
        v = recover_equality_dual(
            self._reduced.basis, self._eq[0],
            torch.as_tensor(g, dtype=self.cfg.torch_dtype,
                            device=self.device))
        return v.cpu().numpy()

    def __str__(self):
        opt_val = "Not yet solved" if self.optimal is False else self.value
        return f"{type(self).__name__}(Optimal Value: {opt_val})"

    def __repr__(self):
        return str(self)
