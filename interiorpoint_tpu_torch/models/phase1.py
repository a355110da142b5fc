"""Standalone phase-one (feasibility) solvers (counterpart of
interiorpoint_tpu/models/phase1.py).

* ``PhaseOneSolver``: min s s.t. slackᵢ(x) + s ≥ 0 over [x, s] for an
  inequality block and bounds, early-exiting once s < −tol.
* ``PhaseOne``: the legacy class for polyhedra Gx ≤ h; ``solve()``
  returns (x, s, warn) with s < 0 ⇔ strictly feasible.

Both run the barrier loop of ops/ipm.py (``phase1_solve``), whose Newton
steps go through K2 (ops/newton_step.py) on the augmented [C | −1] block
when there are no bounds.  ``PhaseOneSolver(socp=True,
socp_params=(A, b, c, d))`` runs the SOCP phase one (ops/socp.py
``make_phase1_socp_oracle``) on the oracle path, as the JAX package does:
no fused step applies to phase one there.  Same arguments as the JAX
package, plus ``device=`` (default ``default_device()``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import sync
from ..ops.barrier import make_phase1_linear_oracle
from ..ops.ipm import phase1_solve
from ..ops.socp import make_phase1_socp_oracle
from ..utils.config import SolverConfig
from .base import default_device, default_dtype
from .problem import make_lp, make_socp


class PhaseOneSolver:
    """Drop-in analogue of the JAX package's PhaseOneSolver: for LP/QP
    feasibility pass C, d and bounds; for SOCP pass ``socp=True`` and
    ``socp_params=(A, b, c, d)`` (and bounds)."""

    def __init__(self, C=None, d=None, lower_bound=0, upper_bound=None,
                 x0=None, max_outer_iters=50, max_inner_iters=20,
                 epsilon=1e-8, inner_epsilon=1e-5,
                 linear_solve_method="cholesky", max_cg_iters=50, alpha=0.2,
                 beta=0.6, mu=15, t0=1, suppress_print=False, use_gpu=False,
                 track_loss=False, n=None, tol=0.1, socp=False,
                 socp_params=None, use_psd_condition=False,
                 update_slacks_every=0, dtype=None, device=None):
        del use_gpu, update_slacks_every, track_loss, n
        self.device = torch.device(device) if device is not None \
            else default_device()
        self.cfg = SolverConfig(
            t0=float(t0), mu=float(mu), epsilon=float(epsilon),
            max_outer_iters=int(max_outer_iters),
            inner_epsilon=float(inner_epsilon),
            max_inner_iters=int(max_inner_iters),
            phase1_max_inner_iters=int(max_inner_iters),
            phase1_t0=float(t0), phase1_tol=float(tol),
            alpha=float(alpha), beta=float(beta),
            kkt_strategy=linear_solve_method,
            max_cg_iters=int(max_cg_iters),
            use_psd_condition=bool(use_psd_condition),
            dtype=dtype or default_dtype(),
        )
        self.tol = tol
        self.suppress_print = suppress_print
        dev = dict(dtype=self.cfg.torch_dtype, device=self.device)
        if not socp:
            if C is None or d is None:
                raise ValueError("Phase one requires C and d")
            n = C.shape[1]
            self._prob = make_lp(np.zeros(n), C=C, d=d, lb=lower_bound,
                                 ub=upper_bound, **dev)
            self._oracle = make_phase1_linear_oracle(self._prob)
        else:
            A, b, c, d_socp = socp_params
            self._prob = make_socp(A, b, c, d_socp, lb=lower_bound,
                                   ub=upper_bound, **dev)
            self._oracle = make_phase1_socp_oracle(self._prob)
            n = self._prob.n
        self.n = n
        self.x = (np.asarray(x0, dtype=np.float64) if x0 is not None
                  else np.zeros(n))
        self.outer_iters = 0
        self.inner_iters = []
        # the starting slack, as the reference's phase1_fm.s
        z0 = torch.zeros(n + 1, dtype=self.cfg.torch_dtype,
                         device=self.device)
        z0[:n] = self._x_tensor(self.x)
        self.s = -sync.read(self._oracle.min_slack(z0)) + 1.0

    def _x_tensor(self, x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64),
                               dtype=self.cfg.torch_dtype, device=self.device)

    def solve(self, x0=None):
        """Returns (x_feasible, s) with s < −tol on success."""
        x = x0 if x0 is not None else self.x
        res = phase1_solve(self._oracle, self._x_tensor(x), self.cfg)
        self.outer_iters = int(res.outer_iters)
        self.inner_iters = [int(res.newton_iters)]
        self.s = float(res.s)
        if not self.suppress_print:
            print(f"Current slack: {self.s}")
        return res.x.cpu().numpy(), self.s


class PhaseOne:
    """Legacy standalone phase one for Gx ≤ h: minimize s s.t.
    Gx − h ≤ s·1.  ``solve()`` → (x, s, warn): s < 0 strictly feasible,
    s ≈ 0 boundary, s > 0 likely empty; warn when the iteration limit was
    hit without feasibility."""

    def __init__(self, G, h, mu=15, x0=None, eps=1e-8,
                 max_iter_interior=200, max_iter_newton=200, use_cupy=False,
                 linear_solver="solve", max_cg_iters=50, dtype=None,
                 device=None):
        del use_cupy
        self.device = torch.device(device) if device is not None \
            else default_device()
        G = np.asarray(G, dtype=np.float64)
        h = np.asarray(h, dtype=np.float64)
        self.G, self.h = G, h
        self.m, self.n = G.shape
        self.x = (np.asarray(x0, dtype=np.float64) if x0 is not None
                  else np.zeros(self.n))
        self.cfg = SolverConfig(
            t0=1.0, mu=float(mu), epsilon=float(eps),
            max_outer_iters=int(max_iter_interior),
            max_inner_iters=int(max_iter_newton),
            phase1_max_inner_iters=int(max_iter_newton),
            phase1_t0=1.0, phase1_tol=0.0,
            kkt_strategy=linear_solver, max_cg_iters=int(max_cg_iters),
            dtype=dtype or default_dtype(),
        )
        self._prob = make_lp(np.zeros(self.n), C=G, d=h, lb=None, ub=None,
                             dtype=self.cfg.torch_dtype, device=self.device)
        self.s = None
        self.warn = False

    def solve(self):
        # already feasible: no solve (reference: PhaseOne.py:342-345)
        if np.max(self.G @ self.x - self.h) <= 0:
            self.s = -1.0
            return self.x, self.s, False
        x = torch.as_tensor(self.x, dtype=self.cfg.torch_dtype,
                            device=self.device)
        res = phase1_solve(make_phase1_linear_oracle(self._prob), x,
                           self.cfg)
        self.x = res.x.cpu().numpy()
        self.s = float(res.s)
        self.warn = bool(res.outer_iters >= self.cfg.max_outer_iters
                         and self.s >= 0)
        return self.x, self.s, self.warn
