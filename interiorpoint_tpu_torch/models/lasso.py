"""LASSO driver: min 1/(2m)‖Ax − b‖² + λ‖x‖₁, batched over (b, λ) pairs
(counterpart of interiorpoint_tpu/models/lasso.py).

The constructor, ``solve()`` and its return shapes are the JAX
package's, plus ``device=`` (default ``default_device()``: the GPU, and a
raise when there is none).  The ADMM iteration is ops/admm.py; its ladder
of Q⁻¹ is built once per solver and reused across solves and chunks.

Chunking: the samples are split into chunks when three iterate copies
and the data would not fit a device-memory budget: half the free memory
of the card (``torch.cuda.mem_get_info``), and the JAX package's 8e9
bytes on the CPU, so that chunk counts agree there.  An explicit
``num_chunks`` is honoured, with samples i, i + k, i + 2k, … in chunk i.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.admm import (admm_core, admm_core_prepared, admm_prepare,
                        lasso_objective, soft_threshold)
from ..utils import metrics
from ..utils import oracle as oracle_check
from ..utils.config import AdmmConfig
from .base import default_device, default_dtype

# the JAX package's budget for the iterates, kept for CPU solves
_CPU_BUDGET_BYTES = 8 * 1000**3


def _budget_bytes(device: torch.device) -> int:
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0] // 2
    return _CPU_BUDGET_BYTES


class LassoSolver:
    """Batched LASSO by ADMM with the JAX package's ``LassoSolver`` API.

    ``adaptive_rho`` (default True: descents down a ladder of ρ, the
    passed ``rho`` its top rung) and ``relax`` (default 1.8,
    over-relaxation) leave the stopping test as it is; pass
    ``adaptive_rho=False, relax=1.0`` for the reference's fixed-ρ
    iteration.  ``use_gpu`` is ignored: ``device`` decides.
    """

    def __init__(self, A, b, reg=1, rho=0.4, max_iters=1000, check_stop=10,
                 add_bias=False, normalize_A=False, positive=False,
                 compute_loss=False, adaptive_rho=True, eps_abs=1e-4,
                 eps_rel=3e-2, use_gpu=False, num_chunks=0,
                 check_cvxpy=True, dtype=None, relax=1.8, device=None):
        del use_gpu
        self.device = torch.device(device) if device is not None \
            else default_device()
        dtype = dtype or default_dtype()
        self.cfg = AdmmConfig(
            rho=float(rho), max_iters=int(max_iters),
            check_stop=int(check_stop), eps_abs=float(eps_abs),
            eps_rel=float(eps_rel), positive=bool(positive),
            add_bias=bool(add_bias), compute_loss=bool(compute_loss),
            dtype=dtype, relax=float(relax),
            adaptive_rho=bool(adaptive_rho))

        A = np.asarray(A, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        if b.ndim < 2:
            b = b[:, None]
        self.m = A.shape[0]
        if normalize_A:
            A = A / A.std(axis=0)
        self.add_bias = add_bias
        if add_bias:
            A = np.hstack((np.ones((self.m, 1)), A))
        self.n = A.shape[1]

        reg = np.atleast_1d(np.asarray(reg, dtype=np.float64))
        if not (len(reg) == b.shape[1] or len(reg) == 1
                or b.shape[1] == 1):
            raise ValueError("reg must broadcast against the columns of b")
        self.num_samples = max(b.shape[1], len(reg))
        self.reg = reg
        self.rho = float(rho)
        self.positive = positive
        self.compute_loss = compute_loss

        # three iterate copies, the data and one Q⁻¹ against the budget
        itemsize = 8 if dtype == "float64" else 4
        iterate_bytes = (3 * self.n * self.num_samples
                         + b.size + A.size + self.n**2) * itemsize
        auto_chunks = int(iterate_bytes // _budget_bytes(self.device)) + 1
        self.num_chunks = max(auto_chunks, int(num_chunks), 1)

        dt = self.cfg.torch_dtype
        self._A = torch.as_tensor(A, dtype=dt, device=self.device)
        self._b = torch.as_tensor(b, dtype=dt, device=self.device)
        self._reg = torch.as_tensor(reg, dtype=dt, device=self.device)

        if check_cvxpy:
            print("Testing CVXPY")
            self.feasible, self.cvxpy_vals, self.cvxpy_sols = (
                oracle_check.check_lasso(A, b, reg))
        else:
            self.feasible, self.cvxpy_vals, self.cvxpy_sols = (None, None,
                                                               None)

        self.X = np.zeros((self.n, self.num_samples))
        self.solutions = None
        self.gaps = None
        self.num_iterations = None
        self._prepared = None

    def _get_prepared(self):
        """The ladder of Q⁻¹, built on the first solve and kept."""
        if self._prepared is None:
            self._prepared = admm_prepare(self._A, self.cfg)
        return self._prepared

    def _run(self, prepared, b, reg, num_samples):
        """One chunk: the ADMM solve, then its X, solutions and gaps to
        numpy in one transfer."""
        res = admm_core_prepared(prepared, self._A, b, reg, self.cfg,
                                 num_samples)
        flat = torch.cat([res.X.reshape(-1), res.solutions.reshape(-1),
                          res.gaps.reshape(-1)]).cpu().numpy()
        nx, B = res.X.numel(), res.solutions.numel()
        return (flat[:nx].reshape(res.X.shape), flat[nx:nx + B],
                flat[nx + B:].reshape(res.gaps.shape), res.iterations)

    def solve(self):
        """Returns (X, solutions, gaps, iterations): ``iterations`` an int
        for one chunk, a list (one per chunk) for several."""
        wall0 = time.time()
        prepared = self._get_prepared()
        if self.num_chunks == 1:
            X, sols, gaps, it = self._run(prepared, self._b, self._reg,
                                          self.num_samples)
            self.X = X
            self.solutions = sols
            self.gaps = gaps[:it]
            self.num_iterations = [it]
            self._emit_metrics(time.time() - wall0)
            return self.X, self.solutions, self.gaps, it

        indices = np.arange(self.num_samples)
        self.solutions = np.empty(self.num_samples)
        gaps_rows = self.cfg.max_iters if self.compute_loss else 0
        self.gaps = np.zeros((gaps_rows, self.num_samples))
        self.num_iterations = []
        b_cols = self._b.shape[1]
        for i in range(self.num_chunks):
            sel = indices[i::self.num_chunks]
            sel_t = torch.as_tensor(sel, device=self.device)
            b_i = self._b[:, sel_t] if b_cols == self.num_samples \
                else self._b
            reg_i = self._reg[sel_t] if len(self.reg) == self.num_samples \
                else self._reg
            X, sols, gaps, it = self._run(prepared, b_i, reg_i, len(sel))
            self.X[:, sel] = X
            self.solutions[sel] = sols
            if self.compute_loss:
                self.gaps[:, sel] = gaps
            self.num_iterations.append(it)
        self._emit_metrics(time.time() - wall0)
        return self.X, self.solutions, self.gaps, self.num_iterations

    def _emit_metrics(self, wall_s):
        """Per-solve record (utils/metrics.py): outer_iters carries the
        chunk count and newton_iters the ADMM iterations over all
        chunks."""
        iters = self.num_iterations
        self.last_metrics = metrics.solve_record(
            type(self).__name__, n=self.X.shape[0],
            num_constraints=0, num_eq=0,
            value=float(np.mean(self.solutions)), dual_gap=None,
            outer_iters=len(iters), newton_iters=int(sum(iters)),
            wall_s=wall_s,
            extra={"num_samples": int(self.num_samples),
                   "num_chunks": int(self.num_chunks),
                   "device": str(self.device)})
        metrics.emit(self.last_metrics)

    def objective(self):
        """The objective of every sample at the current X."""
        X = torch.as_tensor(self.X, dtype=self._A.dtype, device=self.device)
        return lasso_objective(self._A, self._b, self._reg, X,
                               self.positive, self.add_bias).cpu().numpy()

    def prox(self, v, eta):
        """The soft-threshold prox of this solver's options."""
        dt = self._A.dtype
        return soft_threshold(
            torch.as_tensor(np.asarray(v), dtype=dt, device=self.device),
            torch.as_tensor(np.asarray(eta), dtype=dt, device=self.device),
            self.positive, self.add_bias).cpu().numpy()

    def check_cvxpy(self):
        return oracle_check.check_lasso(self._A.cpu().numpy(),
                                        self._b.cpu().numpy(), self.reg)

    def plot(self, iteration_start=0, iteration_end=-1, subtract_opt=True):
        """Objective gap per iteration, one line per sample (needs
        ``compute_loss=True``)."""
        if not self.compute_loss:
            raise ValueError(
                "Need to solve problem with compute_loss set to True to be "
                "able to plot convergence!")
        import matplotlib.pyplot as plt

        gaps = self.gaps
        iters = self.num_iterations
        if iteration_end == -1:
            ends = iters
        elif not isinstance(iteration_end, list):
            ends = [iteration_end]
        else:
            ends = iteration_end
        ax = plt.subplot()
        for i in range(gaps.shape[1]):
            iter_gaps = gaps[iteration_start:ends[i % len(ends)], i]
            if subtract_opt and len(iter_gaps):
                iter_min = iter_gaps.min()
                if self.cvxpy_vals is not None:
                    iter_min = min(self.cvxpy_vals[i], iter_min)
                ax.plot(iter_gaps[:-1] - iter_min)
            else:
                ax.plot(iter_gaps)
        ax.set_ylabel("Optimality gap")
        ax.set_xlabel("iteration number")
        ax.set_title("Convergence of LassoSolver")
        ax.set_yscale("log")
        return ax


def solve_lasso(A, b, reg=1.0, cfg=None, *, device=None, **cfg_overrides):
    """One batched LASSO solve; returns ops/admm.py's ADMMResult (tensors
    on ``device``, default ``default_device()``)."""
    if cfg is None:
        cfg = AdmmConfig(**{"dtype": default_dtype(), **cfg_overrides})
    device = torch.device(device) if device is not None \
        else default_device()
    dt = cfg.torch_dtype
    A = torch.as_tensor(np.asarray(A), dtype=dt, device=device)
    b = torch.as_tensor(np.asarray(b), dtype=dt, device=device)
    if b.ndim < 2:
        b = b[:, None]
    reg = torch.atleast_1d(torch.as_tensor(np.asarray(reg), dtype=dt,
                                           device=device))
    num_samples = max(b.shape[1], reg.shape[0])
    return admm_core(A, b, reg, cfg, num_samples)
