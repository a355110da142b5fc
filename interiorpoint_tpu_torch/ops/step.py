"""One Newton iteration as a standalone function (counterpart of
interiorpoint_tpu/ops/step.py:19-32): one infeasible-start step on a
boxed LP, a building block for custom loops and the single-step entry
(interiorpoint_tpu_torch/entry.py).

The step is ``newton_infeasible`` (ops/newton.py) with one inner
iteration over ``make_qp_oracle(prob, try_diag=False)``.  Its KKT solve
is ops/kkt.py's block elimination, as the JAX step's: no step kernel is
on this path.  In float32 (the entry's arguments) it is torch's Cholesky
in float32 (TF32 stays off); in float64 the Hessian solve is the mixed
path, the fp32 blocked Cholesky and its solve (K3a, K3b) with fp64
refinement, as the JAX package's ``robust_cholesky32`` on a TPU.
"""

from __future__ import annotations

import torch

from ..models.problem import LPProblem
from ..utils.config import SolverConfig
from .barrier import make_qp_oracle
from .newton import newton_infeasible

_STEP_CFG = SolverConfig(max_inner_iters=1, dtype="float32")
_STEP_CFG_64 = SolverConfig(max_inner_iters=1, dtype="float64")


def lp_newton_step(c, A, b, C, d, lb, ub, x, v, t):
    """One infeasible-start Newton iteration on a boxed, inequality- and
    equality-constrained LP: KKT block elimination, the candidate line
    search and the iterate update.  All arguments are tensors on one
    device (t a scalar); returns (x', v', residual_norm), tensors of x's
    dtype on its device."""
    prob = LPProblem(c=c, A=A, b=b, C=C, d=d, lb=lb, ub=ub)
    oracle = make_qp_oracle(prob, try_diag=False)
    cfg = _STEP_CFG if x.dtype == torch.float32 else _STEP_CFG_64
    res = newton_infeasible(oracle, A, b, x, v, t, cfg)
    return res.x, res.v, torch.as_tensor(res.resid, dtype=x.dtype,
                                         device=x.device)
