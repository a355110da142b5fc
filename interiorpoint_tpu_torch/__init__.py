"""interiorpoint_tpu_torch: the PyTorch/CUDA port of interiorpoint_tpu.

The port runs the primal-dual (Mehrotra) LP/QP path on an NVIDIA H100
with hand-written CUDA kernels for the fused step (ops/pd_step.py) and the
blocked fp32 Cholesky (ops/chol.py), and on the CPU with their plain
PyTorch versions.  It imports torch, numpy and scipy, never JAX; the JAX
package beside it is the reference it is tested against.

    from interiorpoint_tpu_torch import LPSolver
    LPSolver(c=c, A=A, b=b, C=C, d=d, lower_bound=-3, upper_bound=3,
             algorithm="auto", device="cuda").solve()
"""

from .models.base import default_device
from .models.lp import LPSolver, solve_lp
from .models.qp import QPSolver, solve_qp
from .utils.config import SolverConfig

__version__ = "0.1.0"

__all__ = ["LPSolver", "QPSolver", "solve_lp", "solve_qp", "SolverConfig",
           "default_device"]
