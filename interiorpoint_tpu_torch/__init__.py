"""interiorpoint_tpu_torch: the PyTorch/CUDA port of interiorpoint_tpu.

The port runs the log-barrier and the primal-dual (Mehrotra) LP/QP
engines (with or without equality constraints), the SOCP log-barrier and
conic Mehrotra engines and phase one (LP/QP and SOCP) on an NVIDIA H100,
with hand-written CUDA kernels for the fused barrier Newton step
(ops/newton_step.py), the fused SOCP barrier Newton step
(ops/socp_step.py), the fused Mehrotra step (ops/pd_step.py), the dense-KKT
direction (ops/kkt_step.py) and the blocked fp32/fp64 Cholesky
(ops/chol.py), and on the CPU (``device="cpu"``) with their plain PyTorch versions.  It imports torch, numpy and scipy, never JAX; the JAX
package beside it is the reference it is tested against.

    from interiorpoint_tpu_torch import LPSolver
    LPSolver(c=c, A=A, b=b, C=C, d=d, lower_bound=-3, upper_bound=3,
             device="cuda").solve()
"""

from .models.base import default_device
from .models.lp import LPSolver, solve_lp
from .models.phase1 import PhaseOne, PhaseOneSolver
from .models.problem import SOCPProblem, make_lp, make_qp, make_socp
from .models.qp import QPSolver, solve_qp
from .models.socp import SOCPSolver, solve_socp
from .utils.config import SolverConfig

__version__ = "0.1.0"

__all__ = ["LPSolver", "QPSolver", "SOCPSolver", "PhaseOneSolver",
           "PhaseOne", "solve_lp", "solve_qp", "solve_socp", "make_lp",
           "make_qp", "make_socp", "SOCPProblem", "SolverConfig",
           "default_device"]
