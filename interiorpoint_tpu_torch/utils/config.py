"""Solver configuration (counterpart of interiorpoint_tpu/utils/config.py).

Same fields, defaults and validation as the JAX package's
``SolverConfig`` and ``AdmmConfig``, so a configuration means the same
thing in both packages.  ``dtype`` names map to torch dtypes through
``torch_dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_STRATEGY_ALIASES = {
    "cholesky": "cholesky",
    "np_solve": "solve",
    "solve": "solve",
    "np_lstsq": "lstsq",
    "lstsq": "lstsq",
    "direct": "inverse",
    "inverse": "inverse",
    "cg": "cg",
    "kkt": "full_kkt",
    "full_kkt": "full_kkt",
    "diagonal": "diagonal",
}

_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
}


def canonical_strategy(name: str) -> str:
    try:
        return _STRATEGY_ALIASES[name]
    except KeyError:
        raise ValueError(
            f"Unknown linear solve method {name!r}; valid options: "
            f"{sorted(set(_STRATEGY_ALIASES))}"
        ) from None


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Hyperparameters of the interior-point solvers.

    Every field and default of the JAX package's ``SolverConfig``, with
    the same meaning.

    ``use_pallas=True`` routes each equality-free float64 primal-dual
    iteration through the hand-written step kernel K1 (ops/pd_step.py),
    and each barrier Newton step on a single-block linear form (the
    reduced problem, phase one) with the cholesky strategy through K2
    (ops/newton_step.py): the CUDA kernels for tensors on a GPU, their
    plain PyTorch versions for tensors on the CPU.  ``use_pallas=False``
    selects the eager engines (ops/pd.py ``pd_solve``; the oracle path of
    ops/newton.py).  ``matrix_free``, ``allow_stream`` and
    ``staged_dispatch`` are TPU-memory and TPU-runtime switches with no
    effect here.
    """

    t0: float = 0.1
    mu: float = 15.0
    epsilon: float = 1e-10
    max_outer_iters: int = 20

    inner_epsilon: float = 1e-5
    max_inner_iters: int = 50

    alpha: float = 0.2
    beta: float = 0.6
    max_linesearch_steps: int = 64

    phase1_t0: float = 0.01
    phase1_max_inner_iters: int = 500
    phase1_tol: float = 0.0

    kkt_strategy: str = "cholesky"
    max_cg_iters: int = 50
    use_psd_condition: bool = False
    try_diag: bool = True

    eq_gate: Optional[float] = None

    dtype: str = "float32"
    refine_steps: int = 0
    mixed_precision: bool = True
    matrix_free: bool = False
    use_pallas: bool = True
    allow_stream: bool = True
    pallas_refine: int = 3
    staged_dispatch: Optional[bool] = None
    pd_max_iters: int = 60

    def __post_init__(self):
        object.__setattr__(
            self, "kkt_strategy", canonical_strategy(self.kkt_strategy)
        )
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


@dataclasses.dataclass(frozen=True)
class AdmmConfig:
    """Hyperparameters of the batched ADMM LASSO solver (ops/admm.py).

    Every field and default of the JAX package's ``AdmmConfig``:
    ``relax`` is the over-relaxation coefficient (1.0: the plain
    iteration), ``adaptive_rho`` the descent down a ladder of
    ``rho_rungs`` values of ρ spaced by ``rho_factor``.
    """

    rho: float = 0.4
    max_iters: int = 1000
    check_stop: int = 10
    eps_abs: float = 1e-4
    eps_rel: float = 3e-2
    positive: bool = False
    add_bias: bool = False
    compute_loss: bool = False
    dtype: str = "float32"
    relax: float = 1.0
    adaptive_rho: bool = False
    rho_rungs: int = 5
    rho_factor: float = 4.0

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]
