"""Null-space elimination of equality constraints (counterpart of
interiorpoint_tpu/ops/nullspace.py).

    x = x_p + N z,   A x_p = b,   A N = 0,   NᵀN = I_r,   r = n − m

The basis comes from the same host scipy QR as the JAX package (one-time
set-up in LAPACK fp64), so both packages get the same N and x_p, and the
reduced problems, iterates and multipliers compare directly.  Only the
results (N, x_p, AAᵀ) go to the device of A.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .kkt import mixed_posdef_solve


class AffineBasis(NamedTuple):
    """x = x_p + N z parameterization of {x : Ax = b}."""
    N: torch.Tensor     # (n, r) orthonormal null-space basis of A
    x_p: torch.Tensor   # (n,) min-norm particular solution
    AAt: torch.Tensor   # AAᵀ (reused for dual recovery)


def affine_elimination(A: torch.Tensor, b: torch.Tensor,
                       seed: int = 0) -> AffineBasis:
    """Factor {x : Ax = b} = {x_p + N z} by a full host QR of Aᵀ.
    Rank-deficient A returns a NaN basis (the caller's fall-back signal)."""
    del seed  # the host QR needs no random probe block
    dtype, device = A.dtype, A.device
    A_h = A.detach().cpu().numpy().astype(np.float64)
    b_h = b.detach().cpu().numpy().astype(np.float64)
    m, n = A_h.shape
    r = n - m
    if r <= 0:
        raise ValueError("null-space elimination requires m < n")

    from scipy.linalg import qr, solve_triangular

    Q, R = qr(A_h.T, mode="full")
    diag = np.abs(np.diag(R[:m, :m]))
    to = lambda v: torch.as_tensor(v, dtype=dtype, device=device)  # noqa
    if diag.min() <= max(m, n) * np.finfo(np.float64).eps * diag.max():
        return AffineBasis(N=to(np.full((n, r), np.nan)),
                           x_p=to(np.full((n,), np.nan)),
                           AAt=to(A_h @ A_h.T))
    w = solve_triangular(R[:m, :m].T, b_h, lower=True)
    return AffineBasis(N=to(np.ascontiguousarray(Q[:, m:])),
                       x_p=to(Q[:, :m] @ w), AAt=to(A_h @ A_h.T))


def recover_equality_dual(basis: AffineBasis, A: torch.Tensor,
                          g_full: torch.Tensor) -> torch.Tensor:
    """v solving min‖Aᵀv + g_full‖: the equality multiplier consistent
    with stationarity at the final iterate."""
    return -mixed_posdef_solve(basis.AAt, A @ g_full)
