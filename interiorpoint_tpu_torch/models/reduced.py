"""Reduced-space (null-space) problem transforms (counterpart of the LP/QP
part of interiorpoint_tpu/models/reduced.py).

For x = x_p + N z the equalities vanish and the bounds become rows of one
inequality block [C; I(ub); −I(lb)], in the slack order of the full
problem, so multipliers map back row for row.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.nullspace import AffineBasis, affine_elimination
from .problem import LPProblem, QPProblem


class ReducedForm(NamedTuple):
    prob: object            # z-space problem (no equality block)
    basis: AffineBasis
    obj_offset: torch.Tensor  # objective contribution of x_p

    def expand(self, z: torch.Tensor) -> torch.Tensor:
        """Map a z-space iterate back to x-space."""
        return self.basis.x_p + self.basis.N @ z


def _reduced_ineq_block(prob, N, x_p):
    """Stack [C; I(ub); −I(lb)] · (x_p + Nz) ≤ [d; ub; −lb]."""
    rows, rhs = [], []
    if prob.C is not None:
        rows.append(prob.C @ N)
        rhs.append(prob.d - prob.C @ x_p)
    if prob.ub is not None:
        rows.append(N)
        rhs.append(prob.ub - x_p)
    if prob.lb is not None:
        rows.append(-N)
        rhs.append(x_p - prob.lb)
    if not rows:
        return None, None
    return torch.cat(rows, dim=0).contiguous(), torch.cat(rhs)


def reduce_lp(prob: LPProblem, seed: int = 0) -> ReducedForm:
    basis = affine_elimination(prob.A, prob.b, seed)
    N, x_p = basis.N, basis.x_p
    C_z, d_z = _reduced_ineq_block(prob, N, x_p)
    prob_z = LPProblem(c=N.T @ prob.c, C=C_z, d=d_z)
    return ReducedForm(prob=prob_z, basis=basis, obj_offset=prob.c @ x_p)


def reduce_qp(prob: QPProblem, seed: int = 0) -> ReducedForm:
    basis = affine_elimination(prob.A, prob.b, seed)
    N, x_p = basis.N, basis.x_p
    C_z, d_z = _reduced_ineq_block(prob, N, x_p)
    Px_p = prob.P @ x_p
    q_z = N.T @ (Px_p if prob.q is None else Px_p + prob.q)
    offset = 0.5 * x_p @ Px_p
    if prob.q is not None:
        offset = offset + prob.q @ x_p
    prob_z = QPProblem(P=(N.T @ (prob.P @ N)).contiguous(), q=q_z, C=C_z,
                       d=d_z)
    return ReducedForm(prob=prob_z, basis=basis, obj_offset=offset)


def full_space_pd_problem(prob, dtype):
    """Inequality form for the primal-dual engine: bounds stacked into C
    through the identity map.  Raises when there is no inequality or
    bound."""
    n = prob.n
    device = (prob.P if isinstance(prob, QPProblem) else prob.c).device
    C_z, d_z = _reduced_ineq_block(
        prob, torch.eye(n, dtype=dtype, device=device),
        torch.zeros(n, dtype=dtype, device=device))
    if C_z is None:
        raise ValueError(
            "algorithm='pd' requires inequality constraints or bounds")
    if isinstance(prob, QPProblem):
        return QPProblem(P=prob.P, q=prob.q, C=C_z, d=d_z)
    return LPProblem(c=prob.c, C=C_z, d=d_z)
