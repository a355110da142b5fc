"""Reduced-space (null-space) problem transforms (counterpart of
interiorpoint_tpu/models/reduced.py).

For x = x_p + N z the equalities vanish.  LP/QP: the bounds become rows of
one inequality block [C; I(ub); −I(lb)], in the slack order of the full
problem, so multipliers map back row for row.  SOCP: the cones rotate
(``reduce_socp``); bounds have no block to fold into, so the driver keeps
the full-space form when there are any.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.nullspace import AffineBasis, affine_elimination
from .problem import LPProblem, QPProblem, SOCPProblem


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


def reduce_socp(prob: SOCPProblem, seed: int = 0) -> ReducedForm:
    """‖A_k(x_p+Nz)+b_k‖ ≤ c_k·(x_p+Nz)+d_k is the cone in z with
    Ã = A_k N, b̃ = A_k x_p + b_k, c̃ = Nᵀc_k, d̃ = c_k·x_p + d_k.  Raises
    ``ValueError`` when bounds are present."""
    if prob.lb is not None or prob.ub is not None:
        raise ValueError("reduced SOCP requires unbounded variables")
    basis = affine_elimination(prob.F, prob.g, seed)
    N, x_p = basis.N, basis.x_p
    K, M, n = prob.A.shape
    A_z = (prob.A.reshape(K * M, n) @ N).reshape(K, M, -1).contiguous()
    b_z = torch.einsum("kmn,n->km", prob.A, x_p) + prob.b
    offset = torch.zeros((), dtype=x_p.dtype, device=x_p.device)
    P_z = q_z = None
    if prob.P is not None:
        Px_p = prob.P @ x_p
        q_z = N.T @ (Px_p if prob.q is None else Px_p + prob.q)
        P_z = (N.T @ (prob.P @ N)).contiguous()
        offset = offset + 0.5 * x_p @ Px_p
        if prob.q is not None:
            offset = offset + prob.q @ x_p
    elif prob.q is not None:
        q_z = N.T @ prob.q
        offset = offset + prob.q @ x_p
    prob_z = SOCPProblem(A=A_z, b=b_z, c=(prob.c @ N).contiguous(),
                         d=prob.d + prob.c @ x_p, P=P_z, q=q_z)
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
