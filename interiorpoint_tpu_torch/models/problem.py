"""LP and QP problem data as frozen dataclasses of tensors (counterpart
of interiorpoint_tpu/models/problem.py; SOCP and LASSO are not ported
yet).

Every tensor of a problem lives on one device, chosen by the caller of
``make_lp``/``make_qp``.  A field is None when its block is absent.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LPProblem:
    """min cᵀx  s.t.  Ax = b, Cx ≤ d, lb ≤ x ≤ ub."""

    c: torch.Tensor
    A: Optional[torch.Tensor] = None
    b: Optional[torch.Tensor] = None
    C: Optional[torch.Tensor] = None
    d: Optional[torch.Tensor] = None
    lb: Optional[torch.Tensor] = None  # always a length-n vector when present
    ub: Optional[torch.Tensor] = None

    @property
    def n(self) -> int:
        return self.c.shape[-1]

    @property
    def num_ineq_constraints(self) -> int:
        """Inequality count used for the duality gap m/t."""
        return _num_ineq(self)


@dataclasses.dataclass(frozen=True)
class QPProblem:
    """min ½xᵀPx + qᵀx  s.t.  Ax = b, Cx ≤ d, lb ≤ x ≤ ub."""

    P: torch.Tensor
    q: Optional[torch.Tensor] = None
    A: Optional[torch.Tensor] = None
    b: Optional[torch.Tensor] = None
    C: Optional[torch.Tensor] = None
    d: Optional[torch.Tensor] = None
    lb: Optional[torch.Tensor] = None
    ub: Optional[torch.Tensor] = None

    @property
    def n(self) -> int:
        return self.P.shape[-1]

    @property
    def num_ineq_constraints(self) -> int:
        return _num_ineq(self)


def _num_ineq(prob) -> int:
    m = 0
    if prob.d is not None:
        m += prob.d.shape[-1]
    if prob.lb is not None:
        m += prob.n
    if prob.ub is not None:
        m += prob.n
    return m


def _tensor(v, dtype, device):
    if v is None:
        return None
    if isinstance(v, torch.Tensor):
        return v.to(dtype=dtype, device=device)
    return torch.as_tensor(np.asarray(v), dtype=dtype, device=device)


def _as_bound_vector(bound, n, dtype, device):
    """Broadcast scalar bounds to length-n vectors."""
    if bound is None:
        return None
    arr = _tensor(bound, dtype, device)
    if arr.ndim == 0:
        arr = torch.full((n,), float(arr), dtype=dtype, device=device)
    return arr


def make_lp(c, A=None, b=None, C=None, d=None, lb=None, ub=None, *,
            dtype=torch.float64, device="cpu") -> LPProblem:
    cvt = lambda v: _tensor(v, dtype, device)  # noqa: E731
    c = cvt(c)
    n = c.shape[-1]
    return LPProblem(c=c, A=cvt(A), b=cvt(b), C=cvt(C), d=cvt(d),
                     lb=_as_bound_vector(lb, n, dtype, device),
                     ub=_as_bound_vector(ub, n, dtype, device))


def make_qp(P, q=None, A=None, b=None, C=None, d=None, lb=None, ub=None, *,
            dtype=torch.float64, device="cpu") -> QPProblem:
    cvt = lambda v: _tensor(v, dtype, device)  # noqa: E731
    P = cvt(P)
    n = P.shape[-1]
    return QPProblem(P=P, q=cvt(q), A=cvt(A), b=cvt(b), C=cvt(C), d=cvt(d),
                     lb=_as_bound_vector(lb, n, dtype, device),
                     ub=_as_bound_vector(ub, n, dtype, device))
