"""LP, QP, SOCP and LASSO problem data as frozen dataclasses of tensors
(counterpart of interiorpoint_tpu/models/problem.py).

Every tensor of a problem lives on one device, chosen by the caller of
``make_lp``/``make_qp``/``make_socp``/``make_lasso``.  A field is None when its block is
absent.
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


@dataclasses.dataclass(frozen=True)
class SOCPProblem:
    """min ½xᵀPx + qᵀx  s.t.  ‖A_k x + b_k‖ ≤ c_kᵀx + d_k (k < K), Fx = g,
    lb ≤ x ≤ ub.  The K cones are stacked and zero-padded to the tallest
    one (padded rows add nothing to ‖·‖²):

      A: (K, M, n),  b: (K, M),  c: (K, n),  d: (K,)
    """

    A: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    d: torch.Tensor
    P: Optional[torch.Tensor] = None
    q: Optional[torch.Tensor] = None
    F: Optional[torch.Tensor] = None
    g: Optional[torch.Tensor] = None
    lb: Optional[torch.Tensor] = None
    ub: Optional[torch.Tensor] = None

    @property
    def n(self) -> int:
        return self.A.shape[-1]

    @property
    def num_cones(self) -> int:
        return self.A.shape[-3]

    @property
    def num_ineq_constraints(self) -> int:
        """One per cone, plus n per bound vector."""
        m = self.num_cones
        if self.lb is not None:
            m += self.n
        if self.ub is not None:
            m += self.n
        return m


@dataclasses.dataclass(frozen=True)
class LassoProblem:
    """min 1/(2m)‖Ax − b‖² + λ‖x‖₁, batched over the columns of b and the
    entries of reg:

      A: (m, n),  b: (m, B),  reg: (B,) or (1,)
    """

    A: torch.Tensor
    b: torch.Tensor
    reg: torch.Tensor

    @property
    def n(self) -> int:
        return self.A.shape[-1]

    @property
    def m(self) -> int:
        return self.A.shape[-2]

    @property
    def num_samples(self) -> int:
        return max(self.b.shape[-1], self.reg.shape[-1])


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


def _as_list(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


def make_socp(A, b=None, c=None, d=None, P=None, q=None, F=None, g=None,
              lb=None, ub=None, *, dtype=torch.float64,
              device="cpu") -> SOCPProblem:
    """Pack list-of-cones input into the stacked, zero-padded tensors of
    ``SOCPProblem``: ``A`` a list of (mᵢ, n) matrices (a 1-D array is read
    as a diagonal), ``b`` a list of (mᵢ,) vectors, ``c`` of (n,) vectors,
    ``d`` of scalars; a single ``b`` or ``d`` is broadcast to every cone."""
    A_mats = [np.diag(Ai) if Ai.ndim == 1 else Ai
              for Ai in (np.asarray(v) for v in _as_list(A))]
    K = len(A_mats)
    n = A_mats[0].shape[1]
    M = max(Ai.shape[0] for Ai in A_mats)

    A_pad = np.zeros((K, M, n))
    for i, Ai in enumerate(A_mats):
        A_pad[i, :Ai.shape[0], :] = Ai
    b_pad = np.zeros((K, M))
    if b is not None:
        b = _as_list(b)
        if len(b) == 1:
            b = b * K
        for i, bi in enumerate(b):
            bi = np.asarray(bi)
            b_pad[i, :bi.shape[0]] = bi
    c_pad = np.zeros((K, n))
    if c is not None:
        for i, ci in enumerate(_as_list(c)):
            c_pad[i] = np.asarray(ci)
    d_pad = np.zeros((K,))
    if d is not None:
        d = _as_list(d)
        if len(d) == 1:
            d = d * K
        for i, di in enumerate(d):
            d_pad[i] = float(di)

    cvt = lambda v: _tensor(v, dtype, device)  # noqa: E731
    return SOCPProblem(A=cvt(A_pad), b=cvt(b_pad), c=cvt(c_pad),
                       d=cvt(d_pad), P=cvt(P), q=cvt(q), F=cvt(F), g=cvt(g),
                       lb=_as_bound_vector(lb, n, dtype, device),
                       ub=_as_bound_vector(ub, n, dtype, device))


def make_lasso(A, b, reg=1.0, *, dtype=torch.float64,
               device="cpu") -> LassoProblem:
    """A LassoProblem; a vector b becomes one column, a scalar reg one
    entry."""
    A = _tensor(A, dtype, device)
    b = _tensor(b, dtype, device)
    if b.ndim < 2:
        b = b[:, None]
    reg = torch.atleast_1d(_tensor(reg, dtype, device))
    return LassoProblem(A=A, b=b, reg=reg)
