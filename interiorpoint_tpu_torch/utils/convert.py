"""Carry state from the JAX package to the port.

Takes the JAX package's objects (anything whose fields ``numpy.asarray``
accepts; this module imports no JAX) and rebuilds the port's counterparts
on a given device:

* ``problem_from_jax``: an LPProblem/QPProblem;
* ``basis_from_jax`` / ``reduced_from_jax``: an AffineBasis (N, x_p, AAᵀ)
  and a ReducedForm;
* ``pd_state_to_torch``: a primal-dual state (z, s, λ).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.problem import LPProblem, QPProblem
from ..models.reduced import ReducedForm
from ..ops.nullspace import AffineBasis


def _t(v, device, dtype=torch.float64):
    if v is None:
        return None
    return torch.as_tensor(np.array(v, dtype=np.float64), dtype=dtype,
                           device=device)


def problem_from_jax(prob, device="cpu", dtype=torch.float64):
    """LPProblem or QPProblem (told apart by a ``P`` field)."""
    fields = {f: _t(getattr(prob, f, None), device, dtype)
              for f in ("A", "b", "C", "d", "lb", "ub")}
    if getattr(prob, "P", None) is not None:
        return QPProblem(P=_t(prob.P, device, dtype),
                         q=_t(prob.q, device, dtype), **fields)
    return LPProblem(c=_t(prob.c, device, dtype), **fields)


def basis_from_jax(basis, device="cpu", dtype=torch.float64) -> AffineBasis:
    return AffineBasis(N=_t(basis.N, device, dtype),
                       x_p=_t(basis.x_p, device, dtype),
                       AAt=_t(basis.AAt, device, dtype))


def reduced_from_jax(rf, device="cpu", dtype=torch.float64) -> ReducedForm:
    return ReducedForm(prob=problem_from_jax(rf.prob, device, dtype),
                       basis=basis_from_jax(rf.basis, device, dtype),
                       obj_offset=_t(rf.obj_offset, device, dtype))


def pd_state_to_torch(z, s, lam, device="cpu", dtype=torch.float64):
    """(z, s, λ) as contiguous tensors on ``device``."""
    return tuple(_t(v, device, dtype).contiguous() for v in (z, s, lam))
