"""Carry state from the JAX package to the port.

Takes the JAX package's objects (anything whose fields ``numpy.asarray``
accepts; this module imports no JAX) and rebuilds the port's counterparts
on a device: the caller's ``device``, else ``models.base.default_device()``
(the GPU; it raises when there is none, so a CPU caller passes
``device="cpu"``):

* ``problem_from_jax``: an LPProblem/QPProblem/SOCPProblem;
* ``basis_from_jax`` / ``reduced_from_jax``: an AffineBasis (N, x_p, AAᵀ)
  and a ReducedForm (LP, QP or SOCP);
* ``pd_state_to_torch``: a primal-dual state (z, s, λ);
* ``newton_consts_from_jax``: the barrier step's constants (NTConsts)
  from the JAX package's ``ReducedConsts``: the double-float words of C
  and d joined back to fp64, the padding dropped;
* ``socp_consts_from_jax``: the SOCP step's constants (SOCPConsts) from
  the JAX package's ``SOCPConsts`` in the same way;
* ``kkt_consts_from_jax``: the dense-KKT direction's constants
  (KKTConsts) from the JAX package's ``KKTConsts`` (Fhi+Flo joined to
  fp64, the padding dropped);
* ``ipm_result_from_jax`` / ``phase1_result_from_jax``: the barrier
  engine's results (IPMResult, Phase1Result);
* ``socp_pd_result_from_jax``: the conic Mehrotra engine's result
  (SOCPPDResult);
* ``admm_prepared_from_jax``: the LASSO ADMM's ladder of Q⁻¹
  (``admm_prepare``), in the type it has.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.base import default_device
from ..models.problem import LPProblem, QPProblem, SOCPProblem
from ..models.reduced import ReducedForm
from ..ops.ipm import IPMResult, Phase1Result
from ..ops.kkt_step import KKTConsts, prep_kkt_consts
from ..ops.newton_step import NTConsts, prep_newton_consts
from ..ops.nullspace import AffineBasis
from ..ops.socp_pd import SOCPPDResult
from ..ops.socp_step import SOCPConsts


def _t(v, device, dtype=torch.float64):
    """``v`` as a tensor on ``device`` (None: ``default_device()``)."""
    if v is None:
        return None
    return torch.as_tensor(np.array(v, dtype=np.float64), dtype=dtype,
                           device=default_device() if device is None
                           else device)


def problem_from_jax(prob, device=None, dtype=torch.float64):
    """SOCPProblem (told apart by its ``F`` field), QPProblem (by a ``P``
    field) or LPProblem."""
    if hasattr(prob, "F"):
        return SOCPProblem(**{f: _t(getattr(prob, f), device, dtype)
                              for f in ("A", "b", "c", "d", "P", "q", "F",
                                        "g", "lb", "ub")})
    fields = {f: _t(getattr(prob, f, None), device, dtype)
              for f in ("A", "b", "C", "d", "lb", "ub")}
    if getattr(prob, "P", None) is not None:
        return QPProblem(P=_t(prob.P, device, dtype),
                         q=_t(prob.q, device, dtype), **fields)
    return LPProblem(c=_t(prob.c, device, dtype), **fields)


def basis_from_jax(basis, device=None, dtype=torch.float64) -> AffineBasis:
    return AffineBasis(N=_t(basis.N, device, dtype),
                       x_p=_t(basis.x_p, device, dtype),
                       AAt=_t(basis.AAt, device, dtype))


def reduced_from_jax(rf, device=None, dtype=torch.float64) -> ReducedForm:
    return ReducedForm(prob=problem_from_jax(rf.prob, device, dtype),
                       basis=basis_from_jax(rf.basis, device, dtype),
                       obj_offset=_t(rf.obj_offset, device, dtype))


def pd_state_to_torch(z, s, lam, device=None, dtype=torch.float64):
    """(z, s, λ) as contiguous tensors on ``device``."""
    return tuple(_t(v, device, dtype).contiguous() for v in (z, s, lam))


def _join(hi, lo):
    """fp64 value of a double-float32 pair."""
    return (np.asarray(hi, dtype=np.float32).astype(np.float64)
            + np.asarray(lo, dtype=np.float32).astype(np.float64))


def newton_consts_from_jax(consts, device=None) -> NTConsts:
    """NTConsts from a JAX ``ReducedConsts`` (Chi+Clo, dhi+dlo)."""
    k, r = int(consts.k), int(consts.r)
    C = _join(consts.Chi, consts.Clo)[:k, :r]
    d = _join(consts.dhi, consts.dlo)[:k, 0]
    return prep_newton_consts(_t(C, device), _t(d, device))


def socp_consts_from_jax(consts, device=None) -> SOCPConsts:
    """SOCPConsts from a JAX ``SOCPConsts``: Ahi+Alo, bhi+blo, chi+clo and
    dhi+dlo joined to fp64, the padding dropped (K·M rows, r columns, K
    cones)."""
    K, M, r = int(consts.K), int(consts.M), int(consts.r)
    A = _t(_join(consts.Ahi, consts.Alo)[:K * M, :r], device).contiguous()
    return SOCPConsts(
        A=A, A32=A.to(torch.float32),
        b=_t(_join(consts.bhi, consts.blo)[:K * M, 0], device).contiguous(),
        c=_t(_join(consts.chi, consts.clo)[:K, :r], device).contiguous(),
        d=_t(_join(consts.dhi, consts.dlo)[:K, 0], device).contiguous(), M=M)


def kkt_consts_from_jax(consts, device=None) -> KKTConsts:
    """KKTConsts from a JAX ``KKTConsts``: Fhi+Flo joined to fp64, the
    padding dropped (pe rows, r columns; no block when pe = 0)."""
    pe, r = int(consts.pe), int(consts.r)
    if pe == 0:
        return prep_kkt_consts(None, r)
    return prep_kkt_consts(
        _t(_join(consts.Fhi, consts.Flo)[:pe, :r], device), r)


def socp_pd_result_from_jax(res, device=None,
                            dtype=torch.float64) -> SOCPPDResult:
    """SOCPPDResult with tensors on ``device`` and host scalars."""
    return SOCPPDResult(
        **{f: _t(getattr(res, f), device, dtype)
           for f in ("x", "y", "z", "s", "lam_ub", "lam_lb")},
        iters=int(res.iters), converged=bool(res.converged),
        gap=float(res.gap), rp_norm=float(res.rp_norm),
        rd_norm=float(res.rd_norm))


def phase1_result_from_jax(p1, device=None, dtype=torch.float64):
    if p1 is None:
        return None
    return Phase1Result(x=_t(p1.x, device, dtype), s=float(p1.s),
                        outer_iters=int(p1.outer_iters),
                        newton_iters=int(p1.newton_iters))


def ipm_result_from_jax(res, device=None, dtype=torch.float64) -> IPMResult:
    """IPMResult with tensors on ``device`` and host scalars."""
    bt = getattr(res, "bt_hist", None)
    return IPMResult(
        x=_t(res.x, device, dtype),
        v=None if res.v is None else _t(res.v, device, dtype),
        value=float(res.value), dual_gap=float(res.dual_gap),
        t=float(res.t), outer_iters=int(res.outer_iters),
        inner_iters=np.asarray(res.inner_iters, dtype=np.int64),
        obj_vals=np.asarray(res.obj_vals, dtype=np.float64),
        phase1=phase1_result_from_jax(res.phase1, device, dtype),
        bt_hist=None if bt is None else np.asarray(bt, dtype=np.int64))


def admm_prepared_from_jax(prepared, device=None):
    """The JAX package's ``admm_prepare`` ladder (a tuple of Q⁻¹) as the
    port's, each Q⁻¹ in its own type (fp64 or fp32)."""
    dev = default_device() if device is None else device
    return tuple(torch.as_tensor(np.array(q), device=dev) for q in prepared)
