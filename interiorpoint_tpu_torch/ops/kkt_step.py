"""One dense-KKT direction (K5):

    [ H   Fᵀ ] [dx]   [ r1  ]
    [ F   0  ] [dy] = [ −rpe ]

for an assembled symmetric positive definite H (r, r) and an equality
block F (pe, r), pe ≥ 0.

Counterpart of interiorpoint_tpu/ops/pallas_kkt.py (``kkt_dir_prepared``,
the TPU kernel ``_kkt_dir_kernel``, pallas_call at :348, and its
``_sfactor_jittered``).  The callers are the conic Mehrotra engine
(ops/socp_pd.py) and the equality path of ops/pd.py ``pd_solve``.

The pipeline is the TPU kernel's, with its precision redesigned for the
card.  The TPU has no fp64, so its kernel carries double-float32 pairs
and factors in fp32; near an LP vertex the equilibrated H reaches κ 1e12,
where an fp32 factor does not contract the refinement at all.  Here the
factors are fp64 (the DMMA tensor-core path of csrc/chol.cu and
csrc/kkt.cu), and they are built once per Newton matrix:

* ``kkt_prepare(H, consts) -> KKTFactors``: H's Jacobi equilibration
  (csrc/gram.cu), its jittered blocked fp64 Cholesky (ladder
  0/1e-6/3e-3/1) and W = L⁻¹ (csrc/chol.cu); for pe > 0 the Schur
  preconditioner S = YᵀY with Y = W·diag(D)·Fᵀ (csrc/kkt.cu
  ``ip_kkt_schur64`` and ``ip_kkt_gram64``), equilibrated by its diagonal
  (identity on the padding: the blocked factor runs at any pe, where the
  TPU held S̃ as one 128-wide tile), factored with the same ladder (the
  counterpart of ``_sfactor_jittered``) and inverted.
* ``kkt_dir_prepared(factors, r1, rpe)``: the refined H-solve
  (ops/refine.py ``refined_solve``) against the fp64 H applied by
  ``ip_c_matvec`` (csrc/rows.cu), preconditioned by the fp64 W-solve,
  exiting at the refinement floor (``exit_rel2=1e-25``, as the TPU kernel
  passes it: the Schur-CG's operator goes through these solves), with the
  PCG escalation above ``dir_tol``; for pe > 0 the Schur-CG for dy on the
  Ds-equilibrated system Ŝ ŷ = Ds·F·H⁻¹·Fᵀ·Ds·ŷ = Ds·(F t1 + rpe),
  t1 = H⁻¹r1, every operator application through a refined H-solve and
  F, Fᵀ in fp64 (``ip_c_matvec``/``ip_ct_matvec`` on F), at most
  ``rounds`` rounds, exit at ‖r‖² ≤ cg_tol²·‖û‖²; dy = Ds·ŷ; then the
  back-substitution dx = H⁻¹(r1 − Fᵀdy) and the KKT residual norms
  rn2 = ‖r1 − H dx − Fᵀdy‖² + ‖−rpe − F dx‖², bn2 = ‖r1‖² + ‖rpe‖² + 1e-30.
  Without an equality block, (rn2, bn2) are the H-solve's own, in the
  equilibrated metric, as in the TPU kernel.
* ``kkt_dir(H, consts, r1, rpe)``: prepare, then one direction.

The TPU's layout tricks (``_col_to_row``, ``_broadcast_col``) exist for
its matrix unit and have no counterpart.  Every loop decision (jitter
rungs, refinement and PCG exits, CG rounds) is one host read
(ops/sync.py).  ``COUNTS`` tallies factorizations (``kkt_prepare``
calls), directions, Schur-CG rounds and refined H-solves, for both
versions alike.

``kkt_prepare`` picks the CUDA kernels for CUDA tensors and the plain
PyTorch pieces (``kkt_prepare_plain``, the same orchestration) for CPU
tensors, and raises on any other device; the direction runs on the
backend its factors were built with.

The callers do not hand K5 their Newton matrix as the JAX package does:
``augment`` forms the exact augmented-Lagrangian system H + ρFᵀF once per
matrix, ``kkt_prepare`` factors it, and ``kkt_solve`` runs the
predictor's and the corrector's directions on those factors, calling the
direction again on the fp64 residual while it stalls (the port's repair
of the reference, ROADMAP.md §3).
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Optional

import torch

from . import pd_step, sync
from .pd_step import _empty, _ws
from .refine import factor_inverse, refined_solve
from ..kernels import _build

# the H-solves exit at the refinement floor (pallas_kkt.py:149-151)
H_EXIT_REL2 = 1e-25
# kkt_solve's refinement: at most 2 more directions while
# rn2 > 1e-18·bn2 (the bound tests/test_pallas_kkt.py:46 holds the TPU
# kernel to); a stricter gate refines far more often and converges in no
# fewer iterations (ROADMAP.md §3)
KKT_REFINE = 2
KKT_REFINE_REL2 = 1e-18

# factorizations, directions, Schur-CG rounds and refined H-solves, of
# both versions
COUNTS: Counter = Counter()


@dataclasses.dataclass(frozen=True)
class KKTConsts:
    """Per-solve constants: the equality block F (pe, r) in fp64 and FᵀF
    (fp64) for ``augment`` (None when pe = 0), and r."""
    F: Optional[torch.Tensor]
    FtF: Optional[torch.Tensor]
    r: int

    @property
    def pe(self) -> int:
        return 0 if self.F is None else self.F.shape[0]


def prep_kkt_consts(F, n: int) -> KKTConsts:
    """The constants once per solve (``F is None``: no equality block)."""
    if F is None or F.shape[0] == 0:
        return KKTConsts(F=None, FtF=None, r=n)
    if F.shape[1] != n:
        raise ValueError(f"prep_kkt_consts: F has {F.shape[1]} columns, "
                         f"expected {n}")
    F = F.contiguous()
    return KKTConsts(F=F, FtF=F.T @ F, r=n)


@dataclasses.dataclass(frozen=True)
class KKTFactors:
    """The fp64 factors of one Newton matrix (``kkt_prepare``): the
    backend ``ops`` they were built with, the matrix H, the inverse W of
    its equilibrated jittered factor and the equilibration dsc (padded),
    and for pe > 0 the same for S (Ws, ds)."""
    ops: type
    cs: KKTConsts
    H: torch.Tensor
    W: torch.Tensor
    dsc: torch.Tensor
    Ws: Optional[torch.Tensor]
    ds: Optional[torch.Tensor]


def augment(H, cs: KKTConsts):
    """The augmented-Lagrangian form of the system, once per Newton
    matrix: since F dx = −rpe,

        [ H + ρFᵀF   Fᵀ ] [dx]   [ r1 − ρFᵀrpe ]
        [ F          0  ] [dy] = [ −rpe        ]

    has the same solution for any ρ ≥ 0.  Returns (H + ρFᵀF, ρ) with
    ρ = r / Σⱼ (FᵀF)ⱼⱼ/Hⱼⱼ: in H's Jacobi-equilibrated metric D(·)D the
    shift ρ·DFᵀFD then has the trace r of the equilibrated H.  Without an
    equality block, H itself and 0.  ``kkt_solve`` shifts r1."""
    if cs.pe == 0:
        return H.contiguous(), 0.0
    dH = torch.diagonal(H)
    rho = dH.shape[0] / (torch.diagonal(cs.FtF) / dH).sum()
    return (H + rho * cs.FtF).contiguous(), rho


def kkt_solve(factors: KKTFactors, rho, r1, rpe=None, **kw):
    """One direction of the callers' KKT system on the factors of the
    augmented matrix (``augment``, then ``kkt_prepare``):
    ``kkt_dir_prepared`` on (r1 − ρFᵀrpe, rpe), then up to ``KKT_REFINE``
    rounds of refinement, each one more direction on the fp64 residual
    with the same factors, while the relative residual
    ‖(e1, e2)‖²/‖(r1 − ρFᵀrpe, rpe)‖² exceeds ``KKT_REFINE_REL2``.  ``kw``
    are ``kkt_dir_prepared``'s tolerances.  Returns (dx, dy, rn2, bn2),
    the norms unscaled.

    The augmented form and the refinement are the port's repair of the
    reference's elimination (the JAX package hands K5 H itself, once per
    direction): near an LP vertex H = Cᵀdiag(λ/s)C is nearly singular on
    the directions only the equalities fix (κ of the equilibrated H 9e11
    on tests/test_pallas_kkt.py:131's LP at its 13th iteration); the
    reference's engine then stalls (ROADMAP.md §3).  The TPU kernel
    returns (rn2, bn2) so that its caller can see such a stall; here the
    caller acts on it."""
    cs, Ha = factors.cs, factors.H
    F = cs.F
    if cs.pe:
        r1 = (r1 - rho * (F.T @ rpe)).contiguous()
    dx, dy, _, _ = kkt_dir_prepared(factors, r1, rpe, **kw)

    def residual(dx, dy):
        e1 = r1 - Ha @ dx
        if not cs.pe:
            return e1, None, e1 @ e1
        e1 = e1 - F.T @ dy
        e2 = -rpe - F @ dx
        return e1, e2, e1 @ e1 + e2 @ e2

    bn2 = r1 @ r1 + (rpe @ rpe if cs.pe else 0.0) + 1e-30
    e1, e2, rn2 = residual(dx, dy)
    for _ in range(KKT_REFINE):
        if not sync.read(rn2 > KKT_REFINE_REL2 * bn2):
            break
        cx, cy, _, _ = kkt_dir_prepared(
            factors, e1.contiguous(),
            None if e2 is None else (-e2).contiguous(), **kw)
        dx, dy = dx + cx, dy + cy
        e1, e2, rn2 = residual(dx, dy)
    return dx, dy, rn2, bn2


# ---------------------------------------------------------------------------
# The two backends: K1's pieces (ops/pd_step.py, here in fp64) plus the
# Schur build.
# ---------------------------------------------------------------------------

class _Cuda(pd_step._Cuda):
    @staticmethod
    def kkt_schur(W, dsc, F):
        pe, r = F.shape
        Y = _empty((r, pe), F)
        _build.launch("ip_kkt_schur64", W, W.shape[1], dsc, F, Y, r, pe)
        return Y

    @staticmethod
    def schur_gram(Y):
        r, pe = Y.shape
        S = _empty((pe, pe), Y)
        _build.launch("ip_kkt_gram64", Y,
                      _ws("ip_kkt_gram64_ws_bytes", r, pe, Y), S, r, pe)
        return S


class _Plain(pd_step._Plain):
    @staticmethod
    def kkt_schur(W, dsc, F):
        r = F.shape[1]
        return torch.tril(W[:r, :r]) @ (dsc[:r, None] * F.T)

    @staticmethod
    def schur_gram(Y):
        return Y.T @ Y


# ---------------------------------------------------------------------------
# Orchestration shared by both backends
# ---------------------------------------------------------------------------

def schur_preconditioner(ops, W, dsc, F):
    """S = YᵀY, Y = W·diag(dsc)·Fᵀ, equilibrated and factored in fp64.
    Returns (Ws, ds): S⁻¹ ≈ ds·WsᵀWs·ds."""
    S = ops.schur_gram(ops.kkt_schur(W, dsc, F))
    return factor_inverse(ops, S, torch.float64)


def _prepare(ops, H, cs: KKTConsts) -> KKTFactors:
    COUNTS["factorizations"] += 1
    W, dsc = factor_inverse(ops, H, torch.float64)
    Ws = ds = None
    if cs.pe:
        Ws, ds = schur_preconditioner(ops, W, dsc, cs.F)
    return KKTFactors(ops=ops, cs=cs, H=H, W=W, dsc=dsc, Ws=Ws, ds=ds)


def h_solver(factors: KKTFactors, refine: int, stall_rel2: float):
    """The refined H-solve at the floor exit on the prepared factors,
    ``solve(b) -> (x, rn2, bn2)``."""
    ops, H, W = factors.ops, factors.H, factors.W
    dsc = factors.dsc[:H.shape[0]]

    def precond(v):
        return ops.w_solve(W, v)

    def apply_h(x):
        return ops.c_matvec(H, x)

    def solve(b):
        COUNTS["h_solves"] += 1
        return refined_solve(precond, apply_h, dsc, b, refine, stall_rel2,
                             exit_rel2=H_EXIT_REL2)

    return solve


def _kkt_dir(fac: KKTFactors, r1, rpe, refine: int, rounds: int,
             stall_rel2: float, cg_rel2: float):
    COUNTS["directions"] += 1
    ops, cs, H = fac.ops, fac.cs, fac.H
    solve = h_solver(fac, refine, stall_rel2)
    pe = cs.pe
    if pe == 0:
        dx, rn2, bn2 = solve(r1)
        return dx, r1.new_zeros(0), rn2, bn2

    F = cs.F
    ds = fac.ds[:pe]

    def precond_pe(v):
        return ops.w_solve(fac.Ws, v)

    def shat(y):
        """Ŝ y = Ds·F·H⁻¹·Fᵀ·Ds·y through the refined H-solve."""
        return ds * ops.c_matvec(F, solve(ops.ct_matvec(F, ds * y))[0])

    # Schur-CG on Ŝ ŷ = û, û = Ds (F H⁻¹ r1 + rpe)
    t1 = solve(r1)[0]
    ue = ds * (ops.c_matvec(F, t1) + rpe)
    un2 = (ue * ue).sum() + 1e-30
    y = torch.zeros_like(ue)
    res = ue
    p = precond_pe(ue)
    rz = ue @ p
    i = 0
    while i < rounds:
        rn2c = res @ res
        if not sync.read((rn2c > cg_rel2 * un2) & torch.isfinite(rn2c)
                         & torch.isfinite(rz)):
            break
        hp = shat(p)
        denom = p @ hp
        a = rz / torch.where(denom.abs() > 1e-30, denom, 1e-30)
        y = y + a * p
        res = res - a * hp
        z = precond_pe(res)
        rz2 = res @ z
        beta = rz2 / torch.where(rz.abs() > 1e-30, rz, 1e-30)
        p = z + beta * p
        rz = rz2
        i += 1
    COUNTS["cg_rounds"] += i
    dy = ds * y

    # back-substitution and the KKT residual norms
    fty = ops.ct_matvec(F, dy)
    dx = solve(r1 - fty)[0]
    e1 = r1 - ops.c_matvec(H, dx) - fty
    e2 = -rpe - ops.c_matvec(F, dx)
    rn2 = e1 @ e1 + e2 @ e2
    bn2 = r1 @ r1 + rpe @ rpe + 1e-30
    return dx, dy, rn2, bn2


def _check_matrix(H, cs: KKTConsts):
    r, pe = cs.r, cs.pe
    want = [("H", H, (r, r))] + ([("F", cs.F, (pe, r))] if pe else [])
    for name, t, shape in want:
        if t.dtype != torch.float64 or tuple(t.shape) != shape or \
                not t.is_contiguous() or t.device != H.device:
            raise ValueError(f"kkt_dir: {name} must be a contiguous "
                             f"torch.float64 {shape} tensor on {H.device}")
    kind = H.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"kkt_dir: unsupported device {H.device}")
    return kind


def _check_rhs(H, cs: KKTConsts, r1, rpe):
    want = [("r1", r1, (cs.r,))]
    if cs.pe:
        if rpe is None:
            raise ValueError("kkt_dir: rpe is required with an equality "
                             "block")
        want.append(("rpe", rpe, (cs.pe,)))
    for name, t, shape in want:
        if t.dtype != torch.float64 or tuple(t.shape) != shape or \
                not t.is_contiguous() or t.device != H.device:
            raise ValueError(f"kkt_dir: {name} must be a contiguous "
                             f"torch.float64 {shape} tensor on {H.device}")


def kkt_prepare(H, consts: KKTConsts) -> KKTFactors:
    """The fp64 factors of the Newton matrix ``H`` (r, r), symmetric
    positive definite, with ``consts`` from ``prep_kkt_consts``: once per
    matrix, for every direction on it.  CUDA tensors launch the kernels;
    CPU tensors take ``kkt_prepare_plain``."""
    if _check_matrix(H, consts) == "cpu":
        return kkt_prepare_plain(H, consts)
    return _prepare(_Cuda, H, consts)


def kkt_prepare_plain(H, consts: KKTConsts) -> KKTFactors:
    """Plain PyTorch version of ``kkt_prepare`` (same orchestration)."""
    _check_matrix(H, consts)
    return _prepare(_Plain, H, consts)


def kkt_dir_prepared(factors: KKTFactors, r1, rpe=None, *, refine: int = 3,
                     rounds: int = 24, dir_tol: float = 1e-6,
                     cg_tol: float = 1e-13):
    """One dense-KKT direction on prepared factors.

    ``r1`` (r,) and ``rpe`` (pe,) fp64, in the convention F dx = −rpe.
    ``refine``: refinement rounds per H-solve; ``rounds``: the
    Schur-CG's cap; ``dir_tol``: the L2-relative H-solve residual above
    which the PCG escalation fires; ``cg_tol``: the Schur-CG's
    L2-relative exit.  Returns (dx, dy, rn2, bn2).  Runs on the backend
    of ``factors``; counts one launch of ``kkt_dir`` (CUDA) or one call of
    ``kkt_dir_plain``."""
    _check_rhs(factors.H, factors.cs, r1, rpe)
    out = _kkt_dir(factors, r1, rpe, refine, rounds, float(dir_tol) ** 2,
                   float(cg_tol) ** 2)
    if factors.ops is _Cuda:
        kkt_dir.launches += 1
    else:
        kkt_dir_plain.calls += 1
    return out


def kkt_dir(H, consts: KKTConsts, r1, rpe=None, *, refine: int = 3,
            rounds: int = 24, dir_tol: float = 1e-6, cg_tol: float = 1e-13):
    """One dense-KKT direction: ``kkt_prepare`` then
    ``kkt_dir_prepared`` (see there).  ``H`` (r, r) fp64, symmetric
    positive definite; ``consts`` from ``prep_kkt_consts``.  Returns
    (dx, dy, rn2, bn2)."""
    if _check_matrix(H, consts) == "cpu":
        return kkt_dir_plain(H, consts, r1, rpe, refine=refine,
                             rounds=rounds, dir_tol=dir_tol, cg_tol=cg_tol)
    _check_rhs(H, consts, r1, rpe)
    return kkt_dir_prepared(_prepare(_Cuda, H, consts), r1, rpe,
                            refine=refine, rounds=rounds, dir_tol=dir_tol,
                            cg_tol=cg_tol)


def kkt_dir_plain(H, consts: KKTConsts, r1, rpe=None, *, refine: int = 3,
                  rounds: int = 24, dir_tol: float = 1e-6,
                  cg_tol: float = 1e-13):
    """Plain PyTorch version of ``kkt_dir`` (same control flow)."""
    _check_matrix(H, consts)
    _check_rhs(H, consts, r1, rpe)
    return kkt_dir_prepared(_prepare(_Plain, H, consts), r1, rpe,
                            refine=refine, rounds=rounds, dir_tol=dir_tol,
                            cg_tol=cg_tol)


kkt_dir.launches = 0
kkt_dir_plain.calls = 0
