"""One dense-KKT direction (K5):

    [ H   Fᵀ ] [dx]   [ r1  ]
    [ F   0  ] [dy] = [ −rpe ]

for an assembled symmetric positive definite H (r, r) and an equality
block F (pe, r), pe ≥ 0.

Counterpart of interiorpoint_tpu/ops/pallas_kkt.py (``kkt_dir_prepared``,
the TPU kernel ``_kkt_dir_kernel``, pallas_call at :348, and its
``_sfactor_jittered``).  The callers are the conic Mehrotra engine
(ops/socp_pd.py) and the equality path of ops/pd.py ``pd_solve``.

The pipeline is the TPU kernel's, in fp64 where it used double-float32
pairs (ops/pd_step.py gives the reason), with fp32 only in the two
preconditioners:

* H32 = fp32(H), its Jacobi equilibration, the jittered blocked Cholesky
  (ladder 0/1e-6/3e-3/1) and W = L⁻¹ (K1's pieces: csrc/gram.cu,
  csrc/chol.cu);
* the refined H-solve (ops/refine.py ``refined_solve``) against the fp64
  H applied by ``ip_c_matvec`` (csrc/rows.cu), preconditioned by the
  W-solve, exiting at the refinement floor (``exit_rel2=1e-25``, as the
  TPU kernel passes it: the Schur-CG's operator goes through these
  solves), with the PCG escalation above ``dir_tol``;
* for pe > 0, the Schur preconditioner S̃ = YᵀY with Y = W·diag(D)·Fᵀ
  (csrc/kkt.cu ``ip_kkt_schur``, then K1's Gram on Y with unit weights),
  equilibrated by its diagonal (identity on the padding: the blocked
  factor runs at any pe, where the TPU held S̃ as one 128-wide tile),
  factored with the same jitter ladder and inverted; its application is
  a W-solve on the S̃ factor;
* the Schur-CG for dy on the Ds-equilibrated system
  Ŝ ŷ = Ds·F·H⁻¹·Fᵀ·Ds·ŷ = Ds·(F t1 + rpe), t1 = H⁻¹r1, every operator
  application through a refined H-solve and F, Fᵀ in fp64
  (``ip_c_matvec``/``ip_ct_matvec`` on F), at most ``rounds`` rounds,
  exit at ‖r‖² ≤ cg_tol²·‖û‖²; dy = Ds·ŷ;
* the back-substitution dx = H⁻¹(r1 − Fᵀdy) and the KKT residual norms
  rn2 = ‖r1 − H dx − Fᵀdy‖² + ‖−rpe − F dx‖², bn2 = ‖r1‖² + ‖rpe‖² + 1e-30.
  Without an equality block, (rn2, bn2) are the H-solve's own, in the
  equilibrated metric, as in the TPU kernel.

The TPU's layout tricks (``_col_to_row``, ``_broadcast_col``) exist for
its matrix unit and have no counterpart.  Every loop decision (jitter
rungs, refinement and PCG exits, CG rounds) is one host read
(ops/sync.py).  ``COUNTS`` tallies directions, Schur-CG rounds and
refined H-solves, for both versions alike.

``kkt_dir`` launches the CUDA kernels for CUDA tensors, calls
``kkt_dir_plain`` (the same orchestration over plain PyTorch pieces) for
CPU tensors, and raises on any other device.

The callers do not hand K5 their Newton matrix as the JAX package does:
``augment`` forms the exact augmented-Lagrangian system H + ρFᵀF once per
matrix, and ``kkt_solve`` runs one direction on it, calling K5 again on
the fp64 residual while the direction stalls (the port's repair of the
reference, ROADMAP.md §3).
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Optional

import torch

from . import pd_step, sync
from .pd_step import _empty
from .refine import factor_inverse, refined_solve
from ..kernels import _build

# the H-solves exit at the refinement floor (pallas_kkt.py:149-151)
H_EXIT_REL2 = 1e-25
# kkt_solve's refinement: at most 2 more K5 calls per direction while
# rn2 > 1e-18·bn2 (the bound tests/test_pallas_kkt.py:46 holds the TPU
# kernel to); a stricter gate refines far more often and converges in no
# fewer iterations (ROADMAP.md §3)
KKT_REFINE = 2
KKT_REFINE_REL2 = 1e-18

# directions, Schur-CG rounds and refined H-solves, of both versions
COUNTS: Counter = Counter()


@dataclasses.dataclass(frozen=True)
class KKTConsts:
    """Per-solve constants: the equality block F (pe, r) in fp64, its
    fp32 copy that the Schur build reads and FᵀF (fp64) for ``augment``
    (None when pe = 0), and r."""
    F: Optional[torch.Tensor]
    F32: Optional[torch.Tensor]
    FtF: Optional[torch.Tensor]
    r: int

    @property
    def pe(self) -> int:
        return 0 if self.F is None else self.F.shape[0]


def prep_kkt_consts(F, n: int) -> KKTConsts:
    """The constants once per solve (``F is None``: no equality block)."""
    if F is None or F.shape[0] == 0:
        return KKTConsts(F=None, F32=None, FtF=None, r=n)
    if F.shape[1] != n:
        raise ValueError(f"prep_kkt_consts: F has {F.shape[1]} columns, "
                         f"expected {n}")
    F = F.contiguous()
    return KKTConsts(F=F, F32=F.to(torch.float32), FtF=F.T @ F, r=n)


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


def kkt_solve(Ha, cs: KKTConsts, rho, r1, rpe=None, **kw):
    """One direction of the callers' KKT system through K5, on the
    augmented matrix ``Ha`` of ``augment``: ``kkt_dir`` on
    (r1 − ρFᵀrpe, rpe), then up to ``KKT_REFINE`` rounds of refinement,
    each one more ``kkt_dir`` on the fp64 residual, while the relative
    residual ‖(e1, e2)‖²/‖(r1 − ρFᵀrpe, rpe)‖² exceeds
    ``KKT_REFINE_REL2``.  ``kw`` are ``kkt_dir``'s tolerances.  Returns
    (dx, dy, rn2, bn2), the norms unscaled.

    The augmented form and the refinement are the port's repair of the
    reference's elimination (the JAX package hands K5 H itself, once per
    direction): near an LP vertex H = Cᵀdiag(λ/s)C is nearly singular on
    the directions only the equalities fix (κ of the equilibrated H 9e11
    on tests/test_pallas_kkt.py:131's LP at its 13th iteration), beyond
    what an fp32 preconditioner and 48 PCG rounds resolve, and on QPs
    the late Schur-CG stops at its round cap a few digits short; the
    reference's engine then stalls (ROADMAP.md §3).  The TPU kernel
    returns (rn2, bn2) so that its caller can see such a stall; here the
    caller acts on it."""
    F = cs.F
    if cs.pe:
        r1 = (r1 - rho * (F.T @ rpe)).contiguous()
    dx, dy, _, _ = kkt_dir(Ha, cs, r1, rpe, **kw)

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
        cx, cy, _, _ = kkt_dir(Ha, cs, e1.contiguous(),
                               None if e2 is None else (-e2).contiguous(),
                               **kw)
        dx, dy = dx + cx, dy + cy
        e1, e2, rn2 = residual(dx, dy)
    return dx, dy, rn2, bn2


# ---------------------------------------------------------------------------
# The two backends: K1's pieces (ops/pd_step.py) plus the Schur build.
# ---------------------------------------------------------------------------

class _Cuda(pd_step._Cuda):
    @staticmethod
    def kkt_schur(W, dsc, F32):
        pe, r = F32.shape
        Y = _empty((r, pe), F32, torch.float32)
        _build.launch("ip_kkt_schur", W, W.shape[1], dsc, F32, Y, r, pe)
        return Y


class _Plain(pd_step._Plain):
    @staticmethod
    def kkt_schur(W, dsc, F32):
        r = F32.shape[1]
        return torch.tril(W[:r, :r]) @ (dsc[:r, None] * F32.T)


# ---------------------------------------------------------------------------
# Orchestration shared by both backends
# ---------------------------------------------------------------------------

def h_solver(ops, H, refine: int, stall_rel2: float):
    """The H preconditioner and the refined H-solve at the floor exit,
    ``solve(b) -> (x, rn2, bn2)``.  Returns (solve, W, dsc32)."""
    r = H.shape[0]
    f64 = torch.float64
    W, dsc = factor_inverse(ops, H.to(torch.float32))
    dsc64 = dsc[:r].to(f64)

    def precond(v):
        return ops.w_solve(W, v.to(torch.float32)).to(f64)

    def apply_h(x):
        return ops.c_matvec(H, x)

    def solve(b):
        COUNTS["h_solves"] += 1
        return refined_solve(precond, apply_h, dsc64, b, refine, stall_rel2,
                             exit_rel2=H_EXIT_REL2)

    return solve, W, dsc


def schur_preconditioner(ops, W, dsc, F32):
    """S̃ = YᵀY, Y = W·diag(dsc)·Fᵀ, equilibrated and factored.  Returns
    (Ws, ds) with ds fp32 (padded): S̃⁻¹ ≈ ds·WsᵀWs·ds."""
    pe, r = F32.shape
    Y = ops.kkt_schur(W, dsc, F32)
    ones = torch.ones(r, dtype=torch.float64, device=F32.device)
    return factor_inverse(ops, ops.gram(Y, ones, None))


def _kkt_dir(ops, H, cs: KKTConsts, r1, rpe, refine: int, rounds: int,
             stall_rel2: float, cg_rel2: float):
    COUNTS["directions"] += 1
    solve, W, dsc = h_solver(ops, H, refine, stall_rel2)
    pe = cs.pe
    if pe == 0:
        dx, rn2, bn2 = solve(r1)
        return dx, r1.new_zeros(0), rn2, bn2

    f64 = torch.float64
    F = cs.F
    Ws, ds = schur_preconditioner(ops, W, dsc, cs.F32)
    ds = ds[:pe].to(f64)

    def precond_pe(v):
        return ops.w_solve(Ws, v.to(torch.float32)).to(f64)

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


def _check(H, cs: KKTConsts, r1, rpe):
    r, pe = cs.r, cs.pe
    f64, f32 = torch.float64, torch.float32
    want = [("H", H, f64, (r, r)), ("r1", r1, f64, (r,))]
    if pe:
        if rpe is None:
            raise ValueError("kkt_dir: rpe is required with an equality "
                             "block")
        want += [("F", cs.F, f64, (pe, r)), ("F32", cs.F32, f32, (pe, r)),
                 ("rpe", rpe, f64, (pe,))]
    for name, t, dtype, shape in want:
        if t.dtype != dtype or tuple(t.shape) != shape or \
                not t.is_contiguous() or t.device != H.device:
            raise ValueError(f"kkt_dir: {name} must be a contiguous {dtype} "
                             f"{shape} tensor on {H.device}")
    kind = H.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"kkt_dir: unsupported device {H.device}")
    return kind


def kkt_dir(H, consts: KKTConsts, r1, rpe=None, *, refine: int = 3,
            rounds: int = 24, dir_tol: float = 1e-6, cg_tol: float = 1e-13):
    """One dense-KKT direction.

    ``H`` (r, r) fp64, symmetric positive definite; ``consts`` from
    ``prep_kkt_consts``; ``r1`` (r,) and ``rpe`` (pe,) fp64, in the
    convention F dx = −rpe.  ``refine``: refinement rounds per H-solve;
    ``rounds``: the Schur-CG's cap; ``dir_tol``: the L2-relative H-solve
    residual above which the PCG escalation fires; ``cg_tol``: the
    Schur-CG's L2-relative exit.  Returns (dx, dy, rn2, bn2)."""
    if _check(H, consts, r1, rpe) == "cpu":
        return kkt_dir_plain(H, consts, r1, rpe, refine=refine,
                             rounds=rounds, dir_tol=dir_tol, cg_tol=cg_tol)
    out = _kkt_dir(_Cuda, H, consts, r1, rpe, refine, rounds,
                   float(dir_tol) ** 2, float(cg_tol) ** 2)
    kkt_dir.launches += 1
    return out


def kkt_dir_plain(H, consts: KKTConsts, r1, rpe=None, *, refine: int = 3,
                  rounds: int = 24, dir_tol: float = 1e-6,
                  cg_tol: float = 1e-13):
    """Plain PyTorch version of ``kkt_dir`` (same control flow)."""
    _check(H, consts, r1, rpe)
    kkt_dir_plain.calls += 1
    return _kkt_dir(_Plain, H, consts, r1, rpe, refine, rounds,
                    float(dir_tol) ** 2, float(cg_tol) ** 2)


kkt_dir.launches = 0
kkt_dir_plain.calls = 0
