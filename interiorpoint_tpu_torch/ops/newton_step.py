"""One barrier Newton step (K2) and its direction alone (K2d) on the
reduced barrier subproblem

    min_z  t·(cᵀz + ½ zᵀP z) − Σᵢ log sᵢ,   s = d − C z   (P = None: LP)

Counterpart of interiorpoint_tpu/ops/pallas_newton.py:

* ``newton_step`` / ``newton_step_plain``: ``reduced_newton_step_prepared``
  (TPU kernel ``_newton_step_kernel``, pallas_call at :1301): direction
  plus the closed-form Armijo/domain sweep over the J candidates σⱼ and
  x' = z + σ·dx.
* ``newton_dir`` / ``newton_dir_plain``: ``reduced_newton_dir_prepared``
  (``_newton_dir_kernel``, pallas_call at :1207): dx, g and the squared
  residual rn2 of the direction.
* ``prep_newton_consts``: ``prep_reduced_consts``, once per solve: fp64 C
  and d, and the fp32 copy of C that the Gram reads.

The direction is the TPU kernel's ``_direction_core``: pass 1 over C
(csrc/rows.cu ``ip_nt_pass1``: s, 1/s, w = 1/s², min s), the gradient
g = t·c (+ tP z) + Cᵀ(1/s), the fp32 Gram H32 = CᵀWC (+ tP) with Jacobi
equilibration, the jittered blocked Cholesky and W = L⁻¹ (the pieces of
ops/pd_step.py), and the refined solve of H dx = −g against the fp64
operator H·x = Cᵀ(w ⊙ Cx) + tP x with the PCG escalation (ops/refine.py,
the same rules as K1).  The sweep (``ip_nt_sweep``) takes u = (C dx)/s and,
for every candidate, Σᵢ φ(σⱼuᵢ) with φ(y) = −log(1−y) − y in a
cancellation-free form, and max u; it accepts the first (largest) σⱼ with
σⱼ·max u < 1 − 1e-6 and σⱼ(1−α)·g·dx + σⱼ²·q2 + Σφ ≤ 0, q2 = ½·dxᵀ tP dx.

Differences from the TPU kernel, by design:
* fp64 throughout, fp32 only in the preconditioner (ops/pd_step.py gives
  the reason); so the sweep is fp64 too, where the TPU's is f32;
* C·dx costs one more pass over C: the TPU kernel reads it from a side
  channel of its last refinement pass (pallas_newton.py:703-737);
* the preconditioner is the blocked Cholesky and its inverse, which is the
  fallback of the TPU kernel's LDL/Newton-Schulz hybrid
  (``_factor_hybrid``); the cross-step Minv carry is not used.  The
  refinement against the fp64 operator makes dx independent of the
  preconditioner to the refinement tolerance.

Stats row (fp64, 11): the TPU's 9-entry row with the Newton decrement as
one value, then dir_ok, the candidate index and the pre-step min slack:
``[nd, σ, any_acc, rn2, g·dx, bn2, q2, ns_hit (0), dir_ok, j, min s]``
(indices ``ST_*``), read by the engine in one host read.

``newton_step``/``newton_dir`` launch the CUDA kernels for CUDA tensors,
call their ``*_plain`` twins (the same orchestration over plain PyTorch
pieces) for CPU tensors, and raise on any other device.
"""

from __future__ import annotations

import dataclasses

import torch

from . import pd_step
from .pd_step import _empty, _ws
from .refine import factor_inverse, refined_solve
from ..kernels import _build

(ST_ND, ST_SIGMA, ST_ANY, ST_RN2, ST_GDX, ST_BN2, ST_Q2, ST_NS_HIT,
 ST_DIR_OK, ST_INDEX, ST_SMIN) = range(11)
N_STATS = 11
# Domain margin of the sweep: σ·max u < 1 − _DOMAIN_MARGIN
# (pallas_newton.py:_newton_step_kernel).
_DOMAIN_MARGIN = 1e-6
# φ's series coefficients 1/(m+2), m = 0..15 (csrc/rows.cu ip_phi).
_PHI_COEF = tuple(1.0 / (m + 2) for m in range(16))


@dataclasses.dataclass(frozen=True)
class NTConsts:
    """Per-solve constants of the step: C and d (fp64) and the fp32 copy
    of C that the Gram reads."""
    C: torch.Tensor
    C32: torch.Tensor
    d: torch.Tensor

    @property
    def k(self) -> int:
        return self.C.shape[0]

    @property
    def r(self) -> int:
        return self.C.shape[1]


def prep_newton_consts(C: torch.Tensor, d: torch.Tensor) -> NTConsts:
    """Make the per-solve constants (the fp32 copy once per solve)."""
    C = C.contiguous()
    return NTConsts(C=C, C32=C.to(torch.float32), d=d.contiguous())


def pick_first(accept, sig):
    """First (largest) accepted candidate: (any, index, σ); σ = 0 when
    none passes."""
    any_acc = accept.any()
    j = torch.argmax(accept.to(torch.int32))
    return any_acc, j, torch.where(any_acc, sig[j], torch.zeros_like(sig[0]))


def phi(y: torch.Tensor) -> torch.Tensor:
    """φ(y) = −log(1−y) − y ≥ 0 without cancellation: the series
    y²·Σ_{m<16} yᵐ/(m+2) for |y| < 0.1, else the direct form (y ≥ 1 gives
    inf or NaN).  The fp64 counterpart of pallas_newton.py:_phi_stable."""
    small = y.abs() < 0.1
    ys = torch.where(small, y, torch.zeros_like(y))
    p = torch.full_like(ys, _PHI_COEF[15])
    for m in range(14, -1, -1):
        p = p * ys + _PHI_COEF[m]
    yb = torch.where(small, torch.full_like(y, 0.5), y)
    return torch.where(small, ys * ys * p, -torch.log1p(-yb) - yb)


# ---------------------------------------------------------------------------
# The two backends: the K1 pieces (ops/pd_step.py) plus pass 1 and the sweep.
# ---------------------------------------------------------------------------

class _Cuda(pd_step._Cuda):
    @staticmethod
    def nt_pass1(C, z, d):
        k, r = C.shape
        s, inv_s, w = _empty(k, C), _empty(k, C), _empty(k, C)
        smin = _empty((), C)
        _build.launch("ip_nt_pass1", C, z, d, s, inv_s, w,
                      _ws("ip_rows_ws_bytes", k, r, C), smin, k, r)
        return s, inv_s, w, smin

    @staticmethod
    def sweep(cdx, inv_s, sig, gdx, q2, alpha, z, dx):
        k, J, r = cdx.shape[0], sig.shape[0], z.shape[0]
        phisum, umax = _empty(J, z), _empty((), z)
        sel, xnew = _empty(3, z), _empty(r, z)
        _build.launch("ip_nt_sweep", cdx, inv_s, sig, J, gdx, q2,
                      float(alpha), z, dx, r,
                      _ws("ip_sweep_ws_bytes", k, J, z), phisum, umax, sel,
                      xnew, k)
        return phisum, umax, sel, xnew


class _Plain(pd_step._Plain):
    @staticmethod
    def nt_pass1(C, z, d):
        s = d - C @ z
        inv_s = 1.0 / s
        return s, inv_s, inv_s * inv_s, s.amin()

    @staticmethod
    def sweep(cdx, inv_s, sig, gdx, q2, alpha, z, dx):
        u = cdx * inv_s
        phisum = phi(u[:, None] * sig[None, :]).sum(dim=0)
        umax = u.amax()
        accept = ((sig * umax < 1.0 - _DOMAIN_MARGIN)
                  & torch.isfinite(phisum)
                  & (sig * ((1.0 - alpha) * gdx) + sig * sig * q2 + phisum
                     <= 0.0))
        any_acc, j, sigma = pick_first(accept, sig)
        sel = torch.stack([sigma, j.to(sig.dtype), any_acc.to(sig.dtype)])
        return phisum, umax, sel, z + sigma * dx


# ---------------------------------------------------------------------------
# Orchestration shared by both backends
# ---------------------------------------------------------------------------

def _gradient(ops, cs: NTConsts, tc, z, tP):
    """Pass 1 over C and the gradient g = t·c (+ tP z) + Cᵀ(1/s).
    Returns (g, 1/s, w = 1/s², min s)."""
    _, inv_s, w, smin = ops.nt_pass1(cs.C, z, cs.d)
    g = tc + ops.ct_matvec(cs.C, inv_s)
    if tP is not None:
        g = g + ops.p_matvec(tP, z)
    return g, inv_s, w, smin


def _solve_dir(ops, cs: NTConsts, w, g, tP, tP32, refine: int,
               stall_rel2: float):
    """The fp32 preconditioner of H = Cᵀ diag(w) C (+ tP) and the refined
    solve of H dx = −g.  Returns (dx, rn2, bn2)."""
    C, r = cs.C, cs.r
    f64 = torch.float64
    W, dsc = factor_inverse(ops, ops.gram(cs.C32, w, tP32))
    dsc64 = dsc[:r].to(f64)

    def precond(v):
        return ops.w_solve(W, v.to(torch.float32)).to(f64)

    def apply_h(x):
        hx = ops.ct_matvec(C, ops.c_matvec(C, x, w))
        return hx + ops.p_matvec(tP, x) if tP is not None else hx

    return refined_solve(precond, apply_h, dsc64, -g, refine, stall_rel2)


def _direction(ops, cs: NTConsts, tc, z, tP, tP32, refine: int,
               stall_rel2: float):
    """Slacks, gradient, fp32 preconditioner and the refined dx."""
    g, inv_s, w, smin = _gradient(ops, cs, tc, z, tP)
    dx, rn2, bn2 = _solve_dir(ops, cs, w, g, tP, tP32, refine, stall_rel2)
    return dx, g, rn2, bn2, inv_s, smin


def _newton_step(ops, cs: NTConsts, tc, z, tP, tP32, sig, alpha: float,
                 refine: int, stall_rel2: float):
    dx, g, rn2, bn2, inv_s, smin = _direction(ops, cs, tc, z, tP, tP32,
                                              refine, stall_rel2)
    gdx = g @ dx
    q2 = (0.5 * (dx @ ops.p_matvec(tP, dx)) if tP is not None
          else torch.zeros_like(gdx))
    cdx = ops.c_matvec(cs.C, dx)
    _, _, sel, xnew = ops.sweep(cdx, inv_s, sig, gdx, q2, alpha, z, dx)
    dir_ok = (rn2 <= 1e-4 * bn2 + 1e-30).to(gdx.dtype)
    zero = torch.zeros_like(gdx)
    stats = torch.stack([-0.5 * gdx, sel[0], sel[2], rn2, gdx, bn2, q2,
                         zero, dir_ok, sel[1], smin])
    return xnew, stats


def _check(name, cs: NTConsts, tc, z, tP, tP32, sig=None):
    k, r = cs.k, cs.r
    f64, f32 = torch.float64, torch.float32
    want = [("C", cs.C, f64, (k, r)), ("C32", cs.C32, f32, (k, r)),
            ("d", cs.d, f64, (k,)), ("tc", tc, f64, (r,)),
            ("z", z, f64, (r,))]
    if tP is not None:
        want += [("tP", tP, f64, (r, r)), ("tP32", tP32, f32, (r, r))]
    if sig is not None:
        if sig.ndim != 1 or sig.shape[0] < 1:
            raise ValueError(f"{name}: sigmas must hold at least one "
                             "candidate")
        want.append(("sigmas", sig, f64, tuple(sig.shape)))
    for what, t, dtype, shape in want:
        if t.dtype != dtype or tuple(t.shape) != shape or \
                not t.is_contiguous() or t.device != cs.C.device:
            raise ValueError(f"{name}: {what} must be a contiguous {dtype} "
                             f"{shape} tensor on {cs.C.device}")
    kind = cs.C.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {cs.C.device}")
    return kind


def _tp32(tP, tP32):
    if tP is None or tP32 is not None:
        return tP32
    return tP.to(torch.float32)


def newton_step(cs: NTConsts, tc, z, tP, sigmas, *, alpha: float,
                refine: int = 3, dir_tol: float = 1e-6, tP32=None):
    """One Newton iteration: direction and line search.

    ``tc`` = t·c (r,), ``z`` the iterate, ``tP`` = t·P (r, r) or None and
    ``tP32`` its fp32 copy (made here when not given: the engine casts it
    once per barrier stage), ``sigmas`` (J,) the candidates β^j.
    Returns (x', stats), stats as in the module docstring."""
    tP32 = _tp32(tP, tP32)
    if _check("newton_step", cs, tc, z, tP, tP32, sigmas) == "cpu":
        return newton_step_plain(cs, tc, z, tP, sigmas, alpha=alpha,
                                 refine=refine, dir_tol=dir_tol, tP32=tP32)
    out = _newton_step(_Cuda, cs, tc, z, tP, tP32, sigmas, alpha, refine,
                       float(dir_tol) ** 2)
    newton_step.launches += 1
    return out


def newton_step_plain(cs: NTConsts, tc, z, tP, sigmas, *, alpha: float,
                      refine: int = 3, dir_tol: float = 1e-6, tP32=None):
    """Plain PyTorch version of ``newton_step`` (same control flow)."""
    newton_step_plain.calls += 1
    return _newton_step(_Plain, cs, tc, z, tP, _tp32(tP, tP32), sigmas,
                        alpha, refine, float(dir_tol) ** 2)


def newton_dir(cs: NTConsts, tc, z, tP=None, *, refine: int = 3,
               dir_tol: float = 1e-6, tP32=None):
    """The Newton direction alone: (dx, g, rn2), rn2 the squared
    residual ‖D(H dx + g)‖² in the equilibrated metric."""
    tP32 = _tp32(tP, tP32)
    if _check("newton_dir", cs, tc, z, tP, tP32) == "cpu":
        return newton_dir_plain(cs, tc, z, tP, refine=refine,
                                dir_tol=dir_tol, tP32=tP32)
    dx, g, rn2, _, _, _ = _direction(_Cuda, cs, tc, z, tP, tP32, refine,
                                     float(dir_tol) ** 2)
    newton_dir.launches += 1
    return dx, g, rn2


def newton_dir_plain(cs: NTConsts, tc, z, tP=None, *, refine: int = 3,
                     dir_tol: float = 1e-6, tP32=None):
    """Plain PyTorch version of ``newton_dir``."""
    newton_dir_plain.calls += 1
    dx, g, rn2, _, _, _ = _direction(_Plain, cs, tc, z, tP,
                                     _tp32(tP, tP32), refine,
                                     float(dir_tol) ** 2)
    return dx, g, rn2


newton_step.launches = 0
newton_dir.launches = 0
newton_step_plain.calls = 0
newton_dir_plain.calls = 0
