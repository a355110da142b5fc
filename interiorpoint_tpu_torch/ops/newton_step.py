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
g = t·c (+ tP z) + Cᵀ(1/s), the fp32 Gram H32 = CᵀWC (+ tP) (csrc/gram.cu)
with Jacobi equilibration, the preconditioner of ops/hybrid.py, and the
refined solve of H dx = −g against the fp64 operator
H·x = Cᵀ(w ⊙ Cx) + tP x with the PCG escalation (ops/refine.py, the same
rules as K1).  The preconditioner is the TPU kernel's: with a carry
(``NSCarry``, r ≤ 512) the last step's X ≈ Hs⁻¹ refreshed by
Newton–Schulz, used when it reaches ‖I − Hs·X‖²_F < 1e-4 (a hit: no
factor this step); otherwise ``_factor_hybrid``: the block-LDL factor
with Newton–Schulz tile inverses at jitter 0 and 1e-6, and, when both
miss, the jittered blocked Cholesky with W = L⁻¹, its first rung failed by a
pivot floor (ops/refine.py ``factor_jittered``) as well as by
finiteness; a miss re-seeds the carry with the factor's solve applied to
I (WᵀW after the fallback).  The hit and both LDL rungs are decided by
one host read: each LDL launch skips itself on the device after a hit or
an earlier rung's success.
The sweep (``ip_nt_sweep``) takes u = (C dx)/s and, for every candidate,
Σᵢ φ(σⱼuᵢ) with φ(y) = −log(1−y) − y in a cancellation-free form, and
max u; it accepts the first (largest) σⱼ with σⱼ·max u < 1 − 1e-6 and
σⱼ(1−α)·g·dx + σⱼ²·q2 + Σφ ≤ 0, q2 = ½·dxᵀ tP dx.  C·dx comes from the
last refinement pass (``ip_c_matvec_keep`` keeps C·x of every operator
application), as the TPU kernel reads it from a side channel
(pallas_newton.py:703-737), on every exit of ``refined_solve`` that ends
with an application of the returned dx; the two that do not (no
refinement round, a rejected PCG) pay one more pass over C
(``COUNTS``).

Differences from the TPU kernel, by design:
* fp64 throughout, fp32 only in the preconditioner (ops/pd_step.py gives
  the reason); so the sweep is fp64 too, where the TPU's is f32;
* pass 1 stays a pass of its own before the Gram: each wᵢ = 1/sᵢ² needs
  the whole row's fp64 dot product Cᵢ·z, which a column tile of the
  Gram does not see (the TPU fused the two because its slab spanned all
  of C's columns);
* the Cholesky fallback's blocks are 64 wide (the TPU's 128; the LDL's
  tiles are the TPU's 128).  The refinement against the fp64 operator
  makes dx independent of the preconditioner to the refinement
  tolerance.

Stats row (fp64, 11): the TPU's 9-entry row with the Newton decrement as
one value, then dir_ok, the candidate index and the pre-step min slack:
``[nd, σ, any_acc, rn2, g·dx, bn2, q2, ns_hit, dir_ok, j, min s]``
(indices ``ST_*``), read by the engine in one host read.

``newton_step``/``newton_dir`` launch the CUDA kernels for CUDA tensors,
call their ``*_plain`` twins (the same orchestration over plain PyTorch
pieces) for CPU tensors, and raise on any other device.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Optional

import torch

from . import hybrid, pd_step, sync
from .pd_step import _empty, _ws
from .refine import factor_jittered, refined_solve
from ..kernels import _build

(ST_ND, ST_SIGMA, ST_ANY, ST_RN2, ST_GDX, ST_BN2, ST_Q2, ST_NS_HIT,
 ST_DIR_OK, ST_INDEX, ST_SMIN) = range(11)
N_STATS = 11
# Domain margin of the sweep: σ·max u < 1 − _DOMAIN_MARGIN
# (pallas_newton.py:_newton_step_kernel).
_DOMAIN_MARGIN = 1e-6
# φ's series coefficients 1/(m+2), m = 0..15 (csrc/rows.cu ip_phi).
_PHI_COEF = tuple(1.0 / (m + 2) for m in range(16))
# per preconditioner: carry trials and hits, the LDL rung taken or the
# Cholesky fallback; per step: C·dx of the sweep read from the last
# refinement pass, or one more pass
COUNTS: Counter = Counter()


@dataclasses.dataclass
class NSCarry:
    """The cross-step preconditioner carry of K2 (the TPU kernel's
    ``minv``/``mvok``): X ≈ Hs⁻¹ of the previous step (fp32, padded
    np × np), ``ok`` once X holds a seed (False at a solve's first
    step)."""
    X: Optional[torch.Tensor] = None
    ok: bool = False


@dataclasses.dataclass(frozen=True)
class NTConsts:
    """Per-solve constants of the step: C and d (fp64) and the fp32 copy
    of C that the Gram reads (a view whose rows start 16 bytes apart,
    zero columns past r, so the Gram copies whole 16-byte chunks)."""
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
    """Make the per-solve constants (the fp32 copy once per solve, its row
    stride rounded up to a multiple of 4)."""
    C = C.contiguous()
    k, r = C.shape
    C32 = torch.zeros((k, -(-r // 4) * 4), dtype=torch.float32,
                      device=C.device)
    C32[:, :r] = C
    return NTConsts(C=C, C32=C32[:, :r], d=d.contiguous())


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
    def c_matvec_keep(C, x, w):
        """(w ⊙ Cx, Cx): the operator's row pass, keeping C·x."""
        k, r = C.shape
        y, cx = _empty(k, C), _empty(k, C)
        _build.launch("ip_c_matvec_keep", C, x, w, y, cx, k, r)
        return y, cx

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

    ldl_factor = staticmethod(hybrid.ldl_factor_cuda)
    ldl_solve = staticmethod(hybrid.ldl_solve_cuda)
    ns_refresh = staticmethod(hybrid.ns_refresh_cuda)
    xt_matvec = staticmethod(hybrid.xt_matvec_cuda)
    gram_tn = staticmethod(hybrid.gram_tn_cuda)


class _Plain(pd_step._Plain):
    @staticmethod
    def nt_pass1(C, z, d):
        s = d - C @ z
        inv_s = 1.0 / s
        return s, inv_s, inv_s * inv_s, s.amin()

    @staticmethod
    def c_matvec_keep(C, x, w):
        cx = C @ x
        return w * cx, cx

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

    ldl_factor = staticmethod(hybrid.ldl_factor_plain)
    ldl_solve = staticmethod(hybrid.ldl_solve_plain)
    ns_refresh = staticmethod(hybrid.ns_refresh_plain)
    xt_matvec = staticmethod(hybrid.xt_matvec_plain)
    gram_tn = staticmethod(hybrid.gram_tn_plain)


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


def preconditioner(ops, H32, carry: Optional[NSCarry] = None):
    """The fp32 preconditioner of H32 (``_direction_core``'s, module
    docstring): returns (apply, dsc, hit), ``apply`` v ↦ M⁻¹v on fp32
    r-vectors in the equilibrated metric, dsc the padded equilibration
    and hit 1.0 when the carry was taken.  Updates ``carry``."""
    Hs, dsc = ops.equilibrate(H32, hybrid.LDL_BLK)
    trial = carry is not None and carry.ok
    i32 = torch.int32
    hit = torch.zeros((), dtype=i32, device=Hs.device)
    if trial:
        X, hit, _, _ = ops.ns_refresh(Hs, carry.X)
    # both LDL rungs, each skipped on the device once a carry hit or an
    # earlier rung has succeeded; one host read decides
    facs, flags, skip = [], [hit], hit
    for delta in hybrid.LDL_JITTERS:
        Lt, Dinv, bad = ops.ldl_factor(Hs, delta, skip)
        facs.append((Lt, Dinv))
        flags.append(bad.to(i32))
        skip = torch.maximum(skip, (bad == 0).to(i32))
    hit_h, *bads = sync.read_list(torch.stack(flags))
    COUNTS["carry_trials"] += int(trial)
    if hit_h:
        carry.X = X
        COUNTS["carry_hits"] += 1
        return (lambda v: ops.xt_matvec(X, v)), dsc, 1.0
    rung = next((i for i, b in enumerate(bads) if not b), None)
    COUNTS["cholesky_fallback" if rung is None else "ldl_rung%d" % rung] += 1
    bad_h = rung is None
    if rung is not None:
        Lt, Dinv = facs[rung]
    if not bad_h:
        def apply(v):
            return ops.ldl_solve(Lt, Dinv, v)

        def reseed():
            eye = torch.eye(Hs.shape[0], dtype=Hs.dtype, device=Hs.device)
            return ops.ldl_solve(Lt, Dinv, eye)
    else:
        W = ops.invert(*factor_jittered(ops, Hs, pivot_floor=True))

        def apply(v):
            return ops.w_solve(W, v)

        def reseed():
            return ops.gram_tn(W)
    if carry is not None:
        carry.X = reseed()
        carry.ok = True
    return apply, dsc, 0.0


def _solve_dir(ops, cs: NTConsts, w, g, tP, tP32, refine: int,
               stall_rel2: float, carry: Optional[NSCarry] = None):
    """The fp32 preconditioner of H = Cᵀ diag(w) C (+ tP) and the refined
    solve of H dx = −g.  Returns (dx, rn2, bn2, cdx, hit), cdx = C·dx
    from the last operator application when that was to dx, else None."""
    C, r = cs.C, cs.r
    f64 = torch.float64
    apply, dsc, hit = preconditioner(ops, ops.gram(cs.C32, w, tP32), carry)
    dsc64 = dsc[:r].to(f64)

    def precond(v):
        return apply(v.to(torch.float32)).to(f64)

    last = {}

    def apply_h(x):
        y, cx = ops.c_matvec_keep(C, x, w)
        last["x"], last["cx"] = x, cx
        hx = ops.ct_matvec(C, y)
        return hx + ops.p_matvec(tP, x) if tP is not None else hx

    dx, rn2, bn2 = refined_solve(precond, apply_h, dsc64, -g, refine,
                                 stall_rel2)
    cdx = last["cx"] if last.get("x") is dx else None
    return dx, rn2, bn2, cdx, hit


def _direction(ops, cs: NTConsts, tc, z, tP, tP32, refine: int,
               stall_rel2: float, carry: Optional[NSCarry] = None):
    """Slacks, gradient, fp32 preconditioner and the refined dx."""
    g, inv_s, w, smin = _gradient(ops, cs, tc, z, tP)
    dx, rn2, bn2, cdx, hit = _solve_dir(ops, cs, w, g, tP, tP32, refine,
                                        stall_rel2, carry)
    return dx, g, rn2, bn2, inv_s, smin, cdx, hit


def _newton_step(ops, cs: NTConsts, tc, z, tP, tP32, sig, alpha: float,
                 refine: int, stall_rel2: float,
                 carry: Optional[NSCarry] = None):
    dx, g, rn2, bn2, inv_s, smin, cdx, hit = _direction(
        ops, cs, tc, z, tP, tP32, refine, stall_rel2, carry)
    gdx = g @ dx
    q2 = (0.5 * (dx @ ops.p_matvec(tP, dx)) if tP is not None
          else torch.zeros_like(gdx))
    if cdx is None:
        COUNTS["cdx_extra_pass"] += 1
        cdx = ops.c_matvec(cs.C, dx)
    else:
        COUNTS["cdx_side_channel"] += 1
    _, _, sel, xnew = ops.sweep(cdx, inv_s, sig, gdx, q2, alpha, z, dx)
    dir_ok = (rn2 <= 1e-4 * bn2 + 1e-30).to(gdx.dtype)
    zero = torch.zeros_like(gdx)
    stats = torch.stack([-0.5 * gdx, sel[0], sel[2], rn2, gdx, bn2, q2,
                         zero + hit, dir_ok, sel[1], smin])
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
        # C32 may have a longer row stride (prep_newton_consts)
        laid = (t.stride(1) == 1 and t.stride(0) >= shape[1]) \
            if what == "C32" else t.is_contiguous()
        if t.dtype != dtype or tuple(t.shape) != shape or not laid or \
                t.device != cs.C.device:
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
                refine: int = 3, dir_tol: float = 1e-6, tP32=None,
                carry: Optional[NSCarry] = None):
    """One Newton iteration: direction and line search.

    ``tc`` = t·c (r,), ``z`` the iterate, ``tP`` = t·P (r, r) or None and
    ``tP32`` its fp32 copy (made here when not given: the engine casts it
    once per barrier stage), ``sigmas`` (J,) the candidates β^j,
    ``carry`` the cross-step preconditioner carry (updated in place) or
    None.  Returns (x', stats), stats as in the module docstring."""
    tP32 = _tp32(tP, tP32)
    if _check("newton_step", cs, tc, z, tP, tP32, sigmas) == "cpu":
        return newton_step_plain(cs, tc, z, tP, sigmas, alpha=alpha,
                                 refine=refine, dir_tol=dir_tol, tP32=tP32,
                                 carry=carry)
    out = _newton_step(_Cuda, cs, tc, z, tP, tP32, sigmas, alpha, refine,
                       float(dir_tol) ** 2, carry)
    newton_step.launches += 1
    return out


def newton_step_plain(cs: NTConsts, tc, z, tP, sigmas, *, alpha: float,
                      refine: int = 3, dir_tol: float = 1e-6, tP32=None,
                      carry: Optional[NSCarry] = None):
    """Plain PyTorch version of ``newton_step`` (same control flow)."""
    newton_step_plain.calls += 1
    return _newton_step(_Plain, cs, tc, z, tP, _tp32(tP, tP32), sigmas,
                        alpha, refine, float(dir_tol) ** 2, carry)


def newton_dir(cs: NTConsts, tc, z, tP=None, *, refine: int = 3,
               dir_tol: float = 1e-6, tP32=None):
    """The Newton direction alone: (dx, g, rn2), rn2 the squared
    residual ‖D(H dx + g)‖² in the equilibrated metric."""
    tP32 = _tp32(tP, tP32)
    if _check("newton_dir", cs, tc, z, tP, tP32) == "cpu":
        return newton_dir_plain(cs, tc, z, tP, refine=refine,
                                dir_tol=dir_tol, tP32=tP32)
    dx, g, rn2 = _direction(_Cuda, cs, tc, z, tP, tP32, refine,
                            float(dir_tol) ** 2)[:3]
    newton_dir.launches += 1
    return dx, g, rn2


def newton_dir_plain(cs: NTConsts, tc, z, tP=None, *, refine: int = 3,
                     dir_tol: float = 1e-6, tP32=None):
    """Plain PyTorch version of ``newton_dir``."""
    newton_dir_plain.calls += 1
    dx, g, rn2 = _direction(_Plain, cs, tc, z, tP, _tp32(tP, tP32),
                            refine, float(dir_tol) ** 2)[:3]
    return dx, g, rn2


newton_step.launches = 0
newton_dir.launches = 0
newton_step_plain.calls = 0
newton_dir_plain.calls = 0
