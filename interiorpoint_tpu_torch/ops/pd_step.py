"""One Mehrotra predictor-corrector iteration (K1) on

    min ½ zᵀP z + qᵀz   s.t.   C z ≤ d        (P = None for LP)

Counterpart of interiorpoint_tpu/ops/pallas_pd.py (``pd_step_prepared``,
the TPU kernel ``_pd_step_kernel``/``_pd_step_core``) together with the
pieces of interiorpoint_tpu/ops/pallas_newton.py it runs
(``_equilibrate``, ``_factor_jittered``, ``_chol_invert_ref``,
``_w_solve``, ``_refined_solve``, ``_dd_pmatvec_row``, ``_dd_recip``).

Precision.  The TPU kernel carries every residual, operator application
and state vector as a double-float32 pair (ops/dd.py) because the TPU has
no fp64.  The H100 has native fp64, so the port keeps them in plain fp64
and ``ops/dd.py`` is not ported.  The preconditioner (the Gram
H32 = Cᵀdiag(λ/s)C (+P), its Jacobi equilibration, its blocked Cholesky
factor and the inverse W = L⁻¹) stays true fp32 with no TF32, for the
reason interiorpoint_tpu/ops/pallas_chol.py:_dot gives: fp64 refinement
against the true operator converges only when κ·(factor error) < 1.

Structure.  The one TPU kernel becomes a Python orchestration of CUDA
launches (csrc/rows.cu: fp64 passes over C; csrc/gram.cu: fp32 Gram and
equilibration; csrc/chol.cu: factor, inverse, W-solves), with the same
rules as the TPU kernel (ops/refine.py, shared with the barrier step
K2): the 0/1e-6/3e-3/1 jitter ladder on the
unit-diagonal Hs, ``refine`` rounds of refinement with early exit at
max(stall_rel2·1e-4, 1e-25), the PCG escalation in the equilibrated metric
only when the residual stalls above ``stall_rel2``, capped at 48 rounds
and kept only if it improved the residual.  The resident/stream split and
the VMEM size gates of the TPU kernel do not carry over.

Vector glue between launches stays as torch tensor ops on the device:
the k-length μ_aff dot, the r-length axpys, dots and norms of the
refinement and PCG, and the scalar clamps of σ, αp and αd.  The row
kernels finish their own reductions (gap, ‖rp‖∞, the step-ratio minima)
on the device, and the launch geometry stays in the CUDA sources: the
wrappers size workspaces by asking the library (``_build.query``).
Inside the step, everything that reads C, H, L, W or P is a kernel; the
fp32 copies of C and P that the Gram reads are cast once per solve by
``prep_pd_consts``, as the TPU path splits C into its double-float words
once per solve (pallas_newton.py:prep_reduced_consts).  Host reads
(ops/sync.py) decide the jitter ladder, the refinement exits and the PCG
loop.

``pd_step`` launches the CUDA kernels for CUDA tensors and calls
``pd_step_plain`` (the same orchestration over plain PyTorch versions:
fp32 Gram, factor and inverse, fp64 everything else) for CPU tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..kernels import _build
from .chol import (PLAIN_BLK, cuda_block, factor_cuda, factor_plain,
                   invert_cuda, invert_plain, padded, w_solve_cuda,
                   w_solve_plain)
from .refine import factor_inverse, refined_solve

_GAMMA = 0.99995


@dataclasses.dataclass(frozen=True)
class PDConsts:
    """Per-solve constants of the step: C and d (fp64), the fp32 copy of
    C the Gram reads, and P (fp64 and fp32) for QP."""
    C: torch.Tensor
    C32: torch.Tensor
    d: torch.Tensor
    P: Optional[torch.Tensor]
    P32: Optional[torch.Tensor]

    @property
    def k(self) -> int:
        return self.C.shape[0]

    @property
    def r(self) -> int:
        return self.C.shape[1]


def prep_pd_consts(C: torch.Tensor, d: torch.Tensor,
                   P: Optional[torch.Tensor] = None) -> PDConsts:
    """Make the per-solve constants (the fp32 copies once per solve)."""
    C = C.contiguous()
    P = None if P is None else P.contiguous()
    return PDConsts(C=C, C32=C.to(torch.float32), d=d.contiguous(), P=P,
                    P32=None if P is None else P.to(torch.float32))


# ---------------------------------------------------------------------------
# The two backends: CUDA launches and their plain PyTorch versions.
# ---------------------------------------------------------------------------

def _empty(n, like, dtype=torch.float64):
    return torch.empty(n, dtype=dtype, device=like.device)


def _ws(query, *args):
    """Workspace of a C entry, sized by the library's query:
    ``_ws(query, *dims, like)`` on the device of ``like``."""
    *dims, like = args
    return torch.empty(_build.query(query, *dims), dtype=torch.uint8,
                       device=like.device)


class _Cuda:
    @staticmethod
    def c_matvec(C, x, w=None):
        k, r = C.shape
        y = _empty(k, C)
        _build.launch("ip_c_matvec", C, x, w, y, k, r)
        return y

    @staticmethod
    def ct_matvec(C, v):
        k, r = C.shape
        out = _empty(r, C)
        _build.launch("ip_ct_matvec", C, v, _ws("ip_rows_ws_bytes", k, r, C),
                      out, k, r)
        return out

    @staticmethod
    def pass1(C, z, s, lam, d):
        k, r = C.shape
        rp, inv_s, w = _empty(k, C), _empty(k, C), _empty(k, C)
        gap, rpn = _empty((), C), _empty((), C)
        _build.launch("ip_pd_pass1", C, z, s, lam, d, rp, inv_s, w,
                      _ws("ip_rows_ws_bytes", k, r, C), gap, rpn, k, r)
        return rp, inv_s, w, gap, rpn

    @staticmethod
    def rhs(s, lam, rp, inv_s, ds, dl, sig_mu, use_corr):
        k = s.shape[0]
        rc, t = _empty(k, s), _empty(k, s)
        _build.launch("ip_pd_rhs", s, lam, rp, inv_s,
                      ds if use_corr else s, dl if use_corr else s,
                      sig_mu, int(use_corr), rc, t, k)
        return rc, t

    @staticmethod
    def ds_pass(C, dz, rp, rc, lam, s, inv_s):
        k, r = C.shape
        ds, dl = _empty(k, C), _empty(k, C)
        ap, ad = _empty((), C), _empty((), C)
        _build.launch("ip_pd_ds", C, dz, rp, rc, lam, s, inv_s, ds, dl,
                      _ws("ip_rows_ws_bytes", k, r, C), ap, ad, k, r)
        return ds, dl, ap, ad

    @staticmethod
    def update(s, lam, ds, dl, ap, ad):
        k = s.shape[0]
        s2, lam2, gap = _empty(k, s), _empty(k, s), _empty((), s)
        _build.launch("ip_pd_update", s, lam, ds, dl, ap, ad, s2, lam2,
                      _ws("ip_rows_ws_bytes", k, 0, s), gap, k)
        return s2, lam2, gap

    @staticmethod
    def p_matvec(P, x):
        return _Cuda.c_matvec(P, x)

    @staticmethod
    def gram(C32, w, P32):
        """C32 may be a view with a longer row stride (unit column
        stride)."""
        k, r = C32.shape
        if C32.stride(1) != 1 or C32.stride(0) < r:
            raise ValueError("gram: C32 must have unit column stride")
        H = _empty((r, r), C32, torch.float32)
        _build.launch("ip_gram", C32, C32.stride(0), w, P32,
                      _ws("ip_gram_ws_bytes", k, r, C32), H, k, r)
        return H

    @staticmethod
    def equilibrate(H, blk=0):
        """fp32 (the step kernels' preconditioners) or fp64 (K5's), padded
        to a multiple of ``blk`` (default: the factor's block)."""
        r = H.shape[0]
        np_ = padded(r, blk or cuda_block())
        Hs = _empty((np_, np_), H, H.dtype)
        dsc = _empty(np_, H, H.dtype)
        entry = {torch.float32: "ip_equilibrate",
                 torch.float64: "ip_equilibrate64"}[H.dtype]
        _build.launch(entry, H, r, Hs, dsc, np_)
        return Hs, dsc

    @staticmethod
    def factor(Hs, delta):
        return factor_cuda(Hs, Hs.shape[0], Hs.shape[0], delta)

    invert = staticmethod(invert_cuda)
    w_solve = staticmethod(w_solve_cuda)


class _Plain:
    @staticmethod
    def c_matvec(C, x, w=None):
        y = C @ x
        return y if w is None else w * y

    @staticmethod
    def ct_matvec(C, v):
        return C.T @ v

    @staticmethod
    def pass1(C, z, s, lam, d):
        rp = C @ z + s - d
        inv_s = 1.0 / s
        return rp, inv_s, lam * inv_s, (s * lam).sum(), rp.abs().amax()

    @staticmethod
    def rhs(s, lam, rp, inv_s, ds, dl, sig_mu, use_corr):
        rc = s * lam - sig_mu
        if use_corr:
            rc = rc + ds * dl
        return rc, (rc - lam * rp) * inv_s

    @staticmethod
    def ds_pass(C, dz, rp, rc, lam, s, inv_s):
        ds = -rp - C @ dz
        dl = (-rc - lam * ds) * inv_s
        inf = torch.full_like(ds, float("inf"))
        ap = torch.where(ds < 0, -s / torch.where(ds < 0, ds, -1.0), inf)
        ad = torch.where(dl < 0, -lam / torch.where(dl < 0, dl, -1.0), inf)
        return ds, dl, ap.amin(), ad.amin()

    @staticmethod
    def update(s, lam, ds, dl, ap, ad):
        s2 = s + ap * ds
        lam2 = lam + ad * dl
        return s2, lam2, (s2 * lam2).sum()

    @staticmethod
    def p_matvec(P, x):
        return P @ x

    @staticmethod
    def gram(C32, w, P32):
        H = (C32 * w.to(torch.float32)[:, None]).T @ C32
        return H if P32 is None else H + P32

    @staticmethod
    def equilibrate(H, blk=0):
        r = H.shape[0]
        np_ = padded(r, blk or PLAIN_BLK)
        dsc = torch.ones(np_, dtype=H.dtype, device=H.device)
        dsc[:r] = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(H),
                                               min=1e-30))
        Hs = torch.eye(np_, dtype=H.dtype, device=H.device)
        Hs[:r, :r] = H * dsc[:r, None] * dsc[None, :r]
        return Hs, dsc

    @staticmethod
    def factor(Hs, delta):
        return factor_plain(Hs, Hs.shape[0], Hs.shape[0], delta)

    invert = staticmethod(invert_plain)
    w_solve = staticmethod(w_solve_plain)


# ---------------------------------------------------------------------------
# Orchestration shared by both backends
# ---------------------------------------------------------------------------

def _pd_step(ops, cs: PDConsts, q, z, s, lam, refine: int,
             stall_rel2: float):
    C, k, r = cs.C, cs.k, cs.r
    f64 = torch.float64
    has_P = cs.P is not None

    # pass 1: rp, 1/s, w = λ/s, gap, ‖rp‖∞; rd = q + Cᵀλ (+ P z)
    rp, inv_s, w, gap, rpn = ops.pass1(C, z, s, lam, cs.d)
    rd = q + ops.ct_matvec(C, lam)
    if has_P:
        rd = rd + ops.p_matvec(cs.P, z)
    rdn = rd.abs().amax()
    mu = gap / k

    # fp32 preconditioner: Gram, equilibration, jittered factor, W = L⁻¹
    W, dsc = factor_inverse(ops, ops.gram(cs.C32, w, cs.P32))
    dsc64 = dsc[:r].to(f64)

    def precond(v):
        return ops.w_solve(W, v.to(torch.float32)).to(f64)

    def apply_h(x):
        hx = ops.ct_matvec(C, ops.c_matvec(C, x, w))
        return hx + ops.p_matvec(cs.P, x) if has_P else hx

    def direction(sig_mu, prev):
        use_corr = prev is not None
        ds_p, dl_p = prev if use_corr else (None, None)
        rc, t = ops.rhs(s, lam, rp, inv_s, ds_p, dl_p, sig_mu, use_corr)
        b = -rd + ops.ct_matvec(C, t)
        dz, srn2, sbn2 = refined_solve(precond, apply_h, dsc64, b, refine,
                                       stall_rel2)
        ds, dl, ap_r, ad_r = ops.ds_pass(C, dz, rp, rc, lam, s, inv_s)
        return (dz, ds, dl, torch.clamp(ap_r, max=1.0),
                torch.clamp(ad_r, max=1.0), srn2, sbn2)

    zero = torch.zeros((), dtype=f64, device=C.device)
    # predictor (σ = 0)
    _, ds_a, dl_a, ap_a, ad_a, _, _ = direction(zero, None)
    mu_aff = ((s + ap_a * ds_a) * (lam + ad_a * dl_a)).sum() / k
    ratio = torch.clamp(mu_aff, min=0.0) / torch.clamp(mu, min=1e-30)
    sigma = torch.clamp(ratio ** 3, 0.0, 1.0)
    # corrector (same factor)
    dz, ds, dl, ap, ad, srn2, sbn2 = direction(sigma * mu, (ds_a, dl_a))
    ap = torch.clamp(_GAMMA * ap, max=1.0)
    ad = torch.clamp(_GAMMA * ad, max=1.0)

    z2 = z + ap * dz
    s2, lam2, gap2 = ops.update(s, lam, ds, dl, ap, ad)
    # rp and (LP) rd contract exactly by (1−α); QP adds (αp−αd)·P dz
    rpn2 = (1.0 - ap) * rpn
    rdn2 = (1.0 - ad) * rdn
    if has_P:
        rdn2 = rdn2 + (ap - ad).abs() * ops.p_matvec(cs.P, dz).abs().amax()
    stats = torch.stack([gap2, rpn2, rdn2, ap, ad, sigma, srn2, sbn2,
                         gap, rpn, rdn, zero])
    return z2, s2, lam2, stats


def _check(cs: PDConsts, q, z, s, lam):
    k, r = cs.k, cs.r
    P_shapes = () if cs.P is None else (
        ("P", cs.P, torch.float64, (r, r)),
        ("P32", cs.P32, torch.float32, (r, r)))
    for name, t, dtype, shape in (
            ("C", cs.C, torch.float64, (k, r)),
            ("C32", cs.C32, torch.float32, (k, r)),
            ("d", cs.d, torch.float64, (k,)),
            ("q", q, torch.float64, (r,)), ("z", z, torch.float64, (r,)),
            ("s", s, torch.float64, (k,)),
            ("lam", lam, torch.float64, (k,))) + P_shapes:
        if t.dtype != dtype or tuple(t.shape) != shape or \
                not t.is_contiguous() or t.device != cs.C.device:
            raise ValueError(f"pd_step: {name} must be a contiguous {dtype} "
                             f"{shape} tensor on {cs.C.device}")


def pd_step(cs: PDConsts, q, z, s, lam, *, refine: int = 3,
            dir_tol: float = 1e-6):
    """One fused primal-dual iteration.

    Returns (z', s', λ', stats) with stats (fp64, 12) =
    [gap', rp'∞, rd'∞, αp, αd, σ, srn2, sbn2, gap, rp∞, rd∞, 0]: primed
    entries are post-step (rp'/rd' by (1−α)-contraction bookkeeping),
    unprimed the exact pre-step values; srn2/sbn2 are the corrector
    solve's squared residual and right-hand side in the equilibrated
    metric.  CUDA tensors launch the kernels; CPU tensors take
    ``pd_step_plain``."""
    _check(cs, q, z, s, lam)
    kind = cs.C.device.type
    if kind == "cpu":
        return pd_step_plain(cs, q, z, s, lam, refine=refine,
                             dir_tol=dir_tol)
    if kind != "cuda":
        raise ValueError(f"pd_step: unsupported device {cs.C.device}")
    out = _pd_step(_Cuda, cs, q, z, s, lam, refine, float(dir_tol) ** 2)
    pd_step.launches += 1
    return out


def pd_step_plain(cs: PDConsts, q, z, s, lam, *, refine: int = 3,
                  dir_tol: float = 1e-6):
    """Plain PyTorch version of ``pd_step`` (same control flow)."""
    pd_step_plain.calls += 1
    return _pd_step(_Plain, cs, q, z, s, lam, refine, float(dir_tol) ** 2)


pd_step.launches = 0
pd_step_plain.calls = 0
