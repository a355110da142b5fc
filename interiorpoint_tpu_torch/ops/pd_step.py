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

Structure.  The one TPU kernel becomes a short chain of CUDA launches
with no host read inside the step, the same rules as the TPU kernel and
the same function as ``pd_step_plain``:

1. pass 1, one read of C (csrc/rows.cu ``ip_pd_pass1``, a strip pass of
   csrc/strip.cuh): rp, 1/s, w = λ/s, gap, ‖rp‖∞ and rd = q + Cᵀλ
   (+ P z), ‖rd‖∞;
2. the fp32 preconditioner: the Gram H32 = Cᵀdiag(w)C (+P) (csrc/gram.cu),
   its Jacobi equilibration, the 0/1e-6/3e-3/1 jitter ladder of the
   blocked Cholesky factor with each rung skipping itself on the device
   once an earlier one was finite (ops/refine.py
   ``factor_jittered_device``), and W = L⁻¹ (csrc/chol.cu);
3. per direction (predictor, then corrector on the same factor): the
   right-hand side and Cᵀt in one read of C (``ip_pd_rhs``); the whole
   refined solve of H dz = b in one cooperative launch
   (csrc/hop.cu ``ip_refined_solve``: ``refine`` rounds with early exit at
   max(stall_rel2·1e-4, 1e-25), the PCG escalation in the equilibrated
   metric when the residual stalls above ``stall_rel2``, capped at 48
   rounds and kept only if it improved the residual, every decision on
   the device), which also returns C·dz from its last operator pass; the
   ds/dλ pass and the step-ratio minima from that C·dz, with no read of
   C (``ip_pd_ds``);
4. σ = clamp((μ_aff/μ)³, 0, 1) from the predictor (``ip_pd_sigma``), and
   the update with the step lengths min(γ·α, 1) and the stats row
   (``ip_pd_update``).

So the step reads C once for pass 1, once per right-hand side and once
per operator application; H = Cᵀ(w ⊙ Cx) (+ Px) is applied with one read
of C (csrc/hop.cu, the counterpart of the TPU's ``_apply_h``,
interiorpoint_tpu/ops/pallas_pd.py:186-201).  The scalar glue (μ_aff, σ,
the clamps of αp and αd, the stats row) is computed in those kernels, so
a step is about twenty launches.  The
fp32 copies of C and P that the Gram reads are cast once per solve by
``prep_pd_consts``, as the TPU path splits C into its double-float words
once per solve (pallas_newton.py:prep_reduced_consts).  The resident/
stream split and the VMEM size gates of the TPU kernel do not carry over.

``pd_step`` launches the CUDA kernels for CUDA tensors and calls
``pd_step_plain`` (the same orchestration over plain PyTorch versions:
fp32 Gram, factor and inverse, fp64 everything else, the refined solve of
ops/refine.py with its host reads) for CPU tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..kernels import _build
from .chol import (PLAIN_BLK, cuda_block, factor_cuda, factor_plain,
                   invert_cuda, invert_plain, padded, w_solve_cuda,
                   w_solve_plain)
from .hybrid import precond_apply_plain
from .refine import exit_rel2_of, factor_inverse_device, refined_solve

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


# Device tallies of the refined solves (csrc/hop.cu): operator passes,
# refinement rounds, PCG rounds, solves; one int32 tensor per device, read
# by the checks, never by the step.
TALLY = {}


def tally(device):
    key = str(device)
    if key not in TALLY:
        TALLY[key] = torch.zeros(4, dtype=torch.int32, device=device)
    return TALLY[key]


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
    def pass1(C, z, s, lam, d, q, P):
        k, r = C.shape
        rp, inv_s, w = _empty(k, C), _empty(k, C), _empty(k, C)
        rd = _empty(r, C)
        gap, rpn, rdn = _empty((), C), _empty((), C), _empty((), C)
        _build.launch("ip_pd_pass1", C, z, s, lam, d, q, P, rp, inv_s, w, rd,
                      _ws("ip_pd_ws_bytes", k, r, C), gap, rpn, rdn, k, r)
        return rp, inv_s, w, gap, rpn, rd, rdn

    @staticmethod
    def rhs(C, s, lam, rp, inv_s, ds, dl, sig_mu, use_corr, rd):
        k, r = C.shape
        rc, t, b = _empty(k, s), _empty(k, s), _empty(r, s)
        _build.launch("ip_pd_rhs", C, s, lam, rp, inv_s,
                      ds if use_corr else s, dl if use_corr else s,
                      sig_mu, int(use_corr), rd, rc, t,
                      _ws("ip_pd_ws_bytes", k, r, C), b, k, r)
        return rc, t, b

    @staticmethod
    def ds_pass(cdz, rp, rc, lam, s, inv_s):
        k = s.shape[0]
        ds, dl = _empty(k, s), _empty(k, s)
        ap, ad = _empty((), s), _empty((), s)
        _build.launch("ip_pd_ds", cdz, rp, rc, lam, s, inv_s, ds, dl,
                      _ws("ip_pd_ws_bytes", k, 1, s), ap, ad, k)
        return ds, dl, ap, ad

    @staticmethod
    def sigma(s, lam, ds, dl, ap, ad, gap):
        k = s.shape[0]
        sigma, sig_mu = _empty((), s), _empty((), s)
        _build.launch("ip_pd_sigma", s, lam, ds, dl, ap, ad, gap,
                      _ws("ip_pd_ws_bytes", k, 1, s), sigma, sig_mu, k)
        return sigma, sig_mu

    @staticmethod
    def update(s, lam, ds, dl, ap, ad, z, dz, pdz, sigma, srn2, sbn2, gap,
               rpn, rdn):
        k, r = s.shape[0], z.shape[0]
        s2, lam2, z2 = _empty(k, s), _empty(k, s), _empty(r, s)
        stats = _empty(12, s)
        _build.launch("ip_pd_update", s, lam, ds, dl, ap, ad, z, dz, pdz,
                      sigma, srn2, sbn2, gap, rpn, rdn, s2, lam2, z2,
                      _ws("ip_pd_ws_bytes", k, r, s), stats, k, r)
        return z2, s2, lam2, stats

    @staticmethod
    def p_matvec(P, x):
        return _Cuda.c_matvec(P, x)

    @staticmethod
    def h_apply(M, wt, x, P=None):
        """(Mᵀ(wt ⊙ Mx) (+ P x), M x): one read of M (csrc/hop.cu)."""
        m, r = M.shape
        out, mx = _empty(r, M), _empty(m, M)
        _build.launch("ip_h_apply", M, wt, x, P, mx,
                      _ws("ip_h_ws_bytes", m, r, M), out, m, r)
        return out, mx

    @staticmethod
    def refined_solve(M, wt, P, W, dsc, b, refine, stall_rel2, kind=None,
                      X=None, ldl=None):
        """The refined solve of (Mᵀdiag(wt)M (+ P)) x = b on the fp32
        preconditioner (W, dsc), one cooperative launch (csrc/hop.cu).
        With ``kind`` (a 0-dim int32 device flag, K2's) the kernel reads
        it at launch and, where it is 1, applies the dense fp32 X (x ↦ Xᵀx
        on the leading r), where 2, the block-LDL factor ``ldl`` = (Lt,
        Dinv) by its tile sweeps, in place of the W-solve.  Returns (x,
        rn2, bn2, M·x, counts): counts an int32 device tensor [rounds,
        stalled, PCG rounds, PCG kept]."""
        m, r = M.shape
        Lt = Dinv = lv = None
        if kind is not None:
            if X is None or ldl is None or X.dtype != torch.float32 or \
                    X.stride(1) != 1 or min(X.shape) < r:
                raise ValueError("refined_solve: kind takes an fp32 X "
                                 "holding r x r with unit column stride "
                                 "and the LDL factor")
            Lt, Dinv = ldl
            lv = torch.empty(3 * Lt.shape[0], dtype=torch.float32,
                             device=b.device)
        x, mx = _empty(r, b), _empty(m, b)
        rn2, bn2 = _empty((), b), _empty((), b)
        counts = torch.empty(4, dtype=torch.int32, device=b.device)
        _build.launch("ip_refined_solve", M, wt, P, W, W.stride(0), kind, X,
                      0 if X is None else X.stride(0), Lt, Dinv,
                      0 if Lt is None else Lt.shape[0], lv, dsc, b,
                      int(refine), float(stall_rel2),
                      exit_rel2_of(stall_rel2), x, mx, rn2, bn2, counts,
                      tally(b.device),
                      _ws("ip_refined_solve_ws_bytes", m, r, b), m, r)
        return x, rn2, bn2, mx, counts

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
    def factor(Hs, delta, out=None, after=None, bad=None):
        return factor_cuda(Hs, Hs.shape[0], Hs.shape[0], delta, out=out,
                           after=after, bad=bad)

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
    def pass1(C, z, s, lam, d, q, P):
        rp = C @ z + s - d
        inv_s = 1.0 / s
        rd = q + C.T @ lam
        if P is not None:
            rd = rd + P @ z
        return (rp, inv_s, lam * inv_s, (s * lam).sum(), rp.abs().amax(), rd,
                rd.abs().amax())

    @staticmethod
    def rhs(C, s, lam, rp, inv_s, ds, dl, sig_mu, use_corr, rd):
        rc = s * lam if sig_mu is None else s * lam - sig_mu
        if use_corr:
            rc = rc + ds * dl
        t = (rc - lam * rp) * inv_s
        return rc, t, -rd + C.T @ t

    @staticmethod
    def ds_pass(cdz, rp, rc, lam, s, inv_s):
        ds = -rp - cdz
        dl = (-rc - lam * ds) * inv_s
        inf = torch.full_like(ds, float("inf"))
        ap = torch.where(ds < 0, -s / torch.where(ds < 0, ds, -1.0), inf)
        ad = torch.where(dl < 0, -lam / torch.where(dl < 0, dl, -1.0), inf)
        return (ds, dl, torch.clamp(ap.amin(), max=1.0),
                torch.clamp(ad.amin(), max=1.0))

    @staticmethod
    def sigma(s, lam, ds, dl, ap, ad, gap):
        k = s.shape[0]
        mu = gap / k
        mu_aff = ((s + ap * ds) * (lam + ad * dl)).sum() / k
        ratio = torch.clamp(mu_aff, min=0.0) / torch.clamp(mu, min=1e-30)
        sigma = torch.clamp(ratio ** 3, 0.0, 1.0)
        return sigma, sigma * mu

    @staticmethod
    def update(s, lam, ds, dl, ap, ad, z, dz, pdz, sigma, srn2, sbn2, gap,
               rpn, rdn):
        ap = torch.clamp(_GAMMA * ap, max=1.0)
        ad = torch.clamp(_GAMMA * ad, max=1.0)
        s2 = s + ap * ds
        lam2 = lam + ad * dl
        rdn2 = (1.0 - ad) * rdn
        if pdz is not None:
            rdn2 = rdn2 + (ap - ad).abs() * pdz.abs().amax()
        stats = torch.stack([(s2 * lam2).sum(), (1.0 - ap) * rpn, rdn2, ap,
                             ad, sigma, srn2, sbn2, gap, rpn, rdn,
                             torch.zeros_like(gap)])
        return z + ap * dz, s2, lam2, stats

    @staticmethod
    def p_matvec(P, x):
        return P @ x

    @staticmethod
    def h_apply(M, wt, x, P=None):
        mx = M @ x
        hx = M.T @ (wt * mx)
        return (hx if P is None else hx + P @ x), mx

    # forms 1 and 2 of the preconditioner on one vector (a subclass may
    # take the CUDA solve's own, hybrid.precond_apply_cuda)
    precond_apply = staticmethod(precond_apply_plain)

    @classmethod
    def refined_solve(cls, M, wt, P, W, dsc, b, refine, stall_rel2,
                      kind=None, X=None, ldl=None):
        """ops/refine.py ``refined_solve`` on the operator ``h_apply`` and
        the fp32 W-solve (or, where ``kind`` is 1, x ↦ Xᵀx; where 2, the
        LDL factor's solve: ``precond_apply``), with ``ip_refined_solve``'s
        outputs: M·x of the returned x from the last application to it
        (zeros when x = 0 was never applied) and the counts as an int32
        tensor."""
        r = b.shape[0]
        applied = []
        form = 0 if kind is None else int(kind)

        def precond(v):
            v = v.to(torch.float32)
            v = (cls.precond_apply(form, X, ldl, v) if form else
                 w_solve_plain(W, v))
            return v.to(torch.float64)

        def apply_h(x):
            hx, mx = _Plain.h_apply(M, wt, x, P)
            applied.append((x, mx))
            return hx

        c = {}
        x, rn2, bn2 = refined_solve(precond, apply_h,
                                    dsc[:r].to(torch.float64), b, refine,
                                    stall_rel2, counts=c)
        mx = next((m for xa, m in reversed(applied) if xa is x), None)
        if mx is None:
            mx = torch.zeros(M.shape[0], dtype=b.dtype, device=b.device)
        counts = torch.stack([torch.as_tensor(c[key], dtype=torch.int32,
                                              device=b.device)
                              for key in ("rounds", "stalled", "pcg_rounds",
                                          "pcg_kept")])
        return x, rn2, bn2, mx, counts

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
    def factor(Hs, delta, out=None, after=None, bad=None):
        return factor_plain(Hs, Hs.shape[0], Hs.shape[0], delta, out=out,
                            after=after, bad=bad)

    invert = staticmethod(invert_plain)
    w_solve = staticmethod(w_solve_plain)


# ---------------------------------------------------------------------------
# Orchestration shared by both backends
# ---------------------------------------------------------------------------

def _pd_step(ops, cs: PDConsts, q, z, s, lam, refine: int,
             stall_rel2: float, record=None):
    C = cs.C

    # pass 1: rp, 1/s, w = λ/s, gap, ‖rp‖∞; rd = q + Cᵀλ (+ P z), ‖rd‖∞
    rp, inv_s, w, gap, rpn, rd, rdn = ops.pass1(C, z, s, lam, cs.d, q, cs.P)

    # fp32 preconditioner: Gram, equilibration, jittered factor, W = L⁻¹
    W, dsc, delta = factor_inverse_device(ops, ops.gram(cs.C32, w, cs.P32))

    def direction(sig_mu, prev):
        """dz, ds, dλ, the step-ratio minima clamped to 1, and the solve's
        srn2, sbn2 (sig_mu None: σμ = 0)."""
        use_corr = prev is not None
        ds_p, dl_p = prev if use_corr else (None, None)
        rc, _, b = ops.rhs(C, s, lam, rp, inv_s, ds_p, dl_p, sig_mu,
                           use_corr, rd)
        dz, srn2, sbn2, cdz, counts = ops.refined_solve(
            C, w, cs.P, W, dsc, b, refine, stall_rel2)
        if record is not None:
            record.append({"delta": delta, "counts": counts})
        ds, dl, ap, ad = ops.ds_pass(cdz, rp, rc, lam, s, inv_s)
        return dz, ds, dl, ap, ad, srn2, sbn2

    # predictor (σ = 0), then σ = clamp((μ_aff/μ)³, 0, 1) on the device
    _, ds_a, dl_a, ap_a, ad_a, _, _ = direction(None, None)
    sigma, sig_mu = ops.sigma(s, lam, ds_a, dl_a, ap_a, ad_a, gap)
    # corrector (same factor)
    dz, ds, dl, ap, ad, srn2, sbn2 = direction(sig_mu, (ds_a, dl_a))
    # the step lengths min(γ·α, 1), the update and the stats row: rp and
    # (LP) rd contract exactly by (1−α); QP adds (αp−αd)·P dz
    pdz = None if cs.P is None else ops.p_matvec(cs.P, dz)
    return ops.update(s, lam, ds, dl, ap, ad, z, dz, pdz, sigma, srn2, sbn2,
                      gap, rpn, rdn)


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
            dir_tol: float = 1e-6, record=None):
    """One fused primal-dual iteration.

    Returns (z', s', λ', stats) with stats (fp64, 12) =
    [gap', rp'∞, rd'∞, αp, αd, σ, srn2, sbn2, gap, rp∞, rd∞, 0]: primed
    entries are post-step (rp'/rd' by (1−α)-contraction bookkeeping),
    unprimed the exact pre-step values; srn2/sbn2 are the corrector
    solve's squared residual and right-hand side in the equilibrated
    metric.  CUDA tensors launch the kernels; CPU tensors take
    ``pd_step_plain``.  ``record`` (a list, for checks) receives one entry
    per direction: the factor's jitter δ and the solve's counts [rounds,
    stalled, PCG rounds, PCG kept] (device tensors)."""
    _check(cs, q, z, s, lam)
    kind = cs.C.device.type
    if kind == "cpu":
        return pd_step_plain(cs, q, z, s, lam, refine=refine,
                             dir_tol=dir_tol, record=record)
    if kind != "cuda":
        raise ValueError(f"pd_step: unsupported device {cs.C.device}")
    out = _pd_step(_Cuda, cs, q, z, s, lam, refine, float(dir_tol) ** 2,
                   record)
    pd_step.launches += 1
    return out


def pd_step_plain(cs: PDConsts, q, z, s, lam, *, refine: int = 3,
                  dir_tol: float = 1e-6, record=None):
    """Plain PyTorch version of ``pd_step`` (same control flow)."""
    pd_step_plain.calls += 1
    return _pd_step(_Plain, cs, q, z, s, lam, refine, float(dir_tol) ** 2,
                    record)


pd_step.launches = 0
pd_step_plain.calls = 0
