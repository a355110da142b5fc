"""One SOCP barrier Newton step (K4) on the pure-cone subproblem

    min_z  t·(qᵀz + ½ zᵀP z) − Σₖ log(rhsₖ² − ‖lhsₖ‖²),
    lhsₖ = Aₖ z + bₖ,   rhsₖ = cₖᵀz + dₖ          (P = None: no quadratic)

Counterpart of interiorpoint_tpu/ops/pallas_socp.py
(``socp_newton_step_prepared``, the TPU kernel ``_socp_step_kernel`` and
its ``_socp_core``, pallas_call at :441), and of the shapes the JAX package
routes to ``xl_step.socp_newton_step_xla``: one K4 regime, no size gate.

The step, with w = 2/(s + ε) and Gₖ = Aₖᵀlhsₖ − rhsₖcₖ, a short chain of
launches with no host read inside the step:
* pass 1 over the stacked (K·M, r) fp64 matrix A (csrc/cones.cu
  ``ip_socp_pass1``): lhs, the per-cone Σ lhs², rhs, s = rhs² − Σ lhs², w,
  the per-row weights w_row and the cone-min of s;
* the segmented Aᵀ pass (``ip_socp_gcone``): G (K, r) in fp64 and the
  gradient's cone term Σₖ wₖGₖ = A_flatᵀ(w_row ⊙ lhs) − cᵀ(w ⊙ rhs), with no
  second pass over A; g = t·q (+ tP z) + Σₖ wₖGₖ;
* the Hessian is one weighted Gram of the stacked matrix
  M = [A; c; G] ((K·M + 2K) × r: ``prep_socp_consts`` allocates A with 2K
  spare rows, c in the first K, and each step writes G into the last K)
  with the weights wt = [w_row; w; w²]:
  H = Mᵀdiag(wt)M (+ tP) = tP + Σₖ wₖ(AₖᵀAₖ + cₖcₖᵀ) + Σₖ(wₖGₖ)(wₖGₖ)ᵀ.
  Its fp32 preconditioner is one Gram launch on the fp32 copy of M
  (+ tP32, csrc/gram.cu), then the equilibration, the jittered blocked
  Cholesky with the ladder on the device and W = L⁻¹ (ops/refine.py
  ``factor_inverse_device``, csrc/chol.cu, as K1);
* the refined solve of H dx = −g with the PCG escalation, in one
  cooperative launch (csrc/hop.cu ``ip_refined_solve``, the rules of
  ops/refine.py), against the fp64 operator Mᵀ(wt ⊙ Mx) (+ tP x) applied
  with one read of M; its last operator pass gives M·dx: A dx (the first
  K·M entries) and c·dx (the next K);
* the line-search coefficients (``ip_socp_lscoef``) from A dx, with no
  read of A: ip1ₖ = Σ lhs·(A dx), ip2ₖ = Σ (A dx)²;
* the closed-form cone sweep (``ip_socp_sweep``): a = p1/(s+ε),
  b = p2/(s+ε), v = (c·dx)/rhs with p1 = 2(rhs·c·dx − ip1),
  p2 = (c·dx)² − ip2; for every candidate σⱼ, u = σa + σ²b, the domain test
  min u > 10⁻⁶ − 1 and min σv > 10⁻⁶ − 1, and Armijo on
  σ(1−α)·g·dx + σ²(q2 − Σb) + Σφ(−u) ≤ 0 with φ(y) = −log(1−y) − y in the
  16-term series form of K2's sweep, q2 = ½·dxᵀ tP dx; the first (largest)
  accepted σ and x' = z + σ·dx.

Cones are contiguous M-row blocks of A, so on the GPU a row's cone is
row // M: the TPU kernel's 0/1 membership matrix E (pallas_socp.py:388-390)
and its matmuls are not needed.

Differences from the TPU kernel, by design:
* fp64 throughout, fp32 only in the preconditioner (ops/pd_step.py gives
  the reason), so the sweep is fp64 where the TPU's is f32;
* the refinement's operator keeps G in fp64 (the stacked M's last rows).  The TPU kernel puts its f32
  G32 inside its dd operator (pallas_socp.py:38-44), a TPU compromise about
  1e-7 from the oracle's Hessian; the port solves the oracle's own Hessian
  (ops/socp.py ``hess``);
* the preconditioner is the blocked Cholesky and its inverse, as in K1;
  the TPU's VMEM gate (``supported``: K ≤ 128,
  rp ≤ 1536) and its XLA fallback do not carry over.

Stats row (fp64, 11): the same as K2's, ``[nd, σ, any_acc, rn2, g·dx,
bn2, q2, ns_hit (0), dir_ok, j, min s]`` (indices ``ST_*`` of
ops/newton_step.py), so the engine (ops/newton.py) treats both steps
alike.

``socp_newton_step`` launches the CUDA kernels for CUDA tensors, calls
``socp_newton_step_plain`` (the same orchestration over plain PyTorch
pieces) for CPU tensors, and raises on any other device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import pd_step
from .barrier import SOCP_SLACK_EPS
from .newton_step import _DOMAIN_MARGIN, _tp32, phi, pick_first
from .pd_step import _empty, _ws
from .refine import factor_inverse_device
from ..kernels import _build


@dataclasses.dataclass(frozen=True)
class SOCPConsts:
    """Per-solve constants of the step: the stacked cone matrix A
    (K·M, r) in fp64 and its fp32 copy that the Gram reads, b (K·M), c
    (K, r) and d (K) in fp64, and the rows per cone M.  A and A32 are the
    leading K·M rows of ``Ast``/``Ast32`` ((K·M + 2K, r), made here when
    not given): c in the next K rows, and each step's G in the last K
    (``_gradient``)."""
    A: torch.Tensor
    A32: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    d: torch.Tensor
    M: int
    Ast: Optional[torch.Tensor] = None
    Ast32: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.Ast is not None:
            return
        km, r = self.A.shape
        K = self.c.shape[0]
        Ast = torch.zeros((km + 2 * K, r), dtype=self.A.dtype,
                          device=self.A.device)
        Ast32 = torch.zeros((km + 2 * K, r), dtype=torch.float32,
                            device=self.A.device)
        Ast[:km] = self.A
        Ast[km:km + K] = self.c
        Ast32[:km] = self.A32
        Ast32[km:km + K] = self.c
        for name, t in (("Ast", Ast), ("Ast32", Ast32), ("A", Ast[:km]),
                        ("A32", Ast32[:km])):
            object.__setattr__(self, name, t)

    @property
    def K(self) -> int:
        return self.c.shape[0]

    @property
    def r(self) -> int:
        return self.A.shape[1]


def prep_socp_consts(prob) -> SOCPConsts:
    """Flatten the (K, M, r) cone stack of an SOCPProblem once per solve
    into the stacked matrix with its 2K spare rows (and cast its fp32
    copy)."""
    K, M, r = prob.A.shape
    A = prob.A.reshape(K * M, r).contiguous()
    return SOCPConsts(A=A, A32=A.to(torch.float32),
                      b=prob.b.reshape(K * M).contiguous(),
                      c=prob.c.contiguous(), d=prob.d.contiguous(), M=M)


# ---------------------------------------------------------------------------
# The two backends: K1's pieces (ops/pd_step.py) plus the cone passes.
# ---------------------------------------------------------------------------

class _Cuda(pd_step._Cuda):
    @staticmethod
    def socp_pass1(A, z, b, c, d, M, wt):
        """wt (K·M + 2K, the stacked weights) receives w_row and w in its
        first K·M + K entries (the returned w_row and w are views of it)."""
        K, r = c.shape
        lhs = _empty(K * M, A)
        rhs, s = _empty(K, A), _empty(K, A)
        w_row, w = wt[:K * M], wt[K * M:K * M + K]
        smin = _empty((), A)
        _build.launch("ip_socp_pass1", A, z, b, c, d, lhs, rhs, s, w, w_row,
                      smin, K, M, r)
        return lhs, rhs, s, w, w_row, smin

    @staticmethod
    def socp_gcone(A, lhs, c, rhs, w, M, G):
        """G (written into ``G``, K × r) and Σₖ wₖGₖ."""
        K, r = c.shape
        wG = _empty(r, A)
        _build.launch("ip_socp_gcone", A, lhs, c, rhs, w,
                      _ws("ip_socp_ws_bytes", K, M, r, A), G, wG, K, M, r)
        return G, wG

    @staticmethod
    def socp_dots(g, dx, tpdx):
        gdx, q2 = _empty((), g), _empty((), g)
        _build.launch("ip_socp_dots", g, dx, tpdx, gdx, q2, g.shape[0])
        return gdx, q2

    @staticmethod
    def socp_stats(gdx, q2, rn2, bn2, sel, smin):
        st = _empty(11, gdx)
        _build.launch("ip_socp_stats", gdx, q2, rn2, bn2, sel, smin, st)
        return st

    @staticmethod
    def socp_lscoef(adx, lhs, M):
        K = lhs.shape[0] // M
        ip1, ip2 = _empty(K, lhs), _empty(K, lhs)
        _build.launch("ip_socp_lscoef", adx, lhs, ip1, ip2, K, M)
        return ip1, ip2

    @staticmethod
    def socp_sweep(ip1, ip2, cdx, rhs, s, sig, gdx, q2, alpha, z, dx):
        K, J, r = ip1.shape[0], sig.shape[0], z.shape[0]
        phisum, umin, vmin = _empty(J, z), _empty(J, z), _empty(J, z)
        sel, xnew = _empty(3, z), _empty(r, z)
        _build.launch("ip_socp_sweep", ip1, ip2, cdx, rhs, s, sig, J, gdx,
                      q2, float(alpha), z, dx, r,
                      _ws("ip_socp_sweep_ws_bytes", K, J, z), phisum, umin,
                      vmin, sel, xnew, K)
        return phisum, umin, vmin, sel, xnew


class _Plain(pd_step._Plain):
    @staticmethod
    def socp_pass1(A, z, b, c, d, M, wt):
        K = c.shape[0]
        lhs = A @ z + b
        rhs = c @ z + d
        s = rhs * rhs - (lhs.reshape(K, M) ** 2).sum(dim=1)
        w_row, w = wt[:K * M], wt[K * M:K * M + K]
        w.copy_(2.0 / (s + SOCP_SLACK_EPS))
        w_row.copy_(w.repeat_interleave(M))
        return lhs, rhs, s, w, w_row, s.amin()

    @staticmethod
    def socp_gcone(A, lhs, c, rhs, w, M, G):
        K, r = c.shape
        G.copy_(torch.einsum("kmr,km->kr", A.reshape(K, M, r),
                             lhs.reshape(K, M)) - rhs[:, None] * c)
        return G, w @ G

    @staticmethod
    def socp_dots(g, dx, tpdx):
        gdx = g @ dx
        return gdx, (0.5 * (dx @ tpdx) if tpdx is not None
                     else torch.zeros_like(gdx))

    @staticmethod
    def socp_stats(gdx, q2, rn2, bn2, sel, smin):
        dir_ok = (rn2 <= 1e-4 * bn2 + 1e-30).to(gdx.dtype)
        return torch.stack([-0.5 * gdx, sel[0], sel[2], rn2, gdx, bn2, q2,
                            torch.zeros_like(gdx), dir_ok, sel[1], smin])

    @staticmethod
    def socp_lscoef(adx, lhs, M):
        K = lhs.shape[0] // M
        adx = adx.reshape(K, M)
        return (lhs.reshape(K, M) * adx).sum(dim=1), (adx * adx).sum(dim=1)

    @staticmethod
    def socp_sweep(ip1, ip2, cdx, rhs, s, sig, gdx, q2, alpha, z, dx):
        ise = 1.0 / (s + SOCP_SLACK_EPS)
        a = 2.0 * (rhs * cdx - ip1) * ise
        b = (cdx * cdx - ip2) * ise
        v = cdx / rhs
        u = a[:, None] * sig[None, :] + b[:, None] * (sig * sig)[None, :]
        phisum = phi(-u).sum(dim=0)
        umin = u.amin(dim=0)
        vmin = (v[:, None] * sig[None, :]).amin(dim=0)
        accept = ((umin > _DOMAIN_MARGIN - 1.0)
                  & (vmin > _DOMAIN_MARGIN - 1.0)
                  & torch.isfinite(phisum)
                  & (sig * ((1.0 - alpha) * gdx)
                     + sig * sig * (q2 - b.sum()) + phisum <= 0.0))
        any_acc, j, sigma = pick_first(accept, sig)
        sel = torch.stack([sigma, j.to(sig.dtype), any_acc.to(sig.dtype)])
        return phisum, umin, vmin, sel, z + sigma * dx


# ---------------------------------------------------------------------------
# Orchestration shared by both backends
# ---------------------------------------------------------------------------

def _gradient(ops, cs: SOCPConsts, tq, z, tP, wt):
    """Pass 1 and the G pass: fill the stacked weights ``wt`` (K·M + 2K)
    with [w_row; w; w²] and the stacked matrix's last K rows (fp64 and
    fp32) with G.  Returns (g, pass 1's outputs)."""
    km, K = cs.K * cs.M, cs.K
    p1 = ops.socp_pass1(cs.A, z, cs.b, cs.c, cs.d, cs.M, wt)
    lhs, rhs, _, w, _, _ = p1
    G, wG = ops.socp_gcone(cs.A, lhs, cs.c, rhs, w, cs.M, cs.Ast[km + K:])
    cs.Ast32[km + K:].copy_(G)
    torch.mul(w, w, out=wt[km + K:])
    g = tq + wG
    if tP is not None:
        g = g + ops.p_matvec(tP, z)
    return g, p1


def _solve_dir(ops, cs: SOCPConsts, wt, g, tP, tP32, refine: int,
               stall_rel2: float, record=None):
    """The fp32 preconditioner of H = Mᵀ diag(wt) M (+ tP), M the stacked
    matrix [A; c; G] (G and the weights written by ``_gradient``),
    and the refined solve of H dx = −g.  Returns (dx, rn2, bn2, M·dx)."""
    W, dsc, delta = factor_inverse_device(ops, ops.gram(cs.Ast32, wt, tP32))
    dx, rn2, bn2, mdx, counts = ops.refined_solve(cs.Ast, wt, tP, W, dsc, -g,
                                                  refine, stall_rel2)
    if record is not None:
        record.append({"delta": delta, "counts": counts})
    return dx, rn2, bn2, mdx


def _socp_step(ops, cs: SOCPConsts, tq, z, tP, tP32, sig, alpha: float,
               refine: int, stall_rel2: float, record=None):
    km, K = cs.K * cs.M, cs.K
    # the stacked weights [w_row; w; w²], written by _gradient
    wt = torch.empty(km + 2 * K, dtype=z.dtype, device=z.device)
    g, (lhs, rhs, s, _, _, smin) = _gradient(ops, cs, tq, z, tP, wt)
    dx, rn2, bn2, mdx = _solve_dir(ops, cs, wt, g, tP, tP32, refine,
                                   stall_rel2, record)
    gdx, q2 = ops.socp_dots(g, dx, None if tP is None
                            else ops.p_matvec(tP, dx))
    ip1, ip2 = ops.socp_lscoef(mdx[:km], lhs, cs.M)
    sel, xnew = ops.socp_sweep(ip1, ip2, mdx[km:km + K], rhs, s, sig, gdx,
                               q2, alpha, z, dx)[3:]
    return xnew, ops.socp_stats(gdx, q2, rn2, bn2, sel, smin)


def _check(cs: SOCPConsts, tq, z, tP, tP32, sig):
    K, r, km = cs.K, cs.r, cs.K * cs.M
    f64, f32 = torch.float64, torch.float32
    want = [("A", cs.A, f64, (km, r)), ("A32", cs.A32, f32, (km, r)),
            ("Ast", cs.Ast, f64, (km + 2 * K, r)),
            ("Ast32", cs.Ast32, f32, (km + 2 * K, r)),
            ("b", cs.b, f64, (km,)), ("c", cs.c, f64, (K, r)),
            ("d", cs.d, f64, (K,)), ("tq", tq, f64, (r,)),
            ("z", z, f64, (r,))]
    if tP is not None:
        want += [("tP", tP, f64, (r, r)), ("tP32", tP32, f32, (r, r))]
    if sig.ndim != 1 or sig.shape[0] < 1:
        raise ValueError("socp_newton_step: sigmas must hold at least one "
                         "candidate")
    want.append(("sigmas", sig, f64, tuple(sig.shape)))
    for what, t, dtype, shape in want:
        if t.dtype != dtype or tuple(t.shape) != shape or \
                not t.is_contiguous() or t.device != cs.A.device:
            raise ValueError(f"socp_newton_step: {what} must be a contiguous "
                             f"{dtype} {shape} tensor on {cs.A.device}")
    kind = cs.A.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError("socp_newton_step: unsupported device "
                         f"{cs.A.device}")
    return kind


def socp_newton_step(cs: SOCPConsts, tq, z, tP, sigmas, *, alpha: float,
                     refine: int = 3, dir_tol: float = 1e-6, tP32=None,
                     record=None):
    """One SOCP Newton iteration: direction and cone line search.

    ``tq`` = t·q (r,) (zeros without q), ``z`` the iterate (strictly
    inside every cone), ``tP`` = t·P (r, r) or None and ``tP32`` its fp32
    copy (made here when not given: the engine casts it once per barrier
    stage), ``sigmas`` (J,) the candidates β^j.  Returns (x', stats),
    stats as in the module docstring.  ``record`` (a list, for checks)
    receives the factor's jitter δ and the solve's counts, as in
    ops/pd_step.py ``pd_step``."""
    tP32 = _tp32(tP, tP32)
    if _check(cs, tq, z, tP, tP32, sigmas) == "cpu":
        return socp_newton_step_plain(cs, tq, z, tP, sigmas, alpha=alpha,
                                      refine=refine, dir_tol=dir_tol,
                                      tP32=tP32, record=record)
    out = _socp_step(_Cuda, cs, tq, z, tP, tP32, sigmas, alpha, refine,
                     float(dir_tol) ** 2, record)
    socp_newton_step.launches += 1
    return out


def socp_newton_step_plain(cs: SOCPConsts, tq, z, tP, sigmas, *,
                           alpha: float, refine: int = 3,
                           dir_tol: float = 1e-6, tP32=None, record=None):
    """Plain PyTorch version of ``socp_newton_step`` (same control flow)."""
    socp_newton_step_plain.calls += 1
    return _socp_step(_Plain, cs, tq, z, tP, _tp32(tP, tP32), sigmas, alpha,
                      refine, float(dir_tol) ** 2, record)


socp_newton_step.launches = 0
socp_newton_step_plain.calls = 0
