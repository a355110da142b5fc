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
H·x = Cᵀ(w ⊙ Cx) + tP x with the PCG escalation: one cooperative launch
of csrc/hop.cu ``ip_refined_solve`` (M = C, wt = w, P = tP), K1's rules.
The preconditioner is the TPU kernel's: with a carry (``NSCarry``,
r ≤ 512) the last step's X ≈ Hs⁻¹ refreshed by Newton–Schulz, taken when
it reaches ‖I − Hs·X‖²_F < 1e-4 (a hit: no factor this step); otherwise
``_factor_hybrid``: the block-LDL factor with Newton–Schulz tile inverses
at jitter 0 and 1e-6, and, when both miss, the jittered blocked Cholesky
with W = L⁻¹, its first rung failed by a pivot floor (ops/refine.py
``pivot_floor2``) as well as by finiteness.  A miss re-seeds the carry
with the factor's solve applied to I (WᵀW after the fallback), and the
step is preconditioned by that re-seed, as the TPU kernel's solve reads
``minvout`` on every branch (pallas_newton.py:686-701).

Every decision of a step is taken on the device, so a step is a fixed
sequence of launches with no host read (``preconditioner``): each launch
reads the flags the launches before it wrote and skips itself outside
its branch (the LDL rungs after a hit or an earlier rung's success, the
re-seed, the fallback's ladder, inverse and WᵀW), the branch itself comes
from ``ip_k2_decide``, and the refined solve reads the form (X or W) at
launch.  The engine's one read per step (ops/newton.py) carries the
branch and the solve's counts in the stats row, and ``tally`` fills
``COUNTS`` from it.
The sweep (``ip_nt_sweep``) takes u = (C dx)/s and, for every candidate,
Σᵢ φ(σⱼuᵢ) with φ(y) = −log(1−y) − y in a cancellation-free form, and
max u; it accepts the first (largest) σⱼ with σⱼ·max u < 1 − 1e-6 and
σⱼ(1−α)·g·dx + σⱼ²·q2 + Σφ ≤ 0, q2 = ½·dxᵀ tP dx.  C·dx comes from the
last operator pass, as the TPU kernel reads it from a side channel
(pallas_newton.py:703-737): ``ip_refined_solve`` returns M·x of the
returned x on every exit (the PCG's M·x2 where it is kept, zeros where
x = 0 was never applied).

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

Stats row (fp64, 17): the TPU's 9-entry row with the Newton decrement as
one value, then dir_ok, the candidate index and the pre-step min slack,
then the preconditioner's branch (0 carry hit, 1 LDL rung 0, 2 LDL rung
1, 3 + i the Cholesky fallback at jitter rung i), whether the carry was
tried, and the solve's counts:
``[nd, σ, any_acc, rn2, g·dx, bn2, q2, ns_hit, dir_ok, j, min s, branch,
trial, rounds, stalled, PCG rounds, kept]`` (indices ``ST_*``), read by
the engine in one host read.

``newton_step``/``newton_dir`` launch the CUDA kernels for CUDA tensors,
call their ``*_plain`` twins (the same orchestration over plain PyTorch
pieces) for CPU tensors, and raise on any other device.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Optional

import torch

from . import hybrid, pd_step
from .chol import pivot_floor_cuda, pivot_floor_plain
from .hybrid import DEC_BRANCH, DEC_FALLBACK, DEC_KIND, DEC_RESEED, DEC_SKIP1
from .pd_step import _empty, _ws
from .refine import FACTOR_JITTERS, factor_jittered_device
from ..kernels import _build

(ST_ND, ST_SIGMA, ST_ANY, ST_RN2, ST_GDX, ST_BN2, ST_Q2, ST_NS_HIT,
 ST_DIR_OK, ST_INDEX, ST_SMIN, ST_BRANCH, ST_TRIAL, ST_ROUNDS, ST_STALLED,
 ST_PCG, ST_KEPT) = range(17)
N_STATS = 17
# the preconditioner's branches as ST_BRANCH numbers them (3 + i: the
# Cholesky fallback at its jitter rung i)
BRANCHES = ("carry_hits", "ldl_rung0", "ldl_rung1", "cholesky_fallback")
# Domain margin of the sweep: σ·max u < 1 − _DOMAIN_MARGIN
# (pallas_newton.py:_newton_step_kernel).
_DOMAIN_MARGIN = 1e-6
# φ's series coefficients 1/(m+2), m = 0..15 (csrc/rows.cu ip_phi).
_PHI_COEF = tuple(1.0 / (m + 2) for m in range(16))
# per step, from its stats row (``tally``): carry trials and hits, the LDL
# rung taken or the Cholesky fallback (and its jitter rung), the refined
# solve's counts
COUNTS: Counter = Counter()


def tally(vals) -> None:
    """Fill ``COUNTS`` from one step's stats row as the host read it (a
    list of floats; ops/newton.py's one read per step)."""
    branch = int(vals[ST_BRANCH])
    COUNTS["carry_trials"] += int(vals[ST_TRIAL])
    COUNTS[BRANCHES[min(branch, 3)]] += 1
    if branch >= 3:
        COUNTS["fallback_rung%d" % (branch - 3)] += 1
    COUNTS["solve_rounds"] += int(vals[ST_ROUNDS])
    COUNTS["solve_stalled"] += int(vals[ST_STALLED])
    COUNTS["pcg_rounds"] += int(vals[ST_PCG])
    COUNTS["pcg_kept"] += int(vals[ST_KEPT])


@dataclasses.dataclass
class NSCarry:
    """The cross-step preconditioner carry of K2 (the TPU kernel's
    ``minv``/``mvok``): X ≈ Hs⁻¹ of the previous step (fp32, padded
    np × np), ``ok`` once X holds a seed (False at a solve's first
    step).  Two buffers take turns: a step reads X and writes the other,
    ``spare``, in whichever branch it takes on the device."""
    X: Optional[torch.Tensor] = None
    ok: bool = False
    spare: Optional[torch.Tensor] = None

    def out(self, like: torch.Tensor) -> torch.Tensor:
        """The buffer this step writes (the spare, made at first use)."""
        if self.spare is None or self.spare.shape != like.shape or \
                self.spare.device != like.device:
            self.spare = torch.empty_like(like)
        return self.spare

    def advance(self) -> None:
        """The buffer written becomes X."""
        self.X, self.spare = self.spare, self.X
        self.ok = True


@dataclasses.dataclass
class Precond:
    """A step's fp32 preconditioner as the refined solve takes it: the
    form ``kind`` (int32 device scalar: 1 the dense X, 2 the LDL factor's
    sweeps, 0 the W-solve), W = L⁻¹ of the fallback, X (np × np), the LDL
    factor (Lt, Dinv), the padded equilibration ``dsc``, the branch
    (int64 device scalar, ``ST_BRANCH``'s numbering) and whether the
    carry was tried (host)."""
    kind: torch.Tensor
    W: torch.Tensor
    X: torch.Tensor
    ldl: tuple
    dsc: torch.Tensor
    branch: torch.Tensor
    trial: bool


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
    gram_tn = staticmethod(hybrid.gram_tn_cuda)
    decide = staticmethod(hybrid.decide_cuda)
    pivot_floor = staticmethod(pivot_floor_cuda)


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

    ldl_factor = staticmethod(hybrid.ldl_factor_plain)
    ldl_solve = staticmethod(hybrid.ldl_solve_plain)
    ns_refresh = staticmethod(hybrid.ns_refresh_plain)
    gram_tn = staticmethod(hybrid.gram_tn_plain)
    decide = staticmethod(hybrid.decide_plain)
    pivot_floor = staticmethod(pivot_floor_plain)


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


def preconditioner(ops, H32, carry: Optional[NSCarry] = None) -> Precond:
    """The fp32 preconditioner of H32 (``_direction_core``'s, module
    docstring), every branch decided on the device: the carry trial (when
    the carry holds a seed, known on the host), the LDL rungs (each
    skipped after a hit or an earlier rung's success), the branch
    (``decide``), the re-seed M⁻¹I after an LDL rung, the Cholesky
    fallback's ladder with the pivot floor on its first rung, its inverse
    W and, with a carry, the re-seed WᵀW, each running only in its branch.
    With a carry every branch leaves its X in the carry's spare buffer
    (the refreshed X, M⁻¹I or WᵀW), which becomes the carry's X and the
    step's preconditioner; without one the step applies an LDL rung's
    factor by its tile sweeps, or the fallback's W.  Plain twins read the
    flags on the host.  Returns a ``Precond``."""
    Hs, dsc = ops.equilibrate(H32, hybrid.LDL_BLK)
    np_, dev = Hs.shape[0], Hs.device
    # without a carry no branch forms an X: the solve never reads it
    X = Hs if carry is None else carry.out(Hs)
    trial = carry is not None and carry.ok
    hit = ops.ns_refresh(Hs, carry.X, out=X)[1] if trial else None
    fac = (torch.empty_like(Hs),
           torch.empty((np_, hybrid.LDL_BLK), dtype=Hs.dtype, device=dev))
    _, _, bad0 = ops.ldl_factor(Hs, hybrid.LDL_JITTERS[0], hit, out=fac)
    dec = ops.decide(hit, bad0, None, carry is not None)
    _, _, bad1 = ops.ldl_factor(Hs, hybrid.LDL_JITTERS[1], dec[DEC_SKIP1],
                                out=fac)
    ops.decide(hit, bad0, bad1, carry is not None, dec)
    if carry is not None:
        ops.ldl_solve(*fac, hybrid.eye(np_, dev), after=dec[DEC_RESEED],
                      out=X)
    bads = torch.zeros(len(FACTOR_JITTERS), dtype=torch.int32, device=dev)
    fallback = dec[DEC_FALLBACK]
    L, Dinv, _ = factor_jittered_device(ops, Hs, pivot_floor=True,
                                        after=fallback, bads=bads)
    W = ops.invert(L, Dinv, after=fallback)
    if carry is not None:
        ops.gram_tn(W, after=fallback, out=X)
        carry.advance()
    return Precond(kind=dec[DEC_KIND], W=W, X=X, ldl=fac, dsc=dsc,
                   branch=dec[DEC_BRANCH] + bads[:-1].sum(), trial=trial)


def _solve_dir(ops, cs: NTConsts, w, g, tP, tP32, refine: int,
               stall_rel2: float, carry: Optional[NSCarry] = None):
    """The fp32 preconditioner of H = Cᵀ diag(w) C (+ tP) and the refined
    solve of H dx = −g (one launch on the card).  Returns (dx, rn2, bn2,
    cdx, pre, counts): cdx = C·dx from the solve's last operator pass,
    ``pre`` the ``Precond``, counts the solve's [rounds, stalled, PCG
    rounds, kept] (int32)."""
    pre = preconditioner(ops, ops.gram(cs.C32, w, tP32), carry)
    dx, rn2, bn2, cdx, counts = ops.refined_solve(
        cs.C, w, tP, pre.W, pre.dsc, -g, refine, stall_rel2, kind=pre.kind,
        X=pre.X, ldl=pre.ldl)
    return dx, rn2, bn2, cdx, pre, counts


def _direction(ops, cs: NTConsts, tc, z, tP, tP32, refine: int,
               stall_rel2: float, carry: Optional[NSCarry] = None):
    """Slacks, gradient, fp32 preconditioner and the refined dx."""
    g, inv_s, w, smin = _gradient(ops, cs, tc, z, tP)
    dx, rn2, bn2, cdx, pre, counts = _solve_dir(ops, cs, w, g, tP, tP32,
                                                refine, stall_rel2, carry)
    return dx, g, rn2, bn2, inv_s, smin, cdx, pre, counts


def _newton_step(ops, cs: NTConsts, tc, z, tP, tP32, sig, alpha: float,
                 refine: int, stall_rel2: float,
                 carry: Optional[NSCarry] = None):
    dx, g, rn2, bn2, inv_s, smin, cdx, pre, counts = _direction(
        ops, cs, tc, z, tP, tP32, refine, stall_rel2, carry)
    gdx = g @ dx
    q2 = (0.5 * (dx @ ops.p_matvec(tP, dx)) if tP is not None
          else torch.zeros_like(gdx))
    _, _, sel, xnew = ops.sweep(cdx, inv_s, sig, gdx, q2, alpha, z, dx)
    f64 = gdx.dtype
    dir_ok = (rn2 <= 1e-4 * bn2 + 1e-30).to(f64)
    zero = torch.zeros_like(gdx)
    stats = torch.cat([
        torch.stack([-0.5 * gdx, sel[0], sel[2], rn2, gdx, bn2, q2,
                     (pre.branch == 0).to(f64), dir_ok, sel[1], smin,
                     pre.branch.to(f64), zero + float(pre.trial)]),
        counts.to(f64)])
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
