"""Primal-dual Mehrotra predictor-corrector engine for LP/QP (counterpart
of interiorpoint_tpu/ops/pd.py) on the inequality form

    min ½ zᵀP z + qᵀz   s.t.   C z ≤ d        (P = None for LP)

* ``pd_solve_fused``: the driver loop around one step of ops/pd_step.py
  (K1) per iteration, with the JAX driver's contract: the Mehrotra slack
  shift start, the ε-derived direction gate ``dir_stall_tol(ε, cap=3e-5)``,
  the keep-old-on-(bad | certify) rollback, the ``solve_ok`` gate
  srn2 ≤ 1e-8·sbn2 + 1e-30, the exact pre-step certificate from the next
  step's pass 1, and the stall test.  Each iteration reads the 12-entry
  stats row to the host once (ops/sync.py).
* ``pd_solve``: dispatch, and the eager engine (the counterpart of the
  JAX package's XLA engine) for an equality pair (A, b), for
  ``use_pallas=False`` or for ``mixed_precision=False``: the fp64 Gram
  H = Cᵀdiag(λ/s)C (+P) with ``torch.matmul`` (an XLA product in the JAX
  package too), then per direction either the dense-KKT direction K5
  (ops/kkt_step.py, A as its equality block, H symmetrised and handed
  over in the exact augmented-Lagrangian form H + ρAᵀA, factored once per
  iteration in fp64 for the predictor, the corrector and the directions
  on the residual while they stall: ``kkt_step.augment``,
  ``kkt_prepare`` and ``kkt_solve``, the port's repair of the
  reference, ROADMAP.md §3)
  or the Schur block elimination over ops/kkt.py ``posdef_solver``
  (S = A·H⁻¹Aᵀ, both factors reused by the predictor and the corrector).

Dispatch mirrors the JAX package with its TPU test replaced by "always":
equality-free, mixed-precision fp64 and ``use_pallas`` go to
``pd_solve_fused`` on every device (kernels on the GPU, their plain
versions on the CPU); with equalities the same switches (or
``kkt_kernel=True``) send every direction through K5.  There are no VMEM
size gates: on Hopper the only limit is device memory.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import sync
from .kkt import posdef_solver
from .kkt_step import augment, kkt_prepare, kkt_solve, prep_kkt_consts
from .pd_step import pd_step, prep_pd_consts

_GAMMA = 0.99995
_STALL_STEP = 1e-10


class PDResult(NamedTuple):
    z: torch.Tensor       # primal iterate
    lam: torch.Tensor     # inequality multipliers, in C's row order
    s: torch.Tensor       # primal slacks d − Cz (up to the residual rp)
    v: torch.Tensor       # equality multipliers (empty when no A)
    iters: int
    converged: bool
    gap: float            # complementarity gap sᵀλ
    rp_norm: float        # ‖Cz + s − d‖∞ (∨ ‖Az − b‖∞ when A given)
    rd_norm: float        # ‖Pz + q + Cᵀλ + Aᵀv‖∞


def dir_stall_tol(epsilon: float, floor: float = 1e-6,
                  cap: float = 1e-3) -> float:
    """ε-derived direction-quality gate for the PCG escalation:
    τ = clamp(0.1·√ε, floor, cap) (interiorpoint_tpu/ops/pallas_newton.py
    dir_stall_tol)."""
    return min(cap, max(floor, 0.1 * math.sqrt(epsilon)))


def _objective_vector(prob, z0):
    P = getattr(prob, "P", None)
    if P is None:
        return prob.c
    return prob.q if prob.q is not None else torch.zeros_like(z0)


def _start(C, d, z0):
    """Mehrotra-style start: a global slack shift on violated starts."""
    s_hat = d - C @ z0
    floor = 1e-4 * (1.0 + d.abs().amax())
    smin = s_hat.amin()
    delta = torch.where(smin < floor,
                        -1.5 * torch.clamp(smin, max=0.0) + floor,
                        torch.zeros_like(smin))
    s0 = torch.maximum(s_hat + delta, floor)
    lam0 = torch.clamp(1.0 / s0, 1e-6, 1e6)
    return s0, lam0


def _tolerances(cfg, d, q):
    gap_tol = float(cfg.epsilon)
    feas_tol = max(1e-9, min(1e-6, gap_tol))
    scales = sync.read_list(torch.stack([d.abs().amax(), q.abs().amax()]))
    return gap_tol, feas_tol, 1.0 + scales[0], 1.0 + scales[1]


def pd_solve_fused(prob, z0, cfg, max_iters=None) -> PDResult:
    """Driver loop around the fused step (ops/pd_step.py); semantics of
    the JAX package's ``pd_solve_fused``."""
    C, d = prob.C, prob.d
    P = getattr(prob, "P", None)
    dtype = C.dtype
    if max_iters is None:
        max_iters = int(cfg.pd_max_iters)
    cs = prep_pd_consts(C, d, P)
    z0 = z0.to(dtype).contiguous()
    q = _objective_vector(prob, z0).contiguous()
    s0, lam0 = _start(C, d, z0)
    gap_tol, feas_tol, d_scale, q_scale = _tolerances(cfg, d, q)
    dtol = dir_stall_tol(float(cfg.epsilon), cap=3e-5)

    def exact_ok(st):
        return (st[8] < gap_tol and st[9] < feas_tol * d_scale
                and st[10] < feas_tol * q_scale)

    def done_of(st):
        solve_ok = st[6] <= 1e-8 * st[7] + 1e-30
        post = (st[0] < gap_tol and st[1] < feas_tol * d_scale
                and st[2] < feas_tol * q_scale and solve_ok)
        return post or exact_ok(st)

    # seed stats: the initial point's gap/rp/rd (a converged start exits
    # at once), steps 1 (not stalled), solve quality "failed"
    rd0 = q + C.T @ lam0
    if P is not None:
        rd0 = rd0 + P @ z0
    g0, rp0, rd0n = sync.read_list(torch.stack([
        s0 @ lam0, (C @ z0 + s0 - d).abs().amax(), rd0.abs().amax()]))
    stats = [g0, rp0, rd0n, 1.0, 1.0, 0.0, 1.0, 0.0, g0, rp0, rd0n, 0.0]

    z, s, lam = z0, s0.contiguous(), lam0.contiguous()
    it, bad = 0, False
    while (it < max_iters and not done_of(stats)
           and not ((stats[3] < 1e-10 and stats[4] < 1e-10) or bad)
           and math.isfinite(stats[0])):
        z2, s2, lam2, st2 = pd_step(cs, q, z, s, lam,
                                    refine=int(cfg.pallas_refine),
                                    dir_tol=dtol)
        vals = sync.read_list(torch.cat([
            st2, torch.isfinite(z2).all().to(st2.dtype)[None]]))
        st, z_ok = vals[:12], vals[12] == 1.0
        bad = not (all(math.isfinite(v) for v in st) and z_ok)
        # pass 1 of this step recomputed the exact (gap, rp, rd) of the
        # PRE-step state: when they certify, keep that state and report
        # the exact values
        certify = exact_ok(st)
        if certify:
            st[0:3] = st[8:11]
        if not (bad or certify):
            z, s, lam = z2, s2, lam2
        if not bad:
            stats = st
        it += 1
    return PDResult(z=z, lam=lam, s=s, v=torch.zeros(0, dtype=dtype,
                                                     device=C.device),
                    iters=it, converged=done_of(stats), gap=stats[0],
                    rp_norm=stats[1], rd_norm=stats[2])


def _max_step(v, dv):
    """Largest α ∈ (0, 1] with v + α·dv ≥ 0 (v > 0 elementwise)."""
    ratio = torch.where(dv < 0, -v / torch.where(dv < 0, dv, -1.0),
                        torch.full_like(v, float("inf")))
    return torch.clamp(ratio.amin(), max=1.0)


def pd_solve(prob, z0, cfg, max_iters=None, A=None, b=None,
             kkt_kernel=None) -> PDResult:
    """Predictor-corrector solve of an inequality-form problem
    (LPProblem/QPProblem with ``C``/``d``), optionally with an equality
    pair ``A z = b``; returns a :class:`PDResult`.

    ``kkt_kernel``: the equality path's direction backend — None = K5
    when ``cfg.mixed_precision`` and ``cfg.use_pallas`` (fp64), True =
    K5, False = the Schur block elimination over ``posdef_solver``."""
    C, d = prob.C, prob.d
    P = getattr(prob, "P", None)
    dtype = C.dtype
    k = C.shape[0]
    has_eq = A is not None
    mixed = bool(cfg.mixed_precision) and dtype == torch.float64
    if max_iters is None:
        max_iters = int(cfg.pd_max_iters)
    if not has_eq and mixed and cfg.use_pallas:
        return pd_solve_fused(prob, z0, cfg, max_iters)

    z0 = z0.to(dtype)
    q = _objective_vector(prob, z0)
    s0, lam0 = _start(C, d, z0)
    gap_tol, feas_tol, d_scale, q_scale = _tolerances(cfg, d, q)
    if has_eq:
        d_scale = max(d_scale, 1.0 + sync.read(b.abs().amax()))
    if kkt_kernel is None:
        use_kkt = has_eq and mixed and bool(cfg.use_pallas)
    else:
        use_kkt = has_eq and bool(kkt_kernel) and dtype == torch.float64
    if use_kkt:
        kc = prep_kkt_consts(A, C.shape[1])

    def residuals(z, s, lam, v):
        rd = q + C.T @ lam
        if P is not None:
            rd = rd + P @ z
        if has_eq:
            rd = rd + A.T @ v
        rpe = (A @ z - b).contiguous() if has_eq else None
        return rd, C @ z + s - d, rpe

    def norms(z, s, lam, v):
        rd, rp, rpe = residuals(z, s, lam, v)
        rpn = rp.abs().amax()
        if has_eq:
            rpn = torch.maximum(rpn, rpe.abs().amax())
        return s @ lam, rpn, rd.abs().amax()

    z, s, lam = z0, s0, lam0
    v = torch.zeros(A.shape[0] if has_eq else 0, dtype=dtype,
                    device=C.device)
    gap, rpn, rdn = sync.read_list(torch.stack(norms(z, s, lam, v)))
    it, stalled = 0, False
    while (it < max_iters and not stalled and math.isfinite(gap)
           and not (gap < gap_tol and rpn < feas_tol * d_scale
                    and rdn < feas_tol * q_scale)):
        rd, rp, rpe = residuals(z, s, lam, v)
        w = lam / s
        H = (C.T * w[None, :]) @ C
        if P is not None:
            H = H + P
        if use_kkt:
            H, rho = augment(0.5 * (H + H.T), kc)
            fac = kkt_prepare(H, kc)   # shared by both directions
        else:
            solve_h = posdef_solver(H, mixed)
            if has_eq:
                Hinv_AT = solve_h(A.T)
                S = A @ Hinv_AT
                solve_s = posdef_solver(0.5 * (S + S.T), mixed)

        def direction(rc):
            rhs = -rd + C.T @ ((rc - lam * rp) / s)
            if use_kkt:
                dz, dv, _, _ = kkt_solve(fac, rho, rhs, rpe)
            elif has_eq:
                # H dz + Aᵀdv = rhs, A dz = −rpe ⇒ S dv = A H⁻¹rhs + rpe
                t1 = solve_h(rhs)
                dv = solve_s(A @ t1 + rpe)
                dz = t1 - Hinv_AT @ dv
            else:
                dz, dv = solve_h(rhs), None
            ds = -rp - C @ dz
            return dz, ds, (-rc - lam * ds) / s, dv

        mu = (s @ lam) / k
        _, ds_a, dl_a, _ = direction(s * lam)
        ap_a = _max_step(s, ds_a)
        ad_a = _max_step(lam, dl_a)
        mu_aff = (s + ap_a * ds_a) @ (lam + ad_a * dl_a) / k
        sigma = torch.clamp((mu_aff / mu) ** 3, 0.0, 1.0)
        rc = s * lam - sigma * mu + ds_a * dl_a
        dz, ds, dlam, dv = direction(rc)
        ap = torch.clamp(_GAMMA * _max_step(s, ds), max=1.0)
        ad = torch.clamp(_GAMMA * _max_step(lam, dlam), max=1.0)
        z2, s2, lam2 = z + ap * dz, s + ap * ds, lam + ad * dlam
        v2 = v + ad * dv if has_eq else v
        g2, rpn2, rdn2 = norms(z2, s2, lam2, v2)
        finite = torch.isfinite(z2).all() & torch.isfinite(lam2).all()
        vals = sync.read_list(torch.stack([g2, rpn2, rdn2, ap, ad,
                                           finite.to(dtype)]))
        bad = not (all(math.isfinite(x) for x in vals[:3])
                   and vals[5] == 1.0)
        stalled = (vals[3] < _STALL_STEP and vals[4] < _STALL_STEP) or bad
        if not bad:
            z, s, lam, v = z2, s2, lam2, v2
            gap, rpn, rdn = vals[:3]
        it += 1
    converged = (gap < gap_tol and rpn < feas_tol * d_scale
                 and rdn < feas_tol * q_scale)
    return PDResult(z=z, lam=lam, s=s, v=v, iters=it, converged=converged,
                    gap=gap, rp_norm=rpn, rd_norm=rdn)
