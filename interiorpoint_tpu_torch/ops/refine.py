"""The factor-preconditioned refined solve shared by the step kernels'
orchestrations (K1 in ops/pd_step.py, K2 in ops/newton_step.py, K4 in
ops/socp_step.py, K5 in ops/kkt_step.py).

Counterpart of the rules both TPU step kernels share in
interiorpoint_tpu/ops/pallas_newton.py: ``_factor_jittered`` (the
0/1e-6/3e-3/1 jitter ladder on the unit-diagonal Hs) and
``_refined_solve`` with its ``_dd_pcg`` escalation.  The TPU kernels
carry the residuals as double-float32 pairs; here they are fp64, and only
the step kernels' preconditioner (``precond``: the fp32 factor through
W = L⁻¹) is fp32.
With an fp64 factor (K5) the preconditioner is applied in fp64.  Each
loop decision is one host read (ops/sync.py).

``ops`` is a backend table (``_Cuda`` or ``_Plain`` of ops/pd_step.py):
``factor(Hs, delta) -> (L, Dinv, bad)``, and for ``factor_inverse`` its
``equilibrate`` and ``invert``.
"""

from __future__ import annotations

import torch

from . import sync

# The step kernels' own jitter ladder on the unit-diagonal equilibrated Hs
# (pallas_newton.py:_factor_jittered); distinct from ops/kkt.py _JITTERS.
FACTOR_JITTERS = (0.0, 1e-6, 3e-3, 1.0)
PCG_MAX = 48


def factor_jittered(ops, Hs):
    """Factor Hs + δ·I for the first ladder rung δ that gives a finite
    factor (the last rung is kept either way).  Returns (L, Dinv)."""
    for delta in FACTOR_JITTERS:
        L, Dinv, bad = ops.factor(Hs, delta)
        if sync.read(bad) == 0:
            break
    return L, Dinv


def factor_inverse(ops, H, dtype=torch.float32):
    """The preconditioner of the SPD matrix H in the factor type
    ``dtype``: the Jacobi equilibration Hs = D H D (identity on the
    padding), the jittered factor of Hs and its inverse W = L⁻¹.  Returns
    (W, dsc), dsc the padded diagonal of D, both of type ``dtype``.  K1,
    K2 and K4 factor in fp32 (their H is fp32 already); K5 in fp64."""
    Hs, dsc = ops.equilibrate(H.to(dtype))
    L, Dinv = factor_jittered(ops, Hs)
    return ops.invert(L, Dinv), dsc


def sq(v, dsc):
    """Squared norm of v in the equilibrated metric, ‖D v‖²."""
    return ((v * dsc) ** 2).sum()


def pcg(precond, apply_h, dsc, b, x0, r0, bn2, exit_rel2):
    """PCG on the correction system in the equilibrated metric
    (Ĥ = D H D, x += D x̂), fp64 residual recurrence against the true
    operator, fp32 preconditioner; kept only if it improved the residual
    (pallas_newton.py:_refined_solve, its _dd_pcg)."""
    re = r0 * dsc
    zz = precond(re)
    rz = (re * zz).sum()
    cx = torch.zeros_like(b)
    p = zz
    thr = max(exit_rel2, 1e-26) * bn2
    for _ in range(PCG_MAX):
        rn2c = (re * re).sum()
        if not sync.read((rn2c > thr) & torch.isfinite(rn2c)
                         & torch.isfinite(rz)):
            break
        hp = dsc * apply_h(dsc * p)
        denom = (p * hp).sum()
        a = rz / torch.where(denom.abs() > 1e-30, denom, 1e-30)
        cx = cx + a * p
        re = re - a * hp
        zz = precond(re)
        rz2 = (re * zz).sum()
        beta = rz2 / torch.where(rz.abs() > 1e-30, rz, 1e-30)
        p = zz + beta * p
        rz = rz2
    x2 = x0 + dsc * cx
    r2 = b - apply_h(x2)
    if sync.read(sq(r2, dsc) < sq(r0, dsc)):
        return x2, r2
    return x0, r0


def refined_solve(precond, apply_h, dsc, b, refine, stall_rel2,
                  exit_rel2=None):
    """Solve H x = b: ``refine`` rounds of preconditioned refinement with
    exact fp64 residuals (early exit at ``exit_rel2``, by default
    max(stall_rel2·1e-4, 1e-25)), then the PCG escalation when the
    residual stalls above ``stall_rel2`` (squared, relative,
    equilibrated).  Returns (x, rn2, bn2).

    ``exit_rel2`` is for callers whose accuracy is floored by the solve's
    grade: K5's Schur-CG applies its operator through these solves, so
    they exit at the floor 1e-25 (pallas_kkt.py passes ``exit_rel2=1e-25``
    to ``_refined_solve``); a coarser exit caps its KKT residual near
    1e-7 (pallas_newton.py:_refined_solve's docstring)."""
    x = torch.zeros_like(b)
    res = b
    bn2 = sq(b, dsc)
    if exit_rel2 is None:
        exit_rel2 = max(stall_rel2 * 1e-4, 1e-25)
    i = 0
    while i < refine and sync.read(sq(res, dsc) > exit_rel2 * bn2):
        x = x + dsc * precond(res * dsc)
        res = b - apply_h(x)
        i += 1
    if sync.read(sq(res, dsc) > stall_rel2 * bn2):
        x, res = pcg(precond, apply_h, dsc, b, x, res, bn2, exit_rel2)
    return x, sq(res, dsc), bn2
