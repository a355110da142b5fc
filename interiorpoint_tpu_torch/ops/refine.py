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
loop decision here is one host read (ops/sync.py): the plain versions
run these loops.  The CUDA paths run the same rules on the device: K1,
K2 and K4 the whole refined solve in one launch (csrc/hop.cu
``ip_refined_solve``, whose plain twin is ``refined_solve`` with its
``counts``), K5 every H-solve of a direction inside its one launch
(csrc/kktdir.cu ``ip_kkt_direction``), and all of them the jitter ladder
with each rung skipping itself on the device
(``factor_jittered_device``; K2's with its pivot floor, and only in the
branch that takes it; K5's in fp64).

``ops`` is a backend table (``_Cuda`` or ``_Plain`` of ops/pd_step.py):
``factor(Hs, delta, out=None, after=None, bad=None) -> (L, Dinv, bad)``,
for ``factor_inverse`` its ``equilibrate`` and ``invert``, and for the
pivot floor of ``factor_jittered_device`` (K2's tables,
ops/newton_step.py) ``pivot_floor(L, floor2, bad, after=None)``.
"""

from __future__ import annotations

import torch

from . import sync

# The step kernels' own jitter ladder on the unit-diagonal equilibrated Hs
# (pallas_newton.py:_factor_jittered); distinct from ops/kkt.py _JITTERS.
FACTOR_JITTERS = (0.0, 1e-6, 3e-3, 1.0)
PCG_MAX = 48
# the PCG reads its loop test once every PCG_STRIDE rounds (``pcg``)
PCG_STRIDE = 4


def pivot_floor2(n: int, delta: float, dtype) -> float:
    """The rounding of a pivot² of the factor of the unit-diagonal n × n
    Hs + δI, 4(n+1)·u·(1 + δ) (|Hs_ij| ≤ 1): a pivot² at or below it has
    a sign set by the summation order, not by Hs."""
    unit = 2.0 ** -24 if dtype == torch.float32 else 2.0 ** -53
    return 4.0 * (n + 1) * unit * (1.0 + delta)


def factor_jittered(ops, Hs, pivot_floor: bool = False, rung=None):
    """Factor Hs + δ·I for the first ladder rung δ that gives a finite
    factor (the last rung is kept either way).  Returns (L, Dinv);
    ``rung`` (a list) receives the δ taken.

    With ``pivot_floor`` the first rung (δ = 0) also fails when its
    smallest pivot² lies at or below ``pivot_floor2``: a nearly singular
    Hs puts its last pivots at rounding level, where two factors summed
    in different orders would take different rungs by finiteness alone.
    The jittered rungs keep finiteness: their exact pivots² are at least
    δ, away from the rounding (K2's fallback ladder)."""
    for delta in FACTOR_JITTERS:
        L, Dinv, bad = ops.factor(Hs, delta)
        if pivot_floor and delta == 0.0:
            piv2 = torch.diagonal(L).square().amin()
            bad = (bad != 0) | ~(piv2 > pivot_floor2(Hs.shape[0], delta,
                                                     Hs.dtype))
        if sync.read(bad) == 0:
            break
    if rung is not None:
        rung.append(delta)
    return L, Dinv


def factor_jittered_device(ops, Hs, pivot_floor: bool = False, after=None,
                           bads=None):
    """The ladder of ``factor_jittered`` with no host read: the four rungs
    go into one buffer, each after the first running only when the
    previous rung's flag is set (``after``), so the buffer ends with the
    first finite rung's factor (the last rung's when none is).  Returns
    (L, Dinv, δ), δ the chosen rung as a device scalar (for the checks):
    the rungs before it failed, and it and the skipped ones left their
    flags 0.

    ``pivot_floor`` fails the first rung also when its smallest pivot²
    lies at or below ``pivot_floor2``, on the device (``ops.pivot_floor``,
    as ``factor_jittered(pivot_floor=True)`` on the host).  ``after`` (a
    0-dim int32 device flag) runs the ladder only when it is set: every
    rung then skips itself and the flags stay 0 (K2 takes the fallback
    only when no carry hit and both LDL rungs failed).  ``bads`` (int32
    (4,), zeroed) receives the rungs' flags, so that the chosen rung's
    index is ``bads[:-1].sum()``."""
    if bads is None:
        bads = torch.zeros(len(FACTOR_JITTERS), dtype=torch.int32,
                           device=Hs.device)
    out = None
    for i, delta in enumerate(FACTOR_JITTERS):
        L, Dinv, bad = ops.factor(Hs, delta, out=out, after=after,
                                  bad=bads[i])
        if pivot_floor and i == 0:
            ops.pivot_floor(L, pivot_floor2(Hs.shape[0], delta, Hs.dtype),
                            bad, after=after)
        out, after = (L, Dinv), bad
    # index_select: indexing by a 0-dim device tensor would read it on
    # the host
    rung = bads[:-1].sum().view(1)
    return L, Dinv, _jitter_table(Hs.device).index_select(0, rung).view(())


_JITTER_TABLES = {}


def _jitter_table(device):
    """FACTOR_JITTERS as an fp64 tensor on ``device``, made once (a copy
    from the host would wait for the device)."""
    key = str(device)
    if key not in _JITTER_TABLES:
        t = torch.empty(len(FACTOR_JITTERS), dtype=torch.float64,
                        device=device)
        for i, delta in enumerate(FACTOR_JITTERS):
            t[i].fill_(delta)      # on the device: no copy from the host
        _JITTER_TABLES[key] = t
    return _JITTER_TABLES[key]


def factor_inverse(ops, H, dtype=torch.float32, rung=None):
    """The preconditioner of the SPD matrix H in the factor type
    ``dtype``: the Jacobi equilibration Hs = D H D (identity on the
    padding), the jittered factor of Hs and its inverse W = L⁻¹.  Returns
    (W, dsc), dsc the padded diagonal of D, both of type ``dtype``;
    ``rung`` (a list) receives the δ taken.  K1, K2 and K4 factor in fp32
    (their H is fp32 already); K5 in fp64.  The host reads each rung's
    flag: the step kernels' and K5's CUDA paths run
    ``factor_inverse_device``."""
    Hs, dsc = ops.equilibrate(H.to(dtype))
    L, Dinv = factor_jittered(ops, Hs, rung=rung)
    return ops.invert(L, Dinv), dsc


def factor_inverse_device(ops, H):
    """``factor_inverse`` of H in its own type (the step kernels' fp32
    Gram, K5's fp64 matrices) with the ladder on the device
    (``factor_jittered_device``).  Returns (W, dsc, δ)."""
    Hs, dsc = ops.equilibrate(H)
    L, Dinv, delta = factor_jittered_device(ops, Hs)
    return ops.invert(L, Dinv), dsc, delta


def exit_rel2_of(stall_rel2: float) -> float:
    """The refinement's default early exit, max(stall_rel2·1e-4, 1e-25)."""
    return max(stall_rel2 * 1e-4, 1e-25)


def sq(v, dsc):
    """Squared norm of v in the equilibrated metric, ‖D v‖²."""
    return ((v * dsc) ** 2).sum()


def pcg(precond, apply_h, dsc, b, x0, r0, bn2, exit_rel2, counts=None):
    """PCG on the correction system in the equilibrated metric
    (Ĥ = D H D, x += D x̂), fp64 residual recurrence against the true
    operator, fp32 preconditioner; kept only if it improved the residual
    (pallas_newton.py:_refined_solve, its _dd_pcg).

    The host reads the loop test once every ``PCG_STRIDE`` rounds: the
    rounds in between test it on the device and leave the state as it
    was once it fails, so the result is the same round for round, and at
    most ``PCG_STRIDE`` − 1 rounds are computed and dropped."""
    re = r0 * dsc
    zz = precond(re)
    rz = (re * zz).sum()
    cx = torch.zeros_like(b)
    p = zz
    thr = max(exit_rel2, 1e-26) * bn2
    active = None
    rounds = []
    for it in range(PCG_MAX):
        rn2c = (re * re).sum()
        go = (rn2c > thr) & torch.isfinite(rn2c) & torch.isfinite(rz)
        active = go if active is None else active & go
        if it % PCG_STRIDE == 0 and not sync.read(active):
            break
        if counts is not None:
            rounds.append(active)
        hp = dsc * apply_h(dsc * p)
        denom = (p * hp).sum()
        a = rz / torch.where(denom.abs() > 1e-30, denom, 1e-30)
        cx_n = cx + a * p
        re_n = re - a * hp
        zz = precond(re_n)
        rz2 = (re_n * zz).sum()
        beta = rz2 / torch.where(rz.abs() > 1e-30, rz, 1e-30)
        p_n = zz + beta * p
        cx, re = torch.where(active, cx_n, cx), torch.where(active, re_n, re)
        p, rz = torch.where(active, p_n, p), torch.where(active, rz2, rz)
    x2 = x0 + dsc * cx
    r2 = b - apply_h(x2)
    kept = sync.read(sq(r2, dsc) < sq(r0, dsc))
    if counts is not None:
        counts.update(pcg_rounds=torch.stack(rounds).sum() if rounds else 0,
                      pcg_kept=int(kept))
    return (x2, r2) if kept else (x0, r0)


def refined_solve(precond, apply_h, dsc, b, refine, stall_rel2,
                  exit_rel2=None, counts=None):
    """Solve H x = b: ``refine`` rounds of preconditioned refinement with
    exact fp64 residuals (early exit at ``exit_rel2``, by default
    max(stall_rel2·1e-4, 1e-25)), then the PCG escalation when the
    residual stalls above ``stall_rel2`` (squared, relative,
    equilibrated).  Returns (x, rn2, bn2).  The last operator
    application of every path but two is to the returned x: the refinement
    and an accepted PCG end with ``apply_h(x)``; no refinement round
    (x = 0) and a rejected PCG (x0 kept, its last application was x2's)
    do not.

    ``exit_rel2`` is for callers whose accuracy is floored by the solve's
    grade: K5's Schur-CG applies its operator through these solves, so
    they exit at the floor 1e-25 (pallas_kkt.py passes ``exit_rel2=1e-25``
    to ``_refined_solve``); a coarser exit caps its KKT residual near
    1e-7 (pallas_newton.py:_refined_solve's docstring).

    ``counts`` (a dict) receives the decisions the device solve of K1 and
    K4 reports (csrc/hop.cu ``ip_refined_solve``): "rounds" of
    refinement, "stalled", "pcg_rounds" (a device scalar) and
    "pcg_kept"."""
    x = torch.zeros_like(b)
    res = b
    bn2 = sq(b, dsc)
    if exit_rel2 is None:
        exit_rel2 = exit_rel2_of(stall_rel2)
    exited = False
    rounds = 0
    for _ in range(refine):
        if not sync.read(sq(res, dsc) > exit_rel2 * bn2):
            exited = True
            break
        x = x + dsc * precond(res * dsc)
        res = b - apply_h(x)
        rounds += 1
    # a residual at or below the exit is below the stall gate too when
    # exit_rel2 <= stall_rel2: no host read decides that
    stalled = not (exited and exit_rel2 <= stall_rel2) and sync.read(
        sq(res, dsc) > stall_rel2 * bn2)
    if counts is not None:
        counts.update(rounds=rounds, stalled=int(stalled), pcg_rounds=0,
                      pcg_kept=0)
    if stalled:
        x, res = pcg(precond, apply_h, dsc, b, x, res, bn2, exit_rel2,
                     counts)
    return x, sq(res, dsc), bn2
