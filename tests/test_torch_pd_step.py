"""The primal-dual step (K1, ops/pd_step.py) in its plain version against
the JAX package's fused Pallas step in interpret mode.

Tolerance 5e-5 is that of tests/test_pallas_pd.py: in interpret mode
XLA:CPU simplifies away some double-float error terms, so the Pallas
step is only ~f32-accurate on its dd outputs; the port carries fp64."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from torch_helpers import np_of, pd_instance, rel, t64
from interiorpoint_tpu.ops.pallas_newton import prep_reduced_consts
from interiorpoint_tpu.ops.pallas_pd import pd_step_prepared
from interiorpoint_tpu_torch.ops import pd_step as ps


@pytest.mark.parametrize("quad", [False, True])
def test_plain_step_matches_pallas_interpret(quad):
    k, r = 96, 24
    C, d, q, P, z, s, lam = pd_instance(5 if quad else 3, k, r, quad)
    consts = prep_reduced_consts(jnp.asarray(C), jnp.asarray(d))
    tP = None if P is None else jnp.asarray(P)
    cs = ps.prep_pd_consts(t64(C), t64(d), None if P is None else t64(P))
    # one trace for the three steps (the constants are closed over)
    step_j = jax.jit(lambda q_, z_, s_, l_: pd_step_prepared(
        consts, q_, z_, s_, l_, tP, interpret=True))
    zj, sj, lj = z.copy(), s.copy(), lam.copy()
    zt, st, lt = t64(z), t64(s), t64(lam)
    for it in range(3):
        zj2, sj2, lj2, stats_j = step_j(
            jnp.asarray(q), jnp.asarray(zj), jnp.asarray(sj),
            jnp.asarray(lj))
        zt, st, lt, stats_t = ps.pd_step(cs, t64(q), zt, st, lt)
        zj, sj, lj = np.asarray(zj2), np.asarray(sj2), np.asarray(lj2)
        scale = max(1.0, np.abs(zj).max())
        assert np.abs(np_of(zt) - zj).max() / scale < 5e-5, it
        assert np.abs(np_of(st) - sj).max() / max(1.0, sj.max()) < 5e-5, it
        assert np.abs(np_of(lt) - lj).max() / max(1.0, lj.max()) < 5e-5, it
        sj_, st_ = np.asarray(stats_j, np.float64), np_of(stats_t)
        for i in (0, 1, 2, 8, 9, 10):
            assert abs(st_[i] - sj_[i]) <= 5e-5 * max(1.0, abs(sj_[i])), \
                (it, i)
        for i in (3, 4, 5):   # step lengths and σ
            assert abs(st_[i] - sj_[i]) < 1e-3, (it, i)
        assert st_[6] <= 1e-8 * st_[7] + 1e-30   # corrector solve_ok
        # continue both from the JAX state so the comparison stays
        # one step deep
        zt, st, lt = t64(zj), t64(sj), t64(lj)


def test_step_routes_cpu_tensors_to_plain():
    C, d, q, P, z, s, lam = pd_instance(9, 40, 10)
    cs = ps.prep_pd_consts(t64(C), t64(d))
    before = (ps.pd_step.launches, ps.pd_step_plain.calls)
    ps.pd_step(cs, t64(q), t64(z), t64(s), t64(lam))
    assert (ps.pd_step.launches, ps.pd_step_plain.calls) == \
        (before[0], before[1] + 1)
    with pytest.raises(ValueError):
        ps.pd_step(cs, t64(q), t64(z).float(), t64(s), t64(lam))


def test_step_sequence_keeps_contraction():
    """A late-stage step (tiny μ, ill-conditioned Hs) still returns a
    finite state whose primal residual respects the (1−α) bookkeeping."""
    C, d, q, P, z, s, lam = pd_instance(11, 96, 24)
    cs = ps.prep_pd_consts(t64(C), t64(d))
    zt, st, lt = t64(z), t64(s), t64(lam)
    for _ in range(12):
        zt, st, lt, stats = ps.pd_step(cs, t64(q), zt, st, lt)
    rp = C @ np_of(zt) + np_of(st) - d
    assert np.isfinite(np_of(stats)).all()
    assert np.abs(rp).max() <= float(stats[1]) * 1.01 + 1e-9
    assert float(stats[0]) < 1e-3


# ---------------------------------------------------------------------------
# The fused operator, the refined solve's counts and side channel, and the
# jitter ladder on the device (plain versions; csrc/hop.cu and the device
# ladder are held against them on the card by chip_smoke.py)
# ---------------------------------------------------------------------------

def _system(seed, k=80, r=20, quad=True, kappa=None):
    """C (k × r), weights w, P (or None) and the fp32 preconditioner
    (W, dsc) of H = Cᵀdiag(w)C (+P); with ``kappa``, w spans that range
    (an ill-conditioned H)."""
    import torch
    from interiorpoint_tpu_torch.ops import refine
    rng = np.random.default_rng(seed)
    C = t64(rng.uniform(-2, 2, (k, r)))
    lo = 1.0 if kappa is None else 1.0 / kappa
    w = t64(np.exp(rng.uniform(np.log(lo), 0.0, k)))
    P = None
    if quad:
        M = rng.uniform(-1, 1, (r, r))
        P = t64(M.T @ M + np.eye(r))
    H32 = ps._Plain.gram(C.float(), w, None if P is None else P.float())
    W, dsc, delta = refine.factor_inverse_device(ps._Plain, H32)
    assert isinstance(W, torch.Tensor) and float(delta) >= 0.0
    return C, w, P, W, dsc, rng


@pytest.mark.parametrize("quad", [False, True])
def test_h_apply_matches_the_two_pass_operator(quad):
    C, w, P, _, _, rng = _system(21, quad=quad)
    x = t64(rng.standard_normal(C.shape[1]))
    hx, cx = ps._Plain.h_apply(C, w, x, P)
    two = ps._Plain.ct_matvec(C, ps._Plain.c_matvec(C, x, w))
    if quad:
        two = two + ps._Plain.p_matvec(P, x)
    assert rel(np_of(hx), np_of(two)) <= 1e-13
    assert rel(np_of(cx), np_of(C) @ np_of(x)) <= 1e-13


def test_refined_solve_counts_escalate_to_the_pcg():
    """A seeded system with weights over 1e10 and a preconditioner made
    from a perturbed H: one round of refinement stalls above the gate, the
    PCG runs and lowers the residual; the counts record it, and the side
    channel is C·x of the returned x."""
    import torch
    from interiorpoint_tpu_torch.ops import refine
    C, w, P, _, _, rng = _system(23, kappa=1e10)
    H32 = ps._Plain.gram(C.float(), w, P.float())
    bump = torch.as_tensor(rng.uniform(0.0, 0.3, C.shape[1]),
                           dtype=torch.float32)
    W, dsc, _ = refine.factor_inverse_device(
        ps._Plain, H32 * (1.0 + torch.diag(bump)))
    b = t64(rng.standard_normal(C.shape[1]))
    x, rn2, bn2, cx, counts = ps._Plain.refined_solve(C, w, P, W, dsc, b, 1,
                                                      1e-24)
    rounds, stalled, pcg, kept = (int(v) for v in counts)
    assert (rounds, stalled, kept) == (1, 1, 1) and 0 < pcg <= 48
    # the same numbers through refined_solve's own counts
    c = {}
    r = C.shape[1]
    refine.refined_solve(
        lambda v: ps._Plain.w_solve(W, v.float()).double(),
        lambda v: ps._Plain.h_apply(C, w, v, P)[0], dsc[:r].double(), b, 1,
        1e-24, counts=c)
    assert [c["rounds"], c["stalled"], int(c["pcg_rounds"]),
            c["pcg_kept"]] == [rounds, stalled, pcg, kept]
    assert float(rn2) < 1e-4 * float(bn2)
    np.testing.assert_array_equal(np_of(cx), np_of(C @ x))


@pytest.mark.parametrize("case", ["refined", "no_round", "pcg_rejected"])
def test_refined_solve_side_channel_on_every_path(case):
    """C·x of the returned x on each exit: after refinement rounds (the
    last application), with no round (x = 0: zeros) and after a PCG whose
    result was not kept (x0's application before the PCG)."""
    import torch
    C, w, P, W, dsc, rng = _system(29)
    b = t64(rng.standard_normal(C.shape[1]))
    if case == "no_round":
        x, _, _, cx, counts = ps._Plain.refined_solve(C, w, P, W, dsc, b, 0,
                                                      1e30)
        assert counts.tolist() == [0, 0, 0, 0]
        assert float(x.abs().max()) == 0.0
        np.testing.assert_array_equal(np_of(cx), 0.0)
        return
    if case == "refined":
        x, _, _, cx, counts = ps._Plain.refined_solve(C, w, P, W, dsc, b, 3,
                                                      1e-12)
        assert counts.tolist()[1:] == [0, 0, 0] and counts[0] >= 1
    else:
        # every weight 0 and no P: H = 0, so the PCG's first p·Hp is 0,
        # its step is rz/1e-30 and its x2 leaves the residual at b, not
        # below the refined x0's: the PCG runs its 48 rounds and is
        # dropped
        from interiorpoint_tpu_torch.ops import refine
        w0 = torch.zeros_like(w)
        W0, d0, _ = refine.factor_inverse_device(
            ps._Plain, ps._Plain.gram(C.float(), w0, None))
        x, _, _, cx, counts = ps._Plain.refined_solve(C, w0, None, W0, d0, b,
                                                      1, 1e-12)
        assert counts.tolist() == [1, 1, 48, 0]
        x1 = d0[:C.shape[1]].double() * ps._Plain.w_solve(
            W0, (b * d0[:C.shape[1]].double()).float()).double()
        np.testing.assert_array_equal(np_of(x), np_of(x1))
    np.testing.assert_array_equal(np_of(cx), np_of(C @ x))
    assert isinstance(cx, torch.Tensor)


def test_device_ladder_takes_the_host_ladders_rung():
    """The device ladder (each rung skipped once an earlier one was
    finite) ends on the rung of ``factor_jittered``: rung 0 on an SPD Hs,
    and 3e-3 on a seeded Hs with three eigenvalues at -1e-3 (rungs 0 and
    1e-6 fail), its factor that rung's."""
    import torch
    from interiorpoint_tpu_torch.ops import refine
    rng = np.random.default_rng(31)
    n = 40
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    for ev0, want in ((0.5, 0.0), (-1e-3, 3e-3)):
        ev = np.linspace(1.0, 2.0, n)
        ev[:3] = ev0
        Hs = ps._Plain.equilibrate(torch.as_tensor((Q * ev) @ Q.T,
                                                   dtype=torch.float32))[0]
        seen = []

        class Rec(ps._Plain):
            @staticmethod
            def factor(A, delta, **kw):
                seen.append(delta)
                return ps._Plain.factor(A, delta, **kw)

        L_h, _ = refine.factor_jittered(Rec, Hs)
        L, _, delta = refine.factor_jittered_device(ps._Plain, Hs)
        assert seen[-1] == want and float(delta) == want
        np.testing.assert_array_equal(np_of(L), np_of(L_h))
