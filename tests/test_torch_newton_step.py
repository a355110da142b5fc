"""The barrier Newton step K2 and its direction K2d (ops/newton_step.py)
in their plain versions against the JAX package's fused Pallas kernels in
interpret mode (reduced_newton_step_prepared, reduced_newton_dir_prepared)
and against an independent fp64 line search (the ops/barrier.py ls_objs
rule), on the instances of tests/test_pallas_step.py.

Tolerances.  σ is compared exactly with the fp64 rule (both take the same
fp64 candidates β^j) and to 1e-6 relative with the kernel's f32 σ.  The
interpret-mode kernel carries x' only to about f32 accuracy (XLA:CPU
simplifies its double-float error terms; tests/test_pallas_step.py:84-92),
so x' is held at 5e-6 relative to it, and exactly to z + σ·dx of the
port's own direction."""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_helpers import np_of, t64
from interiorpoint_tpu.ops.pallas_newton import (
    _phi_stable, prep_reduced_consts, reduced_newton_dir_prepared,
    reduced_newton_step_prepared)
from interiorpoint_tpu_torch.models.problem import make_lp
from interiorpoint_tpu_torch.ops import newton_step as ns
from interiorpoint_tpu_torch.ops.barrier import make_phase1_linear_oracle
from interiorpoint_tpu_torch.utils import convert

ALPHA, BETA, J = 0.2, 0.6, 40


def _sigmas():
    return BETA ** np.arange(J)


def _ref_select(C, d, tc, z, tP, dx):
    """Largest candidate passing domain + Armijo on the true barrier
    Newton objective, all in fp64 (tests/test_pallas_step.py)."""
    g = tc + C.T @ (1.0 / (d - C @ z))
    if tP is not None:
        g = g + tP @ z
    gdx = g @ dx

    def nobj(x):
        s = d - C @ x
        if np.any(s <= 0):
            return np.inf
        val = tc @ x - np.sum(np.log(s))
        if tP is not None:
            val = val + 0.5 * x @ (tP @ x)
        return val

    f0 = nobj(z)
    for s_ in _sigmas():
        cand = nobj(z + s_ * dx)
        if np.isfinite(cand) and cand <= f0 + ALPHA * s_ * gdx:
            return s_
    return 0.0


def _case(name):
    """(C, d, tc, z, tP) of a named instance."""
    if name in ("lp", "qp"):
        rng = np.random.default_rng(7)
        k, r = 300, 100
        C = rng.standard_normal((k, r))
        z = rng.standard_normal(r) * 0.1
        d = C @ z + rng.uniform(0.05, 2.0, k)
        tc = 10.0 * rng.standard_normal(r)
        tP = None
        if name == "qp":
            M = rng.standard_normal((r, r))
            tP = (M @ M.T / r + np.eye(r)) * 3.0
        return C, d, tc, z, tP
    if name == "near_boundary":
        # a 1e-2 slack: the full step leaves the domain, the sweep must
        # backtrack through the direct branch of φ
        rng = np.random.default_rng(11)
        k, r = 200, 64
        C = rng.standard_normal((k, r))
        z = rng.standard_normal(r) * 0.1
        s_true = rng.uniform(0.5, 2.0, k)
        s_true[0] = 1e-2
        return C, C @ z + s_true, 100.0 * rng.standard_normal(r), z, None
    # phase one: the [C | −1] block over z = [x, s] with cost t·e_s, from
    # an x0 that violates some rows (s0 = −min slack + 1)
    rng = np.random.default_rng(13)
    k, r = 300, 100
    C = rng.uniform(-2, 2, (k, r))
    d = C @ rng.uniform(-0.5, 0.5, r) + 0.2
    x0 = rng.uniform(-1, 1, r)
    oracle = make_phase1_linear_oracle(make_lp(np.zeros(r), C=C, d=d,
                                               lb=None, ub=None))
    Cp = np_of(oracle.lin_form[0])
    z = np.concatenate([x0, [-(d - C @ x0).min() + 1.0]])
    return Cp, d, 5.0 * np_of(oracle.lin_form[2]), z, None


@functools.lru_cache(maxsize=None)
def _jax_step(name):
    C, d, tc, z, tP = _case(name)
    consts = prep_reduced_consts(jnp.asarray(C), jnp.asarray(d))
    out = reduced_newton_step_prepared(
        consts, jnp.asarray(tc), jnp.asarray(z),
        None if tP is None else jnp.asarray(tP), jnp.asarray(_sigmas()),
        alpha=ALPHA, interpret=True)
    x_new, nd, sigma, any_acc, dir_ok = out
    return consts, np.asarray(x_new), float(nd), float(sigma), \
        bool(any_acc), bool(dir_ok)


@pytest.mark.parametrize("name", ["lp", "qp", "near_boundary", "phase1"])
def test_plain_step_matches_pallas_interpret_and_fp64_rule(name):
    C, d, tc, z, tP = _case(name)
    consts, xj, ndj, sigj, accj, okj = _jax_step(name)
    cs = convert.newton_consts_from_jax(consts, device="cpu")
    # the joined double-float C is the fp64 C to 2⁻⁴⁸ relative
    assert np.abs(np_of(cs.C) - C).max() <= 1e-13 * np.abs(C).max()
    tP_t = None if tP is None else t64(tP)
    calls = ns.newton_step_plain.calls
    x_new, st = ns.newton_step(cs, t64(tc), t64(z), tP_t, t64(_sigmas()),
                               alpha=ALPHA)
    assert ns.newton_step_plain.calls == calls + 1
    st = np_of(st)
    dx, g, rn2 = ns.newton_dir(cs, t64(tc), t64(z), tP_t)
    dx, g = np_of(dx), np_of(g)
    sigma = st[ns.ST_SIGMA]
    assert accj and st[ns.ST_ANY] == 1.0
    assert sigma == _ref_select(np_of(cs.C), np_of(cs.d), tc, z, tP, dx)
    assert sigma == pytest.approx(sigj, rel=1e-6)
    assert sigma == _sigmas()[int(st[ns.ST_INDEX])]
    assert okj and st[ns.ST_DIR_OK] == 1.0
    # x' = z + σ·dx of the port's own direction (fp64), and of the
    # kernel's at its interpret-mode f32 floor
    np.testing.assert_allclose(np_of(x_new), z + sigma * dx, rtol=1e-14,
                               atol=1e-15)
    np.testing.assert_allclose(np_of(x_new), xj, rtol=5e-6, atol=1e-8)
    # Newton decrement −g·dx/2, against the port's g·dx and the kernel's
    assert st[ns.ST_ND] == pytest.approx(-0.5 * g @ dx, rel=1e-12)
    assert st[ns.ST_ND] == pytest.approx(ndj, rel=1e-6)
    assert st[ns.ST_RN2] <= 1e-4 * st[ns.ST_BN2]
    assert st[ns.ST_SMIN] == pytest.approx((np_of(cs.d)
                                            - np_of(cs.C) @ z).min(),
                                           rel=1e-12)
    if tP is not None:
        assert st[ns.ST_Q2] == pytest.approx(0.5 * dx @ tP @ dx, rel=1e-12)
    # the accepted step stays strictly inside the domain
    assert (np_of(cs.d) - np_of(cs.C) @ np_of(x_new)).min() > 0


@pytest.mark.parametrize("qp", [False, True])
def test_plain_dir_matches_pallas_interpret(qp):
    C, d, tc, z, tP = _case("qp" if qp else "lp")
    consts = prep_reduced_consts(jnp.asarray(C), jnp.asarray(d))
    tP_j = None if tP is None else jnp.asarray(tP)
    dxj, gj, rnj = reduced_newton_dir_prepared(
        consts, jnp.asarray(tc), jnp.asarray(z), tP_j, interpret=True)
    cs = ns.prep_newton_consts(t64(C), t64(d))
    calls = ns.newton_dir_plain.calls
    dx, g, rn2 = ns.newton_dir(cs, t64(tc), t64(z),
                               None if tP is None else t64(tP))
    assert ns.newton_dir_plain.calls == calls + 1
    # the fp64 direction against the exact solve, and the kernel's
    s = d - C @ z
    H = C.T @ ((1.0 / s ** 2)[:, None] * C) + (0 if tP is None else tP)
    g_ref = tc + C.T @ (1.0 / s) + (0 if tP is None else tP @ z)
    dx_ref = np.linalg.solve(H, -g_ref)
    assert np.abs(np_of(g) - g_ref).max() <= 1e-12 * np.abs(g_ref).max()
    assert np.abs(np_of(dx) - dx_ref).max() <= 1e-9 * np.abs(dx_ref).max()
    assert np.abs(np_of(dx) - np.asarray(dxj)).max() <= \
        1e-7 * np.abs(dx_ref).max()
    assert np.abs(np_of(g) - np.asarray(gj)).max() <= \
        1e-10 * np.abs(g_ref).max()
    assert float(rn2) < 1e-4 and float(rnj) < 1e-4


def test_phi_matches_phi_stable_and_series():
    y = np.concatenate([np.linspace(-0.95, 0.95, 101),
                        np.array([-1e-8, 1e-8, 0.0, 0.0999, -0.0999,
                                  0.1001, 1e-3, -1e-3])])
    got = np_of(ns.phi(t64(y)))
    # the kernel's f32 form
    fj = np.asarray(_phi_stable(jnp.asarray(y, jnp.float32)), np.float64)
    np.testing.assert_allclose(got, fj, rtol=2e-5, atol=1e-12)
    # fp64 reference: 40 terms of y²·Σ yᵐ/(m+2) where |y| < 0.5 (the
    # direct form cancels there), the direct form elsewhere
    yl = y.astype(np.longdouble)
    series = sum(yl ** (m + 2) / (m + 2) for m in range(60))
    direct = -np.log1p(-yl) - yl
    ref = np.where(np.abs(y) < 0.5, series, direct).astype(np.float64)
    np.testing.assert_allclose(got, ref, rtol=1e-14, atol=0)
    # y ≥ 1 rejects the candidate (inf/NaN, never a finite value)
    assert not np.isfinite(np_of(ns.phi(t64([1.0, 1.5])))).any()


def test_sweep_rejects_every_candidate_on_ascent():
    """g·dx > 0 (not a descent direction): nothing passes, σ = 0, x' = z."""
    rng = np.random.default_rng(3)
    k, r = 50, 10
    C = t64(rng.standard_normal((k, r)))
    z, dx = t64(rng.standard_normal(r)), t64(rng.standard_normal(r))
    inv_s = t64(rng.uniform(0.5, 2.0, k))
    sig = t64(_sigmas())
    phisum, umax, sel, xnew = ns._Plain.sweep(
        C @ dx, inv_s, sig, torch.tensor(1.0, dtype=torch.float64),
        torch.tensor(0.0, dtype=torch.float64), ALPHA, z, dx)
    assert np_of(sel).tolist() == [0.0, 0.0, 0.0]
    assert torch.equal(xnew, z)
    assert phisum.shape == (J,) and float(umax) == pytest.approx(
        float((C @ dx * inv_s).max()))


def test_device_dispatch_and_refusals():
    C, d, tc, z, tP = _case("qp")
    cs = ns.prep_newton_consts(t64(C), t64(d))
    args = (t64(tc), t64(z), t64(tP), t64(_sigmas()))
    before = (ns.newton_step.launches, ns.newton_dir.launches)
    ns.newton_step(cs, *args, alpha=ALPHA)
    ns.newton_dir(cs, *args[:3])
    # CPU tensors never count as kernel launches
    assert (ns.newton_step.launches, ns.newton_dir.launches) == before
    bad = [
        (t64(tc).float(), args[1], args[2], args[3]),        # fp32 tc
        (args[0], t64(z)[:-1], args[2], args[3]),             # short z
        (args[0], args[1], t64(tP).T, args[3]),               # tP layout
        (args[0], args[1], args[2], t64(_sigmas())[:0]),      # no sigma
        (args[0], args[1], args[2], t64(_sigmas()).float()),  # fp32 sigma
    ]
    for a in bad:
        with pytest.raises(ValueError):
            ns.newton_step(cs, *a, alpha=ALPHA)
    with pytest.raises(ValueError):
        ns.newton_dir(cs, args[0], args[1], t64(tP).T)
    meta = dict(dtype=torch.float64, device="meta")
    k, r = C.shape
    cs_m = ns.NTConsts(C=torch.empty((k, r), **meta),
                       C32=torch.empty((k, r), dtype=torch.float32,
                                       device="meta"),
                       d=torch.empty(k, **meta))
    with pytest.raises(ValueError, match="unsupported device"):
        ns.newton_step(cs_m, torch.empty(r, **meta),
                       torch.empty(r, **meta), None,
                       torch.empty(J, **meta), alpha=ALPHA)
    with pytest.raises(ValueError, match="unsupported device"):
        ns.newton_dir(cs_m, torch.empty(r, **meta), torch.empty(r, **meta))
