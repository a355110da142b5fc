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

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from torch_helpers import np_of, t64
from interiorpoint_tpu.ops.pallas_newton import (
    _ldl_ns_stages, _ldl_solve, _ns_tile_inv, _pad, _phi_stable,
    prep_reduced_consts, reduced_newton_dir_prepared,
    reduced_newton_step_prepared)
from interiorpoint_tpu_torch.models.problem import make_lp
from interiorpoint_tpu_torch.ops import hybrid, newton, refine, sync
from interiorpoint_tpu_torch.ops import newton_step as ns
from interiorpoint_tpu_torch.ops.barrier import (make_phase1_linear_oracle,
                                                 make_qp_oracle)
from interiorpoint_tpu_torch.ops.pd_step import _Plain as PdPlain
from interiorpoint_tpu_torch.utils import convert
from interiorpoint_tpu_torch.utils.config import SolverConfig

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
                                               lb=None, ub=None,
                                               device="cpu"))
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
    # the fp64 direction against the exact solve, and the kernel's.  At
    # the default gate (dir_tol 1e-6) the refinement exits at a squared
    # relative residual of 1e-16, where the forward error is the
    # preconditioner's: the TPU kernel's own direction is 3e-8 off the
    # exact solve on the QP (1e-10 on the LP), so the port's default
    # direction is held within 1e-9, or twice the kernel's own forward
    # error where that is larger; at a strict gate (exit 1e-18) within
    # 1e-9 on both
    s = d - C @ z
    H = C.T @ ((1.0 / s ** 2)[:, None] * C) + (0 if tP is None else tP)
    g_ref = tc + C.T @ (1.0 / s) + (0 if tP is None else tP @ z)
    dx_ref = np.linalg.solve(H, -g_ref)
    scale = np.abs(dx_ref).max()
    fwd_j = np.abs(np.asarray(dxj) - dx_ref).max() / scale
    dsc = 1.0 / np.sqrt(np.diag(H))
    res = dsc * (H @ np_of(dx) + g_ref)
    assert (res @ res) <= 1e-16 * ((dsc * g_ref) @ (dsc * g_ref)) * 1.01
    dx_s = np_of(ns.newton_dir(cs, t64(tc), t64(z),
                               None if tP is None else t64(tP),
                               dir_tol=1e-7)[0])
    assert np.abs(np_of(g) - g_ref).max() <= 1e-12 * np.abs(g_ref).max()
    assert np.abs(np_of(dx) - dx_ref).max() <= max(1e-9, 2.0 * fwd_j) * scale
    assert np.abs(dx_s - dx_ref).max() <= 1e-9 * scale
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


# ---------------------------------------------------------------------------
# K2's preconditioner: the hybrid factor, its solve and the carry
# ---------------------------------------------------------------------------

def _spd_tile(n, cond, seed):
    """A seeded SPD matrix of condition ``cond``, Jacobi-scaled to a unit
    diagonal (as the factor sees it), fp32."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    H = (Q * np.logspace(0, np.log10(cond), n)) @ Q.T
    dsc = 1.0 / np.sqrt(np.diag(H))
    return (H * dsc[:, None] * dsc[None, :]).astype(np.float32)


@pytest.mark.parametrize("cond,miss", [(1e2, False), (1e4, False),
                                       (1e9, True)])
def test_ns_tile_inv_plain_matches_jax(cond, miss):
    """The Newton–Schulz tile inverse against the TPU kernel's
    ``_ns_tile_inv`` (a plain JAX function) on a seeded 128 × 128 tile:
    X within max(1e-5, 2κu) relative (u = 2⁻²⁴: two fp32 inverses that sum
    in different orders differ by up to κu each; 1e-5 holds at κ = 1e2,
    at κ = 1e4 they differ by 9e-5), or NaN in both where the tile misses
    the gate (κ = 1e9: the fp32 iteration floors above it)."""
    D = _spd_tile(128, cond, int(np.log10(cond)))
    Xj = np.asarray(_ns_tile_inv(jnp.asarray(D)))
    X, bad, f2, _ = hybrid.ns_tile_inv_plain(torch.as_tensor(D))
    X = np_of(X)
    assert bool(bad) == miss
    if miss:
        assert np.isnan(X).all() and np.isnan(Xj).all()
        return
    tol = max(1e-5, 2.0 * cond * 2.0 ** -24)
    assert np.abs(X - Xj).max() <= tol * np.abs(Xj).max()
    assert np.linalg.norm(np.eye(128) - X @ D) <= 1e-2


def _ldl_jax(Hs, rhs):
    """``_ldl_ns_stages`` then ``_ldl_solve`` of the rows of ``rhs``, in
    one Pallas call in interpret mode: (Dinv, rhs·M⁻¹)."""
    rp = Hs.shape[0]
    nb = rp // hybrid.LDL_BLK

    def kernel(h_ref, b_ref, l_ref, d_ref, s_ref):
        l_ref[:] = h_ref[:]
        _ldl_ns_stages(l_ref, d_ref, nb)
        s_ref[:] = _ldl_solve(l_ref, d_ref, b_ref[:], nb)

    f32 = jnp.float32
    with jax.enable_x64(False):
        _, dinv, sol = pl.pallas_call(
            kernel, interpret=True,
            out_shape=(jax.ShapeDtypeStruct((rp, rp), f32),
                       jax.ShapeDtypeStruct((rp, hybrid.LDL_BLK), f32),
                       jax.ShapeDtypeStruct(rhs.shape, f32)))(
            jnp.asarray(Hs, f32), jnp.asarray(rhs, f32))
    return np.asarray(dinv), np.asarray(sol)


@pytest.mark.parametrize("cond,ok", [(1e3, True), (1e7, False)])
def test_ldl_factor_and_solve_plain_match_jax(cond, ok):
    """The plain block-LDL factor and its solve against the TPU kernel's
    ``_ldl_ns_stages``/``_ldl_solve`` at rp = 256 (two 128-wide tiles):
    M⁻¹b within 1e-4 relative (preconditioner grade) where the tiles pass
    their gates, and the failure flagged by both where they do not."""
    Hs = _spd_tile(256, cond, 5)
    b = np.random.default_rng(6).standard_normal((1, 256)).astype(
        np.float32)
    dinv_j, sol_j = _ldl_jax(Hs, b)
    Lt, Dinv, bad = hybrid.ldl_factor_plain(torch.as_tensor(Hs), 0.0)
    assert int(bad) == (not ok)
    assert bool(np.isfinite(dinv_j).all()) == ok
    if not ok:
        return
    x = np_of(hybrid.ldl_solve_plain(Lt, Dinv, torch.as_tensor(b[0])))
    assert np.abs(x - sol_j[0]).max() <= 1e-4 * np.abs(sol_j[0]).max()
    # and it preconditions: M⁻¹Hs ≈ I
    Mi = np_of(hybrid.ldl_solve_plain(Lt, Dinv, torch.eye(256)))
    assert np.linalg.norm(np.eye(256) - Mi @ Hs) < 0.1
    # several right-hand sides at once, column for column (to the fp32
    # rounding of products taken as matrix, not vector, products)
    B3 = torch.as_tensor(np.random.default_rng(8).standard_normal(
        (256, 3)).astype(np.float32))
    X3 = hybrid.ldl_solve_plain(Lt, Dinv, B3)
    for c in range(3):
        xc = hybrid.ldl_solve_plain(Lt, Dinv, B3[:, c].contiguous())
        assert float((X3[:, c] - xc).abs().max()) <= \
            1e-5 * float(xc.abs().max())


def _carry_instance():
    """tests/test_pallas_step.py:180's instance (k = 400, r = 96, seed 3)."""
    rng = np.random.default_rng(3)
    k, r = 400, 96
    C = rng.standard_normal((k, r))
    z = np.zeros(r)
    d = C @ z + rng.uniform(0.5, 2.0, k)
    return C, d, rng.standard_normal(r), z


def test_carry_chain_matches_jax():
    """Four dependent steps of the plain K2 with the cross-step carry
    against the TPU kernel's (interpret mode, ``minv``/``mvok``): the
    same hits step for step and the iterates within 1e-6.  The first step
    misses (no seed yet): both re-seed the carry with the LDL factor's
    solve applied to I and precondition that step with it
    (pallas_newton.py:697-701); the port's re-seed is M⁻¹I of its own
    plain factor of the step's Hs, exactly, and within 2e-3 (relative,
    max norm) of the TPU kernel's ``minv`` (two fp32 factors of the same
    Hs, each tile inverse to its Newton–Schulz gate)."""
    C, d, tc, z = _carry_instance()
    assert hybrid.ns_carry_supported(C.shape[1])
    consts = prep_reduced_consts(jnp.asarray(C), jnp.asarray(d))
    rp = _pad(C.shape[1])
    minv, mvok = jnp.zeros((rp, rp), jnp.float32), jnp.zeros(())
    zj, sig = jnp.asarray(z), jnp.asarray(_sigmas())
    cs = ns.prep_newton_consts(t64(C), t64(d))
    carry, zt = ns.NSCarry(), t64(z)
    hits_j = hits_t = 0.0
    for step in range(4):
        if step == 0:
            w = ns._Plain.nt_pass1(cs.C, zt, cs.d)[2]
            Hs = ns._Plain.equilibrate(ns._Plain.gram(cs.C32, w, None),
                                       hybrid.LDL_BLK)[0]
        zj, _, _, _, _, minv, mvok, hit = reduced_newton_step_prepared(
            consts, jnp.asarray(tc), zj, None, sig, alpha=ALPHA,
            interpret=True, minv=minv, mvok=mvok)
        zt, st = ns.newton_step(cs, t64(tc), zt, None, t64(_sigmas()),
                                alpha=ALPHA, carry=carry)
        hits_j += float(hit)
        hits_t += float(st[ns.ST_NS_HIT])
        assert np.abs(np_of(zt) - np.asarray(zj)).max() <= 1e-6
        if step == 0:
            assert float(hit) == 0.0
            assert st[ns.ST_TRIAL] == 0.0 and st[ns.ST_BRANCH] == 1.0
            Lt, Dinv, bad = ns._Plain.ldl_factor(Hs, 0.0)
            assert int(bad) == 0
            seed = ns._Plain.ldl_solve(Lt, Dinv, torch.eye(rp))
            assert torch.equal(carry.X, seed)
            mj = np.asarray(minv)
            assert (np.abs(np_of(carry.X) - mj).max()
                    <= 2e-3 * np.abs(mj).max())
    assert hits_t >= 1.0 and abs(hits_t - hits_j) <= 1.0
    assert carry.ok and carry.X.shape == (rp, rp)


def test_newton_feasible_with_and_without_carry(monkeypatch):
    """The carry shapes only the preconditioner: newton_feasible on the
    carry instance ends at the same point with and without it."""
    C, d, tc, _ = _carry_instance()
    prob = make_lp(tc, C=C, d=d, lb=None, ub=None, device="cpu")
    cfg = SolverConfig(epsilon=1e-8)
    runs = {}
    for on in (True, False):
        monkeypatch.setattr(newton, "ns_carry_supported", lambda r: on)
        hits = ns.COUNTS["carry_hits"]
        oracle = make_qp_oracle(prob, try_diag=False)
        res = newton.newton_feasible(oracle, t64(np.zeros(C.shape[1])),
                                     10.0, cfg)
        runs[on] = (np_of(res.x), ns.COUNTS["carry_hits"] - hits, res)
    assert runs[True][1] >= 1 and runs[False][1] == 0
    assert runs[True][2].success and runs[False][2].success
    assert np.abs(runs[True][0] - runs[False][0]).max() <= 1e-6


def test_engine_fills_counts_from_the_stats_row(monkeypatch):
    """The engine's one read per step carries K2's decisions: each step's
    stats row (``N_STATS`` entries) holds its preconditioner branch, the
    carry trial and the refined solve's counts, and ``newton_feasible``
    fills ``COUNTS`` from those rows alone (``tally``)."""
    C, d, tc, _ = _carry_instance()
    prob = make_lp(tc, C=C, d=d, lb=None, ub=None, device="cpu")
    rows = []
    orig = newton.newton_step

    def recording(*a, **kw):
        x, st = orig(*a, **kw)
        rows.append(st.tolist())
        return x, st

    monkeypatch.setattr(newton, "newton_step", recording)
    before = dict(ns.COUNTS)
    oracle = make_qp_oracle(prob, try_diag=False)
    res = newton.newton_feasible(oracle, t64(np.zeros(C.shape[1])), 10.0,
                                 SolverConfig(epsilon=1e-8))
    got = {k: ns.COUNTS[k] - before.get(k, 0) for k in ns.COUNTS}
    assert res.success and len(rows) == res.iters >= 3
    assert all(len(r) == ns.N_STATS for r in rows)
    branch = [int(r[ns.ST_BRANCH]) for r in rows]
    assert [r[ns.ST_NS_HIT] for r in rows] == [float(b == 0) for b in branch]
    assert [r[ns.ST_TRIAL] for r in rows] == [0.0] + [1.0] * (res.iters - 1)
    assert got["carry_trials"] == res.iters - 1
    for i, name in enumerate(ns.BRANCHES):
        assert got.get(name, 0) == sum(b == i if i < 3 else b >= 3
                                       for b in branch)
    for key, col in (("solve_rounds", ns.ST_ROUNDS),
                     ("solve_stalled", ns.ST_STALLED),
                     ("pcg_rounds", ns.ST_PCG), ("pcg_kept", ns.ST_KEPT)):
        assert got.get(key, 0) == sum(int(r[col]) for r in rows)


def _branch_gram(name):
    """(H fp32 Gram, carry seed or None, branch expected, form expected)
    of K2's preconditioner branches: a carry hit (κ = 1e2, the carry the
    fp64 inverse of its Jacobi-scaled form rescaled by 1%); LDL rung 0
    (κ = 1e3); LDL rung 1 (κ = 1e2 with row and column 150 zeroed: the
    second tile is singular at δ = 0, rung 1's jitter alone makes its
    zeroed coordinate invertible); the Cholesky fallback with its first
    rung refused by the pivot floor (I − (1 − 1e-7)vvᵀ at n = 500: both
    LDL rungs refuse it, and the δ = 0 factor is finite with its smallest
    pivot² below the floor, so the ladder takes rung 1)."""
    if name == "fallback_floor":
        n = 500
        rng = np.random.default_rng(5)
        v = rng.uniform(0.5, 1.5, n)
        v /= np.linalg.norm(v)
        H = np.eye(n) - (1 - 1e-7) * np.outer(v, v)
        return torch.as_tensor(H, dtype=torch.float32), None, 4
    n = 200
    rng = np.random.default_rng(n)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    top = {"carry_hit": 2, "ldl_rung0": 3, "ldl_rung1": 2}[name]
    H = (Q * np.logspace(0, top, n)) @ Q.T
    if name == "ldl_rung1":
        H[150, :] = 0.0
        H[:, 150] = 0.0
    seed = None
    if name == "carry_hit":
        dd = 1.0 / np.sqrt(np.diag(H))
        sc = 1.0 + 0.01 * rng.uniform(-1, 1, n)
        seed = np.eye(256)
        seed[:n, :n] = np.linalg.inv(H * (dd * sc)[:, None]
                                     * (dd * sc)[None, :])
        seed = torch.as_tensor(seed, dtype=torch.float32)
    return torch.as_tensor(H, dtype=torch.float32), seed, {
        "carry_hit": 0, "ldl_rung0": 1, "ldl_rung1": 2}[name]


@pytest.mark.parametrize("name,with_carry", [
    ("carry_hit", True), ("ldl_rung0", False), ("ldl_rung0", True),
    ("ldl_rung1", False), ("fallback_floor", False),
    ("fallback_floor", True)])
def test_plain_preconditioner_takes_each_branch(name, with_carry):
    """The plain twin of K2's preconditioner takes each branch on its
    seeded Gram, with the form the device step takes there: with a carry
    the dense X (the refreshed X on a hit, the re-seed M⁻¹I after an LDL
    rung, WᵀW after the fallback, left in the carry); without one the LDL
    factor of the rung taken (applied by its tile sweeps), or the W-solve
    of the fallback's W."""
    H32, seed, want = _branch_gram(name)
    carry = None
    if with_carry:
        carry = ns.NSCarry(X=seed, ok=seed is not None)
    pre = ns.preconditioner(ns._Plain, H32, carry)
    assert int(pre.branch) == want
    assert int(pre.kind) == (1 if with_carry else 2 if want < 3 else 0)
    assert pre.trial == (seed is not None)
    Hs = ns._Plain.equilibrate(H32, hybrid.LDL_BLK)[0]
    np_ = Hs.shape[0]
    if want == 0:
        X, hit = ns._Plain.ns_refresh(Hs, seed)[:2]
        assert int(hit) == 1 and torch.equal(pre.X, X)
    elif want in (1, 2):
        Lt, Dinv, bad = ns._Plain.ldl_factor(Hs, hybrid.LDL_JITTERS[want - 1])
        assert int(bad) == 0
        assert torch.equal(pre.ldl[1], Dinv)
        assert torch.equal(torch.tril(pre.ldl[0], -1), torch.tril(Lt, -1))
        if with_carry:
            assert torch.equal(pre.X, ns._Plain.ldl_solve(Lt, Dinv,
                                                          torch.eye(np_)))
    else:
        L, Dinv = refine.factor_jittered(ns._Plain, Hs, pivot_floor=True)
        assert not torch.equal(L, ns._Plain.factor(Hs, 0.0)[0])
        W = ns._Plain.invert(L, Dinv)
        assert torch.equal(pre.W, W)
        if with_carry:
            assert torch.equal(pre.X, W.T @ W)
    if carry is not None:
        assert carry.ok and carry.X is pre.X


def test_step_reads_c_dx_from_the_last_operator_pass():
    """C·dx for the sweep comes from the refinement's last operator
    application (the TPU kernel's side channel) and equals a fresh pass."""
    C, d, tc, z, tP = _case("qp")
    cs = ns.prep_newton_consts(t64(C), t64(d))
    g, _, w, _ = ns._gradient(ns._Plain, cs, t64(tc), t64(z), t64(tP))
    dx, _, _, cdx, _, _ = ns._solve_dir(ns._Plain, cs, w, g, t64(tP),
                                        t64(tP).float(), 3, 1e-12)
    assert cdx is not None
    assert torch.equal(cdx, cs.C @ dx)


@pytest.mark.parametrize("form", [0, 1, 2])
def test_plain_solve_applies_forms_through_precond_apply(form):
    """The plain refined solve applies the X (1) and LDL (2) forms through
    its backend's ``precond_apply`` (a subclass may replace it, as a
    check's reference on the CUDA preconditioner does) and the W-solve
    (0) without it; the same bits as the plain backend where the
    replacement is the plain apply."""
    rng = np.random.default_rng(5)
    k, r = 60, 20
    C = t64(rng.standard_normal((k, r)))
    w = t64(rng.uniform(0.5, 2.0, k))
    b = t64(rng.standard_normal(r))
    Hs, dsc = ns._Plain.equilibrate(ns._Plain.gram(C.float(), w, None),
                                    hybrid.LDL_BLK)
    ldl = ns._Plain.ldl_factor(Hs, 0.0)[:2]
    X = hybrid.ldl_solve_plain(*ldl, torch.eye(Hs.shape[0]))
    W = torch.linalg.inv(torch.linalg.cholesky(Hs.double())).float()
    seen = []

    class Recorded(ns._Plain):
        @staticmethod
        def precond_apply(form_, X_, ldl_, v):
            seen.append(form_)
            return hybrid.precond_apply_plain(form_, X_, ldl_, v)

    kind = torch.tensor(form, dtype=torch.int32)
    args = (C, w, None, W, dsc, b, 3, 1e-12)
    got = Recorded.refined_solve(*args, kind=kind, X=X, ldl=ldl)
    want = ns._Plain.refined_solve(*args, kind=kind, X=X, ldl=ldl)
    for a, e in zip(got, want):
        assert torch.equal(a, e)
    assert len(seen) == (int(got[4][0]) if form else 0) and \
        set(seen) <= {form}
    assert float(got[1]) <= 1e-20 * float(got[2])


def test_pcg_batches_its_reads_and_keeps_its_rounds(monkeypatch):
    """The PCG with its host-read stride (``PCG_STRIDE`` = 4) returns bit
    for bit what it returns reading its test every round, with fewer host
    reads."""
    rng = np.random.default_rng(4)
    n = 60
    M = rng.standard_normal((n, n))
    H = t64(M @ M.T + 1e-6 * np.eye(n))
    b = t64(rng.standard_normal(n))
    dsc = 1.0 / torch.sqrt(torch.diagonal(H))
    Hs32 = (H * dsc[:, None] * dsc[None, :]).float()
    Hs32 = Hs32 + 0.05 * torch.eye(n)        # a deliberately weak M

    def precond(v):
        return torch.linalg.solve(Hs32, v.float()).double()

    out = {}
    assert refine.PCG_STRIDE == 4
    for stride in (1, 4):
        monkeypatch.setattr(refine, "PCG_STRIDE", stride)
        c0 = sync.count
        x, r = refine.pcg(precond, lambda v: H @ v, dsc, b,
                          torch.zeros(n, dtype=torch.float64), b,
                          refine.sq(b, dsc), 1e-20)
        out[stride] = (x, r, sync.count - c0)
    assert torch.equal(out[1][0], out[4][0])
    assert torch.equal(out[1][1], out[4][1])
    assert out[4][2] < out[1][2]


def test_fallback_floors_the_first_rung_only():
    """K2's Cholesky fallback: a pivot² within the rounding fails the
    first rung (δ = 0) even where it is positive; the jittered rungs keep
    finiteness."""
    v = np.linspace(1.0, 2.0, 64)
    v /= np.linalg.norm(v)
    Hs = torch.as_tensor(np.eye(64) - (1 - 1e-7) * np.outer(v, v),
                         dtype=torch.float32)
    Hs = PdPlain.equilibrate(Hs)[0]
    deltas = []
    orig = PdPlain.factor

    class Ops(PdPlain):
        @staticmethod
        def factor(A, delta):
            deltas.append(delta)
            return orig(A, delta)

    L, _ = refine.factor_jittered(Ops, Hs)
    assert deltas == [0.0] and torch.isfinite(L).all()
    deltas.clear()
    refine.factor_jittered(Ops, Hs, pivot_floor=True)
    assert deltas == [0.0, 1e-6]
    assert refine.pivot_floor2(64, 0.0, torch.float32) == \
        4 * 65 * 2.0 ** -24


@pytest.mark.parametrize("np_, entry", [
    (256, "ip_block_solve_column"), (512, "ip_block_solve_column"),
    (1024, "ip_block_solve_column"), (1152, "ip_block_solve")])
def test_ldl_solve_routes_by_np(monkeypatch, np_, entry):
    """K2's preconditioner apply M⁻¹v (p = 1) is one launch of csolve.cu's
    one-cluster kernel up to ``chol.COLUMN_MAX_N`` rows (the n = 1000
    barrier rows' np = 256, lp5000_barrier's 1024), with the tile inverses
    as its middle stack and nothing else; past it one launch of chol.cu's
    8-column tasks.  Counted once each, none of them a wide launch."""
    from interiorpoint_tpu_torch.kernels import _build
    calls = []
    monkeypatch.setattr(_build, "launch",
                        lambda name, *a: calls.append((name, a)))
    monkeypatch.setattr(_build, "query", lambda name, *a: 64)
    Lt = torch.zeros(np_, np_)
    Dinv = torch.zeros(np_, hybrid.LDL_BLK)
    v = torch.zeros(np_)
    n0, w0 = hybrid.ldl_solve_cuda.launches, \
        hybrid.ldl_solve_cuda.wide_launches
    x = hybrid.ldl_solve_cuda(Lt, Dinv, v)
    assert x.shape == v.shape and [c[0] for c in calls] == [entry]
    L, ldl, n, te, F, M, G = calls[0][1][:7]
    assert (L is Lt and ldl == np_ and n == np_ and te == hybrid.LDL_BLK
            and F is None and M is Dinv and G is None)
    assert hybrid.ldl_solve_cuda.launches == n0 + 1
    assert hybrid.ldl_solve_cuda.wide_launches == w0
    hybrid.ldl_solve_cuda.launches = n0


@pytest.mark.parametrize("call", [
    lambda: hybrid.ldl_solve_cuda(torch.eye(256, dtype=torch.float64),
                                  torch.zeros(256, 128), torch.zeros(256)),
    lambda: hybrid.ldl_solve_cuda(torch.eye(256), torch.zeros(256, 64),
                                  torch.zeros(256)),
    lambda: hybrid.ldl_solve_cuda(torch.eye(256), torch.zeros(128, 128),
                                  torch.zeros(256)),
    lambda: hybrid.ldl_solve_cuda(torch.eye(256), torch.zeros(256, 128),
                                  torch.zeros(384)),
    lambda: hybrid.ldl_solve_cuda(torch.eye(256), torch.zeros(256, 128),
                                  torch.zeros(512)[::2]),
    lambda: hybrid.ldl_solve_cuda(torch.eye(256), torch.zeros(256, 128),
                                  torch.zeros(256, dtype=torch.float64)),
    lambda: hybrid.ldl_solve_cuda(torch.eye(256).T.contiguous().T,
                                  torch.zeros(256, 128), torch.zeros(256)),
], ids=["fp64_factor", "tiles_64_wide", "tiles_short", "b_longer_than_L",
        "b_strided", "b_fp64", "L_column_major"])
def test_ldl_solve_refuses_what_the_solve_kernels_cannot_read(call):
    """The LDL apply's wrapper checks types, shapes and layouts before any
    launch: the kernels read L̃ row-major in place, the tile inverses as an
    (np, 128) stack and v as np contiguous floats."""
    with pytest.raises(ValueError):
        call()
