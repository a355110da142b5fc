"""The fused SOCP Newton step K4 (ops/socp_step.py) in its plain version,
against the JAX package's fp64 SOCP oracle (make_socp_oracle, dd=False)
and against its Pallas kernel in interpret mode
(socp_newton_step_prepared), on the instances of
tests/test_pallas_socp.py (K=3 cones of M=24 rows, r=40).

Tolerances.  The pieces (pass 1, G, the line-search coefficients) are
fp64 sums in another order than the oracle's: 1e-12 relative to their
terms.  The direction solves the oracle's own Hessian (the refinement's
operator is fp64 throughout): its residual ‖H dx + g‖/‖g‖ is held at
1e-9, far below the 1e-4 the JAX test allows its kernel.  σ is compared
exactly with the fp64 Armijo rule on the oracle (both take the same fp64
candidates) and to 1e-6 relative with the kernel's f32 σ.  Against the
interpret-mode kernel, x' at the JAX test's 5e-6 and nd at its 1e-4
(relative, x' in the max norm) and dx at 1e-5: the kernel solves the
operator {exact curvature + Gram(G32)}, about 1e-7 from the oracle's
Hessian, and XLA:CPU simplifies its double-float error terms to about f32
accuracy (measured here: dx 5.8e-8 apart, 1.6e-6 near the boundary).
Interpret-mode calls cost 9-13 s each here, so there are two."""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_helpers import np_of, rel, t64
from interiorpoint_tpu.models.problem import make_socp as make_socp_j
from interiorpoint_tpu.ops.pallas_socp import (prep_socp_consts as
                                               prep_socp_consts_j,
                                               socp_newton_step_prepared)
from interiorpoint_tpu.ops.socp import make_socp_oracle as oracle_j
from interiorpoint_tpu_torch.models.problem import make_socp
from interiorpoint_tpu_torch.ops import socp as socp_t
from interiorpoint_tpu_torch.ops import socp_step as ks
from interiorpoint_tpu_torch.ops.newton_step import (ST_ANY, ST_DIR_OK,
                                                     ST_GDX, ST_INDEX, ST_ND,
                                                     ST_Q2, ST_RN2, ST_BN2,
                                                     ST_SIGMA, ST_SMIN)
from interiorpoint_tpu_torch.utils import convert

ALPHA, BETA, J = 0.2, 0.6, 40
K, M, R = 3, 24, 40


def _sigmas():
    return BETA ** np.arange(J)


def _case(seed, with_P=True, tight_cone=None):
    """Pure-cone SOCP data with z0 strictly interior: d_k = ‖A_k z0 + b_k‖
    − c_k·z0 + margin_k (tests/test_pallas_socp.py's recipe)."""
    rng = np.random.default_rng(seed)
    A = [rng.standard_normal((M, R)) for _ in range(K)]
    b = [rng.standard_normal(M) for _ in range(K)]
    c = [rng.standard_normal(R) for _ in range(K)]
    z0 = rng.standard_normal(R) * 0.3
    margins = rng.uniform(0.5, 1.5, K)
    if tight_cone is not None:
        margins[tight_cone] = 1e-3
    d = [float(np.linalg.norm(A[i] @ z0 + b[i]) - c[i] @ z0 + margins[i])
         for i in range(K)]
    P = None
    if with_P:
        Mm = rng.standard_normal((R, R))
        P = Mm @ Mm.T / R + np.eye(R)
    q = rng.standard_normal(R)
    return (A, b, c, d, P, q), z0


def _problems(data):
    A, b, c, d, P, q = data
    pj = make_socp_j(A, b, c, d, P, q, None, None, None, None,
                     dtype=jnp.float64)
    pt = make_socp(A, b, c, d, P, q, device="cpu")
    return pj, pt


def _ref_select(oracle, z, dx, t):
    """Largest candidate passing the domain and Armijo tests on the fp64
    barrier Newton objective (the oracle path's rule)."""
    sig = _sigmas()
    zj, dxj = jnp.asarray(z), jnp.asarray(dx)
    g = np.asarray(oracle.grad(zj, t))
    f0 = float(oracle.newton_obj(zj, t))
    ok, nobjs = oracle.ls_objs(zj, dxj, t, jnp.asarray(sig))
    ok, nobjs = np.asarray(ok), np.asarray(nobjs)
    for j, s_ in enumerate(sig):
        if ok[j] and nobjs[j] <= f0 + ALPHA * s_ * (g @ dx):
            return s_
    return 0.0


def _step_inputs(pt, t):
    r = pt.n
    tq = t * pt.q if pt.q is not None else torch.zeros(r, dtype=torch.float64)
    tP = None if pt.P is None else (t * pt.P).contiguous()
    return tq.contiguous(), tP


def _stacked_weights(cs):
    """The step's stacked weights buffer [w_row; w; w²] (K·M + 2K)."""
    return torch.empty(cs.K * cs.M + 2 * cs.K, dtype=torch.float64)


def _plain_direction(cs, tq, z, tP, dir_tol):
    """g and dx of the plain step's own orchestration."""
    ops = ks._Plain
    wt = _stacked_weights(cs)
    g = ks._gradient(ops, cs, tq, z, tP, wt)[0]
    dx = ks._solve_dir(ops, cs, wt, g, tP,
                       None if tP is None else tP.float(), 3,
                       dir_tol ** 2)[0]
    return g, dx


@pytest.mark.parametrize("with_P", [True, False])
def test_plain_step_solves_the_oracle_newton_system(with_P):
    data, z0 = _case(3, with_P=with_P)
    pj, pt = _problems(data)
    oj = oracle_j(pj, dd=False)
    t = 5.0
    cs = ks.prep_socp_consts(pt)
    tq, tP = _step_inputs(pt, t)
    z = t64(z0)
    calls = ks.socp_newton_step_plain.calls
    x_new, st = ks.socp_newton_step(cs, tq, z, tP, t64(_sigmas()),
                                    alpha=ALPHA, dir_tol=1e-10)
    assert ks.socp_newton_step_plain.calls == calls + 1
    st = np_of(st)
    g, dx = (np_of(v) for v in _plain_direction(cs, tq, z, tP, 1e-10))
    g_ref = np.asarray(oj.grad(jnp.asarray(z0), t))
    H_ref = np.asarray(oj.hess(jnp.asarray(z0), t))
    assert rel(g, g_ref) <= 1e-12
    assert (np.linalg.norm(H_ref @ dx + g_ref)
            / np.linalg.norm(g_ref)) <= 1e-9
    sigma = st[ST_SIGMA]
    assert st[ST_ANY] == 1.0 and st[ST_DIR_OK] == 1.0
    assert sigma == _ref_select(oj, z0, dx, t)
    assert sigma == _sigmas()[int(st[ST_INDEX])]
    np.testing.assert_allclose(np_of(x_new), z0 + sigma * dx, rtol=1e-14,
                               atol=1e-15)
    assert st[ST_GDX] == pytest.approx(g @ dx, rel=1e-12)
    assert st[ST_ND] == pytest.approx(-0.5 * g @ dx, rel=1e-12)
    assert st[ST_RN2] <= 1e-4 * st[ST_BN2]
    slack = np.asarray(oj.min_slack(jnp.asarray(z0)))
    lhs = np.einsum("kmn,n->km", np.asarray(pj.A), z0) + np.asarray(pj.b)
    rhs = np.asarray(pj.c) @ z0 + np.asarray(pj.d)
    s_ref = rhs ** 2 - (lhs ** 2).sum(axis=1)
    assert st[ST_SMIN] == pytest.approx(s_ref.min(), rel=1e-12)
    assert slack <= s_ref.min()
    if with_P:
        assert st[ST_Q2] == pytest.approx(0.5 * dx @ np_of(tP) @ dx,
                                          rel=1e-12)
    else:
        assert st[ST_Q2] == 0.0


def test_pieces_match_the_oracle():
    """Pass 1, G and the gradient, the Hessian the refinement applies and
    the line-search coefficients against the JAX oracle's own formulas."""
    data, z0 = _case(5, with_P=True)
    pj, pt = _problems(data)
    cs = ks.prep_socp_consts(pt)
    A3, b2 = np.asarray(pj.A), np.asarray(pj.b)
    c2, d1 = np.asarray(pj.c), np.asarray(pj.d)
    ops = ks._Plain
    wt = _stacked_weights(cs)
    lhs, rhs, s, w, w_row, smin = (np_of(v) for v in ops.socp_pass1(
        cs.A, t64(z0), cs.b, cs.c, cs.d, cs.M, wt))
    np.testing.assert_array_equal(np_of(wt[:K * M + K]),
                                  np.concatenate([w_row, w]))
    lhs_ref = np.einsum("kmn,n->km", A3, z0) + b2
    rhs_ref = c2 @ z0 + d1
    s_ref = rhs_ref ** 2 - (lhs_ref ** 2).sum(axis=1)
    assert rel(lhs, lhs_ref.reshape(-1)) <= 1e-13
    assert rel(rhs, rhs_ref) <= 1e-13
    assert np.abs(s - s_ref).max() <= 1e-12 * (rhs_ref ** 2).max()
    np.testing.assert_allclose(w, 2.0 / (s + 1e-12), rtol=1e-15)
    np.testing.assert_array_equal(w_row, np.repeat(w, M))
    assert smin == s.min()
    G, wG = (np_of(v) for v in ops.socp_gcone(
        cs.A, t64(lhs), cs.c, t64(rhs), t64(w), cs.M,
        torch.empty((K, R), dtype=torch.float64)))
    G_ref = np.einsum("kmn,km->kn", A3, lhs_ref) - c2 * rhs_ref[:, None]
    assert rel(G, G_ref) <= 1e-12
    assert rel(wG, w @ G_ref) <= 1e-12
    # the operator of the refinement is the oracle's Hessian (no t·P):
    # the step's own stacked matrix and weights
    ks._gradient(ops, cs, torch.zeros(R, dtype=torch.float64), t64(z0),
                 None, wt)
    np.testing.assert_array_equal(np_of(cs.Ast[K * M + K:]), G)
    S, ws = cs.Ast[K * M:], wt[K * M:]
    H = (np_of(cs.A).T @ (w_row[:, None] * np_of(cs.A))
         + np_of(S).T @ (np_of(ws)[:, None] * np_of(S)))
    H_ref = np.asarray(oracle_j(pj, dd=False).hess(jnp.asarray(z0), 0.0))
    assert rel(H, H_ref) <= 1e-12
    # the line-search coefficients from the stacked operator's side
    # channel M·dx = [A dx; c·dx; G dx]
    dx = np.random.default_rng(1).standard_normal(R) * 0.1
    _, mdx = ops.h_apply(cs.Ast, wt, t64(dx))
    ip1, ip2 = (np_of(v) for v in ops.socp_lscoef(mdx[:K * M], t64(lhs),
                                                  cs.M))
    cdx = np_of(mdx[K * M:K * M + K])
    adx = np.einsum("kmn,n->km", A3, dx)
    assert rel(ip1, (lhs_ref * adx).sum(axis=1)) <= 1e-12
    assert rel(ip2, (adx ** 2).sum(axis=1)) <= 1e-12
    assert rel(cdx, c2 @ dx) <= 1e-13


def _sweep(ip1, ip2, cdx, rhs, s, gdx, q2=0.0):
    sig = t64(_sigmas())
    z = torch.zeros(4, dtype=torch.float64)
    dx = torch.ones(4, dtype=torch.float64)
    f = lambda v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
    return ks._Plain.socp_sweep(t64(ip1), t64(ip2), t64(cdx), t64(rhs),
                                t64(s), sig, f(gdx), f(q2), ALPHA, z, dx)


def test_sweep_rhs_domain_decides_alone():
    """A cone whose step leaves its rhs ≥ 0 half-space at σ ≥ 0.5 while
    its squared slack and its barrier term stay unchanged (p1 = p2 = 0):
    only the rhs test rejects σ = 1 and 0.6, so the sweep takes 0.36."""
    phisum, umin, vmin, sel, xnew = _sweep(
        ip1=[-2.0, 0.0], ip2=[4.0, 0.0], cdx=[-2.0, 0.0], rhs=[1.0, 1.0],
        s=[1.0, 1.0], gdx=-1.0)
    np.testing.assert_array_equal(np_of(umin), 0.0)
    np.testing.assert_array_equal(np_of(phisum), 0.0)
    np.testing.assert_allclose(np_of(vmin), -2.0 * _sigmas(), rtol=1e-15)
    assert np_of(sel).tolist() == [_sigmas()[2], 2.0, 1.0]
    np.testing.assert_allclose(np_of(xnew), _sigmas()[2], rtol=1e-15)


def test_sweep_rejects_every_candidate_on_ascent():
    """g·dx > 0: nothing passes the Armijo test, σ = 0 and x' = z."""
    phisum, umin, vmin, sel, xnew = _sweep(
        ip1=[0.1, -0.2], ip2=[0.3, 0.1], cdx=[0.2, 0.1], rhs=[2.0, 1.5],
        s=[1.0, 0.5], gdx=1.0)
    assert np_of(sel).tolist() == [0.0, 0.0, 0.0]
    assert float(xnew.abs().max()) == 0.0
    assert phisum.shape == umin.shape == vmin.shape == (J,)


@functools.lru_cache(maxsize=None)
def _jax_step(seed, tight_cone, t):
    data, z0 = _case(seed, with_P=True, tight_cone=tight_cone)
    pj, _ = _problems(data)
    consts = prep_socp_consts_j(pj)
    out = socp_newton_step_prepared(
        consts, t * pj.q, jnp.asarray(z0), t * pj.P,
        jnp.asarray(_sigmas()), alpha=ALPHA, interpret=True)
    x_new, nd, sigma, any_acc, dir_ok, dx = out
    return (consts, np.asarray(x_new), float(nd), float(sigma),
            bool(any_acc), bool(dir_ok), np.asarray(dx))


@pytest.mark.parametrize("seed,tight_cone,t", [(3, None, 5.0), (9, 1, 50.0)])
def test_plain_step_matches_pallas_interpret(seed, tight_cone, t):
    """On consts carried over from the JAX package; (9, 1): one cone at
    slack 1e-3, where the full step leaves the cone and the sweep must
    backtrack."""
    data, z0 = _case(seed, with_P=True, tight_cone=tight_cone)
    pj, pt = _problems(data)
    consts, xj, ndj, sigj, accj, okj, dxj = _jax_step(seed, tight_cone, t)
    cs = convert.socp_consts_from_jax(consts, device="cpu")
    # the joined double-float A is the fp64 A to 2⁻⁴⁸ relative
    A_ref = np.asarray(pj.A).reshape(K * M, R)
    assert np.abs(np_of(cs.A) - A_ref).max() <= 1e-13 * np.abs(A_ref).max()
    assert cs.M == M and (cs.K, cs.r) == (K, R)
    tq, tP = _step_inputs(pt, t)
    x_new, st = ks.socp_newton_step(cs, tq, t64(z0), tP, t64(_sigmas()),
                                    alpha=ALPHA)
    st = np_of(st)
    _, dx = _plain_direction(cs, tq, t64(z0), tP, 1e-6)
    sigma = st[ST_SIGMA]
    assert accj and st[ST_ANY] == 1.0
    assert sigma == _ref_select(oracle_j(pj, dd=False), z0, np_of(dx), t)
    assert sigma == pytest.approx(sigj, rel=1e-6)
    if tight_cone is not None:
        assert sigma < 1.0
    else:
        assert okj and st[ST_DIR_OK] == 1.0
    assert rel(np_of(x_new), xj) <= 5e-6
    assert rel(np_of(dx), dxj) <= 1e-5
    assert st[ST_ND] == pytest.approx(ndj, rel=1e-4)
    # the accepted iterate stays strictly inside every cone
    xs = np_of(x_new)
    lhs = np.einsum("kmn,n->km", np.asarray(pj.A), xs) + np.asarray(pj.b)
    rhs = np.asarray(pj.c) @ xs + np.asarray(pj.d)
    assert (rhs ** 2 - (lhs ** 2).sum(axis=1)).min() > 0 and rhs.min() > 0


def test_newton_feasible_takes_k4_without_the_curvature_cache():
    """The engine's fused branch: every Newton step one K4 (plain here),
    and the oracle's K·n·n curvature cache is never built; the first
    ``hess`` call builds it once."""
    from interiorpoint_tpu_torch.ops.newton import newton_feasible
    from interiorpoint_tpu_torch.utils.config import SolverConfig

    data, z0 = _case(3, with_P=True)
    _, pt = _problems(data)
    oracle = socp_t.make_socp_oracle(pt)
    assert oracle.socp_form is pt
    builds = socp_t.curvature_cache_builds
    calls = ks.socp_newton_step_plain.calls
    cfg = SolverConfig(dtype="float64", max_inner_iters=30)
    res = newton_feasible(oracle, t64(z0), 5.0, cfg)
    assert res.success and res.iters > 1
    assert ks.socp_newton_step_plain.calls == calls + res.iters
    assert socp_t.curvature_cache_builds == builds
    # phase one never takes K4 (the JAX package's gate)
    p1 = socp_t.make_phase1_socp_oracle(pt)
    assert p1.socp_form is None
    oracle.hess(t64(z0), 1.0)
    oracle.hess(t64(z0), 2.0)
    assert socp_t.curvature_cache_builds == builds + 1


def test_device_dispatch_and_refusals():
    data, z0 = _case(3, with_P=True)
    _, pt = _problems(data)
    cs = ks.prep_socp_consts(pt)
    tq, tP = _step_inputs(pt, 5.0)
    args = (tq, t64(z0), tP, t64(_sigmas()))
    before = ks.socp_newton_step.launches
    ks.socp_newton_step(cs, *args, alpha=ALPHA)
    # CPU tensors never count as kernel launches
    assert ks.socp_newton_step.launches == before
    bad = [
        (tq.float(), args[1], args[2], args[3]),             # fp32 tq
        (args[0], t64(z0)[:-1], args[2], args[3]),            # short z
        (args[0], args[1], tP.T, args[3]),                    # tP layout
        (args[0], args[1], args[2], t64(_sigmas())[:0]),      # no sigma
        (args[0], args[1], args[2], t64(_sigmas()).float()),  # fp32 sigma
    ]
    for a in bad:
        with pytest.raises(ValueError):
            ks.socp_newton_step(cs, *a, alpha=ALPHA)
    meta = dict(dtype=torch.float64, device="meta")
    cs_m = ks.SOCPConsts(A=torch.empty((K * M, R), **meta),
                         A32=torch.empty((K * M, R), dtype=torch.float32,
                                         device="meta"),
                         b=torch.empty(K * M, **meta),
                         c=torch.empty((K, R), **meta),
                         d=torch.empty(K, **meta), M=M)
    with pytest.raises(ValueError, match="unsupported device"):
        ks.socp_newton_step(cs_m, torch.empty(R, **meta),
                            torch.empty(R, **meta), None,
                            torch.empty(J, **meta), alpha=ALPHA)


@pytest.mark.parametrize("with_P", [True, False])
def test_stacked_operator_and_gram_match_the_two_operand_ones(with_P):
    """The stacked matrix [A; c; G] with weights [w_row; w; w²]: its
    operator (the fused h_apply, + tP) and its fp32 Gram against the
    two-operand forms A_flatᵀ diag(w_row) A_flat + Sᵀ diag([w; w²]) S that
    the step used before, to 1e-13 relative (the Gram in fp64 on the fp32
    copies; the step's fp32 Gram to its own rounding)."""
    data, z0 = _case(7, with_P=with_P)
    _, pt = _problems(data)
    cs = ks.prep_socp_consts(pt)
    tq, tP = _step_inputs(pt, 5.0)
    ops = ks._Plain
    wt = _stacked_weights(cs)
    _, (lhs, rhs, _, w, w_row, _) = ks._gradient(ops, cs, tq, t64(z0), tP,
                                                 wt)
    S, ws = cs.Ast[K * M:], wt[K * M:]
    G = ks._Plain.socp_gcone(cs.A, lhs, cs.c, rhs, w, M,
                             torch.empty((K, R), dtype=torch.float64))[0]
    assert S.shape == (2 * K, R)
    np.testing.assert_array_equal(np_of(S[:K]), np_of(cs.c))
    np.testing.assert_array_equal(np_of(S[K:]), np_of(G))
    np.testing.assert_array_equal(np_of(ws), np_of(torch.cat([w, w * w])))
    x = t64(np.random.default_rng(2).standard_normal(R))
    hx, mx = ops.h_apply(cs.Ast, wt, x, tP)
    two = (cs.A.T @ (w_row * (cs.A @ x)) + S.T @ (ws * (S @ x)))
    if tP is not None:
        two = two + tP @ x
    assert rel(np_of(hx), np_of(two)) <= 1e-13
    assert rel(np_of(mx[:K * M]), np_of(cs.A @ x)) <= 1e-13
    assert rel(np_of(mx[K * M:K * M + K]), np_of(cs.c @ x)) <= 1e-13
    # the fp32 copy of the stacked rows, and its Gram
    np.testing.assert_array_equal(np_of(cs.Ast32), np_of(cs.Ast.float()))
    A64, S64 = cs.A32.double(), cs.Ast32[K * M:].double()
    gram2 = (A64.T @ (w_row.float().double()[:, None] * A64)
             + S64.T @ (ws.float().double()[:, None] * S64))
    gram_st = (cs.Ast32.double().T
               @ (wt.float().double()[:, None] * cs.Ast32.double()))
    assert rel(np_of(gram_st), np_of(gram2)) <= 1e-13
    H32 = ops.gram(cs.Ast32, wt, None if tP is None else tP.float())
    if tP is not None:
        gram2 = gram2 + tP.float().double()
    assert rel(np_of(H32), np_of(gram2)) <= 1e-5
