"""The port's barrier engine against the JAX package's on the CPU: the
oracles (ops/barrier.py), the KKT strategies (ops/kkt.py), the Newton
engines and the outer loop (ops/newton.py, ops/ipm.py), and the drivers
``LPSolver``/``QPSolver`` with the default ``algorithm="barrier"``.

Tolerances.  Oracles and linear solves are fp64 on both sides (1e-12 to
1e-9 relative, by conditioning).  The drivers: the JAX package on the CPU
takes the oracle path with the fp64 candidate sweep, the port the fused
step K2 (its plain version here), so a borderline Armijo candidate can
flip between them; values are held within the two reported duality gaps
and outer stages must agree.  With ``use_pallas=False`` on both sides
the algorithms are the same and the outer and inner counts must be
equal, the values within 1e-9 relative."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_helpers import np_of, rel, t64
import interiorpoint_tpu as ipj
import interiorpoint_tpu_torch as ipt
from interiorpoint_tpu.models import problem as prob_j
from interiorpoint_tpu.ops import barrier as bar_j
from interiorpoint_tpu.ops import ipm as ipm_j
from interiorpoint_tpu.ops import kkt as kkt_j
from interiorpoint_tpu.ops import newton as newton_j
from interiorpoint_tpu.utils.config import SolverConfig as CfgJ
from interiorpoint_tpu_torch.models import problem as prob_t
from interiorpoint_tpu_torch.ops import barrier as bar_t
from interiorpoint_tpu_torch.ops import ipm as ipm_t
from interiorpoint_tpu_torch.ops import kkt as kkt_t
from interiorpoint_tpu_torch.ops import newton as newton_t
from interiorpoint_tpu_torch.ops import newton_step
from interiorpoint_tpu_torch.utils import convert
from interiorpoint_tpu_torch.utils.config import SolverConfig
from interiorpoint_tpu_torch.utils.generators import generate_lp, \
    generate_qp

KW = dict(suppress_print=True, check_cvxpy=False)


# ---------------------------------------------------------------------------
# oracles
# ---------------------------------------------------------------------------

def _ineq_problem(kind, seed=0, n=12, k=9):
    """Problem data without equalities and a strictly feasible x."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5, 0.5, n)
    kw = dict(C=None, d=None, lb=None, ub=None)
    if kind in ("lp_dense", "qp", "lp_form", "qp_form"):
        C = rng.uniform(-1, 1, (k, n))
        kw.update(C=C, d=C @ x + rng.uniform(0.2, 1.0, k))
    if kind in ("lp_dense", "lp_diag", "lp_nodiag", "qp"):
        kw.update(lb=-1.0 + rng.uniform(-0.2, 0.2, n),
                  ub=1.0 + rng.uniform(-0.2, 0.2, n))
    if kind.startswith("qp"):
        M = rng.uniform(-1, 1, (n, n))
        data = dict(P=M.T @ M + np.eye(n),
                    q=None if kind == "qp_form" else rng.uniform(-1, 1, n),
                    **kw)
        return data, x, rng
    return dict(c=rng.uniform(-1, 1, n), **kw), x, rng


def _make(mod, data):
    data = dict(data)
    dev = {"device": "cpu"} if mod is prob_t else {}
    if "P" in data:
        return mod.make_qp(data.pop("P"), data.pop("q"), **data, **dev)
    return mod.make_lp(data.pop("c"), **data, **dev)


@pytest.mark.parametrize("kind", ["lp_dense", "lp_diag", "lp_nodiag",
                                  "lp_form", "qp", "qp_form"])
def test_oracles_match_jax(kind):
    data, x, rng = _ineq_problem(kind, seed=len(kind))
    try_diag = kind != "lp_nodiag"
    oj = bar_j.make_qp_oracle(_make(prob_j, data), try_diag=try_diag)
    pt = _make(prob_t, data)
    ot = bar_t.make_qp_oracle(pt, try_diag=try_diag)
    assert ot.diag_hessian == oj.diag_hessian == (kind == "lp_diag")
    assert (ot.lin_form is None) == (oj.lin_form is None) == \
        (not kind.endswith("form"))
    n = x.shape[0]
    dx = rng.standard_normal(n) * 5.0
    sig = 0.6 ** np.arange(16)
    xj, dxj, sj = jnp.asarray(x), jnp.asarray(dx), jnp.asarray(sig)
    xt, dxt, st = t64(x), t64(dx), t64(sig)
    t = 3.7
    for name, a, b in [
            ("obj", ot.obj(xt), oj.obj(xj)),
            ("grad", ot.grad(xt, t), oj.grad(xj, t)),
            ("hess", ot.hess(xt, t), oj.hess(xj, t)),
            ("newton_obj", ot.newton_obj(xt, t), oj.newton_obj(xj, t)),
            ("min_slack", ot.min_slack(xt), oj.min_slack(xj)),
            ("slacks", bar_t.full_linear_slacks(pt, xt),
             bar_j.full_linear_slacks(_make(prob_j, data), xj))]:
        assert rel(np_of(a), np_of(b)) < 1e-12, name
    for name in ("ls_objs", "ls_grads"):
        okt, vt = getattr(ot, name)(xt, dxt, t, st)
        okj, vj = getattr(oj, name)(xj, dxj, t, sj)
        assert np.array_equal(np_of(okt), np.asarray(okj)), name
        assert not np_of(okt).all(), name   # the long steps leave the domain
        fin = np.asarray(okj)
        assert rel(np_of(vt)[..., fin], np.asarray(vj)[..., fin]) < 1e-12
    if ot.lin_form is not None:
        cs = ot.nt_consts()
        assert cs is ot.nt_consts()      # made once per oracle
        assert torch.equal(cs.C, pt.C) and cs.C32.dtype == torch.float32


@pytest.mark.parametrize("bounds", [False, True])
def test_phase1_oracle_matches_jax(bounds):
    data, x, rng = _ineq_problem("lp_dense" if bounds else "lp_form",
                                 seed=5)
    x = x + 2.0    # violates some rows: the phase-one slack is positive
    oj = bar_j.make_phase1_linear_oracle(_make(prob_j, data))
    ot = bar_t.make_phase1_linear_oracle(_make(prob_t, data))
    assert ot.n == oj.n == x.shape[0] + 1
    z = np.concatenate([x, [float(-oj.min_slack(jnp.asarray(
        np.concatenate([x, [0.0]])))) + 1.0]])
    dz = rng.standard_normal(z.shape[0]) * 0.2
    sig = 0.6 ** np.arange(16)
    zj, zt = jnp.asarray(z), t64(z)
    t = 0.7
    for name, a, b in [
            ("obj", ot.obj(zt), oj.obj(zj)),
            ("grad", ot.grad(zt, t), oj.grad(zj, t)),
            ("hess", ot.hess(zt, t), oj.hess(zj, t)),
            ("newton_obj", ot.newton_obj(zt, t), oj.newton_obj(zj, t)),
            ("min_slack", ot.min_slack(zt), oj.min_slack(zj))]:
        assert rel(np_of(a), np_of(b)) < 1e-12, name
    okt, vt = ot.ls_objs(zt, t64(dz), t, t64(sig))
    okj, vj = oj.ls_objs(zj, jnp.asarray(dz), t, jnp.asarray(sig))
    assert np.array_equal(np_of(okt), np.asarray(okj))
    fin = np.asarray(okj)
    assert rel(np_of(vt)[fin], np.asarray(vj)[fin]) < 1e-12
    with pytest.raises(NotImplementedError, match="feasible-start"):
        ot.ls_grads(zt, t64(dz), t, t64(sig))
    assert (ot.lin_form is None) == (oj.lin_form is None) == bounds
    if not bounds:
        for a, b in zip(ot.lin_form[:3], oj.lin_form[:3]):
            assert np.array_equal(np_of(a), np.asarray(b))


# ---------------------------------------------------------------------------
# KKT strategies
# ---------------------------------------------------------------------------

def _kkt_system(seed=2, n=20, m=6):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    H = M @ M.T / n + np.diag(rng.uniform(0.5, 5.0, n))
    return (H, rng.standard_normal((m, n)), rng.standard_normal(n),
            rng.standard_normal(m), rng.standard_normal(n))


_KKT_CASES = [
    ("cholesky", dict(mixed=True)), ("cholesky", dict(mixed=False)),
    ("cholesky", dict(mixed=False, refine_steps=2)),
    ("cholesky", dict(mixed=True, use_psd_condition=True)),
    ("cholesky", dict(diag=True)), ("cholesky", dict(diag=True, mixed=True)),
    ("solve", dict(diag=True)), ("full_kkt", {}), ("solve", {}),
    ("lstsq", {}), ("inverse", {})]


@pytest.mark.parametrize("case", range(len(_KKT_CASES)))
def test_solve_kkt_eq_matches_jax(case):
    strategy, kw = _KKT_CASES[case]
    H, A, g, rpri, _ = _kkt_system()
    if kw.get("diag"):
        H = np.diag(H).copy()
    dxj, wj = kkt_j.solve_kkt_eq(jnp.asarray(H), jnp.asarray(A),
                                 jnp.asarray(g), jnp.asarray(rpri),
                                 strategy, **kw)
    dxt, wt = kkt_t.solve_kkt_eq(t64(H), t64(A), t64(g), t64(rpri),
                                 strategy, **kw)
    assert rel(np_of(dxt), np.asarray(dxj)) < 1e-10
    assert rel(np_of(wt), np.asarray(wj)) < 1e-10
    # and the KKT system itself holds: A dx = −rpri
    assert rel(A @ np_of(dxt), -rpri) < 1e-9


def test_solve_kkt_eq_cg_raises():
    H, A, g, rpri, _ = _kkt_system()
    with pytest.raises(NotImplementedError, match="cg is not supported"):
        kkt_t.solve_kkt_eq(t64(H), t64(A), t64(g), t64(rpri), "cg")


_STEP_CASES = [
    ("cholesky", dict(mixed=True)), ("cholesky", dict(mixed=False)),
    ("cholesky", dict(mixed=False, refine_steps=1,
                      use_psd_condition=True)),
    ("solve", {}), ("lstsq", {}), ("inverse", {}), ("cg", {}),
    ("cg", dict(max_cg_iters=3)), ("cholesky", dict(diag=True))]


@pytest.mark.parametrize("case", range(len(_STEP_CASES)))
def test_solve_newton_step_matches_jax(case):
    strategy, kw = _STEP_CASES[case]
    H, _, _, _, g = _kkt_system(seed=4)
    x = -0.1 * np.linalg.solve(H, g)     # descent_check < 0: CG warm start
    if kw.get("diag"):
        H = np.diag(H).copy()
    dj = kkt_j.solve_newton_step(jnp.asarray(H), jnp.asarray(g),
                                 jnp.asarray(x), strategy, **kw)
    dt = kkt_t.solve_newton_step(t64(H), t64(g), t64(x), strategy, **kw)
    assert rel(np_of(dt), np.asarray(dj)) < 1e-10


def test_solve_newton_step_full_kkt_raises():
    H, _, _, _, g = _kkt_system()
    with pytest.raises(ValueError, match="full_kkt requires equality"):
        kkt_t.solve_newton_step(t64(H), t64(g), t64(g), "full_kkt")


# ---------------------------------------------------------------------------
# Newton engines and the outer loop, on one oracle
# ---------------------------------------------------------------------------

def _cfgs(**kw):
    kw = dict(dict(dtype="float64", use_pallas=False), **kw)
    return CfgJ(**kw), SolverConfig(**kw)


def test_newton_feasible_matches_jax():
    data, x, _ = _ineq_problem("lp_dense", seed=8, n=20, k=15)
    cj, ct = _cfgs()
    rj = newton_j.newton_feasible(
        bar_j.make_qp_oracle(_make(prob_j, data), try_diag=False),
        jnp.asarray(x), 2.0, cj)
    rt = newton_t.newton_feasible(
        bar_t.make_qp_oracle(_make(prob_t, data), try_diag=False),
        t64(x), 2.0, ct)
    assert rt.iters == int(rj.iters) and rt.success == bool(rj.success)
    assert np.array_equal(rt.bt_hist, np.asarray(rj.bt_hist))
    assert rel(np_of(rt.x), np.asarray(rj.x)) < 1e-10
    assert rt.resid == pytest.approx(float(rj.resid), rel=1e-6)


def test_newton_infeasible_matches_jax():
    p = generate_lp(30, rng=np.random.RandomState(2))
    lb, ub = p.pop("lower_bound"), p.pop("upper_bound")
    pj = prob_j.make_lp(p["c"], p["A"], p["b"], p["C"], p["d"], lb, ub)
    pt = prob_t.make_lp(p["c"], p["A"], p["b"], p["C"], p["d"], lb, ub,
                        device="cpu")
    # a point inside the bounds and the rows, off the equalities
    x0 = 0.1 * np.random.RandomState(3).uniform(-1, 1, 30)
    x0 = x0 + 0.0 * p["c"]
    cj, ct = _cfgs()
    t = 1.5
    rj = newton_j.newton_infeasible(bar_j.make_qp_oracle(pj), pj.A, pj.b,
                                    jnp.asarray(x0), jnp.zeros(24), t, cj)
    rt = newton_t.newton_infeasible(bar_t.make_qp_oracle(pt), pt.A, pt.b,
                                    t64(x0), torch.zeros(24,
                                                         dtype=torch.float64),
                                    t, ct)
    assert rt.iters == int(rj.iters) and rt.success == bool(rj.success)
    assert np.array_equal(rt.bt_hist, np.asarray(rj.bt_hist))
    assert rel(np_of(rt.x), np.asarray(rj.x)) < 1e-9
    assert rel(np_of(rt.v), np.asarray(rj.v)) < 1e-7


def test_barrier_solve_with_phase_one_matches_jax():
    data, x, _ = _ineq_problem("lp_dense", seed=9, n=20, k=15)
    x0 = np.full(20, 0.9)          # violates rows: phase one runs
    cj, ct = _cfgs(epsilon=1e-7)
    pj, pt = _make(prob_j, data), _make(prob_t, data)
    kw = dict(num_constraints=pt.num_ineq_constraints, eq_gate=1e-3, t0=1.0)
    rj = ipm_j.barrier_solve(bar_j.make_qp_oracle(pj), None, None,
                             jnp.asarray(x0), cj,
                             p1_oracle=bar_j.make_phase1_linear_oracle(pj),
                             **kw)
    rt = ipm_t.barrier_solve(bar_t.make_qp_oracle(pt), None, None, t64(x0),
                             ct, p1_oracle=bar_t.make_phase1_linear_oracle(pt),
                             **kw)
    rc = convert.ipm_result_from_jax(rj, device="cpu")
    assert rt.phase1.s < 0 and rt.phase1.outer_iters == \
        rc.phase1.outer_iters and rt.phase1.newton_iters == \
        rc.phase1.newton_iters
    assert rt.outer_iters == rc.outer_iters
    assert np.array_equal(rt.inner_iters, rc.inner_iters)
    assert np.array_equal(rt.bt_hist, rc.bt_hist)
    assert rt.value == pytest.approx(rc.value, rel=1e-9)
    assert rt.t == rc.t and rt.dual_gap == pytest.approx(rc.dual_gap)
    fin = np.isfinite(rc.obj_vals)
    assert np.array_equal(np.isfinite(rt.obj_vals), fin)
    assert rel(rt.obj_vals[fin], rc.obj_vals[fin]) < 1e-9
    assert rel(np_of(rt.x), np_of(rc.x)) < 1e-7


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------

def _instance(kind, n):
    gen = generate_lp if kind == "lp" else generate_qp
    return gen(n, rng=np.random.RandomState(1))


def _cls(pkg, kind):
    return pkg.LPSolver if kind == "lp" else pkg.QPSolver


@functools.lru_cache(maxsize=None)
def _jax_solver(kind, n, use_pallas=True, **kw):
    s = _cls(ipj, kind)(**_instance(kind, n), **KW, **kw)
    if not use_pallas:
        s.cfg = dataclasses.replace(s.cfg, use_pallas=False)
    s.solve()
    return s


def _port_solver(kind, n, use_pallas=True, **kw):
    s = _cls(ipt, kind)(**_instance(kind, n), **KW, **kw, device="cpu")
    if not use_pallas:
        s.cfg = dataclasses.replace(s.cfg, use_pallas=False)
    s.solve()
    return s


def _within_gaps(st, sj):
    return abs(st.value - sj.value) <= (st.optimality_gap + sj.optimality_gap
                                        + 1e-12 * abs(sj.value))


@pytest.mark.parametrize("kind,n", [("lp", 60), ("lp", 100), ("qp", 60),
                                    ("qp", 100)])
def test_barrier_solver_matches_jax(kind, n):
    sj = _jax_solver(kind, n)
    calls = newton_step.newton_step_plain.calls
    st = _port_solver(kind, n)
    assert st.algorithm == "barrier" and st.last_metrics["algorithm"] == \
        "barrier"
    # the reduced path runs its Newton steps, phase one's included,
    # through K2's plain version
    p1 = st._result.phase1
    assert st.last_metrics["phase1_ran"] == sj.last_metrics["phase1_ran"]
    assert newton_step.newton_step_plain.calls - calls == \
        sum(st.inner_iters) + p1.newton_iters > 0
    if st.last_metrics["phase1_ran"]:
        assert p1.outer_iters == int(sj._result.phase1.outer_iters)
        assert p1.s < 0
    assert _within_gaps(st, sj)
    assert st.outer_iters == sj.outer_iters
    assert len(st.objective_vals) == len(sj.objective_vals)
    assert rel(st.objective_vals, sj.objective_vals) < 1e-9
    assert rel(st.xstar, sj.xstar) < 1e-5
    assert st.optimality_gap == pytest.approx(sj.optimality_gap)
    assert st.last_metrics["newton_iters"] == sum(st.inner_iters)
    assert st.backtrack_hist.sum() <= sum(st.inner_iters)


@pytest.mark.parametrize("kind", ["lp", "qp"])
def test_barrier_use_pallas_false_matches_exactly(kind):
    """Same algorithm on both sides: equal counts, values to 1e-9, and the
    duals λ* = 1/(t·s), v* of the final iterate (at ε = 1e-6, where the
    active slacks are not yet rounding-dominated)."""
    kw = dict(epsilon=1e-6, get_dual_variables=True)
    sj = _jax_solver(kind, 100, False, **kw)
    st = _port_solver(kind, 100, False, **kw)
    assert st.outer_iters == sj.outer_iters
    assert st.inner_iters == sj.inner_iters
    assert st.value == pytest.approx(sj.value, rel=1e-9)
    assert rel(st.objective_vals, sj.objective_vals) < 1e-9
    assert np.array_equal(st.backtrack_hist, sj.backtrack_hist)
    assert rel(st.lam_star, sj.lam_star) < 1e-3
    assert rel(st.v_star, sj.v_star) < 1e-3


def test_barrier_duals_with_k2():
    """λ*, v* from the K2 path against the JAX package's (ε = 1e-6)."""
    kw = dict(epsilon=1e-6, get_dual_variables=True)
    sj = _jax_solver("lp", 100, **kw)
    st = _port_solver("lp", 100, **kw)
    assert st.inner_iters == sj.inner_iters
    assert rel(st.lam_star, sj.lam_star) < 1e-3
    assert rel(st.v_star, sj.v_star) < 1e-3
    assert st.vstar is st.v_star


@pytest.mark.parametrize("kind", ["lp", "qp"])
def test_barrier_full_space_matches_jax(kind):
    """reduced=False: the infeasible-start engine on the equalities; the
    value is that of the best iterate whose ‖Ax−b‖ passed the gate, so it
    is held at 1e-9 relative rather than within the duality gaps."""
    sj = _jax_solver(kind, 60, reduced=False)
    st = _port_solver(kind, 60, reduced=False)
    assert st._reduced is None
    assert st.value == pytest.approx(sj.value, rel=1e-9)
    assert st.outer_iters == sj.outer_iters
    p = _instance(kind, 60)
    gate = 1e-4 * 60 if kind == "lp" else 1e-3
    assert np.linalg.norm(p["A"] @ st.xstar - p["b"]) < gate
    assert abs(sum(st.inner_iters) - sum(sj.inner_iters)) <= \
        0.2 * sum(sj.inner_iters)


@pytest.mark.parametrize("try_diag", [True, False])
def test_barrier_lp_without_equalities(try_diag):
    """Bounds only (the diagonal-Hessian path), and bounds plus an
    inequality block (dense, try_diag=False) whose rows the bounds'
    midpoint violates: phase one runs first.  At ε = 1e-6 (deeper stages
    can flip a borderline Armijo candidate between two fp64 summation
    orders) the counts are equal."""
    rng = np.random.default_rng(21)
    n = 40
    p = dict(c=rng.uniform(-1, 1, n), lower_bound=-1.0, upper_bound=2.0)
    if not try_diag:
        C = rng.uniform(-1, 1, (15, n))
        p.update(C=C, d=C @ rng.uniform(-0.9, 1.9, n) - 0.5)
    kw = dict(KW, try_diag=try_diag, epsilon=1e-6)
    sj = ipj.LPSolver(**p, **kw)
    st = ipt.LPSolver(**p, **kw, device="cpu")
    vj, vt = sj.solve(), st.solve()
    assert st._reduced is None
    assert st.last_metrics["phase1_ran"] == sj.last_metrics["phase1_ran"] \
        == (not try_diag)
    assert _within_gaps(st, sj)
    assert st.outer_iters == sj.outer_iters
    assert st.inner_iters == sj.inner_iters
    assert vt == pytest.approx(vj, rel=1e-9)


def test_barrier_t0_auto_matches_jax():
    sj = _jax_solver("lp", 60, t0="auto")
    st = _port_solver("lp", 60, t0="auto")
    assert st._t0_auto_value == pytest.approx(sj._t0_auto_value, rel=1e-14)
    assert st.outer_iters == sj.outer_iters
    assert _within_gaps(st, sj)
    # a t0 given to solve() overrides the automatic one, and
    # max_outer_iters caps the stages (phase one's five among them)
    st.solve(t0=1.0, max_outer_iters=6)
    assert st.outer_iters == 6 and st._result.t == 15.0 ** 6


def test_solve_lp_qp_barrier_functional():
    data, x, _ = _ineq_problem("lp_dense", seed=31, n=16, k=10)
    for kind in ("lp", "qp"):
        if kind == "qp":
            data = dict(data, P=np.eye(16), q=data.pop("c"))
        args = {k: data[k] for k in ("C", "d", "lb", "ub")}
        if kind == "lp":
            rj = ipj.solve_lp(data["c"], **args, epsilon=1e-8)
            rt = ipt.solve_lp(data["c"], **args, epsilon=1e-8,
                              device="cpu")
        else:
            rj = ipj.solve_qp(data["P"], data["q"], **args, epsilon=1e-8)
            rt = ipt.solve_qp(data["P"], data["q"], **args, epsilon=1e-8,
                              device="cpu")
        rc = convert.ipm_result_from_jax(rj, device="cpu")
        assert isinstance(rt, ipm_t.IPMResult) and rt.v is None
        assert rt.value == pytest.approx(rc.value, rel=1e-9)
        assert rt.outer_iters == rc.outer_iters
        assert np.array_equal(rt.inner_iters, rc.inner_iters)
