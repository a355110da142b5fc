"""The port's SOCP barrier path against the JAX package's on the CPU: the
problem packing (make_socp, reduce_socp), the oracles (ops/socp.py
against the JAX ``make_socp_oracle(prob, dd=False)`` and
``make_phase1_socp_oracle``) and the driver ``SOCPSolver`` with the
default ``algorithm="barrier"`` (and, in the API test, ``"pd"``), on
generate_socp instances.

Tolerances.  Packing is exact; the reduction's tensors are fp64 products
of the same host-QR basis (1e-12).  Oracles are fp64 on both sides in
another summation order: 1e-12 relative (1e-10 for the Hessian, whose
GᵀG term squares the weights).  The drivers: the JAX package on the CPU
takes the oracle path, the port K4 (its plain version here) on the
reduced problem, so the values are held within the two reported duality
gaps, and the outer stages must agree; with ``use_pallas=False`` on both
sides the algorithms are the same and the counts must be equal, the
values within 1e-9 relative.  The full-space engine (bounds, or
``reduced=False``) is the same algorithm on both sides, but its residual
line search and its stop ‖r‖ < ε_inner sit on borderline tests that two
fp64 summation orders can flip: outer stages equal, Newton steps within
20%, values within the gaps (as tests/test_torch_barrier.py holds the
LP/QP full-space engine).  Duals: λ = 1/(t·slacks) and the stationarity
v within 1e-3 relative: an active cone's slack is a small difference of
its terms, and λ = 1/(t·s) magnifies the final iterates' difference."""
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
from interiorpoint_tpu.models.reduced import reduce_socp as reduce_j
from interiorpoint_tpu.ops import socp as socp_j
from interiorpoint_tpu_torch.models import problem as prob_t
from interiorpoint_tpu_torch.models.reduced import reduce_socp as reduce_t
from interiorpoint_tpu_torch.ops import socp as socp_t
from interiorpoint_tpu_torch.ops import socp_step
from interiorpoint_tpu_torch.utils import convert
from interiorpoint_tpu_torch.utils.generators import generate_socp

KW = dict(suppress_print=True, check_cvxpy=False, epsilon=1e-4, mu=15,
          t0="auto", max_inner_iters=200, max_outer_iters=20, beta=0.5,
          alpha=0.05, dtype="float64")


def _recipe(n=60, k=20, seed=1, bounds=False):
    """bench.py's SOCP recipe at a small n (k equalities, 5 cones of 0.8n
    rows); bounds ±10 where asked (inactive at the start)."""
    p = generate_socp(n, k=k, rng=np.random.RandomState(seed))
    if bounds:
        p["lower_bound"], p["upper_bound"] = -10.0, 10.0
    return p


def _ragged(seed=2, bounds=False):
    """Cones of different heights, one given as a diagonal, a single b
    and d broadcast to every cone, P, q and two equalities."""
    rng = np.random.default_rng(seed)
    n = 7
    A = [rng.standard_normal((4, n)), rng.uniform(1, 2, n),
         rng.standard_normal((2, n))]
    c = [rng.standard_normal(n) for _ in A]
    Pp = rng.standard_normal((n, n))
    F = rng.standard_normal((2, n))
    return dict(A=A, b=[np.full(2, 0.3)], c=c, d=[5.0],
                P=Pp @ Pp.T + np.eye(n), q=rng.standard_normal(n), F=F,
                g=F @ (0.1 * rng.standard_normal(n)),
                lb=-4.0 if bounds else None, ub=4.0 if bounds else None)


def test_make_socp_and_reduce_socp_match_jax():
    p = _ragged()
    # a 1-D matrix is a diagonal of height n, broadcast b fills 2 rows
    pj = prob_j.make_socp(**p, dtype=jnp.float64)
    pt = prob_t.make_socp(**p, device="cpu")
    for f in ("A", "b", "c", "d", "P", "q", "F", "g"):
        np.testing.assert_array_equal(np_of(getattr(pt, f)),
                                      np.asarray(getattr(pj, f)), err_msg=f)
    assert pt.A.shape == (3, 7, 7) and pt.lb is None and pt.ub is None
    assert (pt.num_cones, pt.num_ineq_constraints) == (pj.num_cones, 3)
    pb = _ragged(bounds=True)
    pbt = prob_t.make_socp(**pb, device="cpu")
    np.testing.assert_array_equal(np_of(pbt.lb), np.full(7, -4.0))
    assert pbt.num_ineq_constraints == prob_j.make_socp(
        **pb, dtype=jnp.float64).num_ineq_constraints == 3 + 14
    # the reduction: rotated cones and the objective offset
    rj, rt = reduce_j(pj), reduce_t(pt)
    rc = convert.reduced_from_jax(rj, device="cpu")
    assert isinstance(rc.prob, prob_t.SOCPProblem)
    for f in ("A", "b", "c", "d", "P", "q"):
        assert rel(np_of(getattr(rt.prob, f)),
                   np_of(getattr(rc.prob, f))) <= 1e-12, f
    assert rt.prob.F is None and rt.prob.lb is None
    assert float(rt.obj_offset) == pytest.approx(float(rj.obj_offset),
                                                 rel=1e-12)
    z = t64(np.random.default_rng(3).standard_normal(5))
    # the z-space slacks are the x-space slacks of x_p + N z
    assert rel(np_of(socp_t.socp_full_slacks(rt.prob, z)),
               np_of(socp_t.socp_full_slacks(pt, rt.expand(z)))) <= 1e-12
    with pytest.raises(ValueError, match="unbounded"):
        reduce_t(pbt)


def _oracle_point(bounds):
    p = _ragged(bounds=bounds)
    p.pop("F"), p.pop("g")
    pj = prob_j.make_socp(**p, dtype=jnp.float64)
    pt = prob_t.make_socp(**p, device="cpu")
    x = np.random.default_rng(4).standard_normal(7) * 0.05
    dx = np.random.default_rng(5).standard_normal(7) * 5.0
    return pj, pt, x, dx


@pytest.mark.parametrize("bounds", [False, True])
def test_socp_oracle_matches_jax(bounds):
    pj, pt, x, dx = _oracle_point(bounds)
    oj, ot = socp_j.make_socp_oracle(pj, dd=False), \
        socp_t.make_socp_oracle(pt)
    assert (ot.socp_form is not None) == (not bounds)
    xj, xt = jnp.asarray(x), t64(x)
    sig = 0.6 ** np.arange(12)
    t = 3.7
    assert float(ot.obj(xt)) == pytest.approx(float(oj.obj(xj)), rel=1e-13)
    assert rel(np_of(ot.grad(xt, t)), oj.grad(xj, t)) <= 1e-12
    assert rel(np_of(ot.hess(xt, t)), oj.hess(xj, t)) <= 1e-10
    assert float(ot.newton_obj(xt, t)) == pytest.approx(
        float(oj.newton_obj(xj, t)), rel=1e-12)
    assert float(ot.min_slack(xt)) == pytest.approx(
        float(oj.min_slack(xj)), rel=1e-12)
    assert rel(np_of(socp_t.socp_full_slacks(pt, xt)),
               socp_j.socp_full_slacks(pj, xj)) <= 1e-12
    okj, vj = oj.ls_objs(xj, jnp.asarray(dx), t, jnp.asarray(sig))
    okt, vt = ot.ls_objs(xt, t64(dx), t, t64(sig))
    okj = np.asarray(okj)
    np.testing.assert_array_equal(np_of(okt), okj)
    assert 0 < okj.sum() < len(sig)    # the domain test decides some
    assert rel(np_of(vt)[okj], np.asarray(vj)[okj]) <= 1e-12
    gok, gj = oj.ls_grads(xj, jnp.asarray(dx), t, jnp.asarray(sig))
    tok, gt = ot.ls_grads(xt, t64(dx), t, t64(sig))
    np.testing.assert_array_equal(np_of(tok), np.asarray(gok))
    assert rel(np_of(gt)[:, okj], np.asarray(gj)[:, okj]) <= 1e-12


@pytest.mark.parametrize("bounds", [False, True])
def test_phase1_socp_oracle_matches_jax(bounds):
    pj, pt, x, dx = _oracle_point(bounds)
    # a start outside the cones (far from the centre): s0 = −min slack + 1
    x = x + 3.0
    oj = socp_j.make_phase1_socp_oracle(pj, dd=False)
    ot = socp_t.make_phase1_socp_oracle(pt)
    assert ot.socp_form is None and ot.n == 8
    z0 = np.concatenate([x, [0.0]])
    s0 = -float(oj.min_slack(jnp.asarray(z0))) + 1.0
    assert float(ot.min_slack(t64(z0))) == pytest.approx(1.0 - s0, rel=1e-13)
    assert s0 > 1.0
    z = np.concatenate([x, [s0]])
    dz = np.concatenate([dx, [-2.0]])
    zj, zt = jnp.asarray(z), t64(z)
    t = 0.7
    assert float(ot.obj(zt)) == float(oj.obj(zj))
    assert rel(np_of(ot.grad(zt, t)), oj.grad(zj, t)) <= 1e-12
    assert rel(np_of(ot.hess(zt, t)), oj.hess(zj, t)) <= 1e-10
    assert float(ot.newton_obj(zt, t)) == pytest.approx(
        float(oj.newton_obj(zj, t)), rel=1e-12)
    sig = 0.6 ** np.arange(12)
    okj, vj = oj.ls_objs(zj, jnp.asarray(dz), t, jnp.asarray(sig))
    okt, vt = ot.ls_objs(zt, t64(dz), t, t64(sig))
    okj = np.asarray(okj)
    np.testing.assert_array_equal(np_of(okt), okj)
    assert rel(np_of(vt)[okj], np.asarray(vj)[okj]) <= 1e-12
    with pytest.raises(NotImplementedError):
        ot.ls_grads(zt, t64(dz), t, t64(sig))


@functools.lru_cache(maxsize=None)
def _jax_solve(name):
    """The JAX package's solve of a named case: (value, gap, outer, inner,
    λ, v, phase one ran)."""
    p, x0, solve_kw, cfg_kw = _solver_case(name)
    s = ipj.SOCPSolver(**p, **KW, **cfg_kw)
    if name == "use_pallas_false":
        s.cfg = dataclasses.replace(s.cfg, use_pallas=False)
    v = s.solve(**solve_kw)
    return (v, s.optimality_gap, s.outer_iters, list(s.inner_iters),
            np.asarray(s.lam_star), np.asarray(s.v_star),
            s.last_metrics["phase1_ran"])


def _solver_case(name):
    """(problem, x0, solve() kwargs, constructor kwargs) of a named case."""
    bounds = name == "bounds"
    p = _recipe(bounds=bounds)
    x0 = p.pop("x0")
    cfg_kw = dict(x0=x0, get_dual_variables=True)
    solve_kw = {}
    if name == "reduced_false":
        cfg_kw["reduced"] = False
    if name == "phase_one":
        # an explicit start on Fx = g that leaves a cone: phase one runs
        rng = np.random.RandomState(7)
        F = p["F"]
        shift = rng.standard_normal(60) * 3.0
        shift -= F.T @ np.linalg.solve(F @ F.T, F @ shift)
        solve_kw["x0"] = x0 + shift
    return p, x0, solve_kw, cfg_kw


def _port_solver(name):
    p, x0, solve_kw, cfg_kw = _solver_case(name)
    s = ipt.SOCPSolver(**p, **KW, **cfg_kw, device="cpu")
    if name == "use_pallas_false":
        s.cfg = dataclasses.replace(s.cfg, use_pallas=False)
    return s, solve_kw


@pytest.mark.parametrize("name", ["reduced", "use_pallas_false", "bounds",
                                  "reduced_false", "phase_one"])
def test_socp_solver_matches_jax(name):
    vj, gapj, outj, innj, lamj, vstarj, p1j = _jax_solve(name)
    s, solve_kw = _port_solver(name)
    calls = socp_step.socp_newton_step_plain.calls
    vt = s.solve(**solve_kw)
    k4 = socp_step.socp_newton_step_plain.calls - calls
    gapt = s.optimality_gap
    assert s.outer_iters == outj
    assert s.last_metrics["phase1_ran"] == p1j == (name == "phase_one")
    assert (s._reduced is None) == (name in ("bounds", "reduced_false"))
    if name in ("reduced", "phase_one"):
        # K4 (plain) takes every main-stage Newton step
        assert k4 == sum(s.inner_iters) > 0
        assert abs(vt - vj) <= gapt + gapj
    elif name == "use_pallas_false":
        assert k4 == 0
        assert s.inner_iters == innj
        assert vt == pytest.approx(vj, rel=1e-9)
    else:
        assert k4 == 0
        assert abs(sum(s.inner_iters) - sum(innj)) <= 0.2 * sum(innj)
        assert abs(vt - vj) <= gapt + gapj
        p, _, _, _ = _solver_case(name)
        assert np.linalg.norm(p["F"] @ s.xstar - p["g"]) < 1e-3
    assert rel(s.lam_star, lamj) <= 1e-3
    assert rel(s.v_star, vstarj) <= 1e-3
    # λ* = 1/(t·slacks) over [cones, (ub, lb,) rhs]
    m = 5 + (120 if name == "bounds" else 0)
    assert s.lam_star.shape == (m + 5,) and s.v_star.shape == (20,)


def test_socp_solver_api_matches_jax():
    """Constructor checks byte for byte, t0="auto", the conic Mehrotra
    engine through the solver and the functional entry, and the
    functional barrier solve."""
    p = _recipe()
    x0 = p.pop("x0")
    bad = [dict(A=None), dict(P=np.ones((2, 3))), dict(q=np.ones((2, 2))),
           dict(b=[np.ones(3)] * 2), dict(c=[np.ones(60)] * 2),
           dict(d=[1.0, 2.0]), dict(F=np.ones(60)),
           dict(F=np.ones((2, 5))), dict(g=np.ones(7)),
           dict(lower_bound=1.0, upper_bound=0.0),
           dict(A=[np.ones((2, 2, 2))])]
    for change in bad:
        msgs = []
        for pkg, kw in ((ipj, {}), (ipt, dict(device="cpu"))):
            with pytest.raises(ValueError) as e:
                pkg.SOCPSolver(**{**p, **change}, **KW, **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], change
    sj = ipj.SOCPSolver(**p, **KW, x0=x0)
    st = ipt.SOCPSolver(**p, **KW, x0=x0, device="cpu")
    assert st._t0(None) == pytest.approx(sj_t0(sj), rel=1e-13)
    assert st.num_constraints == 5
    # algorithm="pd" (once a raise naming K5 / ROADMAP item 10): the
    # conic Mehrotra engine, on the reduced problem through K5's plain
    # version and in full space, against the JAX package's (its XLA
    # elimination on the CPU): the same optimum within the gaps
    vpj = ipj.SOCPSolver(**p, **KW, x0=x0, algorithm="pd").solve()
    vpt = ipt.SOCPSolver(**p, **KW, x0=x0, algorithm="pd",
                         device="cpu").solve()
    assert abs(vpt - vpj) <= 1e-8 * (1.0 + abs(vpj))
    args4 = (p["A"], p["b"], p["c"], p["d"])
    rpj = ipj.solve_socp(*args4, algorithm="pd", dtype="float64", x0=x0)
    rpt = ipt.solve_socp(*args4, algorithm="pd", dtype="float64", x0=x0,
                         device="cpu")
    assert bool(rpj.converged) and rpt.converged
    assert abs(rpt.iters - int(rpj.iters)) <= 1
    assert rel(np_of(rpt.x), np.asarray(rpj.x)) <= 1e-6
    # the full-space functional solve with its equalities, against the
    # JAX package's (the same infeasible-start algorithm): the value of
    # the best iterate that passed the 1e-3 equality gate, within the gaps
    # and 1e-8 relative for the equality residual left in it
    args = (p["A"], p["b"], p["c"], p["d"], p["P"], p["q"], p["F"], p["g"])
    kw = dict(epsilon=1e-4, max_inner_iters=200, dtype="float64",
              x0=x0, t0=0.5)
    rj = ipj.solve_socp(*args, **kw)
    rt = ipt.solve_socp(*args, **kw, algorithm="auto", device="cpu")
    assert rt.outer_iters == int(rj.outer_iters)
    assert abs(rt.value - float(rj.value)) <= (
        rt.dual_gap + float(rj.dual_gap) + 1e-8 * abs(float(rj.value)))


def sj_t0(sj):
    """The JAX driver's t0="auto": m / max(|f(x0)|, 1)."""
    from interiorpoint_tpu.models.base import _obj_only
    obj0 = float(_obj_only(sj._prob, jnp.asarray(sj.x), sj._oracle_fn))
    return max(sj.num_constraints, 1) / max(abs(obj0), 1.0)


def test_socp_entry_points_default_to_cuda():
    """Without a GPU and without device=, the SOCP entry points raise
    rather than run on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    p = _recipe()
    p.pop("x0")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ipt.SOCPSolver(**p, **KW)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ipt.PhaseOneSolver(socp=True, socp_params=(p["A"], p["b"], p["c"],
                                                   p["d"]))
