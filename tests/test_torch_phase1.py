"""The port's phase one against the JAX package's on the CPU: the
standalone ``PhaseOneSolver`` and legacy ``PhaseOne`` (the scenarios of
tests/test_phase1.py), and phase one inside ``LPSolver.solve(x0=...)``,
where the barrier's start is infeasible and phase one's Newton steps go
through K2's plain version on the [C | −1] block.

Tolerances.  With bounds, phase one takes the oracle path on both sides
(same algorithm: 1e-9).  Without bounds, the port takes K2 and the JAX
package (on the CPU) the oracle path: the counts must agree and the
final slack to 1e-6 relative (the step exits early on s < −tol, so the
last σ decides s)."""
import numpy as np
import pytest

from torch_helpers import rel
import interiorpoint_tpu as ipj
import interiorpoint_tpu_torch as ipt
from interiorpoint_tpu_torch.ops import newton_step
from interiorpoint_tpu_torch.utils.generators import generate_lp

KW = dict(suppress_print=True, check_cvxpy=False)


def _feasibility_case(seed, n, k):
    rng = np.random.default_rng(seed)
    C = rng.uniform(-2, 2, (k, n))
    x_feas = rng.uniform(-0.5, 0.5, n)
    return C, C @ x_feas + 0.2, x_feas


@pytest.mark.parametrize("bounds", [True, False])
def test_phase_one_solver_matches_jax(bounds):
    C, d, _ = _feasibility_case(4, 20, 30)
    kw = dict(C=C, d=d, lower_bound=-3 if bounds else None,
              upper_bound=3 if bounds else None, x0=np.full(20, 2.5),
              suppress_print=True, tol=0.0, max_outer_iters=50,
              max_inner_iters=200, t0=0.01)
    pj = ipj.PhaseOneSolver(**kw)
    calls = newton_step.newton_step_plain.calls
    pt = ipt.PhaseOneSolver(**kw, device="cpu")
    assert pt.s == pytest.approx(pj.s, rel=1e-14)   # the starting slack
    xj, sj = pj.solve()
    xt, st = pt.solve()
    assert st < 0 and (C @ xt - d).max() < 0
    assert pt.outer_iters == pj.outer_iters
    assert pt.inner_iters == pj.inner_iters
    # without bounds the phase-one problem is the [C | −1] LP: K2
    assert (newton_step.newton_step_plain.calls - calls
            == (0 if bounds else pt.inner_iters[0]))
    if bounds:
        assert st == pytest.approx(sj, rel=1e-9)
        assert rel(xt, xj) < 1e-9
        assert np.abs(xt).max() < 3
    else:
        assert st == pytest.approx(sj, rel=1e-6)
    # warm start from the feasible point: immediate success
    x2, s2 = pt.solve(x0=xt)
    assert s2 < 0


@pytest.mark.parametrize("bounds", [False, True])
def test_phase_one_solver_socp_matches_jax(bounds):
    """SOCP phase one (tests/test_phase1.py's recipe) from a start outside
    both cones: the oracle path on both sides (no fused step applies to
    phase one), so the counts are equal and s, x agree to 1e-9.  With the
    box ±4 both packages end at the same s = 7.2367 > 0: the first stage's
    excursion carries x into the mirror half of cone 2 (rhs < 0, where the
    squared slack is positive too), and rhs + s ≥ 0 then pins s = −rhs
    (ROADMAP.md §3)."""
    rng = np.random.default_rng(6)
    n, m = 8, 5
    A = [rng.normal(size=(m, n)) for _ in range(2)]
    b = [rng.normal(size=m) for _ in range(2)]
    c = [rng.normal(size=n) for _ in range(2)]
    x_c = rng.normal(size=n) * 0.2
    d = [float(np.linalg.norm(Ai @ x_c + bi) - ci @ x_c + 1.0)
         for Ai, bi, ci in zip(A, b, c)]
    x0 = x_c + np.linspace(-3.0, 3.0, n)
    kw = dict(socp=True, socp_params=(A, b, c, d),
              lower_bound=-4.0 if bounds else None,
              upper_bound=4.0 if bounds else None, x0=x0,
              suppress_print=True, tol=0.0, max_outer_iters=50,
              max_inner_iters=200, t0=0.01)
    pj = ipj.PhaseOneSolver(**kw)
    pt = ipt.PhaseOneSolver(**kw, device="cpu")
    assert pt.s == pytest.approx(pj.s, rel=1e-14) and pt.s > 1.0
    xj, sj = pj.solve()
    xt, st = pt.solve()
    rhs = [ci @ xt + di for ci, di in zip(c, d)]
    if bounds:
        assert st > 7.0 and min(rhs) == pytest.approx(-st, rel=1e-8)
    else:
        assert st < 0
        for Ai, bi, rk in zip(A, b, rhs):
            assert np.linalg.norm(Ai @ xt + bi) < rk
    assert pt.outer_iters == pj.outer_iters
    assert pt.inner_iters == pj.inner_iters
    assert st == pytest.approx(sj, rel=1e-9)
    assert rel(xt, xj) < 1e-9
    with pytest.raises(ValueError, match="requires C and d"):
        ipt.PhaseOneSolver(device="cpu")


_LEGACY = {
    "inside": ([[1, 3], [1, 1], [-1, 0], [0, -1]], [9, 5, 0, 0]),
    "outside": ([[-1, -3], [-1, 1], [-1, 2], [1, 4]], [-6, 2, 2, 12]),
    "unbounded": ([[1, -2], [-3, 1]], [-2, 0]),
    "empty": ([[3, -1], [-1, 5], [-1, 0], [0, -1]], [-2, 1.5, 0, 0]),
}


@pytest.mark.parametrize("case", sorted(_LEGACY))
def test_legacy_phase_one_matches_jax(case):
    G, h = (np.asarray(v, dtype=float) for v in _LEGACY[case])
    xj, sj, wj = ipj.PhaseOne(G, h, mu=15).solve()
    xt, st, wt = ipt.PhaseOne(G, h, mu=15, device="cpu").solve()
    assert wt == wj
    if case != "unbounded":
        # (on the unbounded set s runs off to −∞ and the early exit takes
        # whatever the first step below −tol reached: only its sign and
        # feasibility are the result there)
        assert st == pytest.approx(sj, rel=1e-6)
        assert rel(xt, xj) < 1e-6
    if case == "empty":
        assert st > 0
    else:
        assert st < 0 and np.max(G @ xt - h) <= 0


def test_lp_solver_runs_phase_one_through_k2():
    """An explicit in-bounds x0 whose projection onto Ax = b leaves the
    box: the reduced start is infeasible, so phase one runs on [C | −1]
    (K2's plain version) before the barrier stages."""
    p = generate_lp(60, rng=np.random.RandomState(1))
    x0 = np.random.RandomState(5).uniform(-2.9, 2.9, 60)
    sj = ipj.LPSolver(**p, **KW)
    vj = sj.solve(x0=x0)
    st = ipt.LPSolver(**p, **KW, device="cpu")
    calls = newton_step.newton_step_plain.calls
    vt = st.solve(x0=x0)
    p1 = st._result.phase1
    assert st.last_metrics["phase1_ran"] and sj.last_metrics["phase1_ran"]
    assert p1.s < 0 and p1.newton_iters > 0
    assert p1.outer_iters == int(sj._result.phase1.outer_iters)
    assert (newton_step.newton_step_plain.calls - calls
            == p1.newton_iters + sum(st.inner_iters))
    assert abs(vt - vj) <= st.optimality_gap + sj.optimality_gap
    assert st.outer_iters == sj.outer_iters


def test_phase_one_failure_message_matches_jax():
    p = generate_lp(60, rng=np.random.RandomState(1))
    x0 = np.random.RandomState(5).uniform(-2.9, 2.9, 60)
    msgs = []
    for pkg, kw in ((ipj, {}), (ipt, dict(device="cpu"))):
        s = pkg.LPSolver(**p, **KW, **kw)
        with pytest.raises(ValueError, match="Phase 1 Solver did not") as e:
            s.solve(x0=x0, max_outer_iters=1)
        msgs.append(str(e.value))
    # the same text around the final slack (which the two line searches
    # may reach by different steps)
    assert msgs[0].split("slack")[0] == msgs[1].split("slack")[0]
    assert msgs[0].split("after")[1] == msgs[1].split("after")[1]
