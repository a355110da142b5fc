"""The port's solver utilities against the JAX package's on the CPU:
KKT certificates (utils/certify.py) of the same LP, QP and SOCP solved
by both packages, checkpoints with mid-solve resume (utils/checkpoint.py,
through ``solve(checkpoint_path=..., resume=True)``), the CSV, MPS and
MIPLIB readers, plotting and profiling."""
import os

import matplotlib
import numpy as np
import pytest
from scipy.optimize import linprog

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402

from test_checkpoint import _gen  # noqa: E402
from test_lasso import _gen_lasso  # noqa: E402
from test_utils import _MPS_SAMPLE  # noqa: E402
import interiorpoint_tpu as ipj  # noqa: E402
import interiorpoint_tpu_torch as ipt  # noqa: E402
from interiorpoint_tpu.utils import certify as certify_jax  # noqa: E402
from interiorpoint_tpu.utils import csvio as csvio_jax  # noqa: E402
from interiorpoint_tpu.utils import miplib as miplib_jax  # noqa: E402
from interiorpoint_tpu.utils import mps as mps_jax  # noqa: E402
from interiorpoint_tpu.utils import plotting as plotting_jax  # noqa: E402
from interiorpoint_tpu_torch.utils import (checkpoint, csvio, miplib,  # noqa: E402
                                           mps, plotting, profiling)

CPU = dict(device="cpu")
FLOW40 = os.path.join(os.path.dirname(__file__), "data", "miplib",
                      "flow40.npy")


# ---------------------------------------------------------------------------
# certify: tests/test_certify.py's drivers, solved by both packages
# ---------------------------------------------------------------------------

def _certify_case(kind):
    """(JAX class, port class, kwargs) of tests/test_certify.py's LP, QP
    and SOCP drivers."""
    if kind.startswith("lp"):
        rng = np.random.default_rng(11)
        n, m, k = 20, 14, 8
        A = rng.uniform(-2, 2, (m, n))
        C = rng.uniform(-2, 2, (k, n))
        xf = rng.uniform(-1, 1, n)
        c = rng.uniform(-2, 2, n)
        kw = dict(c=c, A=A, b=A @ xf, C=C, d=C @ xf + 0.5, lower_bound=-3,
                  upper_bound=3, suppress_print=True, check_cvxpy=False,
                  epsilon=1e-9, t0=1)
        if kind == "lp_duals":
            kw["get_dual_variables"] = True
        return ipj.LPSolver, ipt.LPSolver, kw
    if kind == "qp":
        rng = np.random.default_rng(5)
        n, m = 16, 10
        M = rng.uniform(-1, 1, (n, n))
        A = rng.uniform(-2, 2, (m, n))
        xf = rng.uniform(-1, 1, n)
        kw = dict(P=M.T @ M + np.eye(n), q=rng.uniform(-1, 1, n), A=A,
                  b=A @ xf, lower_bound=-3, upper_bound=3,
                  suppress_print=True, check_cvxpy=False, epsilon=1e-9, t0=1)
        return ipj.QPSolver, ipt.QPSolver, kw
    rng = np.random.default_rng(7)
    n, K, M_rows = 12, 3, 5
    A = [rng.standard_normal((M_rows, n)) for _ in range(K)]
    b = [rng.standard_normal(M_rows) for _ in range(K)]
    c = [rng.standard_normal(n) for _ in range(K)]
    x0 = rng.standard_normal(n) * 0.1
    d = [np.linalg.norm(A[k] @ x0 + b[k]) - c[k] @ x0 + 1.0
         for k in range(K)]
    Pq = rng.uniform(-1, 1, (n, n))
    kw = dict(P=Pq.T @ Pq + np.eye(n), q=rng.uniform(-1, 1, n), A=A, b=b,
              c=c, d=d, lower_bound=-3, upper_bound=3, suppress_print=True,
              check_cvxpy=False, epsilon=1e-9, t0=1, x0=x0)
    return ipj.SOCPSolver, ipt.SOCPSolver, kw


_RESIDUALS = ("stationarity", "eq_residual", "min_slack", "complementarity",
              "dual_gap")


@pytest.mark.parametrize("kind,polish", [
    ("lp", True), ("lp", False), ("lp_duals", True), ("lp_duals", False),
    ("qp", True), ("socp", True)])
def test_certify_matches_jax(kind, polish):
    """Each residual within 1e-6 of JAX's, the objective within 1e-8.
    The raw analytic duals' stationarity (``polish=False``) is the
    exception: λ = 1/(t·s) on slacks of ~1e-12 measures how inexactly
    the last centering ended (~1e-3 in both packages, 1.8e-4 apart on
    this LP), so it is held by the same ``ok(5e-3)`` as JAX's."""
    cls_j, cls_t, kw = _certify_case(kind)
    sj, st = cls_j(**kw), cls_t(**kw, **CPU)
    sj.solve()
    st.solve()
    cj = certify_jax.certify(sj, polish=polish)
    ct = ipt.certify(st, polish=polish)
    assert isinstance(ct, ipt.Certificate)
    assert ct.kind == cj.kind and ct.polished == cj.polished == polish
    tol = 1e-6 if polish else 5e-3
    assert ct.ok(tol) == cj.ok(tol) and ct.ok(1e-6) == cj.ok(1e-6)
    if polish and kind != "lp_duals":
        assert ct.ok(1e-6 if kind == "lp" else 1e-5), ct
    for f in _RESIDUALS:
        if f == "stationarity" and not polish:
            assert max(ct.stationarity, cj.stationarity) <= 5e-3
            continue
        assert abs(getattr(ct, f) - getattr(cj, f)) <= 1e-6, f
    assert ct.objective == pytest.approx(cj.objective, rel=1e-8)


def test_certify_refuses_unsolved_and_leaves_the_optimum():
    _, cls_t, kw = _certify_case("lp")
    s = cls_t(**kw, **CPU)
    with pytest.raises(ValueError, match="solved"):
        ipt.certify(s)
    s.solve()
    good = ipt.certify(s)
    A = s._eq[0].numpy()
    rng = np.random.default_rng(11)
    p = rng.standard_normal(A.shape[1])
    p = p - A.T @ np.linalg.lstsq(A @ A.T, A @ p, rcond=None)[0]
    bad = ipt.certify(s, x=s.xstar + 1e-2 * p)
    assert bad.eq_residual < 1e-8
    assert bad.stationarity > 10 * good.stationarity


# ---------------------------------------------------------------------------
# checkpoint: tests/test_checkpoint.py's five scenarios on the port
# ---------------------------------------------------------------------------

def _ckpt_kw(seed):
    c, A, b, C, d = _gen(seed=seed)
    return dict(c=c, A=A, b=b, C=C, d=d, lower_bound=-3, upper_bound=3,
                suppress_print=True, check_cvxpy=False, epsilon=1e-9,
                staged_dispatch=True)


def _uninterrupted(seed=23):
    """The port's and the JAX package's uninterrupted solves, and the
    port's phase-one stage count."""
    kw = _ckpt_kw(seed)
    ref = ipt.LPSolver(**kw, **CPU)
    ref.solve()
    vj = ipj.LPSolver(**kw).solve()
    p1 = ref._result.phase1
    p1_stages = (p1.outer_iters
                 if p1 is not None and np.isfinite(p1.s) else 0)
    return kw, ref, vj, p1_stages


def _same_solve(res, ref):
    """Bitwise the same result, with the same stage and step counts."""
    assert res.value == ref.value
    assert np.array_equal(res.xstar, ref.xstar)
    assert res.outer_iters == ref.outer_iters
    assert res.inner_iters == ref.inner_iters
    assert res.objective_vals == ref.objective_vals
    assert res.optimality_gap == ref.optimality_gap
    assert res._result.phase1.outer_iters == ref._result.phase1.outer_iters


def test_checkpoint_roundtrip(tmp_path):
    kw = _ckpt_kw(21)
    ls = ipt.LPSolver(**kw, **CPU)
    ls.solve()
    path = str(tmp_path / "state.npz")
    checkpoint.save_state(path, ls)
    state = checkpoint.load_state(path)
    np.testing.assert_array_equal(state["x"], ls.xstar)
    assert float(state["value"]) == float(ls._result.value)
    assert float(state["t"]) == float(ls._result.t)
    with pytest.raises(ValueError, match="solve"):
        checkpoint.save_state(path, ipt.LPSolver(**kw, **CPU))


def test_checkpoint_warm_solve_halves_iterations(tmp_path):
    kw = _ckpt_kw(22)
    ls = ipt.LPSolver(**kw, **CPU)
    v1 = ls.solve()
    cold = sum(ls.inner_iters)
    path = str(tmp_path / "state.npz")
    checkpoint.save_state(path, ls)
    v2 = checkpoint.warm_solve(ls, checkpoint.load_state(path))
    assert abs(v2 - v1) / max(abs(v1), 1.0) < 1e-6
    assert sum(ls.inner_iters) < cold / 2


def test_midsolve_resume_repeats_uninterrupted_solve(tmp_path):
    """A solve cut two stages after phase one and resumed in a fresh
    solver equals the uninterrupted solve bitwise, with the same stage
    counts (phase one not run again), and the JAX package's value to
    1e-8."""
    kw, ref, vj, p1_stages = _uninterrupted()
    mid = p1_stages + 2
    assert p1_stages > 0 and mid < ref.outer_iters
    path = str(tmp_path / "mid.npz")
    part = ipt.LPSolver(**kw, **CPU)
    part.solve(max_outer_iters=mid, checkpoint_path=path)
    assert part.outer_iters == mid
    assert set(checkpoint.load_outer_state(path)) >= {"state_x", "p1_x"}
    res = ipt.LPSolver(**kw, **CPU)
    v2 = res.solve(checkpoint_path=path, resume=True)
    _same_solve(res, ref)
    assert abs(v2 - vj) / max(abs(vj), 1.0) < 1e-8
    # without a checkpoint file, resume starts afresh
    fresh = ipt.LPSolver(**kw, **CPU)
    fresh.solve(checkpoint_path=str(tmp_path / "none.npz"), resume=True)
    _same_solve(fresh, ref)


def test_phase1_resume_repeats_uninterrupted_solve(tmp_path):
    kw, ref, vj, p1_stages = _uninterrupted()
    assert p1_stages > 2
    path = str(tmp_path / "p1.npz")
    part = ipt.LPSolver(**kw, **CPU)
    with pytest.raises(ValueError, match="Phase 1"):
        part.solve(max_outer_iters=2, checkpoint_path=path)
    assert all(k.startswith("p1state_")
               for k in checkpoint.load_outer_state(path))
    res = ipt.LPSolver(**kw, **CPU)
    v2 = res.solve(checkpoint_path=path, resume=True)
    _same_solve(res, ref)
    assert abs(v2 - vj) / max(abs(vj), 1.0) < 1e-8


def test_midsolve_resume_reconciles_trace_caps(tmp_path):
    kw, ref, _, p1_stages = _uninterrupted()
    mid = p1_stages + 2
    path = str(tmp_path / "mid.npz")
    ipt.LPSolver(**kw, **CPU).solve(max_outer_iters=mid,
                                    checkpoint_path=path)
    small = ipt.LPSolver(**kw, **CPU)
    with pytest.raises(ValueError, match="at least as large"):
        small.solve(max_outer_iters=mid - 1, checkpoint_path=path,
                    resume=True)
    res = ipt.LPSolver(**kw, **CPU)
    res.solve(checkpoint_path=path, resume=True)
    assert len(res.objective_vals) == len(res.inner_iters) == \
        ref.outer_iters
    _same_solve(res, ref)


def test_pd_refuses_checkpoint(tmp_path):
    s = ipt.LPSolver(**_ckpt_kw(21), algorithm="pd", **CPU)
    with pytest.raises(ValueError, match="checkpoint"):
        s.solve(checkpoint_path=str(tmp_path / "pd.npz"))


# ---------------------------------------------------------------------------
# csvio, mps, miplib
# ---------------------------------------------------------------------------

def test_csv_mps_and_npy_parse_as_jax(tmp_path):
    arr = np.array([[1.5, 0.0, 2.25], [3.0, 4.0, 0.0]])
    path = str(tmp_path / "r.csv")
    csvio.write_results(path, arr)
    np.testing.assert_array_equal(
        csvio.read_results(path), csvio_jax.read_results(path))
    np.testing.assert_array_equal(
        csvio.mean_over_reps(csvio.read_results(path)),
        csvio_jax.mean_over_reps(csvio_jax.read_results(path)))
    with open(path) as f:
        written = f.read()
    csvio_jax.write_results(path, arr)
    with open(path) as f:
        assert f.read() == written

    mpath = str(tmp_path / "s.mps")
    with open(mpath, "w") as f:
        f.write(_MPS_SAMPLE)
    pt, pj = mps.parse_mps(mpath), mps_jax.parse_mps(mpath)
    assert pt == pj
    for at, aj in zip(mps.lp_relaxation(pt, big=1e4),
                      mps_jax.lp_relaxation(pj, big=1e4)):
        np.testing.assert_array_equal(at, aj)
    npy = str(tmp_path / "s.npy")
    mps.mps_to_npy(mpath, npy, big=50.0)
    for at, aj in zip(miplib.load_lp_npy(npy), miplib_jax.load_lp_npy(npy)):
        np.testing.assert_array_equal(at, aj)
    for at, aj in zip(miplib.load_lp_npy(FLOW40),
                      miplib_jax.load_lp_npy(FLOW40)):
        np.testing.assert_array_equal(at, aj)


def test_flow40_solves_to_highs():
    """tests/data/miplib/flow40.npy through miplib.solve_lp_npy on the
    port's barrier and pd engines, to tests/test_utils.py's HiGHS
    tolerances."""
    c, A, b, C, d, ub, lb = miplib.load_lp_npy(FLOW40)
    ref = linprog(c, A_ub=C, b_ub=d, A_eq=A, b_eq=b,
                  bounds=list(zip(lb, ub)), method="highs")
    assert ref.status == 0
    s = miplib.solve_lp_npy(FLOW40, suppress_print=True, check_cvxpy=False,
                            epsilon=1e-6, **CPU)
    assert s.device.type == "cpu"
    assert abs(s.value - ref.fun) / abs(ref.fun) < 1e-4
    x = s.xstar
    assert np.max(np.abs(A @ x - b)) < 1e-6
    assert np.max(C @ x - d) < 1e-6
    assert np.all(x >= lb - 1e-8) and np.all(x <= ub + 1e-8)
    pd = miplib.solve_lp_npy(FLOW40, suppress_print=True, check_cvxpy=False,
                             epsilon=1e-8, algorithm="pd", **CPU)
    assert abs(pd.value - ref.fun) / abs(ref.fun) < 1e-8
    assert pd.last_metrics["converged"] is True


# ---------------------------------------------------------------------------
# plotting and profiling
# ---------------------------------------------------------------------------

def test_plot_family_and_relative_error_as_jax(tmp_path):
    rng = np.random.default_rng(9)
    res_a = np.abs(rng.normal(1.0, 0.1, (3, 4)))
    res_b = np.abs(rng.normal(2.0, 0.2, (3, 4)))
    written = plotting.plot_family([res_a, res_b], [100, 500, 1000],
                                   ["ours", "oracle"], "LP", str(tmp_path))
    assert len(written) == 6
    assert {os.path.basename(w) for w in written} == {
        "LPaverageLinearLinePlot.png", "LPaverageLogarithmicLinePlot.png",
        "LPerrorbarLinear.png", "LPerrorbarLogarithmic.png",
        "LPaverageLinearBarPlot.png", "LPaverageLogarithmicBarPlot.png"}
    assert all(os.path.getsize(w) > 0 for w in written)
    truth = np.array([[1.0, 2.0, 4.0], [2.0, 2.0, 2.0]])
    res = np.array([[1.1, np.inf, 4.0], [0.0, 2.2, np.nan]])
    assert plotting.calculate_average_relative_error(truth, res) == \
        plotting_jax.calculate_average_relative_error(truth, res)
    t3 = np.abs(rng.normal(1.0, 0.1, (2, 3, 4)))
    r3 = t3 * (1 + 0.01 * rng.standard_normal(t3.shape))
    r3[0, 1, 2] = np.inf
    assert plotting.calculate_average_relative_error(t3, r3, lasso=True) \
        == plotting_jax.calculate_average_relative_error(t3, r3, lasso=True)
    ax = plotting.plot_backtrack_distribution(np.array([5, 2, 0, 1]))
    assert ax.get_xlabel().startswith("backtracking")
    plt.close("all")


@pytest.mark.parametrize("kind", ["lp", "qp", "socp", "lasso"])
def test_driver_plot_returns_axes(kind):
    if kind == "lasso":
        A, b, reg = _gen_lasso(n=10, m=30, B=2)
        s = ipt.LassoSolver(A, b, reg=reg, compute_loss=True, max_iters=200,
                            check_cvxpy=False, **CPU)
    else:
        _, cls_t, kw = _certify_case(kind)
        s = cls_t(**kw, track_loss=True, **CPU)
        with pytest.raises(ValueError, match="track_loss"):
            s.plot()
    s.solve()
    ax = s.plot()
    assert isinstance(ax, matplotlib.axes.Axes) and ax.lines
    plt.close("all")


def test_time_solve_and_trace_solve(tmp_path):
    _, cls_t, kw = _certify_case("lp")
    s = cls_t(**kw, **CPU)
    stats = profiling.time_solve(s, reps=2)
    assert set(stats) == {"mean_s", "min_s", "max_s", "times"}
    assert len(stats["times"]) == 2 and stats["min_s"] > 0
    logdir = str(tmp_path / "trace")
    value, out = profiling.trace_solve(s, logdir=logdir)
    assert value == s.value and out == logdir
    path = os.path.join(logdir, profiling.TRACE_FILE)
    assert os.path.getsize(path) > 0
    with open(path) as f:
        assert "traceEvents" in f.read()
