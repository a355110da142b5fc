"""The drivers that reach the dense-KKT direction K5 (ops/kkt_step.py)
against the JAX package's on the CPU: ``pd_solve`` with an equality pair,
the functional ``solve_lp``/``solve_qp`` with ``algorithm="pd"`` and
equalities, and ``SOCPSolver(algorithm="pd")`` on its reduced and its
full-space path.

On the CPU the JAX package runs the XLA Schur elimination on these
paths (its K5 only on a TPU, or in interpret mode when asked), the port
K5's plain version.  Both solve the same Newton systems, so the
iteration counts agree within 1 and the optima within 1e-8.  The JAX K5
path in interpret mode is held on tests/test_pallas_kkt.py:131's LP as
that file holds it (its value within 1e-6 relative of HiGHS): it runs
its 60 iterations there without converging (ROADMAP.md §3), where the
port's K5 path converges within 1e-8 of HiGHS.  Duals: λ* and v* within
1e-4 relative (λ_k = z_k0/(2·rhs_k) divides the final conic duals by
the cone's rhs).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from scipy.optimize import linprog

from torch_helpers import np_of, rel, t64
import interiorpoint_tpu as ipj
import interiorpoint_tpu_torch as ipt
from interiorpoint_tpu.models.problem import make_lp as make_lp_j
from interiorpoint_tpu.models.reduced import full_space_pd_problem as fsp_j
from interiorpoint_tpu.ops.pd import pd_solve as pd_solve_j
from interiorpoint_tpu.utils.config import SolverConfig as CfgJ
from interiorpoint_tpu_torch.models.problem import make_lp as make_lp_t
from interiorpoint_tpu_torch.models.reduced import \
    full_space_pd_problem as fsp_t
from interiorpoint_tpu_torch.ops import kkt_step
from interiorpoint_tpu_torch.ops.pd import pd_solve as pd_solve_t
from interiorpoint_tpu_torch.utils.config import SolverConfig
from interiorpoint_tpu_torch.utils.generators import generate_socp


def _lp(rng, n, m_eq, k_in, margin):
    A = rng.uniform(-2, 2, (m_eq, n))
    C = rng.uniform(-2, 2, (k_in, n))
    xf = rng.uniform(-1, 1, n)
    c = rng.uniform(-2, 2, n)
    return dict(c=c, A=A, b=A @ xf, C=C, d=C @ xf + margin)


def _highs(p):
    ref = linprog(p["c"], A_ub=p["C"], b_ub=p["d"], A_eq=p["A"],
                  b_eq=p["b"], bounds=[(-3, 3)] * p["c"].shape[0],
                  method="highs")
    assert ref.success
    return ref.fun


def test_pd_solve_with_equalities_matches_jax_and_highs():
    """tests/test_pallas_kkt.py:131's LP (n = 80, 20 equalities, 40 rows,
    the box ±3)."""
    p = _lp(np.random.default_rng(11), 80, 20, 40, 1.0)
    c, A, b = p["c"], p["A"], p["b"]
    pj = fsp_j(make_lp_j(c=c, C=p["C"], d=p["d"], lb=-3, ub=3), jnp.float64)
    z0 = np.zeros(80)
    cfg_j = CfgJ(dtype="float64", epsilon=1e-8)
    jkw = dict(A=jnp.asarray(A), b=jnp.asarray(b))
    r_int = pd_solve_j(pj, jnp.asarray(z0), cfg_j, kkt_kernel="interpret",
                       **jkw)
    r_xla = pd_solve_j(pj, jnp.asarray(z0), cfg_j, kkt_kernel=False, **jkw)
    pt = fsp_t(make_lp_t(c=c, C=p["C"], d=p["d"], lb=-3, ub=3,
                         device="cpu"), torch.float64)
    calls = kkt_step.kkt_dir_plain.calls
    rt = pd_solve_t(pt, t64(z0), SolverConfig(dtype="float64", epsilon=1e-8),
                    A=t64(A), b=t64(b))
    assert kkt_step.kkt_dir_plain.calls >= calls + 2 * rt.iters
    ref = _highs(p)
    vt = float(c @ np_of(rt.z))
    assert rt.converged and bool(r_xla.converged)
    assert abs(rt.iters - int(r_xla.iters)) <= 1
    assert vt == pytest.approx(ref, rel=1e-8)
    assert vt == pytest.approx(float(c @ np.asarray(r_xla.z)), rel=1e-9)
    assert vt == pytest.approx(float(c @ np.asarray(r_int.z)), rel=1e-6)
    assert np.abs(A @ np_of(rt.z) - b).max() < 1e-8
    assert rel(np_of(rt.v), np.asarray(r_xla.v)) < 1e-5


# the most Schur-CG rounds one direction takes on the LP below with the
# fp64 factors (measured on the CPU: 1 round per direction, 28 directions)
CG_ROUNDS_MAX = 2


def test_pd_solve_with_equalities_factors_once_per_newton_matrix():
    """tests/test_pallas_kkt.py:131's LP through the port's K5 path: one
    fp64 factorization per Newton matrix (the predictor, the corrector
    and kkt_solve's refinement share it), at most CG_ROUNDS_MAX Schur-CG
    rounds per direction, and the optimum within 1e-8 of HiGHS."""
    p = _lp(np.random.default_rng(11), 80, 20, 40, 1.0)
    c, A, b = p["c"], p["A"], p["b"]
    pt = fsp_t(make_lp_t(c=c, C=p["C"], d=p["d"], lb=-3, ub=3,
                         device="cpu"), torch.float64)
    rounds = []
    orig = kkt_step._kkt_dir

    def record(*args):
        c0 = kkt_step.COUNTS["cg_rounds"]
        out = orig(*args)
        rounds.append(kkt_step.COUNTS["cg_rounds"] - c0)
        return out

    before = dict(kkt_step.COUNTS)
    kkt_step._kkt_dir = record
    try:
        rt = pd_solve_t(pt, t64(np.zeros(80)),
                        SolverConfig(dtype="float64", epsilon=1e-8),
                        A=t64(A), b=t64(b))
    finally:
        kkt_step._kkt_dir = orig
    fact = kkt_step.COUNTS["factorizations"] - before.get("factorizations",
                                                          0)
    assert rt.converged
    assert fact == rt.iters
    assert len(rounds) >= 2 * rt.iters
    assert max(rounds) <= CG_ROUNDS_MAX
    assert float(c @ np_of(rt.z)) == pytest.approx(_highs(p), rel=1e-8)


@pytest.mark.parametrize("kind", ["lp", "qp"])
def test_functional_pd_with_equalities_matches_jax(kind):
    """``solve_lp``/``solve_qp(..., algorithm="pd")`` hand the equality
    pair to pd_solve: K5 takes every direction."""
    rng = np.random.default_rng(21)
    p = _lp(rng, 40, 10, 20, 0.5)
    kw = dict(lb=-3, ub=3, algorithm="pd", dtype="float64", epsilon=1e-8)
    if kind == "lp":
        rj = ipj.solve_lp(p["c"], p["A"], p["b"], p["C"], p["d"], **kw)
        calls = kkt_step.kkt_dir_plain.calls
        rt = ipt.solve_lp(p["c"], p["A"], p["b"], p["C"], p["d"], **kw,
                          device="cpu")
        obj = lambda x: p["c"] @ x  # noqa: E731
        assert obj(np_of(rt.z)) == pytest.approx(_highs(p), rel=1e-8)
    else:
        M = rng.uniform(-1, 1, (40, 40))
        P = M.T @ M + np.eye(40)
        rj = ipj.solve_qp(P, p["c"], p["A"], p["b"], p["C"], p["d"], **kw)
        calls = kkt_step.kkt_dir_plain.calls
        rt = ipt.solve_qp(P, p["c"], p["A"], p["b"], p["C"], p["d"], **kw,
                          device="cpu")
        obj = lambda x: 0.5 * x @ P @ x + p["c"] @ x  # noqa: E731
    assert kkt_step.kkt_dir_plain.calls >= calls + 2 * rt.iters
    assert bool(rj.converged) and rt.converged
    assert abs(rt.iters - int(rj.iters)) <= 1
    assert obj(np_of(rt.z)) == pytest.approx(obj(np.asarray(rj.z)),
                                             rel=1e-9, abs=1e-9)
    assert np.abs(p["A"] @ np_of(rt.z) - p["b"]).max() < 1e-8


SOCP_KW = dict(suppress_print=True, check_cvxpy=False, epsilon=1e-6,
          dtype="float64", algorithm="pd", get_dual_variables=True)


@pytest.mark.parametrize("reduced", [True, False])
def test_socp_solver_pd_matches_jax(reduced):
    """The reduced path (z-space, no equality block: K5 takes the
    refined H-solve branch) and the full-space path (F as K5's equality
    block: the Schur-CG branch)."""
    p = generate_socp(40, k=10, num_con=3, rng=np.random.RandomState(4))
    x0 = p.pop("x0")
    sj = ipj.SOCPSolver(**p, **SOCP_KW, x0=x0, reduced=reduced)
    st = ipt.SOCPSolver(**p, **SOCP_KW, x0=x0, reduced=reduced, device="cpu")
    vj, vt = sj.solve(), st.solve()
    assert (st._reduced is not None) == reduced
    assert st.last_metrics["algorithm"] == "pd"
    assert st.last_metrics["converged"] and sj.last_metrics["converged"]
    assert abs(st.outer_iters - sj.outer_iters) <= 1
    assert st.inner_iters == [1] * st.outer_iters
    assert abs(vt - vj) <= 1e-8 * (1.0 + abs(vj))
    assert rel(st.xstar, sj.xstar) <= 1e-6
    assert st.lam_star.shape == sj.lam_star.shape == (6,)
    assert rel(st.lam_star, sj.lam_star) <= 1e-4
    assert st.v_star.shape == (10,)
    assert rel(st.v_star, sj.v_star) <= 1e-4
