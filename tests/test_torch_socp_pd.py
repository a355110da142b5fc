"""The port's conic Mehrotra engine (ops/socp_pd.py) and its driver
surface (``SOCPSolver(algorithm="pd")``) against the JAX package's on the
CPU.

* The Jordan-algebra and NT-scaling functions against the JAX ones on
  seeded cone points, to 1e-13 (fp64 on both sides, the same formulas),
  and the NT identities W z = W⁻¹ s = λ.
* ``socp_pd_solve`` through K5 (its plain version here) against the JAX
  engine with ``kkt_kernel="interpret"`` (its Pallas K5 in interpret
  mode) on tests/test_pallas_kkt.py:79-128's instance: the same
  algorithm, the JAX kernel in double-float32 and the port in fp64, each
  direction solved to its residual floor, so the iteration counts agree
  within 1, x to 1e-7 relative and the objective to 1e-8.
* The block elimination (``kkt_kernel=False``) with ``exact_fallback``
  False (the matrix-free solves and the Schur-CG) against the JAX
  engine's same configuration (tests/test_socp_pd.py's instance): the
  same iterations within 1, x to 1e-7.

``SOCPSolver(algorithm="pd")`` is held against the JAX solver in
tests/test_torch_k5_drivers.py, ``solve_socp(algorithm="pd")`` in
tests/test_torch_socp.py::test_socp_solver_api_matches_jax.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_helpers import np_of, rel, t64
from interiorpoint_tpu.models.problem import make_socp as make_socp_j
from interiorpoint_tpu.ops import socp_pd as spj
from interiorpoint_tpu.utils.config import SolverConfig as CfgJ
from interiorpoint_tpu_torch.models.problem import make_socp as make_socp_t
from interiorpoint_tpu_torch.ops import kkt_step
from interiorpoint_tpu_torch.ops import socp_pd as spt
from interiorpoint_tpu_torch.utils.config import SolverConfig


def _cone_points(rng, K, M1):
    v = rng.standard_normal((K, M1))
    v[:, 0] = np.linalg.norm(v[:, 1:], axis=1) + rng.uniform(0.1, 2.0, K)
    return v


def test_jordan_and_nt_match_jax():
    rng = np.random.default_rng(0)
    K, M1 = 6, 5
    s, z, lam = (_cone_points(rng, K, M1) for _ in range(3))
    v, r, ds = (rng.standard_normal((K, M1)) for _ in range(3))
    J = {k: jnp.asarray(a) for k, a in dict(s=s, z=z, lam=lam, v=v, r=r,
                                             ds=ds).items()}
    T = {k: t64(a) for k, a in dict(s=s, z=z, lam=lam, v=v, r=r,
                                     ds=ds).items()}
    uj, ej = spj.nt_scaling(J["s"], J["z"])
    ut, et = spt.nt_scaling(T["s"], T["z"])
    pairs = [
        (spt._jmul(T["s"], T["v"]), spj._jmul(J["s"], J["v"])),
        (spt._jdet(T["s"]), spj._jdet(J["s"])),
        (spt._jreflect(T["v"]), spj._jreflect(J["v"])),
        (spt._arrow_solve(T["lam"], T["r"]),
         spj._arrow_solve(J["lam"], J["r"])),
        (ut, uj), (et, ej),
        (spt.w_mul(ut, et, T["v"]), spj.w_mul(uj, ej, J["v"])),
        (spt.w_inv_mul(ut, et, T["v"]), spj.w_inv_mul(uj, ej, J["v"])),
        (spt.max_step_cone(T["s"], T["ds"]),
         spj.max_step_cone(J["s"], J["ds"])),
        (spt.max_step_cone(T["s"], -T["s"]),
         spj.max_step_cone(J["s"], -J["s"])),
    ]
    for a, b in pairs:
        assert rel(np_of(a), np.asarray(b)) < 1e-13
    # the NT identities: det u = 1, W z = W⁻¹ s = λ with λᵀλ = sᵀz,
    # W⁻¹(W v) = v, and the arrow solve inverts the Jordan product
    lam1 = spt.w_mul(ut, et, T["z"])
    lam2 = spt.w_inv_mul(ut, et, T["s"])
    assert float((spt._jdet(ut) - 1).abs().max()) < 1e-12
    assert float((lam1 - lam2).abs().max()) < 1e-12
    assert float(((lam1 * lam1).sum(-1) - (T["s"] * T["z"]).sum(-1))
                 .abs().max()) < 1e-11
    assert float((spt.w_inv_mul(ut, et, spt.w_mul(ut, et, T["v"]))
                  - T["v"]).abs().max()) < 1e-12
    assert float((spt._jmul(T["lam"], spt._arrow_solve(T["lam"], T["r"]))
                  - T["r"]).abs().max()) < 1e-12


def _kkt_instance():
    """tests/test_pallas_kkt.py:79-128: K = 4 cones of M = 30 rows,
    n = 60, 12 equalities, P."""
    rng = np.random.default_rng(3)
    K, M, n, m_eq = 4, 30, 60, 12
    As = rng.standard_normal((K, M, n))
    bs = rng.standard_normal((K, M))
    cs = rng.standard_normal((K, n))
    x0 = rng.standard_normal(n) * 0.1
    ds = np.array([np.linalg.norm(As[k] @ x0 + bs[k]) - cs[k] @ x0 + 1.0
                   for k in range(K)])
    q = rng.uniform(-1, 1, n)
    Mq = rng.uniform(-1, 1, (n, n))
    P = Mq.T @ Mq + np.eye(n)
    F = rng.standard_normal((m_eq, n))
    return dict(A=list(As), b=list(bs), c=list(cs), d=list(ds), P=P, q=q,
                F=F, g=F @ x0), x0


def _both(data, x0, cfg_kw, jax_kw, port_kw, **prob_kw):
    pj = make_socp_j(**data, **prob_kw, dtype=jnp.float64)
    pt = make_socp_t(**data, **prob_kw, dtype=torch.float64, device="cpu")
    G, h, q = spj.cone_operator(pj)
    rj = spj.socp_pd_solve(G, h, q, jnp.asarray(x0),
                           CfgJ(dtype="float64", **cfg_kw), P=pj.P, F=pj.F,
                           g=pj.g, lb=pj.lb, ub=pj.ub, **jax_kw)
    Gt, ht, qt = spt.cone_operator(pt)
    rt = spt.socp_pd_solve(Gt, ht, qt, t64(x0),
                           SolverConfig(dtype="float64", **cfg_kw), P=pt.P,
                           F=pt.F, g=pt.g, lb=pt.lb, ub=pt.ub, **port_kw)
    return rj, rt


@pytest.mark.parametrize("case", ["eq", "no_eq", "bounds"])
def test_socp_pd_solve_matches_jax_kernel_path(case):
    data, x0 = _kkt_instance()
    P, q = data["P"], data["q"]
    prob_kw = {}
    if case != "eq":
        data = dict(data, F=None, g=None)
    if case == "bounds":
        prob_kw = dict(lb=-3.0, ub=3.0)
    before = dict(kkt_step.COUNTS)
    rj, rt = _both(data, x0, dict(epsilon=1e-6), dict(kkt_kernel="interpret"),
                   {}, **prob_kw)
    dirs = kkt_step.COUNTS["directions"] - before.get("directions", 0)
    assert dirs >= 2 * rt.iters
    assert bool(rj.converged) and rt.converged
    assert abs(rt.iters - int(rj.iters)) <= 1
    xj, xt = np.asarray(rj.x), np_of(rt.x)
    assert rel(xt, xj) <= 1e-7
    obj = lambda x: 0.5 * x @ P @ x + q @ x  # noqa: E731
    assert obj(xt) == pytest.approx(obj(xj), rel=1e-8, abs=1e-8)
    assert rt.y.shape == ((12,) if case == "eq" else (0,))
    if case == "bounds":
        assert rt.lam_ub.shape == (60,) and rt.lam_lb.shape == (60,)


def test_socp_pd_matrix_free_config_matches_jax():
    """``kkt_kernel=False, exact_fallback=False``: the matrix-free accurate
    H-solves (ops/kkt.py matrix_free_*) and the Schur-CG over the
    equality multipliers (tests/test_socp_pd.py::
    test_socp_pd_tpu_numerics_on_cpu's instance with m_eq = 3, with its
    bounds)."""
    rng = np.random.default_rng(11)
    K, M, n, m_eq = 4, 3, 10, 3
    As = rng.standard_normal((K, M, n))
    bs = rng.standard_normal((K, M))
    cs = rng.standard_normal((K, n))
    x0 = rng.standard_normal(n) * 0.1
    ds = np.array([np.linalg.norm(As[k] @ x0 + bs[k]) - cs[k] @ x0 + 1.0
                   for k in range(K)])
    q = rng.uniform(-1, 1, n)
    F = rng.standard_normal((m_eq, n))
    data = dict(A=list(As), b=list(bs), c=list(cs), d=list(ds), P=None, q=q,
                F=F, g=F @ x0)
    kw = dict(kkt_kernel=False, exact_fallback=False)
    rj, rt = _both(data, x0, dict(epsilon=1e-9), kw, kw, lb=-3.0, ub=3.0)
    assert bool(rj.converged) and rt.converged
    assert abs(rt.iters - int(rj.iters)) <= 1
    assert rel(np_of(rt.x), np.asarray(rj.x)) <= 1e-7
