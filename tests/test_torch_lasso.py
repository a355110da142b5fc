"""The port's batched LASSO (interiorpoint_tpu_torch: ops/admm.py,
models/lasso.py) against the JAX package's on the CPU, on the same numpy
instances (tests/test_lasso.py's generator): the prox and the objective,
the fp64 ladder of Q⁻¹ (whose fp32 factor and solve are K3a and K3b,
here their plain versions), the ADMM loop on the JAX package's own
ladder, and ``LassoSolver``/``solve_lasso`` end to end with equal
iteration counts.

Iteration counts are compared exactly.  Every check of every fp64 case
below decides with a relative margin of at least 6.3e-3 from its
thresholds (r_norm against tol_primal, d_norm against tol_dual, r_norm
against 0.7·r_prev on a rung that may descend; the smallest on
lasso_example.npz, at least 4.3e-2 on the generated instances; measured
with the port on these instances), far above the ~1e-15 by which the two
packages' sums of the norms differ."""
import os

import numpy as np
import pytest
import torch

from test_lasso import _gen_lasso, _subgradient_residual
from torch_helpers import np_of, rel
import interiorpoint_tpu as ipj
import interiorpoint_tpu_torch as ipt
from interiorpoint_tpu.ops import admm as admm_jax
from interiorpoint_tpu_torch.ops import admm as admm_torch
from interiorpoint_tpu_torch.ops import chol
from interiorpoint_tpu_torch.utils import convert

KW = dict(reg=None, rho=0.4, max_iters=5000, check_stop=10, eps_abs=1e-7,
          eps_rel=1e-7, check_cvxpy=False)


def _kw(reg, **over):
    return {**KW, "reg": reg, **over}


def _jnp(a):
    import jax.numpy as jnp
    return jnp.asarray(a)


@pytest.mark.parametrize("positive", [False, True])
@pytest.mark.parametrize("add_bias", [False, True])
def test_prox_and_objective_match_jax(positive, add_bias):
    rng = np.random.default_rng(3)
    v = rng.standard_normal((12, 5))
    eta = np.abs(rng.standard_normal(5)) * 0.3
    A = rng.standard_normal((20, 12))
    b = rng.standard_normal((20, 5))
    xj = admm_jax.soft_threshold(_jnp(v), _jnp(eta), positive, add_bias)
    xt = admm_torch.soft_threshold(torch.as_tensor(v), torch.as_tensor(eta),
                                   positive, add_bias)
    assert rel(np_of(xt), np_of(xj)) <= 1e-15
    fj = admm_jax.lasso_objective(_jnp(A), _jnp(b), _jnp(eta), xj,
                                  positive, add_bias)
    ft = admm_torch.lasso_objective(torch.as_tensor(A), torch.as_tensor(b),
                                    torch.as_tensor(eta), xt, positive,
                                    add_bias)
    assert rel(np_of(ft), np_of(fj)) <= 1e-15


def _cfgs():
    return (ipj.AdmmConfig(dtype="float64", relax=1.8, adaptive_rho=True,
                           max_iters=5000, eps_abs=1e-7, eps_rel=1e-7),
            ipt.AdmmConfig(dtype="float64", relax=1.8, adaptive_rho=True,
                           max_iters=5000, eps_abs=1e-7, eps_rel=1e-7))


def test_fp64_ladder_and_loop_match_jax():
    """Each rung's Q⁻¹ (ops/kkt.py mixed_posdef_solve(Q, I): the
    Jacobi-scaled fp32 factor K3a and solve K3b, refined in fp64) within
    1e-12 of JAX's; then the port's loop on JAX's own ladder takes JAX's
    iterations to X within 1e-12."""
    A, b, reg = _gen_lasso()
    cj, ct = _cfgs()
    Aj, bj, rj = _jnp(A), _jnp(b), _jnp(reg)
    lj = admm_jax.admm_prepare(Aj, cj)
    At = torch.as_tensor(A)
    calls = (chol.cholesky_blocked_plain.calls,
             chol.cholesky_solve_blocked_plain.calls)
    lt = admm_torch.admm_prepare(At, ct)
    assert len(lt) == len(lj) == 5
    # the factor ran once per rung, the solve at least once per rung
    assert chol.cholesky_blocked_plain.calls - calls[0] == 5
    assert chol.cholesky_solve_blocked_plain.calls - calls[1] >= 5
    for qt, qj in zip(lt, lj):
        assert rel(np_of(qt), np_of(qj)) <= 1e-12

    rj_res = admm_jax.admm_core_prepared(lj, Aj, bj, rj, cj, b.shape[1])
    rt = admm_torch.admm_core_prepared(
        convert.admm_prepared_from_jax(lj, device="cpu"), At,
        torch.as_tensor(b), torch.as_tensor(reg), ct, b.shape[1])
    assert rt.iterations == int(rj_res.iterations)
    assert rel(np_of(rt.X), np_of(rj_res.X)) <= 1e-12
    assert rel(np_of(rt.solutions), np_of(rj_res.solutions)) <= 1e-12


def _case(name):
    """(A, b, LassoSolver kwargs) of an end-to-end case."""
    if name == "one_b_eight_lambdas":
        A, b, _ = _gen_lasso(B=1, seed=1)
        return A, b[:, 0], _kw(np.linspace(0.01, 1.0, 8))
    seeds = {"defaults": 0, "plain": 0, "add_bias": 2, "positive": 3,
             "normalize_A": 6, "num_chunks": 4, "compute_loss": 5}
    A, b, reg = _gen_lasso(seed=seeds[name],
                           B=3 if name == "compute_loss" else 6)
    extra = {"defaults": {},
             "plain": dict(adaptive_rho=False, relax=1.0),
             "add_bias": dict(add_bias=True),
             "positive": dict(positive=True),
             "normalize_A": dict(normalize_A=True, max_iters=2000,
                                 eps_abs=1e-4, eps_rel=3e-2),
             "num_chunks": dict(num_chunks=3),
             "compute_loss": dict(compute_loss=True, max_iters=500,
                                  eps_abs=1e-6, eps_rel=1e-6)}[name]
    if name == "add_bias":
        b = b + 100.0
    if name == "positive":
        b = -b
    return A, b, _kw(reg, **extra)


@pytest.mark.parametrize("name", ["defaults", "plain", "add_bias",
                                  "positive", "normalize_A", "num_chunks",
                                  "one_b_eight_lambdas", "compute_loss"])
def test_lasso_solver_matches_jax(name):
    A, b, kw = _case(name)
    Xj, sj, gj, ij = ipj.LassoSolver(A, b, **kw).solve()
    s = ipt.LassoSolver(A, b, **kw, device="cpu")
    Xt, st, gt, it = s.solve()
    assert s.device.type == "cpu" and s.num_chunks == (
        3 if name == "num_chunks" else 1)
    assert type(it) is type(ij)
    assert np.array_equal(np.atleast_1d(it), np.atleast_1d(ij))
    assert Xt.shape == Xj.shape and rel(Xt, Xj) <= 1e-9
    assert rel(st, sj) <= 1e-10
    assert gt.shape == np.asarray(gj).shape
    if name == "compute_loss":
        assert gt.shape == (it, 3) and rel(gt, gj) <= 1e-10
    # the solution is the LASSO optimum (the reference's own certificate)
    if name in ("defaults", "plain", "num_chunks"):
        assert _subgradient_residual(A, b, kw["reg"], Xt) < 1e-4
    assert rel(s.objective(), sj) <= 1e-10
    assert s.last_metrics["newton_iters"] == int(np.sum(it))


def test_solve_lasso_matches_jax():
    A, b, reg = _gen_lasso(seed=7)
    kw = dict(max_iters=5000, eps_abs=1e-7, eps_rel=1e-7, dtype="float64")
    rj = ipj.solve_lasso(A, b, reg, **kw)
    rt = ipt.solve_lasso(A, b, reg, device="cpu", **kw)
    assert rt.iterations == int(rj.iterations)
    assert rel(np_of(rt.X), np_of(rj.X)) <= 1e-9
    assert rel(np_of(rt.solutions), np_of(rj.solutions)) <= 1e-10
    assert _subgradient_residual(A, b, reg, np_of(rt.X)) < 1e-4


def test_lasso_example_data_matches_jax():
    """tests/data/lasso_example.npz as tests/test_lasso.py uses it."""
    path = os.path.join(os.path.dirname(__file__), "data",
                        "lasso_example.npz")
    data = np.load(path)
    A, y = data["X"], data["y"]
    A = A[~np.isnan(A).any(axis=1)]
    y = y[:A.shape[0]]
    kw = dict(reg=np.array([0.1]), add_bias=True, normalize_A=True,
              max_iters=3000, eps_abs=1e-6, eps_rel=1e-6, check_cvxpy=False)
    Xj, sj, _, ij = ipj.LassoSolver(A, y, **kw).solve()
    Xt, st, _, it = ipt.LassoSolver(A, y, **kw, device="cpu").solve()
    assert it == ij
    assert rel(Xt, Xj) <= 1e-9 and rel(st, sj) <= 1e-10
    A_aug = np.hstack([np.ones((A.shape[0], 1)), A / A.std(axis=0)])
    G = A_aug.T @ (A_aug @ Xt - y[:, None]) / A.shape[0]
    assert np.abs(G[0]).max() < 1e-2


def test_lasso_float32_matches_jax():
    """fp32 (the ladder through torch.linalg, as JAX's through XLA): X
    within 1e-4 of JAX's fp32 result, the objectives within 1e-5 of the
    fp64 optimum."""
    A, b, reg = _gen_lasso(seed=0)
    kw = _kw(reg, eps_abs=1e-5, eps_rel=1e-5)
    Xj, sj, _, _ = ipj.LassoSolver(A, b, **kw, dtype="float32").solve()
    s = ipt.LassoSolver(A, b, **kw, dtype="float32", device="cpu")
    Xt, st, _, _ = s.solve()
    assert s._A.dtype == torch.float32
    assert rel(Xt, Xj) <= 1e-4
    _, s64, _, _ = ipt.LassoSolver(A, b, **_kw(reg), device="cpu").solve()
    assert rel(st, s64) <= 1e-5


def test_lasso_defaults_to_cuda_and_exports():
    A, b, reg = _gen_lasso(n=8, m=20, B=2)
    if torch.cuda.is_available():
        assert ipt.LassoSolver(A, b, reg=reg,
                               check_cvxpy=False).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ipt.LassoSolver(A, b, reg=reg, check_cvxpy=False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ipt.solve_lasso(A, b, reg)
    p = ipt.make_lasso(A, b[:, 0], 0.1)
    assert isinstance(p, ipt.LassoProblem)
    assert p.b.shape == (20, 1) and p.reg.shape == (1,)
    assert p.n == 8 and p.m == 20 and p.num_samples == 1
    assert ipt.AdmmConfig().torch_dtype == torch.float32
    for name in ("LassoSolver", "solve_lasso", "AdmmConfig", "LassoProblem",
                 "make_lasso", "Certificate", "certify"):
        assert name in ipt.__all__ and name in ipj.__all__
