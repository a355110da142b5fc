"""Null-space elimination and the reduced LP/QP (ops/nullspace.py,
models/reduced.py) against the JAX package: the same host QR gives the
same basis, so the reduced problems match to rounding."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_helpers import np_of, rel
from interiorpoint_tpu.models import problem as prob_jax
from interiorpoint_tpu.models import reduced as red_jax
from interiorpoint_tpu.ops import nullspace as ns_jax
from interiorpoint_tpu_torch.models import problem as prob_torch
from interiorpoint_tpu_torch.models import reduced as red_torch
from interiorpoint_tpu_torch.ops import nullspace as ns_torch
from interiorpoint_tpu_torch.utils.generators import generate_lp, \
    generate_qp


def test_affine_elimination_matches():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((30, 50))
    b = rng.standard_normal(30)
    bj = ns_jax.affine_elimination(jnp.asarray(A), jnp.asarray(b))
    bt = ns_torch.affine_elimination(torch.as_tensor(A), torch.as_tensor(b))
    np.testing.assert_array_equal(np_of(bt.N), np.asarray(bj.N))
    np.testing.assert_array_equal(np_of(bt.x_p), np.asarray(bj.x_p))
    np.testing.assert_array_equal(np_of(bt.AAt), np.asarray(bj.AAt))
    assert np.abs(A @ np_of(bt.x_p) - b).max() < 1e-12


def test_affine_elimination_rank_deficient_is_nan():
    A = np.ones((3, 6))
    bt = ns_torch.affine_elimination(torch.as_tensor(A),
                                     torch.ones(3, dtype=torch.float64))
    assert torch.isnan(bt.N).all()


def test_recover_equality_dual_matches():
    rng = np.random.default_rng(1)
    A = rng.standard_normal((20, 45))
    g = rng.standard_normal(45)
    bj = ns_jax.affine_elimination(jnp.asarray(A), jnp.zeros(20))
    bt = ns_torch.affine_elimination(torch.as_tensor(A),
                                     torch.zeros(20, dtype=torch.float64))
    vj = ns_jax.recover_equality_dual(bj, jnp.asarray(A), jnp.asarray(g))
    vt = ns_torch.recover_equality_dual(bt, torch.as_tensor(A),
                                        torch.as_tensor(g))
    assert rel(np_of(vt), np.asarray(vj)) < 1e-12


@pytest.mark.parametrize("kind", ["lp", "qp"])
def test_reduced_problem_matches(kind):
    gen = generate_lp if kind == "lp" else generate_qp
    p = gen(60, rng=np.random.RandomState(1))
    lb, ub = p.pop("lower_bound"), p.pop("upper_bound")
    if kind == "lp":
        pj = prob_jax.make_lp(p["c"], p["A"], p["b"], p["C"], p["d"], lb, ub)
        pt = prob_torch.make_lp(p["c"], p["A"], p["b"], p["C"], p["d"], lb,
                                ub, device="cpu")
        rj, rt = red_jax.reduce_lp(pj), red_torch.reduce_lp(pt)
        assert rel(np_of(rt.prob.c), np.asarray(rj.prob.c)) < 1e-13
    else:
        pj = prob_jax.make_qp(p["P"], p["q"], p["A"], p["b"], p["C"],
                              p["d"], lb, ub)
        pt = prob_torch.make_qp(p["P"], p["q"], p["A"], p["b"], p["C"],
                                p["d"], lb, ub, device="cpu")
        rj, rt = red_jax.reduce_qp(pj), red_torch.reduce_qp(pt)
        assert rel(np_of(rt.prob.P), np.asarray(rj.prob.P)) < 1e-13
        assert rel(np_of(rt.prob.q), np.asarray(rj.prob.q)) < 1e-13
    assert rel(np_of(rt.prob.C), np.asarray(rj.prob.C)) < 1e-13
    assert rel(np_of(rt.prob.d), np.asarray(rj.prob.d)) < 1e-13
    assert abs(float(rt.obj_offset) - float(rj.obj_offset)) <= \
        1e-13 * max(1.0, abs(float(rj.obj_offset)))
    z = np.random.default_rng(2).standard_normal(rt.prob.C.shape[1])
    assert rel(np_of(rt.expand(torch.as_tensor(z))),
               np.asarray(rj.expand(jnp.asarray(z)))) < 1e-13


def test_full_space_pd_problem_matches():
    p = generate_lp(30, rng=np.random.RandomState(3))
    pj = prob_jax.make_lp(p["c"], C=p["C"], d=p["d"], lb=-3.0, ub=3.0)
    pt = prob_torch.make_lp(p["c"], C=p["C"], d=p["d"], lb=-3.0, ub=3.0,
                            device="cpu")
    fj = red_jax.full_space_pd_problem(pj, jnp.float64)
    ft = red_torch.full_space_pd_problem(pt, torch.float64)
    np.testing.assert_array_equal(np_of(ft.C), np.asarray(fj.C))
    np.testing.assert_array_equal(np_of(ft.d), np.asarray(fj.d))
    with pytest.raises(ValueError, match="requires inequality"):
        red_torch.full_space_pd_problem(
            prob_torch.make_lp(p["c"], device="cpu"), torch.float64)
