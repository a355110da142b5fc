"""The port's primal-dual drivers (ops/pd.py) against the JAX package's:
``pd_solve_fused`` against the fused Pallas driver in interpret mode, and
the eager ``pd_solve`` against the JAX XLA engine."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_helpers import np_of, pd_instance, t64
from interiorpoint_tpu.models.problem import LPProblem as LPj, \
    QPProblem as QPj
from interiorpoint_tpu.ops import pd as pd_jax
from interiorpoint_tpu.ops.pallas_newton import dir_stall_tol as dst_jax
from interiorpoint_tpu.utils.config import SolverConfig as CfgJ
from interiorpoint_tpu_torch.models.problem import LPProblem, QPProblem
from interiorpoint_tpu_torch.ops import pd as pd_torch
from interiorpoint_tpu_torch.utils.config import SolverConfig


def _problems(seed, quad):
    C, d, q, P, z0, _, _ = pd_instance(seed, 96, 24, quad)
    if quad:
        pj = QPj(P=jnp.asarray(P), q=jnp.asarray(q), C=jnp.asarray(C),
                 d=jnp.asarray(d))
        pt = QPProblem(P=t64(P), q=t64(q), C=t64(C), d=t64(d))
        obj = lambda z: 0.5 * z @ P @ z + q @ z  # noqa: E731
    else:
        pj = LPj(c=jnp.asarray(q), C=jnp.asarray(C), d=jnp.asarray(d))
        pt = LPProblem(c=t64(q), C=t64(C), d=t64(d))
        obj = lambda z: q @ z  # noqa: E731
    return pj, pt, z0, obj


@pytest.mark.parametrize("quad", [False, True])
def test_pd_solve_fused_matches_pallas_driver(quad):
    pj, pt, z0, obj = _problems(17 if not quad else 19, quad)
    cfg_j = CfgJ(dtype="float64", epsilon=1e-7)
    cfg_t = SolverConfig(dtype="float64", epsilon=1e-7)
    rj = pd_jax.pd_solve_fused(pj, jnp.asarray(z0), cfg_j, interpret=True)
    rt = pd_torch.pd_solve_fused(pt, t64(z0), cfg_t)
    assert bool(rj.converged) and rt.converged
    vj, vt = obj(np.asarray(rj.z)), obj(np_of(rt.z))
    assert vt == pytest.approx(vj, rel=1e-6, abs=1e-6)
    assert abs(rt.iters - int(rj.iters)) <= 3
    # the multipliers and slacks of the optimum agree as well
    assert np.abs(np_of(rt.lam) - np.asarray(rj.lam)).max() < 1e-3


@pytest.mark.parametrize("quad", [False, True])
def test_eager_pd_solve_matches_xla_engine(quad):
    pj, pt, z0, obj = _problems(23 if not quad else 29, quad)
    cfg_j = CfgJ(dtype="float64", epsilon=1e-8)
    cfg_t = SolverConfig(dtype="float64", epsilon=1e-8, use_pallas=False)
    rj = pd_jax.pd_solve(pj, jnp.asarray(z0), cfg_j)
    rt = pd_torch.pd_solve(pt, t64(z0), cfg_t)
    assert bool(rj.converged) and rt.converged
    assert obj(np_of(rt.z)) == pytest.approx(obj(np.asarray(rj.z)),
                                             rel=1e-6, abs=1e-6)
    assert abs(rt.iters - int(rj.iters)) <= 3


def test_pd_solve_dispatch():
    """use_pallas + mixed + no equalities → the fused driver (K1's plain
    version on the CPU); use_pallas=False → the eager engine."""
    from interiorpoint_tpu_torch.ops import pd_step

    _, pt, z0, _ = _problems(31, False)
    cfg = SolverConfig(dtype="float64", epsilon=1e-6)
    calls = pd_step.pd_step_plain.calls
    r1 = pd_torch.pd_solve(pt, t64(z0), cfg)
    assert pd_step.pd_step_plain.calls == calls + r1.iters
    r2 = pd_torch.pd_solve(pt, t64(z0),
                           dataclasses.replace(cfg, use_pallas=False))
    assert pd_step.pd_step_plain.calls == calls + r1.iters
    assert r1.converged and r2.converged


def test_pd_solve_with_equalities_names_k5():
    """pd_solve with an equality pair (once a raise naming K5): every
    direction through the dense-KKT direction K5 (its plain version on
    the CPU) against the JAX XLA engine's Schur elimination on the same
    inputs: both converge to the same optimum with A z = b."""
    from interiorpoint_tpu_torch.ops import kkt_step

    pj, pt, z0, obj = _problems(31, False)
    A = np.ones((1, 24))
    b = np.zeros(1)
    rj = pd_jax.pd_solve(pj, jnp.asarray(z0), CfgJ(dtype="float64"),
                         A=jnp.asarray(A), b=jnp.asarray(b))
    calls = kkt_step.kkt_dir_plain.calls
    rt = pd_torch.pd_solve(pt, t64(z0), SolverConfig(dtype="float64"),
                           A=t64(A), b=t64(b))
    assert kkt_step.kkt_dir_plain.calls >= calls + 2 * rt.iters
    assert bool(rj.converged) and rt.converged
    assert obj(np_of(rt.z)) == pytest.approx(obj(np.asarray(rj.z)),
                                             rel=1e-8, abs=1e-8)
    assert abs(rt.iters - int(rj.iters)) <= 3
    assert abs(float(A[0] @ np_of(rt.z))) < 1e-9
    assert rt.v.shape == (1,)
    assert float(np_of(rt.v)[0]) == pytest.approx(float(rj.v[0]), rel=1e-5,
                                                  abs=1e-7)


@pytest.mark.parametrize("eps", [1e-10, 1e-8, 1e-4, 1.0])
def test_dir_stall_tol_matches(eps):
    assert pd_torch.dir_stall_tol(eps, cap=3e-5) == dst_jax(eps, cap=3e-5)
    assert pd_torch.dir_stall_tol(eps) == dst_jax(eps)
