"""The port's dense-KKT direction (K5, ops/kkt_step.py) against the JAX
package's fused kernel (ops/pallas_kkt.py ``kkt_dir_prepared`` in
interpret mode) and against dense fp64 KKT solves, on the instance family
of tests/test_pallas_kkt.py.

Tolerances.  Both solve the same system by refinement against the
operator, the JAX kernel with fp32 preconditioners in double-float32, the
port with fp64 factors in fp64, each to its residual floor: dx and dy to 1e-10 relative of
each other and 1e-11 of the dense solve (κ up to ~1e6 here); the κ ≈ 1e9
case to 1e-8 of the dense solve, as the JAX test holds its kernel.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_helpers import t64
from interiorpoint_tpu.ops.pallas_kkt import (kkt_dir_prepared,
                                              prep_kkt_consts as prep_j,
                                              prep_kkt_h)
from interiorpoint_tpu_torch.ops import kkt_step, refine, sync
from interiorpoint_tpu_torch.ops.kkt_step import _Plain


def _spd(rng, n, diag_spread=6.0):
    M = rng.standard_normal((n, n))
    H = M @ M.T + np.eye(n) * 1e-3
    H += np.diag(10.0 ** rng.uniform(-3, diag_spread, n))
    return 0.5 * (H + H.T)


def _instance(n, pe, seed, diag_spread=6.0):
    rng = np.random.default_rng(seed)
    H = _spd(rng, n, diag_spread)
    r1 = rng.standard_normal(n)
    F = rpe = None
    if pe:
        F = rng.standard_normal((pe, n))
        rpe = rng.standard_normal(pe)
    return H, F, r1, rpe


def _dense(H, F, r1, rpe):
    if F is None:
        return np.linalg.solve(H, r1), np.zeros(0)
    pe, n = F.shape
    KKT = np.block([[H, F.T], [F, np.zeros((pe, pe))]])
    sol = np.linalg.solve(KKT, np.concatenate([r1, -rpe]))
    return sol[:n], sol[n:]


def _port(H, F, r1, rpe):
    n = H.shape[0]
    cs = kkt_step.prep_kkt_consts(None if F is None else t64(F), n)
    return kkt_step.kkt_dir(t64(H), cs, t64(r1),
                            None if rpe is None else t64(rpe))


def _jax(H, F, r1, rpe):
    n = H.shape[0]
    Hhi, Hlo = prep_kkt_h(jnp.asarray(H), n)
    kc = prep_j(None if F is None else jnp.asarray(F), n)
    dx, dy, _, _ = kkt_dir_prepared(
        Hhi, Hlo, kc, jnp.asarray(r1),
        None if rpe is None else jnp.asarray(rpe), interpret=True)
    return np.asarray(dx), np.asarray(dy)


def _rel2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


# (150, 90): pe not a multiple of the 64-wide factor block, so the Schur
# factor crosses a block edge
@pytest.mark.parametrize("n,pe", [(60, 12), (130, 0), (150, 90)])
def test_kkt_dir_matches_jax_kernel_and_dense_solve(n, pe):
    H, F, r1, rpe = _instance(n, pe, n + pe)
    calls = kkt_step.kkt_dir_plain.calls
    dx, dy, rn2, bn2 = _port(H, F, r1, rpe)
    assert kkt_step.kkt_dir_plain.calls == calls + 1
    assert dx.shape == (n,) and dy.shape == (pe,)
    dx, dy = dx.numpy(), dy.numpy()
    dx_ref, dy_ref = _dense(H, F, r1, rpe)
    dx_j, dy_j = _jax(H, F, r1, rpe)
    assert _rel2(dx, dx_ref) < 1e-11
    assert _rel2(dx, dx_j) < 1e-10
    if pe:
        assert _rel2(dy, dy_ref) < 1e-11
        assert _rel2(dy, dy_j) < 1e-10
    assert float(rn2) < 1e-18 * float(bn2) + 1e-20


def test_kkt_dir_ill_conditioned_stays_refined():
    """κ ≈ 1e9 (tests/test_pallas_kkt.py:50-68): the refinement and the
    PCG escalation still recover the direction from the fp64 factors."""
    H, F, r1, rpe = _instance(150, 20, 7, diag_spread=9.0)
    dx, dy, rn2, bn2 = _port(H, F, r1, rpe)
    sol = np.concatenate(_dense(H, F, r1, rpe))
    got = np.concatenate([dx.numpy(), dy.numpy()])
    assert _rel2(got, sol) < 1e-8


def test_kkt_dir_counts_and_checks():
    """COUNTS tallies one direction, its CG rounds and its H-solves (the
    first solve, one per round, the back-substitution); shapes, dtypes
    and devices are checked before anything runs."""
    H, F, r1, rpe = _instance(60, 12, 3)
    before = dict(kkt_step.COUNTS)
    _port(H, F, r1, rpe)
    d = {k: kkt_step.COUNTS[k] - before.get(k, 0) for k in kkt_step.COUNTS}
    assert d["directions"] == 1 and d["cg_rounds"] >= 1
    assert d["h_solves"] == d["cg_rounds"] + 2
    cs = kkt_step.prep_kkt_consts(t64(F), 60)
    with pytest.raises(ValueError, match="rpe is required"):
        kkt_step.kkt_dir(t64(H), cs, t64(r1))
    with pytest.raises(ValueError, match="r1 must be"):
        kkt_step.kkt_dir(t64(H), cs, t64(r1[:10]), t64(rpe))
    with pytest.raises(ValueError, match="H must be"):
        kkt_step.kkt_dir(t64(H).float(), cs, t64(r1), t64(rpe))
    with pytest.raises(ValueError, match="columns"):
        kkt_step.prep_kkt_consts(t64(F), 61)
    meta = kkt_step.prep_kkt_consts(t64(F).to("meta"), 60)
    with pytest.raises(ValueError, match="unsupported device"):
        kkt_step.kkt_dir(t64(H).to("meta"), meta, t64(r1).to("meta"),
                         t64(rpe).to("meta"))


@pytest.mark.parametrize("n,pe", [(70, 0), (90, 15)])
def test_prepared_factors_serve_two_directions(n, pe):
    """``kkt_dir_prepared`` twice on one ``kkt_prepare`` gives what two
    ``kkt_dir`` calls give (each refactors), bit for bit, and counts one
    factorization instead of two."""
    H, F, r1, rpe = _instance(n, pe, 31 + pe)
    rng = np.random.default_rng(5)
    r1b = t64(rng.standard_normal(n))
    rpeb = t64(rng.standard_normal(pe)) if pe else None
    cs = kkt_step.prep_kkt_consts(None if F is None else t64(F), n)
    rpe = None if rpe is None else t64(rpe)
    before = dict(kkt_step.COUNTS)
    fac = kkt_step.kkt_prepare(t64(H), cs)
    got = [kkt_step.kkt_dir_prepared(fac, t64(r1), rpe),
           kkt_step.kkt_dir_prepared(fac, r1b, rpeb)]
    mid = dict(kkt_step.COUNTS)
    ref = [kkt_step.kkt_dir(t64(H), cs, t64(r1), rpe),
           kkt_step.kkt_dir(t64(H), cs, r1b, rpeb)]
    after = dict(kkt_step.COUNTS)
    assert fac.W.dtype == torch.float64 and fac.dsc.dtype == torch.float64
    assert (fac.Ws is not None) == bool(pe)
    for g, r in zip(got, ref):
        for a, b in zip(g, r):
            assert torch.equal(a, b)
    assert mid["factorizations"] - before.get("factorizations", 0) == 1
    assert after["factorizations"] - mid["factorizations"] == 2
    assert mid["directions"] - before.get("directions", 0) == 2


def test_schur_preconditioner_factors_fty_h_inverse_f():
    """The plain Schur build in fp64, as K5 runs it: S = YᵀY with
    Y = W·diag(D)·Fᵀ from H's fp64 factor equals F H⁻¹ Fᵀ, and
    ``schur_preconditioner``'s (Ws, ds) give S⁻¹ = ds·WsᵀWs·ds, both to
    fp64 rounding (H and S well conditioned here)."""
    rng = np.random.default_rng(5)
    n, pe = 70, 9
    M = rng.standard_normal((n, n))
    H = M @ M.T + n * np.eye(n)
    F = rng.standard_normal((pe, n))
    W, dsc = refine.factor_inverse(_Plain, t64(H), torch.float64)
    assert W.dtype == torch.float64 and dsc.dtype == torch.float64
    S = _Plain.schur_gram(_Plain.kkt_schur(W, dsc, t64(F))).numpy()
    ref = F @ np.linalg.solve(H, F.T)
    assert np.abs(S - ref).max() / np.abs(ref).max() < 1e-12
    Ws, ds = kkt_step.schur_preconditioner(_Plain, W, dsc, t64(F))
    assert Ws.dtype == torch.float64 and ds.dtype == torch.float64
    Ws, ds = Ws[:pe, :pe].numpy(), ds[:pe].numpy()
    s_inv = ds[:, None] * (Ws.T @ Ws) * ds[None, :]
    assert np.abs(s_inv @ ref - np.eye(pe)).max() < 1e-12


def _refined_solve_before(precond, apply_h, dsc, b, refine_n, stall_rel2):
    """ops/refine.py refined_solve as it was before ``exit_rel2`` became
    a keyword (the K1/K2/K4 callers pass none)."""
    x = torch.zeros_like(b)
    res = b
    bn2 = refine.sq(b, dsc)
    exit_rel2 = max(stall_rel2 * 1e-4, 1e-25)
    i = 0
    while i < refine_n and sync.read(refine.sq(res, dsc) > exit_rel2 * bn2):
        x = x + dsc * precond(res * dsc)
        res = b - apply_h(x)
        i += 1
    if sync.read(refine.sq(res, dsc) > stall_rel2 * bn2):
        x, res = refine.pcg(precond, apply_h, dsc, b, x, res, bn2, exit_rel2)
    return x, refine.sq(res, dsc), bn2


@pytest.mark.parametrize("spread,stall", [(6.0, 1e-12), (9.0, 1e-12),
                                          (9.0, 1e-6)])
def test_refined_solve_default_exit_unchanged(spread, stall):
    """Without ``exit_rel2`` the refined solve is bit for bit what it was
    (K1, K2 and K4 keep their numbers); ``exit_rel2=1e-25`` refines
    further at a loose gate."""
    rng = np.random.default_rng(11)
    n = 90
    H = t64(_spd(rng, n, spread))
    b = t64(rng.standard_normal(n))
    W, dsc = refine.factor_inverse(_Plain, H.float())
    dsc64 = dsc[:n].double()

    def precond(v):
        return _Plain.w_solve(W, v.float()).double()

    def apply_h(x):
        return H @ x

    new = refine.refined_solve(precond, apply_h, dsc64, b, 3, stall)
    old = _refined_solve_before(precond, apply_h, dsc64, b, 3, stall)
    assert torch.equal(new[0], old[0])
    assert float(new[1]) == float(old[1]) and float(new[2]) == float(old[2])
    floor = refine.refined_solve(precond, apply_h, dsc64, b, 3, stall,
                                 exit_rel2=1e-25)
    assert float(floor[1]) <= float(new[1])


def test_matrix_free_posdef_solve():
    """ops/kkt.py matrix_free_posdef_solve: an fp32-grade, slightly
    perturbed assembly as the preconditioner and the exact operator in
    fp64 give H⁻¹b to the refinement's floor (κ ≈ 1e9: the refinement
    sweeps stall and the PCG escalations finish the solve)."""
    from interiorpoint_tpu_torch.ops.kkt import matrix_free_posdef_solve

    rng = np.random.default_rng(13)
    H = _spd(rng, 80, diag_spread=9.0)
    b = rng.standard_normal(80)
    H_pre = H * (1.0 + 1e-7 * rng.standard_normal(H.shape))
    H_t = t64(H)
    x, rel_res = matrix_free_posdef_solve(t64(0.5 * (H_pre + H_pre.T)),
                                          lambda v: H_t @ v, t64(b))
    ref = np.linalg.solve(H, b)
    assert float(rel_res) < 1e-9
    assert _rel2(x.numpy(), ref) < 1e-6
