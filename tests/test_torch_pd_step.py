"""The primal-dual step (K1, ops/pd_step.py) in its plain version against
the JAX package's fused Pallas step in interpret mode.

Tolerance 5e-5 is that of tests/test_pallas_pd.py: in interpret mode
XLA:CPU simplifies away some double-float error terms, so the Pallas
step is only ~f32-accurate on its dd outputs; the port carries fp64."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from torch_helpers import np_of, pd_instance, t64
from interiorpoint_tpu.ops.pallas_newton import prep_reduced_consts
from interiorpoint_tpu.ops.pallas_pd import pd_step_prepared
from interiorpoint_tpu_torch.ops import pd_step as ps


@pytest.mark.parametrize("quad", [False, True])
def test_plain_step_matches_pallas_interpret(quad):
    k, r = 96, 24
    C, d, q, P, z, s, lam = pd_instance(5 if quad else 3, k, r, quad)
    consts = prep_reduced_consts(jnp.asarray(C), jnp.asarray(d))
    tP = None if P is None else jnp.asarray(P)
    cs = ps.prep_pd_consts(t64(C), t64(d), None if P is None else t64(P))
    # one trace for the three steps (the constants are closed over)
    step_j = jax.jit(lambda q_, z_, s_, l_: pd_step_prepared(
        consts, q_, z_, s_, l_, tP, interpret=True))
    zj, sj, lj = z.copy(), s.copy(), lam.copy()
    zt, st, lt = t64(z), t64(s), t64(lam)
    for it in range(3):
        zj2, sj2, lj2, stats_j = step_j(
            jnp.asarray(q), jnp.asarray(zj), jnp.asarray(sj),
            jnp.asarray(lj))
        zt, st, lt, stats_t = ps.pd_step(cs, t64(q), zt, st, lt)
        zj, sj, lj = np.asarray(zj2), np.asarray(sj2), np.asarray(lj2)
        scale = max(1.0, np.abs(zj).max())
        assert np.abs(np_of(zt) - zj).max() / scale < 5e-5, it
        assert np.abs(np_of(st) - sj).max() / max(1.0, sj.max()) < 5e-5, it
        assert np.abs(np_of(lt) - lj).max() / max(1.0, lj.max()) < 5e-5, it
        sj_, st_ = np.asarray(stats_j, np.float64), np_of(stats_t)
        for i in (0, 1, 2, 8, 9, 10):
            assert abs(st_[i] - sj_[i]) <= 5e-5 * max(1.0, abs(sj_[i])), \
                (it, i)
        for i in (3, 4, 5):   # step lengths and σ
            assert abs(st_[i] - sj_[i]) < 1e-3, (it, i)
        assert st_[6] <= 1e-8 * st_[7] + 1e-30   # corrector solve_ok
        # continue both from the JAX state so the comparison stays
        # one step deep
        zt, st, lt = t64(zj), t64(sj), t64(lj)


def test_step_routes_cpu_tensors_to_plain():
    C, d, q, P, z, s, lam = pd_instance(9, 40, 10)
    cs = ps.prep_pd_consts(t64(C), t64(d))
    before = (ps.pd_step.launches, ps.pd_step_plain.calls)
    ps.pd_step(cs, t64(q), t64(z), t64(s), t64(lam))
    assert (ps.pd_step.launches, ps.pd_step_plain.calls) == \
        (before[0], before[1] + 1)
    with pytest.raises(ValueError):
        ps.pd_step(cs, t64(q), t64(z).float(), t64(s), t64(lam))


def test_step_sequence_keeps_contraction():
    """A late-stage step (tiny μ, ill-conditioned Hs) still returns a
    finite state whose primal residual respects the (1−α) bookkeeping."""
    C, d, q, P, z, s, lam = pd_instance(11, 96, 24)
    cs = ps.prep_pd_consts(t64(C), t64(d))
    zt, st, lt = t64(z), t64(s), t64(lam)
    for _ in range(12):
        zt, st, lt, stats = ps.pd_step(cs, t64(q), zt, st, lt)
    rp = C @ np_of(zt) + np_of(st) - d
    assert np.isfinite(np_of(stats)).all()
    assert np.abs(rp).max() <= float(stats[1]) * 1.01 + 1e-9
    assert float(stats[0]) < 1e-3
