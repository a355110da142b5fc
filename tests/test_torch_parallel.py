"""The port's parallel/ package against the JAX package's, in one process
on the CPU: ``stack_problems``, ``solve_batch`` (the LP barrier with
equalities, an inequality-form LP batch on K2's plain version with phase
one, a pure-cone SOCP batch on K4's, and "pd" on K1's and K5's),
``solve_lasso_sharded`` on a mesh of 8 CPU entries, and at world size 1
(no process group) ``dist_cholesky`` and ``row_sharded_lp_newton_step``
against the JAX ones on a one-device mesh; and why the LP-with-equalities
barrier's last stage takes other Newton counts than JAX's (rounding at
the stop test).  The two-rank solves are in
tests/test_torch_multihost.py."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from torch_helpers import np_of, rel
from interiorpoint_tpu.models import problem as prob_j
from interiorpoint_tpu.parallel import batch as batch_j
from interiorpoint_tpu.parallel import chol as chol_j
from interiorpoint_tpu.parallel import distributed as dist_j
from interiorpoint_tpu.parallel.mesh import make_mesh as make_mesh_j
from interiorpoint_tpu.utils.config import AdmmConfig as AdmmJ, \
    SolverConfig as CfgJ
from interiorpoint_tpu_torch import parallel as par_t
from interiorpoint_tpu_torch.models import problem as prob_t
from interiorpoint_tpu_torch.models.lasso import solve_lasso
from interiorpoint_tpu_torch.ops import (kkt_step, newton_step, pd_step,
                                         socp_step)
from interiorpoint_tpu_torch.ops.barrier import (make_phase1_linear_oracle,
                                                 make_qp_oracle)
from interiorpoint_tpu_torch.ops.ipm import barrier_solve
from interiorpoint_tpu_torch.ops.socp import (make_phase1_socp_oracle,
                                              make_socp_oracle)
from interiorpoint_tpu_torch.parallel.chol import dist_cholesky
from interiorpoint_tpu_torch.utils import convert
from interiorpoint_tpu_torch.utils.config import AdmmConfig, SolverConfig

B = 8


def _gen_lp(n, m, k, seed):
    """tests/test_parallel.py's instance family."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(-2, 2, (m, n))
    C = rng.uniform(-2, 2, (k, n))
    x_feas = rng.uniform(-2, 2, n)
    c = rng.uniform(-2, 2, n)
    return c, A, A @ x_feas, C, C @ x_feas


@functools.lru_cache(maxsize=None)
def _lp_batch(with_A=True):
    """tests/test_parallel.py:33-50's eight LPs (n = 24, bounds ±3);
    without A the equality rows are dropped."""
    probs_j, probs_t = [], []
    for s in range(B):
        c, A, b, C, d = _gen_lp(24, 18, 6, seed=100 + s)
        if not with_A:
            A = b = None
        probs_j.append(prob_j.make_lp(c, A, b, C, d, -3.0, 3.0))
        probs_t.append(prob_t.make_lp(c, A, b, C, d, -3.0, 3.0,
                                      device="cpu"))
    return probs_j, probs_t, np.zeros((B, 24))


@functools.lru_cache(maxsize=None)
def _ineq_batch():
    """Inequality-form LPs (n = 16, k = 48: 16 random rows and the box ±3
    as rows [I; −I], no A and no bounds, so K2 takes every step); every
    start is x_f, strictly inside, except instance 3's, outside the box,
    so its phase one runs (K2 on [C | −1])."""
    n = 16
    probs_j, probs_t, x0s = [], [], []
    for s in range(B):
        rng = np.random.RandomState(300 + s)
        C0 = rng.uniform(-2, 2, (n, n))
        xf = rng.uniform(-2, 2, n)
        C = np.vstack([C0, np.eye(n), -np.eye(n)])
        d = np.concatenate([C0 @ xf + 1.0, np.full(2 * n, 3.0)])
        c = rng.uniform(-2, 2, n)
        probs_j.append(prob_j.make_lp(c, C=C, d=d))
        probs_t.append(prob_t.make_lp(c, C=C, d=d, device="cpu"))
        x0s.append(xf + (5.0 if s == 3 else 0.0))
    return probs_j, probs_t, np.stack(x0s)


@functools.lru_cache(maxsize=None)
def _socp_batch():
    """tests/test_parallel.py:455-499's SOCP batch without F and without
    the bounds (P is positive definite, so the problems stay bounded):
    the pure-cone form, which K4 takes; instance 3 starts 5 outside the
    cones, so its phase one runs."""
    n, K, M = 10, 3, 4
    probs_j, probs_t, x0s = [], [], []
    for s in range(B):
        rng = np.random.default_rng(200 + s)
        A = [rng.standard_normal((M, n)) for _ in range(K)]
        b = [rng.standard_normal(M) for _ in range(K)]
        cc = [rng.standard_normal(n) for _ in range(K)]
        x0 = rng.standard_normal(n) * 0.1
        d = [np.linalg.norm(A[k] @ x0 + b[k]) - cc[k] @ x0 + 1.0
             for k in range(K)]
        Mq = rng.uniform(-1, 1, (n, n))
        Pq = Mq.T @ Mq + np.eye(n)
        q = rng.uniform(-1, 1, n)
        probs_j.append(prob_j.make_socp(A, b, cc, d, P=Pq, q=q,
                                        dtype=jnp.float64))
        probs_t.append(prob_t.make_socp(A, b, cc, d, P=Pq, q=q,
                                        device="cpu"))
        x0s.append(x0 + (5.0 if s == 3 else 0.0))
    return probs_j, probs_t, np.stack(x0s)


# lp_eq runs at ε = 1e-5: from ε ≈ 1e-6 on, the deep stages of these
# LPs stall at max_inner_iters, where the JAX package's own vmapped batch
# and its single solves part (at ε = 1e-9 the batch stops instances 4
# and 7 after 8 and 7 stages, its single solves after 11)
BATCHES = {"lp_eq": (lambda: _lp_batch(True), dict(epsilon=1e-5, t0=1.0)),
           "lp_ineq": (_ineq_batch,
                       dict(epsilon=1e-8, t0=1.0, mu=15.0, alpha=0.05,
                            beta=0.5, max_inner_iters=20,
                            max_outer_iters=10)),
           "socp": (_socp_batch, dict(epsilon=1e-9, t0=1.0, eq_gate=1e-3)),
           "pd_noeq": (lambda: _lp_batch(False), dict(epsilon=1e-9)),
           "pd_eq": (lambda: _lp_batch(True), dict(epsilon=1e-9))}


@functools.lru_cache(maxsize=None)
def _jax_batch(name):
    make, kw = BATCHES[name]
    probs_j, _, x0 = make()
    algo = "pd" if name.startswith("pd") else "barrier"
    res = batch_j.solve_batch(batch_j.stack_problems(probs_j),
                              jnp.asarray(x0), CfgJ(dtype="float64", **kw),
                              algorithm=algo)
    return jax.tree.map(np.asarray, res)


@functools.lru_cache(maxsize=None)
def _jax_singles(name, mixed=True):
    """The JAX package's single-instance calls of its ``solve_batch``
    engine on each instance (one compile for the eight); ``mixed=False``
    with exact fp64 factors in the KKT solves."""
    make, kw = BATCHES[name]
    probs_j, _, x0 = make()
    cfg = CfgJ(dtype="float64", mixed_precision=mixed, **kw)
    if name.startswith("pd"):
        fn = jax.jit(lambda p, x: batch_j._single_pd(p, x, cfg, "lp"))
    else:
        nc = int(probs_j[0].num_ineq_constraints)
        fn = jax.jit(lambda p, x: batch_j._single_lp(
            p, x, jnp.asarray(cfg.t0), cfg, nc, 1e-4 * x0.shape[1], True))
    return [jax.tree.map(np.asarray, fn(p, jnp.asarray(x)))
            for p, x in zip(probs_j, x0)]


def _single_t(name, prob, x0, cfg):
    """The port's single-instance call of ``solve_batch``'s engine."""
    if name.startswith("pd"):
        from interiorpoint_tpu_torch.models.reduced import \
            full_space_pd_problem
        from interiorpoint_tpu_torch.ops.pd import pd_solve
        return pd_solve(full_space_pd_problem(prob, torch.float64), x0, cfg,
                        A=prob.A, b=prob.b)
    n = x0.shape[0]
    kw = dict(num_constraints=prob.num_ineq_constraints, t0=cfg.t0)
    if name == "socp":
        return barrier_solve(make_socp_oracle(prob), prob.F, prob.g, x0, cfg,
                             eq_gate=cfg.eq_gate,
                             p1_oracle=make_phase1_socp_oracle(prob), **kw)
    return barrier_solve(make_qp_oracle(prob, try_diag=cfg.try_diag),
                         prob.A, prob.b, x0, cfg, eq_gate=1e-4 * n,
                         p1_oracle=make_phase1_linear_oracle(prob), **kw)


def _same(a, b):
    """Bitwise equality of two results' fields."""
    for f, va in a._asdict().items():
        vb = getattr(b, f)
        if isinstance(va, torch.Tensor):
            assert torch.equal(va, vb), f
        elif isinstance(va, tuple):
            _same(va, vb)
        elif va is not None:
            assert np.array_equal(np.asarray(va), np.asarray(vb),
                                  equal_nan=True), f


COUNTERS = {"lp_eq": None, "lp_ineq": newton_step.newton_step_plain,
            "socp": socp_step.socp_newton_step_plain,
            "pd_noeq": pd_step.pd_step_plain, "pd_eq": kkt_step.kkt_dir_plain}


@pytest.mark.parametrize("name", list(BATCHES))
def test_solve_batch_matches_jax(name):
    make, kw = BATCHES[name]
    probs_j, probs_t, x0 = make()
    pd = name.startswith("pd")
    rj = _jax_batch(name)
    cfg = SolverConfig(dtype="float64", **kw)
    # the port starts from JAX's own stacked batch, carried across
    batch = convert.problem_from_jax(batch_j.stack_problems(probs_j),
                                     device="cpu")
    counter = COUNTERS[name]
    calls = counter.calls if counter is not None else 0
    rt = par_t.solve_batch(batch, torch.as_tensor(x0), cfg,
                           mesh=par_t.make_mesh(2, device="cpu"),
                           algorithm="pd" if pd else "barrier")
    if counter is not None:
        assert counter.calls > calls   # the kernel's plain version ran
    jres = (convert.pd_result_from_jax if pd
            else convert.ipm_result_from_jax)(rj, device="cpu")
    x_t = np_of(rt.z if pd else rt.x)
    x_j = np_of(jres.z if pd else jres.x)
    assert x_t.shape == x_j.shape == x0.shape
    if pd:
        vals_t = np.einsum("bn,bn->b", np_of(batch.c), x_t)
        vals_j = np.einsum("bn,bn->b", np_of(batch.c), x_j)
        if name == "pd_eq":
            # the JAX package's vmapped batch stops up to one iteration
            # from its own single solves where the gap test sits at the
            # border: the counts are held to those single solves
            singles = _jax_singles(name)
            np.testing.assert_array_equal(
                rt.iters, [int(r.iters) for r in singles])
            vals_s = np.array([float(p.c @ r.z)
                               for p, r in zip(probs_j, singles)])
            np.testing.assert_allclose(vals_t, vals_s, rtol=1e-9)
        else:
            np.testing.assert_array_equal(rt.iters, jres.iters)
        assert rt.converged.all() and jres.converged.all()
    else:
        vals_t, vals_j = rt.value, jres.value
        np.testing.assert_array_equal(rt.outer_iters, jres.outer_iters)
    assert vals_t.shape == (B,)
    if name == "lp_eq":
        # against the JAX package's single solves too: the same stages,
        # the same Newton steps in each but the last, but the deep stages
        # amplify the two packages' rounding, so the values agree within
        # the reported gaps, not to 1e-9 (printed per seed, pytest -s)
        singles = _jax_singles(name)
        outer = [int(r.outer_iters) for r in singles]
        np.testing.assert_array_equal(rt.outer_iters, outer)
        last_t, last_s = [], []
        for i, (r, k) in enumerate(zip(singles, outer)):
            np.testing.assert_array_equal(rt.inner_iters[i, :k - 1],
                                          r.inner_iters[:k - 1])
            last_t.append(int(rt.inner_iters[i, k - 1]))
            last_s.append(int(r.inner_iters[k - 1]))
        vals_s = np.array([float(r.value) for r in singles])
        print("lp_eq port vs JAX single per seed: rel value diff",
              (np.abs(vals_t - vals_s) / np.abs(vals_s)).tolist(),
              "last-stage Newton steps", last_t, last_s)
        for ref, gap in ((vals_j, jres.dual_gap),
                         (vals_s, [float(r.dual_gap) for r in singles])):
            assert (np.abs(vals_t - ref)
                    <= rt.dual_gap + gap + 1e-9 * np.abs(ref)).all()
    else:
        np.testing.assert_allclose(vals_t, vals_j, rtol=1e-9)
    tol = 1e-5 if name in ("lp_eq", "lp_ineq", "socp") else 1e-7
    assert np.abs(x_t - x_j).max() < tol
    if name in ("lp_ineq", "socp"):
        ran = rt.phase1.outer_iters > 0
        assert ran.tolist() == [i == 3 for i in range(B)]
        np.testing.assert_array_equal(rt.phase1.outer_iters,
                                      jres.phase1.outer_iters)
    # every instance bitwise its own single-instance call
    for i in range(B):
        single = _single_t(name, probs_t[i], torch.as_tensor(x0[i]), cfg)
        inst = type(single)(**{
            f: (None if v is None else
                type(v)(**{g: (None if w is None else w[i])
                           for g, w in v._asdict().items()})
                if isinstance(v, tuple) else v[i])
            for f, v in rt._asdict().items()})
        _same(single, inst)


def _lp_eq_port(i, cfg, x0=None, steps=None):
    """The port's single lp_eq solve of instance i; ``steps`` (a list)
    receives (t, residual) of every infeasible-start Newton step."""
    from interiorpoint_tpu_torch.ops import ipm, sync
    _, probs_t, x0s = _lp_batch(True)
    x0 = torch.as_tensor(x0s[i]) if x0 is None else x0
    if steps is None:
        return _single_t("lp_eq", probs_t[i], x0, cfg)
    inner, read = ipm.newton_infeasible, sync.read_list
    box = {}

    def newton(oracle, A, b, x, v, t, c):
        box["t"] = t
        try:
            return inner(oracle, A, b, x, v, t, c)
        finally:
            box.pop("t")

    def reading(vals):
        out = read(vals)
        if "t" in box:   # the step's [accepted, index, residual]
            steps.append((box["t"], out[2]))
        return out

    ipm.newton_infeasible, sync.read_list = newton, reading
    try:
        return _single_t("lp_eq", probs_t[i], x0, cfg)
    finally:
        ipm.newton_infeasible, sync.read_list = inner, read


def _lp_eq_jax_steps(i, ref):
    """JAX's single lp_eq solve of instance i with (t, residual) of every
    infeasible-start Newton step.  Its engine's loop is a lax.while_loop,
    which cannot be hooked, so this runs a copy of the loop's body
    (interiorpoint_tpu/ops/newton.py:86-123) with a host callback per
    step; the copy's Newton counts are held to the engine's (``ref``)."""
    from interiorpoint_tpu.ops import ipm as ipm_j
    from interiorpoint_tpu.ops import newton as nj

    make, kw = BATCHES["lp_eq"]
    probs_j, _, x0 = make()
    cfg = CfgJ(dtype="float64", **kw)
    steps = []

    def newton(oracle, A, b, x0_, v0, t, c):
        sig = nj._sigmas(c, x0_.dtype)

        def body(s):
            x, v, it, _, _, _ = s
            g, H, rpri = oracle.grad(x, t), oracle.hess(x, t), A @ x - b
            dx, w = nj.solve_kkt_eq(
                H, A, g, rpri, c.kkt_strategy,
                use_psd_condition=c.use_psd_condition,
                refine_steps=c.refine_steps, diag=oracle.diag_hessian,
                mixed=c.mixed_precision)
            dv = w - v
            ATv, ATdv, Adx = A.T @ v, A.T @ dv, A @ dx
            r0 = jnp.sqrt(jnp.sum((g + ATv) ** 2) + jnp.sum(rpri ** 2))
            ok, grads = oracle.ls_grads(x, dx, t, sig)
            r_dual = grads + ATv[:, None] + sig[None, :] * ATdv[:, None]
            r_pri = rpri[:, None] + sig[None, :] * Adx[:, None]
            rn = jnp.sqrt(jnp.sum(r_dual ** 2, 0) + jnp.sum(r_pri ** 2, 0))
            accept = ok & (rn <= (1.0 - c.alpha * sig) * r0)
            any_acc, j, sigma = nj._pick_step(accept, sig)
            res = jnp.where(any_acc, rn[j], r0)
            jax.debug.callback(lambda *a: steps.append(tuple(map(float, a))),
                               t, res, ordered=True)
            conv = res < c.inner_epsilon
            return (x + sigma * dx, v + sigma * dv, it + 1, res,
                    (~any_acc) | conv, conv)

        init = (x0_, v0, jnp.zeros((), jnp.int32),
                jnp.asarray(jnp.inf, x0_.dtype), jnp.zeros((), bool),
                jnp.zeros((), bool))
        out = jax.lax.while_loop(
            lambda s: (~s[4]) & (s[2] < c.max_inner_iters), body, init)
        return nj.NewtonResult(
            x=out[0], v=out[1], iters=out[2], resid=out[3], success=out[5],
            bt_hist=jnp.zeros((sig.shape[0],), jnp.int32))

    engine, ipm_j.newton_infeasible = ipm_j.newton_infeasible, newton
    try:
        nc = int(probs_j[i].num_ineq_constraints)
        r = jax.tree.map(np.asarray, batch_j._single_lp(
            probs_j[i], jnp.asarray(x0[i]), jnp.asarray(cfg.t0), cfg, nc,
            1e-4 * x0.shape[1], True))
    finally:
        ipm_j.newton_infeasible = engine
    k = int(ref.outer_iters)
    assert int(r.outer_iters) == k
    np.testing.assert_array_equal(r.inner_iters[:k], ref.inner_iters[:k])
    return steps


def test_lp_eq_last_stage_split_is_rounding():
    """Why the lp_eq solves of test_solve_batch_matches_jax take other
    Newton counts than JAX's in their last stage only: the rule is the
    same, and the count is decided by rounding at the stop test.

    With exact fp64 factors (``mixed_precision=False``) the two packages
    take the same steps in every stage of all eight instances.  With the
    mixed KKT solves (fp32 factor, fp64 refinement to a relative residual
    of 1e-13) the last stage's Newton residual (t ≈ 1.1e7, ‖r₀‖ ≈ 6e7)
    floors at ~1e-13·‖r₀‖ ≈ 6e-6, within a decade of the stop tolerance
    inner_epsilon = 1e-5: the step at which it first dips below is
    decided by the fp32 factors' rounding.  So a perturbation of the start
    by 1e-15 moves the port's last-stage count over a range that holds
    JAX's, and leaves every earlier stage's.  At the step where JAX stops,
    its residual lies within a decade below the tolerance and the port's
    within a decade above it (``-s`` prints both packages' last-stage
    residuals)."""
    _, kw = BATCHES["lp_eq"]
    cfg = SolverConfig(dtype="float64", mixed_precision=False, **kw)
    singles = _jax_singles("lp_eq", mixed=False)
    for i, r in enumerate(singles):
        rt = _lp_eq_port(i, cfg)
        k = int(r.outer_iters)
        assert rt.outer_iters == k
        np.testing.assert_array_equal(rt.inner_iters[:k], r.inner_iters[:k])

    cfg = SolverConfig(dtype="float64", **kw)
    singles = _jax_singles("lp_eq")
    x0s = _lp_batch(True)[2]
    eps = cfg.inner_epsilon
    for i in (3, 7):
        r = singles[i]
        k = int(r.outer_iters)
        counts = []
        for seed in (1, 2, 3, 4):
            g = torch.Generator().manual_seed(seed)
            x0 = torch.as_tensor(x0s[i]) + 1e-15 * torch.randn(
                24, generator=g, dtype=torch.float64)
            rt = _lp_eq_port(i, cfg, x0)
            assert rt.outer_iters == k
            np.testing.assert_array_equal(rt.inner_iters[:k - 1],
                                          r.inner_iters[:k - 1])
            counts.append(int(rt.inner_iters[k - 1]))
        last_j = int(r.inner_iters[k - 1])
        assert len(set(counts)) > 1 and last_j in counts, (counts, last_j)
        # the deciding step: JAX stops after last_j steps, on a residual
        # below the tolerance; the port's residual at that step is within
        # a decade above it, and the stage's floor, 1e-13 of its first
        # residual, within a decade of it
        steps = []
        rt = _lp_eq_port(i, cfg, steps=steps)
        last = [res for t, res in steps if t == float(r.t)]
        assert len(last) == int(rt.inner_iters[k - 1]) > last_j
        last_jax = [res for t, res in _lp_eq_jax_steps(i, r)
                    if t == float(r.t)]
        assert len(last_jax) == last_j
        floor = 1e-13 * last[0]
        print(f"lp_eq seed {100 + i}: last-stage steps under 1e-15 "
              f"start perturbations {counts}, JAX {last_j}; last-stage "
              f"residuals JAX {last_jax}, the port {last}, floor "
              f"{floor:.2e}, tolerance {eps:g}")
        assert eps / 10 <= last_jax[-1] < eps
        assert eps <= last[last_j - 1] <= 10 * eps
        assert eps / 10 <= floor <= 10 * eps


@pytest.mark.parametrize("kind", ["lp", "socp"])
def test_stack_problems_matches_jax(kind):
    probs_j, probs_t, _ = (_lp_batch(True) if kind == "lp"
                           else _socp_batch())
    sj = batch_j.stack_problems(probs_j)
    st = par_t.stack_problems(probs_t)
    assert type(st).__name__ == type(sj).__name__
    for f in st.__dataclass_fields__:
        vj, vt = getattr(sj, f), getattr(st, f)
        assert (vj is None) == (vt is None), f
        if vt is not None:
            assert tuple(vt.shape) == tuple(vj.shape), f
            np.testing.assert_array_equal(np_of(vt), np.asarray(vj))
    assert st.num_ineq_constraints == sj.num_ineq_constraints
    # None in some problems only is a structure mismatch
    odd = probs_t[:1] + [prob_t.make_lp(np.ones(24), device="cpu")]
    with pytest.raises(ValueError):
        par_t.stack_problems(odd)


def test_solve_batch_rejects_infinite_pd_bounds():
    """The non-finite-bound ValueError carries JAX's message."""
    c, A, b, C, d = _gen_lp(6, 2, 4, seed=1)
    lb = np.full(6, -np.inf)
    pj = batch_j.stack_problems([prob_j.make_lp(c, A, b, C, d, lb, 3.0)] * 2)
    pt = par_t.stack_problems([prob_t.make_lp(c, A, b, C, d, lb, 3.0,
                                              device="cpu")] * 2)
    with pytest.raises(ValueError) as ej:
        batch_j.solve_batch(pj, jnp.zeros((2, 6)), CfgJ(dtype="float64"),
                            algorithm="pd")
    with pytest.raises(ValueError) as et:
        par_t.solve_batch(pt, torch.zeros(2, 6, dtype=torch.float64),
                          SolverConfig(dtype="float64"), algorithm="pd")
    assert str(et.value) == str(ej.value)
    with pytest.raises(ValueError, match="unknown algorithm"):
        par_t.solve_batch(pt, torch.zeros(2, 6, dtype=torch.float64),
                          SolverConfig(), algorithm="newton")


def test_lasso_sharded_matches_jax_and_solve_lasso():
    """tests/test_parallel.py:52-70's instance (16 samples) on a mesh of 8
    CPU entries: the samples gathered on the first entry and solved by
    ``admm_core``, the stopping and descent decisions global as in the
    JAX package's sharded solve."""
    rng = np.random.default_rng(0)
    m, n, nb = 60, 20, 16
    A = rng.random((m, n))
    x_true = np.zeros((n, nb))
    x_true.flat[rng.integers(0, n * nb, n * nb // 4)] = rng.uniform(
        0, 50, n * nb // 4)
    b = A @ x_true + rng.standard_normal((m, nb))
    reg = np.abs(0.05 + 0.01 * rng.standard_normal(nb))
    kw = dict(eps_abs=1e-7, eps_rel=1e-7, max_iters=4000, dtype="float64")
    rj = batch_j.solve_lasso_sharded(A, b, reg, AdmmJ(**kw),
                                     make_mesh_j(8, ("batch",)))
    cfg = AdmmConfig(**kw)
    mesh = par_t.make_mesh(8, device="cpu")
    assert mesh.shape == {"batch": 8}
    from interiorpoint_tpu_torch.ops import sync
    reads = sync.count
    rt = par_t.solve_lasso_sharded(A, b, reg, cfg, mesh)
    reads = sync.count - reads
    reads_single = sync.count
    single = solve_lasso(A, b, reg, cfg=cfg, device="cpu")
    reads_single = sync.count - reads_single
    assert rt.iterations == single.iterations == int(rj.iterations)
    # admm_core's own host reads, no more
    assert reads == reads_single
    assert torch.equal(rt.X, single.X)
    assert np.abs(np_of(rt.X) - np.asarray(rj.X)).max() < 1e-9
    assert rel(np_of(rt.solutions), np.asarray(rj.solutions)) < 1e-9
    # one device: admm_core itself
    one = par_t.solve_lasso_sharded(A, b, reg, cfg,
                                    par_t.make_mesh(1, device="cpu"))
    assert torch.equal(one.X, single.X)


@pytest.mark.parametrize("n,bs", [(37, 8), (130, 32), (333, 64)])
def test_dist_cholesky_matches_jax(n, bs):
    """parallel/chol.py at world size 1 against the JAX factor on a
    one-device mesh: odd n, several block widths, both types."""
    rng = np.random.default_rng(5)
    M = rng.standard_normal((n, n))
    H = M @ M.T + n * np.eye(n)
    mesh = make_mesh_j(1, ("rows",))
    f = jax.jit(shard_map(
        lambda Hm: chol_j.dist_cholesky(Hm, "rows", 1, bs), mesh=mesh,
        in_specs=(P(),), out_specs=P(), check_vma=False))
    Lref = np.linalg.cholesky(H)
    for dt, jdt, tol in ((torch.float64, jnp.float64, 1e-12),
                         (torch.float32, jnp.float32, 1e-5)):
        Lj = np.asarray(f(jnp.asarray(H, jdt)))
        Lt = dist_cholesky(torch.as_tensor(H, dtype=dt), block=bs)
        assert Lt.dtype == dt
        assert rel(np_of(Lt), Lj) < tol, (n, bs, dt)
        assert rel(np_of(Lt), Lref) < (1e-12 if dt == torch.float64
                                       else 1e-4)


def test_row_sharded_newton_step_matches_jax():
    """tests/test_parallel.py:73-128's step at world size 1 against the
    JAX step on a one-device mesh."""
    rng = np.random.default_rng(3)
    n, m, k = 32, 16, 24
    A = rng.uniform(-2, 2, (m, n))
    C = rng.uniform(-2, 2, (k, n))
    x_feas = rng.uniform(-1, 1, n)
    c = rng.uniform(-2, 2, n)
    b = A @ x_feas
    d = C @ x_feas + 1.0
    lb, ub = np.full(n, -3.0), np.full(n, 3.0)
    mesh_j = make_mesh_j(1, ("rows",))
    step_j = dist_j.row_sharded_lp_newton_step(mesh_j)
    sr = lambda a: dist_j.shard_rows(mesh_j, jnp.asarray(a))  # noqa: E731
    xj, vj, rj = step_j(jnp.asarray(c), sr(A), sr(b), sr(C), sr(d),
                        jnp.asarray(lb), jnp.asarray(ub),
                        jnp.asarray(x_feas), jnp.zeros(m), jnp.asarray(2.0))
    mesh = par_t.make_mesh(1, ("rows",), device="cpu")
    step = par_t.row_sharded_lp_newton_step(mesh)
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64))  # noqa
    st = lambda a: par_t.shard_rows(mesh, t(a))  # noqa: E731
    xt, vt, rt = step(t(c), st(A), st(b), st(C), st(d), t(lb), t(ub),
                      t(x_feas), torch.zeros(m, dtype=torch.float64), 2.0)
    assert rel(np_of(xt), np.asarray(xj)) < 1e-10
    assert rel(np_of(vt), np.asarray(vj)) < 1e-8
    assert float(rt) == pytest.approx(float(rj), rel=1e-8)


def test_row_sharded_solves_at_world_size_one():
    """solve_lp_row_sharded (barrier with phase one from the default
    start, pd) and the converter of its result dict, at world size 1
    against the JAX solve on a one-device mesh.  The instance is
    tests/torch_multihost_worker.py's LP, on which the JAX package's own
    Newton counts agree between one and two devices (on many instances of
    this family they do not: its deep stages stop on rounding)."""
    rng = np.random.default_rng(21)
    n, m, k = 24, 11, 13
    A = rng.uniform(-2, 2, (m, n))
    C = rng.uniform(-2, 2, (k, n))
    x_feas = rng.uniform(-1, 1, n)
    c = rng.uniform(-2, 2, n)
    b, d = A @ x_feas, C @ x_feas + 0.5
    assert (d - C @ np.zeros(n)).min() < 0   # the midpoint start: phase one
    mesh_j = make_mesh_j(1, ("rows",))
    mesh = par_t.make_mesh(1, ("rows",), device="cpu")
    for algo in ("barrier", "pd"):
        rj = convert.sharded_result_from_jax(dist_j.solve_lp_row_sharded(
            mesh_j, c, A, b, C, d, lb=-3.0, ub=3.0, epsilon=1e-8,
            algorithm=algo), device="cpu")
        rt = par_t.solve_lp_row_sharded(mesh, c, A, b, C, d, lb=-3.0,
                                        ub=3.0, epsilon=1e-8,
                                        algorithm=algo)
        assert set(rt) == set(rj)
        assert rt["outer_iters"] == rj["outer_iters"]
        assert rt["newton_iters"] == rj["newton_iters"]
        assert rt["objective"] == pytest.approx(rj["objective"], rel=1e-9)
        assert np.abs(np_of(rt["x"]) - np_of(rj["x"])).max() < 1e-6
        assert rt["v"].shape == (m,)


@pytest.mark.parametrize("n", [100, 200])
def test_row_sharded_barrier_deep_end_matches_jax(n):
    """bench.py's LP recipe (seed 1, bounds ±3) at ε = 1e-8, as
    chip_smoke.py's dist_lp5000 rows solve it at n = 5000, against the JAX
    solve on a one-device mesh.  The barrier's deep stages end where no
    candidate lowers the residual, short of centering, so its objective
    lies further from the pd's than its m/t: the port ends where the JAX
    program ends, its barrier − pd difference the JAX one's.  Prints each
    package's relative barrier − pd difference beside m/t (pytest -s)."""
    np.random.seed(1)
    m, k = int(0.8 * n), int(0.2 * n)
    A = np.random.uniform(-2, 2, (m, n))
    C = np.random.uniform(-2, 2, (k, n))
    x_feas = np.random.uniform(-2, 2, n)
    c = np.random.uniform(-2, 2, n)
    args = (c, A, A @ x_feas, C, C @ x_feas)
    kw = dict(lb=-3.0, ub=3.0, epsilon=1e-8)
    mesh_j = make_mesh_j(1, ("rows",))
    mesh = par_t.make_mesh(1, ("rows",), device="cpu")
    out = {}
    for pkg, solve in (("jax", lambda **a: convert.sharded_result_from_jax(
                            dist_j.solve_lp_row_sharded(mesh_j, *args, **a),
                            device="cpu")),
                       ("port", lambda **a: par_t.solve_lp_row_sharded(
                           mesh, *args, **a))):
        out[pkg] = (solve(**kw), solve(**kw, algorithm="pd"))
    (bj, pj), (bt, pt) = out["jax"], out["port"]
    assert bt["outer_iters"] == bj["outer_iters"]
    for rt, rj in ((bt, bj), (pt, pj)):
        assert rt["objective"] == pytest.approx(rj["objective"], rel=1e-9)
        assert np.abs(np_of(rt["x"]) - np_of(rj["x"])).max() < 1e-6
    assert pt["converged"] and pj["converged"]
    scale = abs(pj["objective"])
    diff_j = (bj["objective"] - pj["objective"]) / scale
    diff_t = (bt["objective"] - pt["objective"]) / scale
    m_over_t = (k + 2 * n) / 15.0 ** (bt["outer_iters"] - 1) / scale
    print(f"n={n} barrier-pd rel: jax {diff_j:.6g} port {diff_t:.6g}; "
          f"m/t rel {m_over_t:.6g}")
    assert abs(diff_t - diff_j) <= 1e-9


@pytest.mark.parametrize("kind,algo", [("lp", "barrier"), ("lp", "pd"),
                                       ("qp", "pd"), ("socp", "barrier"),
                                       ("socp", "pd")])
def test_mixed_cooperative_factor_at_world_size_one(kind, algo):
    """The Jacobi-scaled fp32 factor by ``dist_cholesky``
    (``factor_dtype="float32", distributed_factor=True``) in each
    distributed engine, against the JAX solve on a one-device mesh: equal
    stage and Newton counts, the objective to 1e-9."""
    import torch_multihost_worker as W
    from interiorpoint_tpu.parallel import socp_dist as socp_j
    kw = dict(factor_dtype="float32", distributed_factor=True,
              chol_block=8, algorithm=algo)
    axis = "cones" if kind == "socp" else "rows"
    mesh_j = make_mesh_j(1, (axis,))
    mesh = par_t.make_mesh(1, (axis,), device="cpu")
    if kind == "lp":
        args = W.lp_instance()
        run_j = lambda: dist_j.solve_lp_row_sharded(  # noqa: E731
            mesh_j, *args, **W.LP_KW, **kw)
        run_t = lambda: par_t.solve_lp_row_sharded(  # noqa: E731
            mesh, *args, **W.LP_KW, **kw)
    elif kind == "qp":
        *args, xf = W.qp_instance()
        run_j = lambda: dist_j.solve_qp_row_sharded(  # noqa: E731
            mesh_j, *args, x0=xf, **W.LP_KW, **kw)
        run_t = lambda: par_t.solve_qp_row_sharded(  # noqa: E731
            mesh, *args, x0=xf, **W.LP_KW, **kw)
    else:
        A, b, c, d, q, x0 = W.socp_instance()
        skw = dict(q=q, lb=-3.0, ub=3.0, x0=x0, epsilon=1e-8, **kw)
        run_j = lambda: socp_j.solve_socp_cone_sharded(  # noqa: E731
            mesh_j, A, b, c, d, **skw)
        run_t = lambda: par_t.solve_socp_cone_sharded(  # noqa: E731
            mesh, A, b, c, d, **skw)
    rj = convert.sharded_result_from_jax(run_j(), device="cpu")
    rt = run_t()
    assert (rt["outer_iters"], rt["newton_iters"]) == \
        (rj["outer_iters"], rj["newton_iters"])
    assert rt["objective"] == pytest.approx(rj["objective"], rel=1e-9)
    assert np.abs(np_of(rt["x"]) - np_of(rj["x"])).max() < 1e-6


def test_mesh_placement_and_initialize_without_group():
    """make_mesh takes the cards unless given device="cpu" (raising with
    no GPU, as default_device does); batch_sharding splits a length in
    XLA's contiguous ⌈B/p⌉ shards; initialize is a no-op for one
    process; a sharded solve over more positions than ranks is refused."""
    import torch.distributed as dist
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            par_t.make_mesh()
    mesh = par_t.make_mesh(3, ("batch",), device="cpu")
    assert mesh.shape == {"batch": 3}
    shards = par_t.batch_sharding(mesh).shards(8)
    assert [(lo, hi) for _, lo, hi in shards] == [(0, 3), (3, 6), (6, 8)]
    assert par_t.replicated(mesh).shards(8)[0][1:] == (0, 8)
    two = par_t.make_mesh(4, ("batch", "rows"), (2, 2), device="cpu")
    assert two.shape == {"batch": 2, "rows": 2}
    par_t.initialize("localhost:1", 1, 0, device="cpu")
    assert not dist.is_initialized()
    c, A, b, C, d = _gen_lp(6, 2, 4, seed=1)
    with pytest.raises(ValueError, match="2 positions"):
        par_t.solve_lp_row_sharded(par_t.make_mesh(2, ("rows",),
                                                   device="cpu"),
                                   c, A, b, C, d, lb=-3.0, ub=3.0)
