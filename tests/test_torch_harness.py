"""The port's harness against the JAX package's, in one process on the
CPU: ``ops/step.py``'s single Newton step against JAX's on the entry's
instance, ``entry(device="cpu")``, ``dryrun_multichip(1, device="cpu")``
and its refusal of a group of the wrong size, and the three examples'
``main(["--cpu"])``, each held by independent checks (HiGHS for every
LP, the printed constraint residuals, the phase-one demo's signs of s).
The two-rank dry run is in tests/torch_multihost_worker.py."""
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from scipy.optimize import linprog

from torch_helpers import np_of, rel
from interiorpoint_tpu.ops.step import lp_newton_step as step_j
from interiorpoint_tpu_torch.entry import dryrun_multichip, entry
from interiorpoint_tpu_torch.ops.step import lp_newton_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import demo_torch  # noqa: E402
import distributed_demo_torch  # noqa: E402
import phase_one_demo_torch  # noqa: E402


def _entry_arrays():
    """The entry's instance as float64 numpy arrays."""
    _, args = entry(device="cpu")
    return [np_of(a).astype(np.float64) for a in args]


# The port's step against JAX's on the same arguments.  float64: the
# mixed solves refine to 1e-13, the steps agree to ~4e-11 (x', v',
# resid).  float32: 1e-4 of JAX's step was asked for, and is not met.
# No refinement runs there; each package's step is itself 0.8e-4 to
# 3.2e-4 from the float64 step (JAX 8.0e-5 / 2.1e-4 / 4.5e-5, the port
# 1.3e-4 / 3.2e-4 / 1.2e-4), and the two part by 1.5e-4 / 2.8e-4 /
# 7.6e-5.  Both run the same block elimination; the parts are the CPU
# float32 kernels' rounding (test_lp_newton_step_fp32_rounding).  So the
# binding limit is relative: the port's step within 3x JAX's own distance
# from the float64 step.  1e-3 between the two is a backstop.
STEP_TOL = {"float64": 1e-10, "float32": 1e-3}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_lp_newton_step_matches_jax(dtype):
    arrs = _entry_arrays()
    tdt = getattr(torch, dtype)
    out_t = lp_newton_step(*(torch.as_tensor(a, dtype=tdt) for a in arrs))
    out_j = step_j(*(jnp.asarray(a, dtype=dtype) for a in arrs))
    for t in out_t:
        assert t.dtype == tdt and t.device.type == "cpu"
        assert bool(torch.isfinite(t).all())
    assert tuple(out_t[2].shape) == ()
    errs = [rel(np_of(a), np.asarray(b)) for a, b in zip(out_t, out_j)]
    assert max(errs) <= STEP_TOL[dtype], errs
    if dtype == "float32":
        ref = step_j(*(jnp.asarray(a) for a in arrs))   # float64
        for a, b, r in zip(out_t, out_j, ref):
            assert rel(np_of(a), np.asarray(r)) <= \
                3.0 * rel(np.asarray(b), np.asarray(r))


def test_lp_newton_step_fp32_rounding():
    """Why the port's float32 step lies further from the float64 step
    than JAX's: the two packages run the same block elimination (the
    Cholesky factor of H, its solve with [Aᵀ | g], the Schur matrix S =
    A·H⁻¹Aᵀ and its factor, w, dx), and each float32 kernel of it rounds
    differently in torch and in XLA on the CPU.  On JAX's float32 H and g
    at the entry's point: the elimination over XLA's kernels gives JAX's
    dx and w, over torch's the port's, so the packages' difference is
    the kernels' alone.  With ``-s`` it prints each mix of the three
    kernels (factor, triangle solve, product) with dx's and w's distance
    from the exact solve of the same float32 system."""
    import itertools

    import jax.scipy.linalg as jsl
    from interiorpoint_tpu.models.problem import LPProblem as LPj
    from interiorpoint_tpu.ops.barrier import make_qp_oracle as oracle_j
    from interiorpoint_tpu.ops.kkt import solve_kkt_eq as kkt_j
    from interiorpoint_tpu_torch.ops.kkt import solve_kkt_eq as kkt_t

    c, A, b, C, d, lb, ub, x, v, t = [jnp.asarray(a, dtype="float32")
                                      for a in _entry_arrays()]
    o = oracle_j(LPj(c=c, A=A, b=b, C=C, d=d, lb=lb, ub=ub), try_diag=False)
    H, g, rpri = o.hess(x, t), o.grad(x, t), A @ x - b
    f32 = np.float32

    def tri_j(L, B):
        Y = jsl.solve_triangular(jnp.asarray(L), jnp.asarray(B), lower=True)
        return np.array(jsl.solve_triangular(jnp.asarray(L).T, Y,
                                             lower=False))

    def tri_t(L, B):
        L, B = torch.as_tensor(L), torch.as_tensor(B)
        Y = torch.linalg.solve_triangular(L, B, upper=False)
        return torch.linalg.solve_triangular(L.T, Y, upper=True).numpy()

    kernels = {
        "xla": (lambda M: np.array(jnp.linalg.cholesky(jnp.asarray(M))),
                tri_j, lambda a, b: np.array(jnp.asarray(a)
                                             @ jnp.asarray(b))),
        "torch": (lambda M: torch.linalg.cholesky(torch.as_tensor(M))
                  .numpy(), tri_t,
                  lambda a, b: (torch.as_tensor(a) @ torch.as_tensor(b))
                  .numpy())}
    Hn, gn, An, rn = (np.array(a, dtype=f32) for a in (H, g, A, rpri))

    def eliminate(fac, tri, mm):
        """solve_kkt_eq's "cholesky" branch in float32 (no refinement)."""
        fac, tri, mm = kernels[fac][0], kernels[tri][1], kernels[mm][2]
        L1 = fac(Hn)
        Y = tri(L1, np.concatenate([An.T, gn[:, None]], axis=1))
        S = mm(An, Y[:, :-1])
        S = f32(0.5) * (S + S.T)
        w = tri(fac(S), (rn - mm(An, Y[:, -1:])[:, 0])[:, None])[:, 0]
        dx = -tri(L1, (gn + mm(An.T, w[:, None])[:, 0])[:, None])[:, 0]
        return dx, w

    dx_j, w_j = (np.asarray(a) for a in kkt_j(H, A, g, rpri, "cholesky"))
    dx_t, w_t = (np_of(a) for a in kkt_t(*(torch.as_tensor(np.array(a))
                                           for a in (H, A, g, rpri)),
                                         "cholesky"))
    for (dx, w), (dx_pkg, w_pkg) in ((eliminate("xla", "xla", "xla"),
                                      (dx_j, w_j)),
                                     (eliminate("torch", "torch", "torch"),
                                      (dx_t, w_t))):
        assert rel(dx, dx_pkg) <= 1e-6 and rel(w, w_pkg) <= 1e-6
    # the exact solve of the same float32 system
    Hd, Ad, gd, rd = (a.astype(np.float64) for a in (Hn, An, gn, rn))
    Hi_At, Hi_g = np.linalg.solve(Hd, Ad.T), np.linalg.solve(Hd, gd)
    w64 = np.linalg.solve(Ad @ Hi_At, rd - Ad @ Hi_g)
    dx64 = -np.linalg.solve(Hd, gd + Ad.T @ w64)
    print("float32 block elimination on the entry's instance: factor, "
          "triangle solve, product -> dx, w relative to the exact solve")
    for mix in itertools.product(("xla", "torch"), repeat=3):
        dx, w = eliminate(*mix)
        print(f"  {mix[0]:>5} {mix[1]:>5} {mix[2]:>5} -> "
              f"{rel(dx, dx64):.2e} {rel(w, w64):.2e}")
        assert rel(dx, dx64) <= 1e-3 and rel(w, w64) <= 1e-3


def test_entry_cpu():
    # the JAX package's example instance: default_rng(0), uniform data in
    # this order, the box ±3, x_feas, v = 0, t = 2, as float32
    rng = np.random.default_rng(0)
    n, m, k = 256, 200, 64
    A = rng.uniform(-2, 2, (m, n))
    C = rng.uniform(-2, 2, (k, n))
    xf = rng.uniform(-1, 1, n)
    c = rng.uniform(-2, 2, n)
    want = [jnp.asarray(v, dtype=jnp.float32) for v in (
        c, A, A @ xf, C, C @ xf + 1.0, np.full(n, -3.0), np.full(n, 3.0),
        xf, np.zeros(m), 2.0)]
    fn, args = entry(device="cpu")
    assert fn is lp_newton_step
    assert len(args) == len(want) == 10
    for a, b in zip(args, want):
        assert a.dtype == torch.float32 and a.device.type == "cpu"
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(np_of(a), np.asarray(b))
    x1, v1, resid = fn(*args)
    assert x1.shape == (256,) and v1.shape == (200,)
    assert all(bool(torch.isfinite(t).all()) for t in (x1, v1, resid))


def test_dryrun_multichip_one_process():
    outs = dryrun_multichip(1, device="cpu")
    assert set(outs) == {
        "solve_batch", "row_sharded_lp_newton_step", "solve_lp_row_sharded",
        "solve_pd_row_sharded", "solve_socp_cone_sharded",
        "solve_socp_cone_sharded_pd", "solve_lasso_sharded"}
    shapes = {"solve_batch": (1, 8), "row_sharded_lp_newton_step": (16,),
              "solve_lp_row_sharded": (16,), "solve_pd_row_sharded": (16,),
              "solve_socp_cone_sharded": (12,),
              "solve_socp_cone_sharded_pd": (12,),
              "solve_lasso_sharded": (6, 1)}
    for name, x in outs.items():
        assert tuple(x.shape) == shapes[name], name
        assert x.device.type == "cpu" and bool(torch.isfinite(x).all())


def test_dryrun_multichip_group_size_mismatch_raises():
    # the sharded surfaces need n ranks; with no group there is one
    with pytest.raises(ValueError, match="2 ranks.*has 1"):
        dryrun_multichip(2, device="cpu")


def _highs(c, A, b, C, d, lb=-3.0, ub=3.0):
    h = linprog(c, A_ub=C, b_ub=d, A_eq=A, b_eq=b,
                bounds=[(lb, ub)] * len(c), method="highs")
    assert h.status == 0
    return float(h.fun)


def _near(v, ref, tol=1e-6):
    return abs(v - ref) <= tol * max(1.0, abs(ref))


@pytest.mark.parametrize("name", ["demo", "phase_one_demo",
                                  "distributed_demo"])
def test_example_main_cpu(name, capsys):
    mod = {"demo": demo_torch, "phase_one_demo": phase_one_demo_torch,
           "distributed_demo": distributed_demo_torch}[name]
    out = {}
    assert mod.main(["--cpu"], out) == 0
    assert capsys.readouterr().out   # the walkthrough printed
    if name == "demo":
        lp, pd = out["lp"], out["lp_pd"]
        ref = _highs(*out["lp_data"])
        assert _near(lp["value"], ref) and _near(pd["value"], ref)
        assert abs(lp["value"] - ref) <= lp["gap"] + 1e-9 * abs(ref)
        assert abs(pd["value"] - lp["value"]) <= lp["gap"] + pd["gap"]
        assert lp["cert_ok"] and lp["min_dual"] >= 0
        assert out["qp"]["eq_residual"] <= 1e-6
        from interiorpoint_tpu_torch import certify
        assert certify(out["qp"]["solver"]).ok(1e-6)
        assert out["socp"]["cone_norm"] <= 3.0 + 1e-6
        assert abs(out["socp"]["sum_x"] - 1.0) <= 1e-6
        la = out["lasso"]
        assert la["nnz"][0] > la["nnz"][-1]
        # the LASSO optimality residual of every λ of the sweep
        A, B, X = la["A"], la["b"], la["X"]
        G = A.T @ (A @ X - B[:, None]) / A.shape[0]
        on = np.abs(X) > 1e-9
        res = np.where(on, G + la["lambdas"] * np.sign(X),
                       np.maximum(np.abs(G) - la["lambdas"], 0.0))
        assert np.abs(res).max() <= 1e-5
    elif name == "phase_one_demo":
        s = [out[k]["s"] for k in ("triangle", "empty", "random",
                                   "bounded")]
        assert s[0] < 0 and s[1] > 0 and s[2] < 0 and s[3] < 0, s
        assert out["random"]["max_viol"] < 0
        assert out["bounded"]["max_viol"] < 0
        assert out["bounded"]["x_absmax"] < 3.0
        # the empty polyhedron: no x has max(Gx − h) ≤ 0 (HiGHS agrees)
        G, h = out["empty"]["G"], out["empty"]["h"]
        hi = linprog(np.zeros(2), A_ub=G, b_ub=h, bounds=[(None, None)] * 2,
                     method="highs")
        assert hi.status == 2   # infeasible
    else:
        b = out["batch"]
        assert len(b["values"]) == 8
        assert all(_near(v, h) for v, h in zip(b["values"], b["highs"]))
        for key in ("rows", "rows_pd", "resume"):
            assert _near(out[key]["value"], out[key]["highs"]), key
        rs = out["resume"]
        assert rs["stages_first"] == 3
        assert rs["stages_total"] == rs["uninterrupted_stages"]
        cn, cp = out["cones"], out["cones_pd"]
        assert cn["worst_cone"] <= 1e-6 and cn["eq_residual"] <= 1e-6
        assert _near(cp["value"], cn["value"])
    assert not torch.distributed.is_initialized()
