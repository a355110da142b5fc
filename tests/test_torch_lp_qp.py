"""The port's solvers (LPSolver, QPSolver, solve_lp, solve_qp) against the
JAX package's drivers on the CPU: values, solutions and duals of the
slice's main path (algorithm="auto"/"pd"), the API's error strings, the
state converters, and that the port never imports JAX."""
import functools
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_helpers import np_of, rel
import interiorpoint_tpu as ipj
import interiorpoint_tpu_torch as ipt
from interiorpoint_tpu.models import lp as lp_jax
from interiorpoint_tpu.models import problem as prob_jax
from interiorpoint_tpu.models import reduced as red_jax
from interiorpoint_tpu_torch.models import lp as lp_torch
from interiorpoint_tpu_torch.models import problem as prob_torch
from interiorpoint_tpu_torch.models import reduced as red_torch
from interiorpoint_tpu_torch.utils import convert
from interiorpoint_tpu_torch.utils.generators import generate_lp, \
    generate_qp

ROOT = Path(__file__).resolve().parents[1]
KW = dict(suppress_print=True, check_cvxpy=False, get_dual_variables=True)


def _instance(kind, n):
    gen = generate_lp if kind == "lp" else generate_qp
    return gen(n, rng=np.random.RandomState(1))


@functools.lru_cache(maxsize=None)
def _jax_solution(kind, n):
    p = _instance(kind, n)
    cls = ipj.LPSolver if kind == "lp" else ipj.QPSolver
    s = cls(**p, **KW, algorithm="pd")
    s.solve()
    return s.value, s.xstar, s.lam_star, s.v_star


@pytest.mark.parametrize("kind,n,algorithm", [
    ("lp", 60, "auto"), ("lp", 60, "pd"), ("lp", 200, "auto"),
    ("lp", 200, "pd"), ("qp", 60, "auto"), ("qp", 60, "pd"),
    ("qp", 200, "auto"), ("qp", 200, "pd")])
def test_solver_matches_jax(kind, n, algorithm):
    vj, xj, lj, wj = _jax_solution(kind, n)
    cls = ipt.LPSolver if kind == "lp" else ipt.QPSolver
    s = cls(**_instance(kind, n), **KW, algorithm=algorithm, device="cpu")
    v = s.solve()
    assert s.device.type == "cpu"
    assert s.last_metrics["converged"] and s.last_metrics["algorithm"] == \
        "pd"
    assert v == pytest.approx(vj, rel=1e-7)
    assert rel(s.xstar, xj) < 1e-5
    assert rel(s.lam_star, lj) < 1e-4
    assert rel(s.v_star, wj) < 1e-4
    # the resolve=False fast path returns the cached optimum
    assert s.solve(resolve=False) == v


def test_solver_reports_pd_iterations_and_x0_override():
    p = _instance("lp", 60)
    s = ipt.LPSolver(**p, **KW, algorithm="pd", device="cpu")
    v = s.solve(max_outer_iters=2)
    assert s.outer_iters == 2 and not s.last_metrics["converged"]
    x0 = np.zeros(60)
    assert s.solve(x0=x0) == pytest.approx(_jax_solution("lp", 60)[0],
                                           rel=1e-7)
    assert v != s.value


def test_solve_lp_qp_functional_without_equalities():
    rng = np.random.default_rng(4)
    n, k = 30, 12
    C = rng.uniform(-1, 1, (k, n))
    d = C @ rng.uniform(-1, 1, n) + 0.5
    c = rng.uniform(-1, 1, n)
    rj = ipj.solve_lp(c, C=C, d=d, lb=-2.0, ub=2.0, algorithm="pd",
                      epsilon=1e-9)
    rt = ipt.solve_lp(c, C=C, d=d, lb=-2.0, ub=2.0, algorithm="auto",
                      epsilon=1e-9, device="cpu")
    assert rt.converged
    assert float(c @ np_of(rt.z)) == pytest.approx(
        float(c @ np.asarray(rj.z)), rel=1e-7)
    P = np.eye(n)
    rj = ipj.solve_qp(P, c, C=C, d=d, lb=-2.0, ub=2.0, algorithm="pd",
                      epsilon=1e-9)
    rt = ipt.solve_qp(P, c, C=C, d=d, lb=-2.0, ub=2.0, algorithm="pd",
                      epsilon=1e-9, device="cpu")
    assert rel(np_of(rt.z), np.asarray(rj.z)) < 1e-5


def _msg(fn, *a, **k):
    try:
        fn(*a, **k)
    except (ValueError, NotImplementedError) as e:
        return type(e).__name__, str(e)
    return None


_C = np.ones((3, 4))
_BAD_LP = [
    dict(c=np.ones((2, 2))),
    dict(c=np.ones(4), A=np.ones((2, 4))),
    dict(c=np.ones(4), A=np.ones(4), b=np.ones(1)),
    dict(c=np.ones(4), A=np.ones((2, 4)), b=np.ones((2, 1))),
    dict(c=np.ones(4), A=np.ones((2, 4)), b=np.ones(3)),
    dict(c=np.ones(5), A=np.ones((2, 4)), b=np.ones(2)),
    dict(c=np.ones(4), C=_C),
    dict(c=np.ones(4), C=np.ones(4), d=np.ones(3)),
    dict(c=np.ones(4), C=_C, d=np.ones((3, 1))),
    dict(c=np.ones(4), C=_C, d=np.ones(2)),
    dict(c=np.ones(5), C=_C, d=np.ones(3)),
    dict(c=np.ones(4), C=_C, d=np.ones(3), lower_bound=np.zeros(3)),
    dict(c=np.ones(4), C=_C, d=np.ones(3), upper_bound=np.ones(2)),
    dict(c=np.ones(4), C=_C, d=np.ones(3), lower_bound=1.0,
         upper_bound=0.0),
    dict(A=np.ones((2, 4)), b=np.ones(2), C=np.ones((3, 5)),
         d=np.ones(3)),
]


@pytest.mark.parametrize("case", range(len(_BAD_LP)))
def test_validate_lp_errors_match(case):
    kw = dict(_BAD_LP[case])
    args = [kw.get(k) for k in ("c", "A", "b", "C", "d")]
    lb, ub = kw.get("lower_bound", 0), kw.get("upper_bound")
    ej = _msg(lp_jax._validate_lp, *args, lb, ub)
    assert ej is not None
    assert _msg(lp_torch._validate_lp, *args, lb, ub) == ej
    ctor = dict(kw, check_cvxpy=False, suppress_print=True)
    assert _msg(ipt.LPSolver, **ctor, device="cpu") == \
        _msg(ipj.LPSolver, **ctor)


_BAD_QP = [
    dict(),
    dict(P=np.ones((3, 4))),
    dict(P=np.ones(3)),
    dict(P=np.eye(3), q=np.ones(4)),
    dict(P=np.eye(3), q=np.ones(3), A=np.ones((1, 3))),
    dict(P=np.eye(3), C=np.ones((2, 4)), d=np.ones(2)),
    dict(P=np.eye(3), lower_bound=np.zeros(2)),
]


@pytest.mark.parametrize("case", range(len(_BAD_QP)))
def test_qp_errors_match(case):
    kw = dict(_BAD_QP[case], check_cvxpy=False, suppress_print=True)
    ej = _msg(ipj.QPSolver, **kw)
    assert ej is not None
    assert _msg(ipt.QPSolver, **kw, device="cpu") == ej


def test_algorithm_errors(tmp_path):
    p = _instance("lp", 60)
    kw = dict(p, check_cvxpy=False, suppress_print=True)
    assert _msg(ipt.LPSolver, **kw, algorithm="newton", device="cpu") == \
        _msg(ipj.LPSolver, **kw, algorithm="newton")
    s = ipt.LPSolver(**kw, device="cpu")   # default algorithm="barrier"
    assert s.algorithm == "barrier"
    # the barrier engine solves: the value of the pd path, within its gap
    assert s.solve() == pytest.approx(_jax_solution("lp", 60)[0], rel=1e-9)
    assert s.last_metrics["algorithm"] == "barrier"
    # auto with nothing for pd to act on resolves to the barrier and solves
    s = ipt.LPSolver(c=np.ones(3), A=np.ones((1, 3)), b=np.ones(1),
                     lower_bound=None, upper_bound=None, algorithm="auto",
                     check_cvxpy=False, suppress_print=True,
                     max_outer_iters=2, device="cpu")
    s.solve()
    assert s.last_metrics["algorithm"] == "barrier"
    with pytest.raises(ValueError, match="unknown algorithm"):
        ipt.solve_qp(np.eye(3), lb=0.0, algorithm="x", device="cpu")
    path = tmp_path / "ck.npz"
    with pytest.raises(ValueError, match="checkpoint"):
        ipt.LPSolver(**kw, algorithm="pd", device="cpu").solve(
            checkpoint_path=str(path))
    assert not path.exists()
    # the barrier saves its state after every stage; resume without a
    # path solves afresh (tests/test_torch_utils.py resumes mid-solve)
    v = ipt.LPSolver(**kw, device="cpu").solve(checkpoint_path=str(path))
    assert "state_x" in np.load(path).files
    assert ipt.LPSolver(**kw, device="cpu").solve(resume=True) == v


def test_check_cvxpy_oracle_path():
    p = _instance("lp", 60)
    s = ipt.LPSolver(**p, suppress_print=True, algorithm="auto",
                     device="cpu")
    assert s.feasible == "optimal"
    assert s.solve() == pytest.approx(s.cvxpy_val, rel=1e-7)


def test_default_device_and_config():
    # the port runs on the GPU unless asked for the CPU: with no GPU the
    # default device raises, and so does every entry point without device=
    kw = dict(_instance("lp", 60), check_cvxpy=False, suppress_print=True)
    # the problem builders too: make_lp(...) without device= builds on
    # the GPU, as the JAX builders put their arrays on the default device
    builders = (lambda: ipt.make_lp(np.ones(3), C=np.eye(3), d=np.ones(3)),
                lambda: ipt.make_qp(np.eye(3), np.ones(3)),
                lambda: ipt.make_socp([np.eye(3)], [np.zeros(3)],
                                      [np.zeros(3)], [1.0]),
                lambda: ipt.make_lasso(np.eye(3), np.ones(3)))
    if torch.cuda.is_available():
        assert ipt.default_device().type == "cuda"
        assert builders[0]().c.device.type == "cuda"
    else:
        for call in (ipt.default_device, lambda: ipt.LPSolver(**kw),
                     lambda: ipt.solve_lp(np.ones(3), lb=0.0),
                     lambda: ipt.PhaseOne(np.eye(2), np.ones(2))) + builders:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    assert ipt.make_lp(np.ones(3), device="cpu").c.device.type == "cpu"
    assert ipt.LPSolver(**kw, device="cpu").device.type == "cpu"
    cj, ct = ipj.SolverConfig(), ipt.SolverConfig()
    import dataclasses
    assert [f.name for f in dataclasses.fields(cj)] == \
        [f.name for f in dataclasses.fields(ct)]
    for f in dataclasses.fields(cj):
        assert getattr(cj, f.name) == getattr(ct, f.name), f.name
    assert ipt.SolverConfig(dtype="float64").torch_dtype == torch.float64
    with pytest.raises(ValueError, match="dtype must be one of"):
        ipt.SolverConfig(dtype="float16")


def test_convert_problem_basis_and_state():
    p = _instance("qp", 40)
    lb, ub = p.pop("lower_bound"), p.pop("upper_bound")
    pj = prob_jax.make_qp(p["P"], p["q"], p["A"], p["b"], p["C"], p["d"],
                          lb, ub)
    pt = prob_torch.make_qp(p["P"], p["q"], p["A"], p["b"], p["C"], p["d"],
                            lb, ub, device="cpu")
    pc = convert.problem_from_jax(pj, device="cpu")
    for f in ("P", "q", "A", "b", "C", "d", "lb", "ub"):
        assert torch.equal(getattr(pc, f), getattr(pt, f)), f
    rc = convert.reduced_from_jax(red_jax.reduce_qp(pj), device="cpu")
    rt = red_torch.reduce_qp(pt)
    assert torch.equal(rc.basis.N, rt.basis.N)
    assert rel(np_of(rc.prob.C), np_of(rt.prob.C)) < 1e-13
    lp = prob_jax.make_lp(np.ones(3), C=np.eye(3), d=np.ones(3))
    assert isinstance(convert.problem_from_jax(lp, device="cpu"),
                      prob_torch.LPProblem)
    z, s, lam = convert.pd_state_to_torch(np.ones(3), np.ones(4),
                                          np.ones(4), device="cpu")
    assert z.dtype == torch.float64 and s.shape == (4,) and \
        lam.is_contiguous()


def test_converters_default_to_cuda():
    """Without ``device=`` the converters build on ``default_device()``:
    with no GPU they raise its RuntimeError rather than build on the CPU
    unasked."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    lp = prob_jax.make_lp(np.ones(3), C=np.eye(3), d=np.ones(3))
    for call in (lambda: convert.problem_from_jax(lp),
                 lambda: convert.pd_state_to_torch(np.ones(3), np.ones(4),
                                                   np.ones(4))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import interiorpoint_tpu_torch\n"
        "import interiorpoint_tpu_torch.ops.pd\n"
        "import interiorpoint_tpu_torch.ops.newton_step\n"
        "import interiorpoint_tpu_torch.ops.barrier\n"
        "import interiorpoint_tpu_torch.ops.newton\n"
        "import interiorpoint_tpu_torch.ops.ipm\n"
        "import interiorpoint_tpu_torch.models.phase1\n"
        "import interiorpoint_tpu_torch.utils.convert\n"
        "import interiorpoint_tpu_torch.ops.admm\n"
        "import interiorpoint_tpu_torch.models.lasso\n"
        "from interiorpoint_tpu_torch.utils import certify, checkpoint, "
        "csvio, miplib, mps, plotting, profiling\n"
        "import interiorpoint_tpu_torch.kernels._build\n"
        "import interiorpoint_tpu_torch.ops.step\n"
        "import interiorpoint_tpu_torch.entry\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'interiorpoint_tpu.'))"
        " or m == 'interiorpoint_tpu']\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    # the port's examples import inside main(): scan their sources
    import ast
    examples = sorted((ROOT / "examples").glob("*_torch.py"))
    assert [e.name for e in examples] == [
        "demo_torch.py", "distributed_demo_torch.py",
        "phase_one_demo_torch.py"]
    for path in examples:
        names = []
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names.append(node.module or "")
        bad = [m for m in names if m.split(".")[0] in (
            "jax", "jaxlib", "interiorpoint_tpu")]
        assert not bad, (path.name, bad)
        assert "interiorpoint_tpu_torch" in {m.split(".")[0] for m in names}
