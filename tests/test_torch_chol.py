"""Blocked fp32 Cholesky (K3) and the positive-definite solves of the
port (ops/chol.py, ops/kkt.py) against the JAX package: the Pallas
kernels in interpret mode, ops/kkt.py on the CPU."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_helpers import rel
from interiorpoint_tpu.ops import kkt as kkt_jax
from interiorpoint_tpu_torch.ops import hybrid
from interiorpoint_tpu.ops.pallas_chol import (cholesky_blocked,
                                               cholesky_solve_blocked)
from interiorpoint_tpu_torch.ops import chol
from interiorpoint_tpu_torch.ops import kkt as kkt_torch


def _spd32(n):
    rng = np.random.default_rng(n)
    M = rng.standard_normal((n, n)).astype(np.float32)
    H = M @ M.T + n * np.eye(n, dtype=np.float32)
    B = rng.standard_normal((n, 3)).astype(np.float32)
    return H, B


@pytest.mark.parametrize("n", [100, 200, 300])
def test_plain_k3_matches_pallas_interpret(n):
    H, B = _spd32(n)
    Lj, Dj = cholesky_blocked(jnp.asarray(H), interpret=True)
    Xj = cholesky_solve_blocked(Lj, Dj, jnp.asarray(B), interpret=True)
    calls = chol.cholesky_blocked_plain.calls
    L, D, bad = chol.cholesky_blocked(torch.as_tensor(H))
    X = chol.cholesky_solve_blocked(L, D, torch.as_tensor(B))
    # CPU tensors take the plain versions
    assert chol.cholesky_blocked_plain.calls == calls + 1
    assert int(bad) == 0
    b = chol.PLAIN_BLK
    assert D.shape == (chol.padded(n, b), b)
    assert rel(L.numpy(), np.asarray(Lj)) < 1e-5
    assert rel(X.numpy(), np.asarray(Xj)) < 1e-4
    # Dinv holds the inverses of the factor's diagonal blocks
    for k0 in range(0, n - b + 1, b):
        blk = L[k0:k0 + b, k0:k0 + b].double()
        eye = D[k0:k0 + b].double() @ blk
        assert torch.allclose(eye, torch.eye(b, dtype=torch.float64),
                              atol=1e-4)


def test_plain_k3_flags_indefinite_and_jitter():
    H = -np.eye(70, dtype=np.float32)
    L, _, bad = chol.cholesky_blocked(torch.as_tensor(H))
    assert int(bad) == 1 and torch.isnan(L).any()
    L, _, bad = chol.cholesky_blocked(torch.as_tensor(H), jitter=2.0)
    assert int(bad) == 0
    assert torch.allclose(L, torch.eye(70))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-13)])
@pytest.mark.parametrize("n", [70, 130])
def test_plain_factor_inverse_w_solve_both_precisions(n, dtype, tol):
    """The factor pieces' plain twins in fp32 (K1, K2, K4) and fp64 (K5)
    against numpy: L with LLᵀ = H + δI (identity padding), Dinv the
    inverted diagonal blocks, W = L⁻¹ and the W-solve (LLᵀ)⁻¹b, each to
    the working precision's rounding (tol)."""
    rng = np.random.default_rng(n)
    M = rng.standard_normal((n, n))
    H = M @ M.T / n + np.eye(n)
    delta = 1e-3
    np_ = chol.padded(n, chol.PLAIN_BLK)
    src = torch.as_tensor(H, dtype=dtype)
    L, D, bad = chol.factor_plain(src, n, np_, delta)
    assert L.dtype == D.dtype == dtype and int(bad) == 0
    assert L.shape == (np_, np_) and D.shape == (np_, chol.PLAIN_BLK)
    Hj = np.eye(np_)
    Hj[:n, :n] = np.asarray(src, dtype=np.float64) + delta * np.eye(n)
    Ln = np.linalg.cholesky(Hj)
    assert rel(L.double().numpy(), Ln) < tol
    assert np.abs(np.triu(L.double().numpy(), 1)).max() == 0.0
    b = chol.PLAIN_BLK
    for k0 in range(0, np_, b):
        ref = np.linalg.inv(Ln[k0:k0 + b, k0:k0 + b])
        assert rel(D[k0:k0 + b].double().numpy(), ref) < tol
    W = chol.invert_plain(L, D)
    assert W.dtype == dtype
    assert rel(W.double().numpy(), np.linalg.inv(Ln)) < tol
    rhs = rng.standard_normal(n)
    x = chol.w_solve_plain(W, torch.as_tensor(rhs, dtype=dtype))
    assert x.dtype == dtype
    assert rel(x.double().numpy(), np.linalg.solve(Hj[:n, :n], rhs)) < 10 * tol


def test_k3_wrappers_reject_other_devices():
    H = torch.eye(8, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError):
        chol.cholesky_blocked(H)


_T = torch.eye(128, dtype=torch.float32).T     # column-major layout


@pytest.mark.parametrize("call", [
    lambda: chol.factor_cuda(_T[:, :100], 100, 128, 0.0),
    lambda: chol.invert_cuda(_T, torch.zeros(128, 64)),
    lambda: chol.w_solve_cuda(_T, torch.zeros(128)),
    lambda: chol.w_solve_cuda(torch.eye(128), torch.zeros(256)[::2]),
], ids=["factor", "invert", "w_solve_W", "w_solve_b"])
def test_cuda_piece_wrappers_refuse_layouts_they_cannot_read(call):
    """The kernels read row-major memory through raw pointers: a
    transposed or strided tensor is refused before any launch."""
    with pytest.raises(ValueError):
        call()


@pytest.mark.parametrize("n,p", [(50, 0), (130, 2)])
def test_mixed_posdef_solve_matches_jax(n, p):
    rng = np.random.default_rng(n + p)
    M = rng.standard_normal((n, n))
    # barrier-like scaling spread: the Jacobi scaling has work to do
    sc = np.exp(rng.uniform(-4, 4, n))
    H = (M @ M.T + 0.1 * np.eye(n)) * sc[:, None] * sc[None, :]
    B = rng.standard_normal((n,) if p == 0 else (n, p))
    xj = np.asarray(kkt_jax.mixed_posdef_solve(jnp.asarray(H),
                                               jnp.asarray(B)))
    xt = kkt_torch.mixed_posdef_solve(torch.as_tensor(H),
                                      torch.as_tensor(B)).numpy()
    assert rel(xt, xj) < 1e-12


def test_mixed_solve_takes_fp64_factor_when_refinement_diverges():
    """A fp32 factor that passes with a pivot at rounding level makes the
    fp64 refinement diverge until its residual is no longer finite; the
    mixed solve then takes the fp64 factor (the JAX package's test
    ``rn > 1e-10·‖b‖`` is false on NaN and would return the NaN)."""
    n = 40
    rng = np.random.default_rng(7)
    M = rng.standard_normal((n, n))
    H = torch.as_tensor(M @ M.T / n + np.eye(n))
    B = torch.as_tensor(rng.standard_normal((n, 2)))
    d, Hs, L32, Dinv = kkt_torch.mixed_posdef_prepare(H)
    L32 = L32.clone()
    L32[n // 2, n // 2] *= 1e-4          # pivot² at 1e-8 of its own
    fac = (d, Hs, L32, Dinv)
    kept = kkt_torch.mixed_posdef_factor_solve(fac, B, exact_fallback=False)
    assert not bool(torch.isfinite(kept).all())
    X = kkt_torch.mixed_posdef_factor_solve(fac, B)
    assert bool(torch.isfinite(X).all())
    assert float((H @ X - B).norm() / B.norm()) <= 1e-10


def test_robust_cholesky_matches_jax():
    rng = np.random.default_rng(3)
    M = rng.standard_normal((60, 60))
    H = M @ M.T + 1e-3 * np.eye(60)
    Lj = np.asarray(kkt_jax.robust_cholesky(jnp.asarray(H)))
    Lt = kkt_torch.robust_cholesky(torch.as_tensor(H)).numpy()
    assert rel(Lt, Lj) < 1e-12
    B = rng.standard_normal(60)
    xj = np.asarray(kkt_jax.chol_solve(jnp.asarray(Lj), jnp.asarray(B)))
    xt = kkt_torch.chol_solve(torch.as_tensor(Lt), torch.as_tensor(B))
    assert rel(xt.numpy(), xj) < 1e-12


def test_robust_cholesky_ladder_on_semidefinite():
    """A singular PSD matrix fails rung 0 and succeeds on the ladder, as
    in the JAX package."""
    v = np.arange(1.0, 41.0)
    H = np.outer(v, v)
    Lj = np.asarray(kkt_jax.robust_cholesky(jnp.asarray(H)))
    Lt = kkt_torch.robust_cholesky(torch.as_tensor(H)).numpy()
    assert np.isfinite(Lt).all() and np.isfinite(Lj).all()
    assert rel(Lt @ Lt.T, Lj @ Lj.T) < 1e-8


def test_k3b_plain_twin_solves_three_right_hand_sides():
    """K3b's plain twin at p = 3, each column against an fp64 solve of the
    fp32 matrix, to the fp32 factor's accuracy (κ ≈ 3 here)."""
    H, B = _spd32(150)
    L, D, bad = chol.cholesky_blocked_plain(torch.as_tensor(H))
    X = chol.cholesky_solve_blocked_plain(L, D, torch.as_tensor(B))
    assert int(bad) == 0 and X.shape == (150, 3)
    ref = np.linalg.solve(H.astype(np.float64), B.astype(np.float64))
    assert rel(X.numpy(), ref) < 1e-5
    for c in range(3):
        xc = chol.cholesky_solve_blocked_plain(
            L, D, torch.as_tensor(B[:, c].copy()))
        assert rel(xc.numpy(), ref[:, c]) < 1e-5


@pytest.mark.parametrize("rhs", ["diag", "dense"])
def test_plain_k3b_at_p_equal_n_matches_pallas_interpret(rhs):
    """K3b's plain twin at p = n, the LASSO ladder's width (B = diag(d),
    d = diag(H)^-1/2, as the ladder's first solve; a dense B, as a
    refinement round's residual), against the JAX kernel in interpret
    mode on the JAX factor, n = 130 (three 64-row blocks, the last one
    ragged)."""
    n = 130
    H, _ = _spd32(n)
    if rhs == "diag":
        B = np.diag(1.0 / np.sqrt(np.diag(H))).astype(np.float32)
    else:
        B = np.random.default_rng(7).standard_normal((n, n)).astype(
            np.float32)
    Lj, Dj = cholesky_blocked(jnp.asarray(H), interpret=True)
    Xj = np.asarray(cholesky_solve_blocked(Lj, Dj, jnp.asarray(B),
                                           interpret=True))
    L, D, bad = chol.cholesky_blocked(torch.as_tensor(H))
    X = chol.cholesky_solve_blocked(L, D, torch.as_tensor(B))
    assert int(bad) == 0 and X.shape == (n, n)
    assert rel(X.numpy(), Xj) < 1e-4


@pytest.mark.parametrize("n, p, te, route", [
    (1001, 1, 64, "column"), (1024, 1, 128, "column"),
    (1001, 2, 64, "wide"), (40, 2, 64, "wide"), (1001, 3, 64, "wide"),
    (61, 61, 64, "wide"), (1001, 1001, 64, "wide"),
    (1024, 1024, 128, "wide"), (256, 256, 128, "wide"),
    (chol.WIDE_MAX_N, 1001, 64, "wide"),
    (chol.WIDE_MAX_N + 1, 1001, 64, "chunked"),
    (chol.WIDE_MAX_N + 65, 3, 64, "chunked"),
    (chol.WIDE_MAX_N + 1, 1, 64, "chunked"),
    (61, 1, 64, "column"), (800, 1, 64, "column"), (256, 1, 128, "column"),
    (512, 1, 128, "column"), (chol.COLUMN_MAX_N, 1, 64, "column"),
    (chol.COLUMN_MAX_N + 1, 1, 64, "chunked"),
    (chol.COLUMN_MAX_N + 128, 1, 128, "chunked")])
def test_solve_route_by_width(n, p, te, route):
    """The solve's dispatch on the card (``chol.solve_route``): csolve.cu's
    one-cluster kernel at p = 1 up to COLUMN_MAX_N rows at both tile edges
    (K3b's 64, the LDL's 128), the wide kernel from p = 2 (the crossover)
    up to WIDE_MAX_N rows, chol.cu's 8-column tasks beyond either."""
    assert chol.solve_route(n, p, te) == route


@pytest.mark.parametrize("case, route", [
    ("one_stack", "column"), ("two_stacks", "refused"),
    ("two_stacks_past_column", "chunked"),
    ("row_stride_not_16_bytes", "chunked"), ("base_not_16_bytes", "chunked"),
    ("wide_base_not_16_bytes", "chunked"), ("wide_aligned", "wide")])
def test_solve_route_by_stacks_and_layout(monkeypatch, case, route):
    """The cluster kernels read L and the tiles with 16-byte rows: a factor
    they cannot read goes to chol.cu's tasks (``chol.layout_route``), not
    to a refusal at launch.  The one-column kernel takes one stack of
    diagonal tiles, as both its callers pass (K3b F = G = Dinv, the LDL M
    alone): distinct stacks on its route are refused before any launch,
    and past its rows they go to chol.cu's tasks like any other."""
    calls = _recorded_launches(monkeypatch)
    n, p = (1100 if case.endswith("past_column") else 800), 1
    L = torch.zeros(n, n)
    D = torch.zeros(chol.padded(n, 64), 64)
    if case == "row_stride_not_16_bytes":
        L = torch.zeros(n, n + 3)[:, :n]
    elif case.endswith("base_not_16_bytes"):
        L = torch.zeros(n * n + 1)[1:].view(n, n)
    if case.startswith("wide"):
        p = 3
    if case.startswith("two_stacks"):
        solve = lambda: chol.block_solve_cuda(  # noqa: E731
            L, torch.zeros(n), fwd=D, bwd=D.clone(), blk=64)
        if route == "refused":
            with pytest.raises(ValueError):
                solve()
            assert calls == []
        else:
            solve()
            assert [c[0] for c in calls] == ["ip_block_solve"]
        return
    assert chol.layout_route(chol.solve_route(n, p, 64), L, [D]) == route


def _recorded_launches(monkeypatch):
    """Replace the library by a recorder of (entry, arguments)."""
    from interiorpoint_tpu_torch.kernels import _build
    calls = []
    monkeypatch.setattr(_build, "launch",
                        lambda name, *a: calls.append((name, a)))
    monkeypatch.setattr(_build, "query", lambda name, *a: 2 * 16 * 3)
    return calls


@pytest.mark.parametrize("n, p, entry", [
    (800, 1, "ip_block_solve_column"), (61, 1, "ip_block_solve_column"),
    (1100, 1, "ip_block_solve"), (1001, 3, "ip_block_solve_wide")])
def test_block_solve_launches_its_route_once(monkeypatch, n, p, entry):
    """Each solve is one launch of its route's entry (K3b: F = G = Dinv);
    the 8-column kernel's flag words come from one buffer zeroed once and
    each call takes the next call number, so nothing is zeroed per call."""
    calls = _recorded_launches(monkeypatch)
    chol._SOLVE_FLAGS.clear()
    # L as K3a returns it: the leading n x n of its padded buffer
    np_ = chol.padded(n, 64)
    L = torch.zeros(np_, np_)[:n, :n]
    D = torch.zeros(np_, 64)
    B = torch.zeros(n) if p == 1 else torch.zeros(n, p)
    for _ in range(2):
        X = chol.block_solve_cuda(L, B, fwd=D, bwd=D, blk=64)
        assert X.shape == B.shape
    assert [c[0] for c in calls] == [entry, entry]
    args = calls[1][1]
    assert args[0] is L and args[1] == np_ and args[2] == n and args[3] == 64
    assert args[4] is D and args[5] is None and args[6] is D
    if entry == "ip_block_solve":
        flags, call = args[-2:]
        assert flags is calls[0][1][-2] and call == 2
        assert flags.dtype == torch.int64 and int(flags.abs().sum()) == 0
    chol._SOLVE_FLAGS.clear()


def test_solve_flags_count_calls_grow_and_wrap():
    """The 8-column solve's flag words (``chol.flag_words`` on
    ``chol._SOLVE_FLAGS``): one zeroed int64 buffer per device, each solve
    the next call number (the kernel's flags reach it), a fresh zeroed
    buffer with the count restarted when a solve needs more words, and
    again before the call number would leave a C int."""
    dev = torch.device("cpu")
    chol._SOLVE_FLAGS.pop(dev, None)
    f1, c1 = chol.flag_words(chol._SOLVE_FLAGS, dev, 34)
    f2, c2 = chol.flag_words(chol._SOLVE_FLAGS, dev, 20)
    assert f2 is f1 and (c1, c2) == (1, 2) and f1.numel() == 34
    f3, c3 = chol.flag_words(chol._SOLVE_FLAGS, dev, 132)
    assert f3 is not f1 and f3.numel() == 132 and c3 == 1
    assert int(f3.abs().sum()) == 0
    chol._SOLVE_FLAGS[dev][1] = 2 ** 31 - 1
    f4, c4 = chol.flag_words(chol._SOLVE_FLAGS, dev, 132)
    assert f4 is not f3 and c4 == 1
    chol._SOLVE_FLAGS.pop(dev, None)


@pytest.mark.parametrize("call", [
    lambda: chol.solve_route(100, 2, 32),
    lambda: chol.block_solve_cuda(torch.eye(128), torch.zeros(128, 2),
                                  blk=32),
    lambda: chol.block_solve_cuda(torch.eye(128), torch.zeros(2, 128).T,
                                  blk=64),
    lambda: chol.block_solve_cuda(torch.eye(64), torch.zeros(128, 2),
                                  blk=64),
    lambda: chol.block_solve_cuda(torch.eye(128), torch.zeros(128, 2),
                                  fwd=torch.zeros(64, 64), blk=64),
], ids=["tile_32", "solve_tile_32", "b_not_contiguous", "l_too_small",
        "tiles_short"])
def test_solve_routes_refuse_what_no_kernel_takes(call):
    """A tile edge no kernel has, a strided B, an L smaller than B and a
    short stack of diagonal tiles are refused before anything is
    launched."""
    with pytest.raises(ValueError):
        call()


@pytest.mark.parametrize("call", [
    lambda: hybrid.ldl_factor_cuda(torch.eye(192), 0.0),
    lambda: hybrid.ldl_factor_cuda(torch.eye(128, dtype=torch.float64), 0.0),
    lambda: chol.block_solve_cuda(_T, torch.zeros(128), blk=64),
    lambda: chol.block_solve_cuda(torch.eye(128),
                                  torch.zeros(128, dtype=torch.float64),
                                  blk=64),
    lambda: chol.block_solve_cuda(torch.eye(128), torch.zeros(128),
                                  mid=torch.zeros(64, 64), blk=64),
    lambda: hybrid.ns_refresh_cuda(torch.eye(128), torch.eye(64)),
    lambda: hybrid.ns_refresh_cuda(torch.eye(640), torch.eye(640)),
    lambda: hybrid.ns_refresh_cuda(torch.eye(48), torch.eye(48)),
    lambda: hybrid.gram_tn_cuda(torch.zeros(64, 32)),
    lambda: chol.pivot_floor_cuda(torch.eye(128, dtype=torch.float64), 0.1,
                                  torch.zeros((), dtype=torch.int32)),
    lambda: chol.block_solve_cuda(torch.eye(128), torch.zeros(128),
                                  blk=128, after=torch.zeros(
                                      (), dtype=torch.int32)),
], ids=["ldl_not_128", "ldl_fp64", "solve_L_layout", "solve_fp64_B",
        "solve_short_mid", "carry_shapes", "carry_beyond_512",
        "carry_not_32", "gram_tn_shape", "pivot_floor_fp64",
        "solve_after_off_the_wide_route"])
def test_hybrid_and_solve_wrappers_refuse_what_kernels_cannot_read(call):
    """The new K2 and K3b wrappers check types, shapes and layouts before
    any launch (the kernels read raw row-major memory)."""
    with pytest.raises(ValueError):
        call()


def test_factor_flags_count_calls_grow_and_wrap():
    """K3a's flag words (``chol.flag_words`` on ``chol._FACTOR_FLAGS``):
    one zeroed int64 buffer per device, each factor the next call number
    (the kernel counts its flags from call << 16), a fresh zeroed buffer
    with the count restarted when a wider factor needs more words, and
    again before the call number would leave a C int."""
    dev = torch.device("cpu")
    chol._FACTOR_FLAGS.pop(dev, None)
    f1, c1 = chol.flag_words(chol._FACTOR_FLAGS, dev, 16)
    f2, c2 = chol.flag_words(chol._FACTOR_FLAGS, dev, 9)
    assert f2 is f1 and (c1, c2) == (1, 2)
    assert f1.dtype == torch.int64 and f1.numel() == 16
    assert int(f1.abs().sum()) == 0
    f3, c3 = chol.flag_words(chol._FACTOR_FLAGS, dev, 256)
    assert f3 is not f1 and f3.numel() == 256 and c3 == 1
    assert int(f3.abs().sum()) == 0
    chol._FACTOR_FLAGS[dev][1] = 2 ** 31 - 1
    f4, c4 = chol.flag_words(chol._FACTOR_FLAGS, dev, 256)
    assert f4 is not f3 and c4 == 1
    chol._FACTOR_FLAGS.pop(dev, None)


@pytest.mark.parametrize("shift, flag", [(1.0, 0), (-10.0, 1)])
def test_k3a_flag_spread_permutes_symmetrically(shift, flag):
    """chip_smoke.k3a_flag_spread factors P H Pᵀ from H's lower triangle
    (the upper one holds junk): a definite matrix keeps its plain flag in
    every row order, a positive definite one accepted (the rows alone
    permuted would break it), a negative definite one refused."""
    import chip_smoke
    rng = np.random.default_rng(40)
    M = rng.standard_normal((40, 40))
    H = torch.as_tensor(M @ M.T / 40 + shift * np.eye(40),
                        dtype=torch.float32)
    junk = torch.as_tensor(rng.standard_normal((40, 40)),
                           dtype=torch.float32)
    H = torch.tril(H) + torch.triu(junk, 1)
    assert chip_smoke.k3a_flag_spread(H, 0.0) == [flag] * len(
        chip_smoke.K3A_FLAG_PERMS)


@pytest.mark.parametrize("call", [
    lambda: chol.factor_cuda(torch.eye(128), 129, 128, 0.0),
    lambda: chol.factor_cuda(torch.eye(128), -1, 128, 0.0),
    lambda: chol.factor_cuda(torch.eye(128, dtype=torch.float16), 128, 128,
                             0.0),
    lambda: chol.factor_cuda(torch.eye(128), 128, 128, 0.0,
                             bad=torch.zeros((), dtype=torch.int64)),
    lambda: chol.factor_cuda(torch.eye(128), 128, 128, 0.0,
                             after=torch.zeros(2, dtype=torch.int32)),
], ids=["n_beyond_np", "n_negative", "fp16", "bad_int64", "after_two"])
def test_factor_wrapper_refuses_what_the_kernel_cannot_take(call):
    """The factor's wrapper refuses a width beyond the padded one, a type
    the kernel has no entry for and flags it cannot write, before any
    flag word is taken or anything is launched."""
    dev = torch.device("cpu")
    chol._FACTOR_FLAGS.pop(dev, None)
    with pytest.raises(ValueError):
        call()
    assert dev not in chol._FACTOR_FLAGS
