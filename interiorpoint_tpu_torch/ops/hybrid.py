"""The preconditioner of the barrier Newton step K2: the block-LDL factor
with Newton–Schulz tile inverses, its solve, and the cross-step carry.

Counterpart of the preconditioner pieces of
interiorpoint_tpu/ops/pallas_newton.py's ``_newton_step_kernel``:

* ``ns_tile_inv_plain(D)``: ``_ns_tile_inv`` (:334): X ≈ D⁻¹ of an SPD
  tile by symmetric Newton–Schulz, X ← 2X − X·D·X, after a local Jacobi
  pre-scale, from X₀ = I/λmax (3 power iterations), to ‖I − X·D‖²_F ≤
  1e-6 (at most 40 iterations); a tile above 1e-4 there is poisoned with
  NaN.
* ``ldl_factor_*(Hs, delta)`` -> ``(Lt, Dinv, bad)``: ``_ldl_ns_stages``
  (:445) on Hs + δI: Hs ≈ L̃ D L̃ᵀ with L̃ unit block-lower (its panels in
  the strictly lower tiles of Lt; nothing else of Lt is read) and the
  tile inverses X_k ≈ D_k⁻¹ in Dinv (np × b, tile k in rows kb..kb+b);
  ``bad`` (int32, 0-dim) is 1 when a tile missed its gate or a panel is
  not finite.  Stage k inverts the updated diagonal tile, then every
  trailing tile A_ij −= (A_ik X_k) A_jkᵀ (k < j ≤ i) and the panel
  L̃_ik = A_ik X_k.
* ``ldl_solve_*(Lt, Dinv, B)``: ``_ldl_solve`` (:479), M⁻¹B with
  M = L̃ D L̃ᵀ: the forward sweep over L̃, X_kᵀ on each tile, the backward
  sweep over L̃ᵀ (the TPU kernel's row-vector form, transposed).
* ``ns_refresh_*(Hs, X)`` -> ``(X', hit, rho2, iterations)``: the carry
  trial of
  ``_direction_core`` (:649-700): X rescaled by the 3-step power estimate
  of λmax(Hs·X), then X ← 2X − X·Hs·X while ‖I − Hs·X‖²_F > 1e-4 (at
  most 12 iterations); hit when it ends below 1e-4.
* ``gram_tn_*(W)`` = WᵀW, the re-seed after the Cholesky fallback.  The
  carried preconditioner's application Xᵀv (the TPU kernel's v·X) and
  the LDL factor's without a carry run inside the refined solve
  (csrc/hop.cu); ``precond_apply_*`` forms either alone.
* ``decide_*(hit, bad0, bad1, carry)``: the step's branch from the flags
  of the carry trial and the LDL rungs (``ip_k2_decide``), as the TPU
  kernel's ``lax.cond``/``pl.when`` take it (pallas_newton.py:681-701).

The tile edge b of the LDL is the TPU kernel's, ``LDL_BLK`` = 128, in both
versions (Hs is padded to a multiple of it).  It sets which tiles pass
the gate: 64-wide tiles of an ill-conditioned Hs can each pass while the
factor they make does not precondition, where the 128-wide tiles miss
their gate and the Cholesky fallback takes over.

The CUDA sources are ``csrc/ldl.cu`` (the factor, the carry trial, WᵀW,
the branch) and, for the solve, K3b's kernels (``chol.block_solve_cuda``:
``csrc/csolve.cu`` at p = 1, ``csrc/wsolve.cu`` at p > 1).  Every product
is true fp32 on FFMA, as the TPU kernel's ``_dot`` at HIGHEST precision:
no TF32.  The ``*_cuda`` wrappers launch their kernels (K2's backend table
``newton_step._Cuda`` takes them for CUDA tensors, ``_Plain`` the
``*_plain`` twins for CPU tensors); the plain versions are plain PyTorch
in fp32 (their iteration tests read the device, uncounted: they are the
twins, not the path).
"""

from __future__ import annotations

import math

import torch

from ..kernels import _build
from .chol import block_solve_cuda, flag_words

# _ns_tile_inv: iteration cap, convergence target and acceptance gate
NS_TILE_ITERS = 40
NS_TILE_TOL2 = 1e-6
NS_TILE_GATE2 = 1e-4
# the carry trial: _NS_ITERS, _NS_GATE2, _NS_MAX_RP (pallas_newton.py:565)
NS_ITERS = 12
NS_GATE2 = 1e-4
NS_MAX_RP = 512
# the hybrid's own jitter rungs (_factor_hybrid)
LDL_JITTERS = (0.0, 1e-6)
# the LDL's tile edge (pallas_chol.py BLK)
LDL_BLK = 128


def ns_carry_supported(r: int) -> bool:
    """Whether the carry pays at reduced width r: a cost gate, not a
    memory one (pallas_newton.py:ns_carry_supported: the width padded to
    the TPU's 128-wide tile at most 512; beyond it the re-seed's rp³
    product starts to rival the factor it saves)."""
    return max(128, -(-r // 128) * 128) <= NS_MAX_RP


def _f32(name, t, ndim):
    if t.dtype != torch.float32 or t.ndim != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {ndim}-d float32 "
                         f"tensor, got {tuple(t.shape)} {t.dtype}")


# ---------------------------------------------------------------------------
# Newton–Schulz tile inverse (plain; on the card it runs inside the factor)
# ---------------------------------------------------------------------------

def ns_tile_inv_plain(D: torch.Tensor, iters: int = NS_TILE_ITERS,
                      tol2: float = NS_TILE_TOL2):
    """X ≈ D⁻¹ of the SPD fp32 tile D (b × b), or NaN when the iteration
    ends above the gate; returns (X, bad, f2, iterations): bad a 0-dim
    bool, f2 the final ‖I − X·Ds‖²_F that the gate tests."""
    b = D.shape[0]
    eye = torch.eye(b, dtype=D.dtype, device=D.device)
    dsc = torch.rsqrt(torch.clamp(torch.diagonal(D), min=1e-30))
    Ds = D * dsc[:, None] * dsc[None, :]
    u = torch.full((b,), 1.0 / math.sqrt(b), dtype=D.dtype, device=D.device)
    lam = None
    for _ in range(3):
        v = Ds @ u
        lam = torch.sqrt((v * v).sum())
        u = v / torch.clamp(lam, min=1e-30)
    X = eye * (1.0 / torch.clamp(lam, min=1e-30))
    T = X @ Ds
    done = 0
    for _ in range(iters):
        R = eye - T
        f2 = (R * R).sum()
        if not bool((f2 > tol2) & (f2 < 1e10) & torch.isfinite(f2)):
            break
        X = 2.0 * X - T @ X
        T = X @ Ds
        done += 1
    R = eye - T
    f2 = (R * R).sum()
    bad = (f2 > NS_TILE_GATE2) | ~torch.isfinite(f2)
    X = torch.where(bad, torch.full_like(X, float("nan")), X)
    return dsc[:, None] * X * dsc[None, :], bad, f2, done


# ---------------------------------------------------------------------------
# The block-LDL factor
# ---------------------------------------------------------------------------

# ip_ldl_factor's flag words per device and the calls made on them
_LDL_FLAGS = {}


def ldl_factor_cuda(Hs: torch.Tensor, delta: float, skip=None, stats=None,
                    work=None, out=None):
    """Factor Hs + δI (np × np fp32, np a multiple of ``LDL_BLK``) in one
    launch: the tile inverses on a thread-block cluster, the trailing
    updates on the other blocks; ``skip`` (int32 0-dim on the device, or
    None) makes the launch return at once when it holds a non-zero value
    (the carry's hit), with bad 0.  Once a tile fails, the later stages
    stop: a refused factor's Lt and Dinv are not read.  ``stats`` (fp32
    (np/128, 2), or None) receives each tile's final ‖I − X·Ds‖²_F and
    its iterations, the quantities the gate decides on.  ``work`` (np × np
    fp32, or None) is the working copy the trailing updates write: after
    the factor its tile (i, j), 1 ≤ j ≤ i, holds A_ij as stage j read it
    (tile (k, k) the Schur tile whose inverse the gate of tile k tested);
    its first column of tiles is not written.  ``out`` = (Lt, Dinv) of an
    earlier call receives the factor (a skipped call leaves it as it
    was)."""
    _f32("ldl_factor", Hs, 2)
    np_, b = Hs.shape[0], LDL_BLK
    if Hs.shape != (np_, np_) or np_ % b:
        raise ValueError("ldl_factor: Hs must be square, padded to a "
                         f"multiple of {b}")
    A = torch.empty_like(Hs) if work is None else work
    _f32("ldl_factor", A, 2)
    if A.shape != Hs.shape or A.device != Hs.device:
        raise ValueError("ldl_factor: work must be shaped and placed as Hs")
    if out is None:
        Lt = torch.empty_like(Hs)
        Dinv = torch.empty((np_, b), dtype=Hs.dtype, device=Hs.device)
    else:
        Lt, Dinv = out
        if Lt.shape != Hs.shape or Dinv.shape != (np_, b) or \
                Lt.dtype != Hs.dtype or Dinv.dtype != Hs.dtype:
            raise ValueError("ldl_factor: out must be an (np, np) Lt and "
                             "its (np, 128) Dinv")
    ws = torch.empty(_build.query("ip_ldl_ws_floats"), dtype=Hs.dtype,
                     device=Hs.device)
    bad = torch.empty((), dtype=torch.int32, device=Hs.device)
    flags, call = flag_words(_LDL_FLAGS, Hs.device,
                             _build.query("ip_ldl_flag_words", np_))
    _build.launch("ip_ldl_factor", Hs, np_, float(delta), A, Lt, Dinv,
                  flags, call, ws, bad, skip, stats)
    ldl_factor_cuda.launches += 1
    return Lt, Dinv, bad


def ldl_factor_plain(Hs: torch.Tensor, delta: float, skip=None, stats=None,
                     blk: int = LDL_BLK, out=None):
    """Plain twin of ``ldl_factor_cuda`` with tile edge ``blk``; a set
    ``skip`` returns ``out`` (else (Hs, zeros)) and 0 as the kernel leaves
    its outputs unused."""
    np_ = Hs.shape[0]
    if skip is not None and bool(skip):
        if out is None:
            out = (Hs, torch.zeros((np_, blk), dtype=Hs.dtype,
                                   device=Hs.device))
        return (*out, torch.zeros((), dtype=torch.int32, device=Hs.device))
    if out is not None:
        Lt, Dinv, bad = ldl_factor_plain(Hs, delta, stats=stats, blk=blk)
        out[0].copy_(Lt)
        out[1].copy_(Dinv)
        return (*out, bad)
    A = Hs + delta * torch.eye(np_, dtype=Hs.dtype, device=Hs.device)
    Dinv = torch.empty((np_, blk), dtype=Hs.dtype, device=Hs.device)
    bad = torch.zeros((), dtype=torch.bool, device=Hs.device)
    for k0 in range(0, np_, blk):
        k1 = k0 + blk
        Xk, bk, f2, its = ns_tile_inv_plain(A[k0:k1, k0:k1])
        Dinv[k0:k1] = Xk
        if stats is not None:
            stats[k0 // blk, 0], stats[k0 // blk, 1] = f2, its
        bad = bad | bk
        if k1 < np_:
            B = A[k1:, k0:k1] @ Xk
            A[k1:, k1:] -= B @ A[k1:, k0:k1].T
            A[k1:, k0:k1] = B
    bad = bad | ~torch.isfinite(torch.tril(A, -1)).all()
    return A, Dinv, bad.to(torch.int32)


# ---------------------------------------------------------------------------
# The LDL solve
# ---------------------------------------------------------------------------

def ldl_solve_cuda(Lt: torch.Tensor, Dinv: torch.Tensor,
                   B: torch.Tensor, after=None, out=None) -> torch.Tensor:
    """M⁻¹B for B (n,) or (n, p), n ≤ np: the K3b solve kernels with the
    unit block-lower L̃ and the tile inverses in their middle (p = 1 on
    csrc/csolve.cu's one-cluster kernel; p > 1, K2's re-seed M⁻¹I among
    them, on csrc/wsolve.cu's, its launches counted apart in
    ``wide_launches``).  ``after``/``out`` as ``block_solve_cuda``'s (the
    re-seed runs only in its own branch, decided on the device)."""
    _f32("ldl_solve", Lt, 2)
    _f32("ldl_solve", Dinv, 2)
    wide0 = _build.LAUNCHES["ip_block_solve_wide"]
    X = block_solve_cuda(Lt, B, mid=Dinv, blk=LDL_BLK, after=after, out=out)
    ldl_solve_cuda.launches += 1
    ldl_solve_cuda.wide_launches += (_build.LAUNCHES["ip_block_solve_wide"]
                                     - wide0)
    return X


def ldl_solve_plain(Lt: torch.Tensor, Dinv: torch.Tensor, B: torch.Tensor,
                    blk: int = LDL_BLK, after=None,
                    out=None) -> torch.Tensor:
    """Plain twin of ``ldl_solve_cuda`` with tile edge ``blk``."""
    if out is not None:
        if after is None or int(after):
            out.copy_(ldl_solve_plain(Lt, Dinv, B, blk))
        return out
    vec = B.ndim == 1
    n, np_ = B.shape[0], Lt.shape[0]
    Y = torch.zeros((np_, 1 if vec else B.shape[1]), dtype=B.dtype,
                    device=B.device)
    Y[:n] = B[:, None] if vec else B
    nb = np_ // blk
    tiles = [slice(k * blk, (k + 1) * blk) for k in range(nb)]
    for k in range(nb):
        for j in range(k):
            Y[tiles[k]] -= Lt[tiles[k], tiles[j]] @ Y[tiles[j]]
    for k in range(nb):
        Y[tiles[k]] = Dinv[tiles[k]].T @ Y[tiles[k]]
    for k in range(nb - 1, -1, -1):
        for j in range(k + 1, nb):
            Y[tiles[k]] -= Lt[tiles[j], tiles[k]].T @ Y[tiles[j]]
    return Y[:n, 0] if vec else Y[:n]


def precond_apply_cuda(form: int, X, ldl, v: torch.Tensor) -> torch.Tensor:
    """M⁻¹v (fp32, r) of the refined solve's preconditioner form 1 (Xᵀv on
    the leading r × r of X) or 2 (the LDL factor ``ldl`` = (Lt, Dinv) by
    its tile sweeps), by the device functions ``ip_refined_solve`` applies
    inside itself (csrc/hop.cu ``ip_precond_apply``): bitwise the solve's
    own application.  Not on the main path: a check's plain solve on the
    CUDA preconditioner takes it."""
    _f32("precond_apply", v, 1)
    r = v.shape[0]
    out = torch.empty_like(v)
    if form == 1:
        if X.dtype != torch.float32 or X.stride(1) != 1 or min(X.shape) < r:
            raise ValueError("precond_apply: X must be fp32 with unit "
                             "column stride, at least r x r")
        _build.launch("ip_precond_apply", 1, X, X.stride(0), None, None, 0,
                      None, v, out, r)
        return out
    Lt, Dinv = ldl
    _f32("precond_apply", Lt, 2)
    _f32("precond_apply", Dinv, 2)
    lv = torch.empty(3 * Lt.shape[0], dtype=torch.float32, device=v.device)
    _build.launch("ip_precond_apply", int(form), None, 0, Lt, Dinv,
                  Lt.shape[0], lv, v, out, r)
    return out


def precond_apply_plain(form: int, X, ldl, v: torch.Tensor) -> torch.Tensor:
    """Plain twin of ``precond_apply_cuda``."""
    if form == 1:
        r = v.shape[0]
        return v @ X[:r, :r]
    return ldl_solve_plain(*ldl, v)


# ---------------------------------------------------------------------------
# The carry trial and WᵀW
# ---------------------------------------------------------------------------

def ns_refresh_cuda(Hs: torch.Tensor, X: torch.Tensor, out=None):
    """The carry trial on the card (np ≤ ``NS_MAX_RP``), one cooperative
    launch: returns (X', hit, rho2, iterations), hit and iterations int32,
    rho2 fp32, 0-dim; X' into ``out`` where given (not X itself)."""
    _f32("ns_refresh", Hs, 2)
    _f32("ns_refresh", X, 2)
    np_ = Hs.shape[0]
    if Hs.shape != (np_, np_) or X.shape != Hs.shape or \
            X.device != Hs.device:
        raise ValueError("ns_refresh: Hs and X must be square, of one "
                         "shape, on one device")
    if np_ % 32 or np_ > NS_MAX_RP:
        raise ValueError(f"ns_refresh: np = {np_} must be a multiple of 32 "
                         f"and at most {NS_MAX_RP}")
    Xo = torch.empty_like(X) if out is None else out
    if Xo.shape != X.shape or Xo.dtype != X.dtype or \
            Xo.data_ptr() == X.data_ptr():
        raise ValueError("ns_refresh: out must be shaped as X, apart "
                         "from it")
    ws = torch.empty(_build.query("ip_ns_refresh_ws_floats", np_),
                     dtype=torch.float32, device=Hs.device)
    out = torch.empty(2, dtype=torch.int32, device=Hs.device)
    rho2 = torch.empty((), dtype=torch.float32, device=Hs.device)
    _build.launch("ip_ns_refresh", Hs, X, np_, Xo, ws, out, rho2)
    ns_refresh_cuda.launches += 1
    return Xo, out[0], rho2, out[1]


def ns_refresh_plain(Hs: torch.Tensor, X: torch.Tensor, out=None,
                     iters: int = NS_ITERS, gate2: float = NS_GATE2):
    """Plain twin of ``ns_refresh_cuda``."""
    if out is not None:
        Xo, *rest = ns_refresh_plain(Hs, X, iters=iters, gate2=gate2)
        out.copy_(Xo)
        return (out, *rest)
    np_ = Hs.shape[0]
    eye = torch.eye(np_, dtype=Hs.dtype, device=Hs.device)
    u = torch.full((np_,), 1.0 / math.sqrt(np_), dtype=Hs.dtype,
                   device=Hs.device)
    lam = None
    for _ in range(3):
        v = Hs @ (X @ u)
        lam = torch.sqrt((v * v).sum())
        u = v / torch.clamp(lam, min=1e-30)
    X = X * (1.0 / torch.clamp(lam, min=1e-30))
    R = eye - Hs @ X
    done = 0
    for _ in range(iters):
        f2 = (R * R).sum()
        if not bool((f2 > gate2) & (f2 < 1e8) & torch.isfinite(f2)):
            break
        X = 2.0 * X - (X @ Hs) @ X
        R = eye - Hs @ X
        done += 1
    rho2 = (R * R).sum()
    hit = (rho2 < gate2) & torch.isfinite(rho2)
    return X, hit.to(torch.int32), rho2, torch.tensor(done,
                                                      dtype=torch.int32)


def gram_tn_cuda(W: torch.Tensor, after=None, out=None) -> torch.Tensor:
    """WᵀW of the square fp32 W (the re-seed after the fallback); with
    ``after`` (a 0-dim int32 device flag) nothing runs unless it is set,
    and ``out`` (or the new tensor) keeps what it held."""
    _f32("gram_tn", W, 2)
    n = W.shape[0]
    if W.shape != (n, n):
        raise ValueError("gram_tn: W must be square")
    out = torch.empty_like(W) if out is None else out
    if out.shape != W.shape or out.dtype != W.dtype:
        raise ValueError("gram_tn: out must be shaped as W")
    _build.launch("ip_gram_tn", W, n, out, after)
    gram_tn_cuda.launches += 1
    return out


def gram_tn_plain(W: torch.Tensor, after=None, out=None) -> torch.Tensor:
    if out is None:
        return W.T @ W
    if after is None or int(after):
        out.copy_(W.T @ W)
    return out


# ---------------------------------------------------------------------------
# The step's branch
# ---------------------------------------------------------------------------

# the entries of ``decide_*``'s int32 (5,) result
(DEC_SKIP1, DEC_FALLBACK, DEC_RESEED, DEC_KIND, DEC_BRANCH) = range(5)


def decide_cuda(hit, bad0, bad1, carry: bool, dec=None):
    """The branch of K2's preconditioner from the carry trial's hit (None:
    no trial) and the LDL rungs' flags (``bad1`` None: after rung 0 only,
    when only ``DEC_SKIP1`` is written), into ``dec`` (int32 (5,), made
    when None), on the device (one thread, ``ip_k2_decide``):
    ``DEC_SKIP1`` rung 1 skips itself (a hit, or rung 0 passed);
    ``DEC_FALLBACK`` the Cholesky fallback runs (no hit, both rungs
    refused); ``DEC_RESEED`` the LDL re-seed of the carry runs (a carry, no
    hit, a rung passed); ``DEC_KIND`` the refined solve's form
    (csrc/hop.cu): 1 the carry's X with a carry; without one 2 the LDL
    factor's tile sweeps after an LDL rung, 0 the W-solve after the
    fallback; ``DEC_BRANCH`` 0 hit, 1 LDL rung 0, 2 LDL rung 1, 3
    fallback."""
    if dec is None:
        dec = torch.zeros(5, dtype=torch.int32, device=bad0.device)
    _build.launch("ip_k2_decide", hit, bad0, bad1, int(carry), dec)
    decide_cuda.launches += 1
    return dec


def decide_plain(hit, bad0, bad1, carry: bool, dec=None):
    """Plain twin of ``decide_cuda``."""
    if dec is None:
        dec = torch.zeros(5, dtype=torch.int32, device=bad0.device)
    h = hit is not None and bool(hit)
    b0 = bool(bad0)
    dec[DEC_SKIP1] = int(h or not b0)
    if bad1 is None:
        return dec
    b1 = bool(bad1)
    need = not h and b0 and b1
    dec[DEC_FALLBACK] = int(need)
    dec[DEC_RESEED] = int(carry and not h and not need)
    dec[DEC_KIND] = 1 if carry else 0 if need else 2
    dec[DEC_BRANCH] = 0 if h else 1 if not b0 else 2 if not b1 else 3
    return dec


_EYES = {}


def eye(np_: int, device) -> torch.Tensor:
    """The fp32 np × np identity on ``device``, made once (the re-seed's
    right-hand side)."""
    key = (np_, str(device))
    if key not in _EYES:
        _EYES[key] = torch.eye(np_, dtype=torch.float32, device=device)
    return _EYES[key]


# launches of each wrapper's kernel (CUDA tensors only)
for _f in (ldl_factor_cuda, ldl_solve_cuda, ns_refresh_cuda, gram_tn_cuda,
           decide_cuda):
    _f.launches = 0
ldl_solve_cuda.wide_launches = 0   # of them, those on wsolve.cu
