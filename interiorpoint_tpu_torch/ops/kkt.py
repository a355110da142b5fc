"""Positive-definite solves of the primal-dual path (counterpart of the
subset of interiorpoint_tpu/ops/kkt.py that the path runs).

* ``robust_cholesky`` / ``chol_solve``: fp64 factor with the escalating
  jitter ladder ``_JITTERS`` × mean(diag H), and two triangular solves.
  These are the exact fallback; JAX leaves this factor to XLA outside any
  Pallas kernel, and so does the port (``torch.linalg``).
* ``robust_cholesky32`` / ``_f32_factor_solve``: the fp32 factor and solve
  of the Jacobi-scaled system, through the blocked Cholesky kernels of
  ops/chol.py (K3) on every device (the JAX package reaches its Pallas
  kernels on the TPU; the port's kernels run on the GPU and their plain
  versions on the CPU).
* ``mixed_posdef_prepare`` / ``mixed_posdef_factor_solve`` /
  ``mixed_posdef_solve`` / ``posdef_solver``: Jacobi-scaled fp32 factor
  plus adaptive fp64 iterative refinement, with the exact-fp64 fallback
  when refinement stalls.

The fp64 products of the refinement (Hs @ X) are ``torch.matmul``, as the
JAX package leaves them to XLA.  Loop exits are host reads
(ops/sync.py).
"""

from __future__ import annotations

import torch

from . import sync
from .chol import cholesky_blocked, cholesky_solve_blocked

_JITTERS = (0.0, 1e-14, 1e-11, 1e-8, 1e-5, 1e-2)

_MIXED_MAX_REFINE = 20
_MIXED_RTOL = 1e-13


def _finite(t: torch.Tensor) -> bool:
    return bool(sync.read(torch.isfinite(t).all()))


def _cholesky_nan(H: torch.Tensor) -> torch.Tensor:
    """torch Cholesky with JAX's failure semantics (NaN, not a raise)."""
    L, info = torch.linalg.cholesky_ex(H)
    if sync.read(info) != 0:
        L = torch.full_like(H, float("nan"))
    return L


def robust_cholesky(H: torch.Tensor) -> torch.Tensor:
    """Factor of H + δ·mean(diag H)·I for the smallest ladder δ giving a
    finite factor (δ = 0 first).  All-NaN if every rung fails."""
    n = H.shape[0]
    scale = torch.diagonal(H).mean()
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    L = _cholesky_nan(H)
    i = 1
    while not _finite(L) and i < len(_JITTERS):
        L = _cholesky_nan(H + (_JITTERS[i] * scale) * eye)
        i += 1
    return L


def chol_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve (L Lᵀ) X = B via two triangular solves."""
    vec = B.ndim == 1
    B2 = B[:, None] if vec else B
    Y = torch.linalg.solve_triangular(L, B2, upper=False)
    X = torch.linalg.solve_triangular(L.T, Y, upper=True)
    return X[:, 0] if vec else X


def robust_cholesky32(Hs32: torch.Tensor):
    """fp32 ``robust_cholesky`` through the blocked factor (K3a):
    returns ``(L, Dinv)``; the ladder adds ``_JITTERS`` × mean(diag)."""
    L, D, bad = cholesky_blocked(Hs32)
    i = 1
    while sync.read(bad) != 0 and i < len(_JITTERS):
        scale = sync.read(torch.diagonal(Hs32).mean())
        L, D, bad = cholesky_blocked(Hs32, _JITTERS[i] * scale)
        i += 1
    return L, D


def _f32_factor_solve(L32, Dinv, B32):
    """Solve (L Lᵀ) X = B in fp32 with the factor of robust_cholesky32."""
    return cholesky_solve_blocked(L32, Dinv, B32)


def mixed_posdef_prepare(H: torch.Tensor):
    """Factor H (fp64) once for repeated right-hand sides: Jacobi scale +
    fp32 factor of the scaled system.  Returns ``(d, Hs, L32, Dinv)``."""
    dg = torch.diagonal(H)
    d = 1.0 / torch.sqrt(torch.clamp(dg, min=torch.finfo(H.dtype).tiny))
    Hs = H * d[:, None] * d[None, :]
    L32, Dinv = robust_cholesky32(Hs.to(torch.float32).contiguous())
    return d, Hs, L32, Dinv


def mixed_posdef_factor_solve(fac, B: torch.Tensor, extra_refine: int = 0,
                              exact_fallback: bool = True) -> torch.Tensor:
    """Solve H X = B given ``fac = mixed_posdef_prepare(H)``: adaptive fp64
    refinement against the scaled system, then (optionally) the exact
    fp64 factor when refinement stalls."""
    d, Hs, L32, Dinv = fac
    dtype = Hs.dtype
    vec = B.ndim == 1
    Bs = (d * B) if vec else (d[:, None] * B)

    def solve32(R):
        return _f32_factor_solve(L32, Dinv,
                                 R.to(torch.float32).contiguous()).to(dtype)

    bnorm = torch.linalg.norm(Bs)
    max_steps = _MIXED_MAX_REFINE + extra_refine
    X = solve32(Bs)
    R = Bs - Hs @ X
    rn = torch.linalg.norm(R)
    i = 0
    while i < max_steps and sync.read(
            (rn > _MIXED_RTOL * bnorm) & torch.isfinite(rn)):
        X = X + solve32(R)
        R = Bs - Hs @ X
        rn = torch.linalg.norm(R)
        i += 1
    if exact_fallback and sync.read(rn > 1e-10 * bnorm):
        X = chol_solve(robust_cholesky(Hs), Bs)
    return (d * X) if vec else (d[:, None] * X)


def mixed_posdef_solve(H: torch.Tensor, B: torch.Tensor,
                       extra_refine: int = 0) -> torch.Tensor:
    """Solve H X = B (fp64) via the Jacobi-scaled fp32 factor and
    adaptive fp64 iterative refinement."""
    return mixed_posdef_factor_solve(mixed_posdef_prepare(H), B,
                                     extra_refine)


def posdef_solver(H: torch.Tensor, mixed: bool, exact_fallback: bool = True):
    """Factor H once and return ``solve(rhs)``: the mixed path when
    ``mixed`` and H is fp64, else a robust native Cholesky."""
    if mixed and H.dtype == torch.float64:
        fac = mixed_posdef_prepare(H)
        return lambda rhs: mixed_posdef_factor_solve(
            fac, rhs, exact_fallback=exact_fallback)
    L = robust_cholesky(H)
    return lambda rhs: chol_solve(L, rhs)
