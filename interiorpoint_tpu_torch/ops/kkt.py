"""KKT and positive-definite solves (counterpart of
interiorpoint_tpu/ops/kkt.py).

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
* ``matrix_free_prepare`` / ``matrix_free_posdef_solve`` /
  ``matrix_free_prepared_solve``: an accurate solve without an fp64
  factor (the conic Mehrotra engine's ``exact_fallback=False``): the fp32
  factor of the Jacobi-scaled preconditioner assembly, refinement sweeps
  against the caller's fp64 operator kept only when they improve the
  residual, then two PCG escalations (the factor, and a 1e-6-shifted
  backup factor) on the fp64 operator.
* ``solve_kkt_eq`` / ``solve_newton_step``: the Newton systems of the
  barrier engines (ops/newton.py): the equality-constrained step by block
  elimination through the Schur complement A·H⁻¹Aᵀ, and the unconstrained
  step H dx = −g, for every strategy of the reference (cholesky, mixed or
  exact, with ``refine_steps`` rounds of ``_refine``; the diagonal-Hessian
  Schur path; ``full_kkt``; solve/lstsq/inverse; CG for the unconstrained
  step, with ``jax.scipy.sparse.linalg.cg``'s stopping rule).

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
    # also on a residual that is not finite: an fp32 factor that passes
    # with a pivot at rounding level (κ(Hs)·u32 > 1) makes the refinement
    # diverge to inf; the JAX package's ``rn > 1e-10·bnorm`` is false on
    # NaN and returns it
    if exact_fallback and sync.read(~(rn <= 1e-10 * bnorm)):
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


def matrix_free_prepare(H_pre: torch.Tensor, dtype):
    """Factor the preconditioner-grade assembly once for repeated
    ``matrix_free_prepared_solve`` calls: Jacobi scaling, the fp32 factor
    of the scaled system (K3a, ``robust_cholesky32``) and the
    1e-6-shifted backup factor of the second PCG escalation.  ``dtype``
    is the fp64 working dtype of the right-hand sides.  Returns
    ``(dsc, L32, Dinv, Lsh)``."""
    dg = torch.diagonal(H_pre).to(dtype)
    dsc = 1.0 / torch.sqrt(torch.clamp(dg, min=torch.finfo(dtype).tiny))
    dsc32 = dsc.to(torch.float32)
    Hs32 = (H_pre.to(torch.float32) * dsc32[:, None]
            * dsc32[None, :]).contiguous()
    L32, Dinv = robust_cholesky32(Hs32)
    eye32 = torch.eye(Hs32.shape[0], dtype=torch.float32,
                      device=Hs32.device)
    Lsh = robust_cholesky(Hs32 + 1e-6 * eye32)
    return dsc, L32, Dinv, Lsh


def matrix_free_posdef_solve(H_pre, apply_h, b, *, pcg_iters: int = 48,
                             pcg_rounds: int = 3):
    """Solve H x = b from a preconditioner-grade assembly ``H_pre`` and
    ``apply_h``, the true operator in fp64; no fp64 factor.  Returns
    ``(x, rel_resid)``."""
    fac = matrix_free_prepare(H_pre, b.dtype)
    return matrix_free_prepared_solve(fac, apply_h, b, pcg_iters=pcg_iters,
                                      pcg_rounds=pcg_rounds)


def matrix_free_prepared_solve(fac, apply_h, b, *, pcg_iters: int = 48,
                               pcg_rounds: int = 3, rtol: float = 1e-10):
    """``matrix_free_posdef_solve`` from a ``matrix_free_prepare`` factor.
    ``rtol``: the scaled-residual target the escalations chase."""
    dtype = b.dtype
    dsc, L32, Dinv, Lsh = fac

    def prec(r):
        return _f32_factor_solve(
            L32, Dinv, (r * dsc).to(torch.float32).contiguous()).to(
                dtype) * dsc

    bnorm = torch.linalg.norm(b * dsc)
    x = prec(b)
    r = b - apply_h(x)
    rn = torch.linalg.norm(r * dsc)
    # refinement sweeps, each kept only if it reduced the scaled residual
    # (refinement diverges once κ(Hs)·eps32 > 1); PCG takes over after
    i = 0
    while i < _MIXED_MAX_REFINE and sync.read(
            (rn > _MIXED_RTOL * bnorm) & torch.isfinite(rn)):
        x2 = x + prec(r)
        r2 = b - apply_h(x2)
        rn2 = torch.linalg.norm(r2 * dsc)
        i += 1
        if not sync.read(torch.isfinite(rn2) & (rn2 < rn)):
            break
        x, r, rn = x2, r2, rn2

    def pcg(r_vec, Lp, iters):
        """PCG on the fp64 operator in the scaled space, the fp32 factor
        as the preconditioner only."""
        rs = r_vec * dsc

        def psolve(v):
            return chol_solve(Lp, v.to(torch.float32)).to(dtype)

        xx = torch.zeros_like(rs)
        z = psolve(rs)
        rr, p, rz = rs, z, rs @ z
        for _ in range(iters):
            hp = dsc * apply_h(dsc * p)
            denom = p @ hp
            a = rz / torch.where(denom.abs() > 1e-300, denom, 1e-300)
            xx = xx + a * p
            rr = rr - a * hp
            z = psolve(rr)
            rz2 = rr @ z
            beta = rz2 / torch.where(rz.abs() > 1e-300, rz, 1e-300)
            p = p * beta + z
            rz = rz2
        return dsc * xx

    def pcg_update(x, r, rn, Lp, iters):
        x2 = x + pcg(r, Lp, iters)
        r2 = b - apply_h(x2)
        rn2 = torch.linalg.norm(r2 * dsc)
        if sync.read(torch.isfinite(rn2) & (rn2 < rn)):
            return x2, r2, rn2
        return x, r, rn

    # the stall escalations: the factor, then the shifted backup factor
    if sync.read(rn > rtol * bnorm):
        x, r, rn = pcg_update(x, r, rn, L32, pcg_iters)
    if sync.read(rn > 10.0 * rtol * bnorm):
        x, r, rn = pcg_update(x, r, rn, Lsh, pcg_rounds * pcg_iters)
    return x, rn / torch.clamp(bnorm, min=torch.finfo(dtype).tiny)


def _refine(solve_fn, H, B, X, steps: int):
    """Iterative refinement: X += M⁻¹(B − H X), ``steps`` rounds."""
    for _ in range(steps):
        X = X + solve_fn(B - H @ X)
    return X


def add_psd_conditioning(H: torch.Tensor) -> torch.Tensor:
    """+1e-9 on the diagonal (reference: NewtonSolver.py:269-275)."""
    return H + 1e-9 * torch.eye(H.shape[0], dtype=H.dtype, device=H.device)


def _solve_posdef(H, B, strategy: str, refine_steps: int = 0,
                  mixed: bool = False):
    """Solve H X = B for (symmetric) positive definite H."""
    if strategy == "cholesky":
        if mixed and H.dtype == torch.float64:
            return mixed_posdef_solve(H, B, refine_steps)
        L = robust_cholesky(H)
        X = chol_solve(L, B)
        return _refine(lambda R: chol_solve(L, R), H, B, X, refine_steps)
    if strategy == "solve":
        return torch.linalg.solve(H, B)
    if strategy == "lstsq":
        vec = B.ndim == 1
        X = torch.linalg.lstsq(H, B[:, None] if vec else B).solution
        return X[:, 0] if vec else X
    if strategy == "inverse":
        return torch.linalg.inv(H) @ B
    raise ValueError(f"unsupported posdef strategy {strategy!r}")


def solve_kkt_eq(H, A, g, rpri, strategy: str, *, use_psd_condition=False,
                 refine_steps: int = 0, diag: bool = False,
                 mixed: bool = False):
    """Equality-constrained Newton step by block elimination:

        [[H Aᵀ] [dx]     [g      ]
         [A 0 ]][w ] = − [Ax − b ]

    H is (n, n), or its diagonal (n,) when ``diag``.  Returns (dx, w),
    w the new equality dual."""
    if diag:
        hinv = 1.0 / H
        Hinv_AT = hinv[:, None] * A.T
        Hinv_g = hinv * g
        S = A @ Hinv_AT
        rhs = rpri - A @ Hinv_g
        strat = "cholesky" if strategy in ("cholesky", "diagonal") \
            else strategy
        w = _solve_posdef(S, rhs, strat, refine_steps, mixed)
        dx = -hinv * (g + A.T @ w)
        return dx, w

    if use_psd_condition:
        H = add_psd_conditioning(H)

    if strategy == "full_kkt":
        n, m = H.shape[0], A.shape[0]
        Z = torch.zeros((m, m), dtype=H.dtype, device=H.device)
        M = torch.cat([torch.cat([H, A.T], dim=1),
                       torch.cat([A, Z], dim=1)], dim=0)
        sol = torch.linalg.solve(M, -torch.cat([g, rpri]))
        return sol[:n], sol[n:]

    if strategy == "cg":
        raise NotImplementedError(
            "cg is not supported for equality-constrained (infeasible-start) "
            "solves; matches reference NewtonSolverInfeasibleStart.py:571-660"
        )

    if strategy == "cholesky":
        # one factorization of H serves both right-hand sides; then the
        # Schur complement
        B = torch.cat([A.T, g[:, None]], dim=1)
        if mixed and H.dtype == torch.float64:
            Y = mixed_posdef_solve(H, B, refine_steps)
            Hinv_AT, Hinv_g = Y[:, :-1], Y[:, -1]
            S = A @ Hinv_AT
            S = 0.5 * (S + S.T)
            w = mixed_posdef_solve(S, rpri - A @ Hinv_g, refine_steps)
            dx = -mixed_posdef_solve(H, g + A.T @ w, refine_steps)
            return dx, w
        L1 = robust_cholesky(H)
        solve1 = lambda R: chol_solve(L1, R)  # noqa: E731
        Y = _refine(solve1, H, B, chol_solve(L1, B), refine_steps)
        Hinv_AT, Hinv_g = Y[:, :-1], Y[:, -1]
        S = A @ Hinv_AT
        S = 0.5 * (S + S.T)
        w = _solve_posdef(S, rpri - A @ Hinv_g, "cholesky", refine_steps)
        dxrhs = g + A.T @ w
        dx = _refine(solve1, H, dxrhs, chol_solve(L1, dxrhs), refine_steps)
        return -dx, w

    # lstsq / solve / inverse block elimination
    Hinv_AT = _solve_posdef(H, A.T, strategy)
    Hinv_g = _solve_posdef(H, g, strategy)
    S = A @ Hinv_AT
    w = _solve_posdef(S, rpri - A @ Hinv_g, strategy)
    dx = -_solve_posdef(H, g + A.T @ w, strategy)
    return dx, w


def _cg(H, b, x0, maxiter: int, tol: float = 1e-5):
    """Unpreconditioned CG on H x = b from x0, with the stopping rule of
    jax.scipy.sparse.linalg.cg: ‖r‖² ≤ tol²·‖b‖², at most ``maxiter``
    iterations (one host read per iteration)."""
    atol2 = tol * tol * (b @ b)
    x = x0
    r = b - H @ x0
    p = r
    gamma = r @ r
    k = 0
    while k < maxiter and sync.read(gamma > atol2):
        Ap = H @ p
        alpha = gamma / (p @ Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        gamma2 = r @ r
        p = r + (gamma2 / gamma) * p
        gamma = gamma2
        k += 1
    return x


def solve_newton_step(H, g, x, strategy: str, *, use_psd_condition=False,
                      refine_steps: int = 0, diag: bool = False,
                      max_cg_iters: int = 50, mixed: bool = False):
    """Unconstrained Newton step H dx = −g (feasible-start engine)."""
    if diag:
        return -g / H
    if strategy == "cg":
        # warm start of the reference (NewtonSolver.py:379-383); the system
        # solved is the positive-definite H dx = −g
        descent_check = x @ g
        x0 = torch.where(descent_check < 0,
                         -descent_check * x / (x @ (H @ x)),
                         torch.zeros_like(x))
        return _cg(H, -g, x0, max_cg_iters)
    if use_psd_condition:
        H = add_psd_conditioning(H)
    if strategy == "full_kkt":
        raise ValueError(
            "full_kkt requires equality constraints "
            "(reference: LPSolver.py:427-430)"
        )
    return _solve_posdef(H, -g, strategy, refine_steps, mixed)
