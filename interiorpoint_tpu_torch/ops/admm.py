"""Batched ADMM for LASSO (counterpart of interiorpoint_tpu/ops/admm.py).

An (n × B) iterate solves B problems at once, with one regularization
per problem and one stopping test over the whole batch.  The JAX package
runs the iterations as one ``lax.while_loop`` per ρ rung; here the rungs
are a Python loop and the iterations inside a rung are torch operations
on the solver's device.  The stopping and descent decision is read from
the device once per check, every ``check_stop`` iterations, as one host
read (ops/sync.py) of (done, desc, r_norm) together; there is no host read
between checks.  Capturing one check interval in a CUDA graph is later
work.

Adaptive ρ (``cfg.adaptive_rho``): at each check the primal residual is
compared with the previous check's; when it contracts by less than
``_GAMMA_T`` the solve descends to the next rung of the ladder ρ0/4^j,
rescaling the scaled dual u by the ratio of the two ρ.  The ladder's
inverses Q⁻¹ = (AᵀA + mρI)⁻¹ are built once (``admm_prepare``): in fp64
through ``ops/kkt.py``'s ``mixed_posdef_solve(Q, I)``, whose fp32 factor
and solve are the blocked Cholesky kernels K3a and K3b (ops/chol.py;
CUDA on the GPU, their plain versions on the CPU), in fp32 through
``torch.linalg``, as the JAX package leaves that ladder to XLA.

The iteration's product Qs·(u − α) is ``torch.matmul`` in the solver's
type: the JAX package computes it outside any Pallas kernel, and splits
it into two fp32 products only on the TPU, which has no fp64; the port
carries native fp64.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import sync

# Descend the ρ ladder when the primal residual contracts slower than
# this factor per check interval.
_GAMMA_T = 0.7


class ADMMResult(NamedTuple):
    X: torch.Tensor          # (n, B) solution (the α iterate)
    solutions: torch.Tensor  # (B,) final objective values
    gaps: torch.Tensor       # (max_iters, B) objective trace, or (0, B)
    iterations: int          # iterations executed over all rungs


def soft_threshold(v, eta, positive: bool, add_bias: bool):
    """Proximal operator of η‖·‖₁; the bias row passes through."""
    x = torch.clamp(v - eta, min=0.0)
    if not positive:
        x = x - torch.clamp(-v - eta, min=0.0)
    if add_bias:
        x = torch.cat([v[:1], x[1:]])
    return x


def lasso_objective(A, b, reg, alpha, positive: bool, add_bias: bool):
    """1/(2m)‖Aα − b‖² + reg·‖α‖₁ per column, the bias row
    unregularized."""
    m = A.shape[0]
    f = (0.5 / m) * ((A @ alpha - b) ** 2).sum(dim=0)
    x_abs = alpha if positive else alpha.abs()
    norm1 = x_abs[1:].sum(dim=0) if add_bias else x_abs.sum(dim=0)
    return f + reg * norm1


def _ladder_rhos(cfg):
    """The ρ rungs: cfg.rho, then /cfg.rho_factor per descent."""
    if not cfg.adaptive_rho:
        return (float(cfg.rho),)
    return tuple(float(cfg.rho) / (float(cfg.rho_factor) ** j)
                 for j in range(int(cfg.rho_rungs)))


def _inverse_for(AtA, eye, m, rho):
    """Q⁻¹ for Q = AᵀA + mρI: the Jacobi-scaled fp32 factor with fp64
    refinement (K3a, K3b) for fp64 input, torch.linalg for fp32."""
    from .kkt import mixed_posdef_solve

    Q = AtA + (m * rho) * eye
    if AtA.dtype == torch.float64:
        return mixed_posdef_solve(Q, eye)
    L = torch.linalg.cholesky(Q)
    Y = torch.linalg.solve_triangular(L, eye, upper=False)
    return torch.linalg.solve_triangular(L.T, Y, upper=True)


def admm_prepare(A, cfg):
    """The ladder of Q⁻¹, one per rung, for ``admm_core_prepared``;
    drivers build it once and reuse it across solves and chunks."""
    m, n = A.shape
    AtA = A.T @ A
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    return tuple(_inverse_for(AtA, eye, m, rho) for rho in _ladder_rhos(cfg))


def _norm(t):
    """Frobenius norm of the whole block."""
    return torch.linalg.vector_norm(t.reshape(-1))


def admm_core_prepared(Qinvs, A, b, reg, cfg,
                       num_samples: int) -> ADMMResult:
    """Run the (possibly ρ-adaptive) batched ADMM on the prepared ladder
    (``admm_prepare``)."""
    dtype, dev = A.dtype, A.device
    m, n = A.shape
    B = num_samples
    rhos = _ladder_rhos(cfg)
    if len(Qinvs) != len(rhos):
        raise ValueError("prepared ladder does not match cfg")

    Atb = A.T @ b
    stop_multiplier = cfg.eps_abs * torch.sqrt(
        torch.tensor(float(n * B), dtype=dtype, device=dev))
    gaps = torch.zeros((cfg.max_iters if cfg.compute_loss else 0, B),
                       dtype=dtype, device=dev)
    x = torch.zeros((n, B), dtype=dtype, device=dev)
    alpha = torch.zeros_like(x)
    u = torch.zeros_like(x)
    it, done, desc = 0, False, False
    check_at = cfg.check_stop - 1

    for j, rho in enumerate(rhos):
        if j > 0:
            # enter rung j only when rung j-1 asked to descend; the scaled
            # dual u = y/ρ rescales by the ρ ratio
            if not desc:
                break
            u = u * (rhos[j - 1] / rho)
            desc = False
        allow_desc = j + 1 < len(rhos)
        r_prev = None      # no check on this rung yet (r_prev = inf)
        checks = 0
        bA = Qinvs[j] @ Atb
        Qs = -(m * rho) * Qinvs[j]
        rho_t = torch.tensor(rho, dtype=dtype, device=dev)
        eta = reg / rho_t
        while not done and not desc and it < cfg.max_iters:
            x = bA + Qs @ (u - alpha)
            last_alpha = alpha
            # over-relaxation: x̂ replaces x in the α and u updates only;
            # the stopping residual keeps r = x − α
            if cfg.relax != 1.0:
                xh = cfg.relax * x + (1.0 - cfg.relax) * alpha
            else:
                xh = x
            alpha = soft_threshold(xh + u, eta, cfg.positive, cfg.add_bias)
            u = u + xh - alpha
            if cfg.compute_loss:
                gaps[it] = lasso_objective(A, b, reg, alpha, cfg.positive,
                                           cfg.add_bias)
            if it % cfg.check_stop == check_at:
                r_norm = _norm(x - alpha)
                d_norm = rho_t * _norm(alpha - last_alpha)
                tol_primal = stop_multiplier + cfg.eps_rel * _norm(alpha)
                tol_dual = stop_multiplier + cfg.eps_rel * rho_t * _norm(u)
                done_t = (r_norm < tol_primal) & (d_norm < tol_dual)
                if allow_desc and checks >= 1:
                    slow = torch.isfinite(r_prev) & (r_norm > _GAMMA_T
                                                     * r_prev)
                    desc_t = ~done_t & slow
                else:
                    desc_t = torch.zeros_like(done_t)
                flags = sync.read_list(torch.stack(
                    [done_t.to(dtype), desc_t.to(dtype), r_norm]))
                done, desc = flags[0] != 0.0, flags[1] != 0.0
                r_prev = r_norm
                checks += 1
            it += 1

    solutions = lasso_objective(A, b, reg, alpha, cfg.positive,
                                cfg.add_bias)
    return ADMMResult(X=alpha, solutions=solutions, gaps=gaps,
                      iterations=it)


def admm_core(A, b, reg, cfg, num_samples: int) -> ADMMResult:
    """Solve the batched LASSO: build the ladder, then iterate.  Drivers
    that solve repeatedly keep ``admm_prepare``'s ladder instead."""
    return admm_core_prepared(admm_prepare(A, cfg), A, b, reg, cfg,
                              num_samples)
