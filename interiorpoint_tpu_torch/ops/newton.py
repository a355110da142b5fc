"""Newton engines of the barrier method (counterpart of the LP/QP part of
interiorpoint_tpu/ops/newton.py).

* ``newton_infeasible``: primal-dual Newton on the KKT system with the
  residual line search ‖r(x+σdx, v+σdv)‖ ≤ (1−ασ)‖r‖, for problems with
  equality constraints.
* ``newton_feasible``: Newton with the Armijo line search on the barrier
  objective, stopping on the Newton decrement −g·dx/2 < ε_inner; phase
  one adds the early exit on its slack variable.

The line search evaluates all J candidates σⱼ = β^j at once and takes the
first (largest) that passes, exactly the step of the reference's
sequential shrink.  Each Newton iteration is one step on the device and
one host read of a few scalars (ops/sync.py) for the loop test; K2's
step takes every decision inside it on the device and reports them in
that read (its branch and its solve's counts, which fill
``newton_step.COUNTS``).

The fused branches of ``newton_feasible`` run one step kernel per
iteration (the CUDA kernels on a GPU, their plain twins on the CPU) under
the JAX package's gates minus their backend test: ``use_pallas``,
``mixed_precision``, the cholesky strategy, no diagonal Hessian, fp64,
and either a single-block linear form (K2, ops/newton_step.py) or, outside
phase one, the pure-cone SOCP form (K4, ops/socp_step.py, which also
covers the shapes the JAX package sends to its pure-XLA SOCP step).  Both
return the same stats row.  K2 carries its preconditioner from one step
to the next at reduced widths r ≤ 512 (``ops/hybrid.py``
``ns_carry_supported``), a new carry per call, as the JAX package threads
(minv, mvok) through its loop state.  The JAX package looks the accepted σ up among
the candidates (``_sigma_index``) because its kernels return σ in f32;
K2 and K4 return the index itself.  The pure-XLA LP and matrix-free
branches are TPU paths and are not here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import sync
from .kkt import solve_kkt_eq, solve_newton_step
from .hybrid import ns_carry_supported
from .newton_step import (ST_ANY, ST_DIR_OK, ST_INDEX, ST_ND, NSCarry,
                          newton_step, pick_first, tally)
from .pd import dir_stall_tol
from .socp_step import socp_newton_step


class NewtonResult(NamedTuple):
    x: torch.Tensor
    v: Optional[torch.Tensor]   # dual iterate (None: feasible-start)
    iters: int                  # Newton iterations executed
    resid: float                # final residual norm / Newton decrement
    success: bool
    bt_hist: np.ndarray         # (J,) accepted-candidate index counts


def sigmas(cfg, dtype=torch.float64, device="cpu") -> torch.Tensor:
    """The line-search candidates β^j, j < max_linesearch_steps."""
    j = np.arange(cfg.max_linesearch_steps, dtype=np.float64)
    return torch.as_tensor(float(cfg.beta) ** j, dtype=dtype, device=device)


def newton_infeasible(oracle, A, b, x0, v0, t, cfg) -> NewtonResult:
    """Infeasible-start Newton for min t·f(x) s.t. Ax = b."""
    sig = sigmas(cfg, x0.dtype, x0.device)
    hist = np.zeros(sig.shape[0], dtype=np.int64)
    x, v = x0, v0
    it, resid, success, done = 0, float("inf"), False, False
    while not done and it < cfg.max_inner_iters:
        g = oracle.grad(x, t)
        H = oracle.hess(x, t)
        rpri = A @ x - b
        dx, w = solve_kkt_eq(
            H, A, g, rpri, cfg.kkt_strategy,
            use_psd_condition=cfg.use_psd_condition,
            refine_steps=cfg.refine_steps, diag=oracle.diag_hessian,
            mixed=cfg.mixed_precision)
        dv = w - v
        ATv, ATdv, Adx = A.T @ v, A.T @ dv, A @ dx
        r0 = torch.sqrt(((g + ATv) ** 2).sum() + (rpri ** 2).sum())
        ok, grads = oracle.ls_grads(x, dx, t, sig)
        r_dual = grads + ATv[:, None] + sig[None, :] * ATdv[:, None]
        r_pri = rpri[:, None] + sig[None, :] * Adx[:, None]
        rn = torch.sqrt((r_dual ** 2).sum(dim=0) + (r_pri ** 2).sum(dim=0))
        accept = ok & (rn <= (1.0 - cfg.alpha * sig) * r0)
        any_acc, j, sigma = pick_first(accept, sig)
        x = x + sigma * dx
        v = v + sigma * dv
        res_new = torch.where(any_acc, rn[j], r0)
        acc, jj, resid = sync.read_list(torch.stack([
            any_acc.to(x.dtype), j.to(x.dtype), res_new]))
        hist[int(jj)] += int(acc)
        success = resid < cfg.inner_epsilon
        done = acc == 0.0 or success
        it += 1
    return NewtonResult(x=x, v=v, iters=it, resid=resid, success=success,
                        bt_hist=hist)


def newton_feasible(oracle, x0, t, cfg, *, phase1_flag: bool = False,
                    phase1_tol: float = 0.1) -> NewtonResult:
    """Feasible-start Newton with Armijo backtracking on the barrier
    objective; stops on the Newton decrement −∇fᵀΔx/2 < ε_inner.
    ``phase1_flag`` adds the early exit once the slack variable (last
    coordinate) drops below −phase1_tol."""
    dtype = x0.dtype
    sig = sigmas(cfg, dtype, x0.device)
    gate = (cfg.use_pallas and cfg.mixed_precision
            and cfg.kkt_strategy == "cholesky" and not oracle.diag_hessian
            and dtype == torch.float64)
    step = None
    if gate and oracle.lin_form is not None:
        step, cs = newton_step, oracle.nt_consts()
        _, _, lin_cost, P_lin = oracle.lin_form
    elif gate and oracle.socp_form is not None and not phase1_flag:
        step, cs = socp_newton_step, oracle.socp_consts()
        lin_cost, P_lin = oracle.socp_form.q, oracle.socp_form.P
    use_fused = step is not None
    # K2's cross-step preconditioner carry (the JAX package's minv/mvok):
    # a new carry per call, so the first step always factors
    step_kw = {}
    if step is newton_step and ns_carry_supported(cs.r):
        step_kw["carry"] = NSCarry()
    if use_fused:
        tc = (t * lin_cost).contiguous() if lin_cost is not None \
            else torch.zeros(cs.r, dtype=dtype, device=x0.device)
        tP = (t * P_lin).contiguous() if P_lin is not None else None
        tP32 = tP.to(torch.float32) if tP is not None else None
        dtol = dir_stall_tol(cfg.epsilon)

    hist = np.zeros(sig.shape[0], dtype=np.int64)
    x = x0
    it, nd, success, done = 0, float("inf"), False, False
    while not done and it < cfg.max_inner_iters:
        if use_fused:
            x_new, st = step(cs, tc, x.contiguous(), tP, sig,
                             alpha=cfg.alpha, refine=cfg.pallas_refine,
                             dir_tol=dtol, tP32=tP32, **step_kw)
            vals = sync.read_list(torch.cat([st, x_new[-1:]]))
            if step is newton_step:
                tally(vals)
            nd = vals[ST_ND]
            if vals[ST_DIR_OK] == 0.0:
                # an inaccurate direction makes the decrement read small
                # prematurely: trust convergence only when it is accurate
                nd = max(nd, cfg.inner_epsilon)
            acc, j, last = vals[ST_ANY], int(vals[ST_INDEX]), vals[-1]
        else:
            g = oracle.grad(x, t)
            H = oracle.hess(x, t)
            dx = solve_newton_step(
                H, g, x, cfg.kkt_strategy,
                use_psd_condition=cfg.use_psd_condition,
                refine_steps=cfg.refine_steps, diag=oracle.diag_hessian,
                max_cg_iters=cfg.max_cg_iters, mixed=cfg.mixed_precision)
            f0 = oracle.newton_obj(x, t)
            gdx = g @ dx
            ok, nobjs = oracle.ls_objs(x, dx, t, sig)
            accept = ok & (nobjs <= f0 + cfg.alpha * sig * gdx)
            any_acc, jt, sigma = pick_first(accept, sig)
            x_new = x + sigma * dx
            acc, jf, nd, last = sync.read_list(torch.stack([
                any_acc.to(dtype), jt.to(dtype), -gdx / 2.0, x_new[-1]]))
            j = int(jf)
        hist[j] += int(acc > 0.5)
        converged = nd < cfg.inner_epsilon
        if phase1_flag:
            early = last < -phase1_tol
            done = acc <= 0.5 or converged or early
            success = converged or early
        else:
            done = acc <= 0.5 or converged
            success = converged
        x = x_new
        it += 1
    return NewtonResult(x=x, v=None, iters=it, resid=nd, success=success,
                        bt_hist=hist)
