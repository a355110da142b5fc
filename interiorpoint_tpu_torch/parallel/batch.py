"""Batched solves over the port's engines (counterpart of
interiorpoint_tpu/parallel/batch.py).

``solve_batch`` solves a batch of same-shaped LP/QP/SOCP instances with
the single-instance engines of the port, so each instance reaches the
kernel its engine's gates select: the barrier Newton step K2 (LP/QP
inequality form, and K2 on [C | −1] in its phase one), the SOCP Newton
step K4 (pure-cone SOCP), the Mehrotra step K1 (``"pd"`` without
equalities) and the dense-KKT direction K5 (``"pd"`` with equalities,
and the conic ``"pd"``); the oracle path where no kernel applies.

The instances run one after another, also the shards of a mesh of
several cards: the kernels' launch and host-sync counters are
process-global and unlocked, so threads would race on them.  Each
instance's result is therefore bitwise that of its single-instance
call; the JAX package gets the same from ``vmap``, whose
``lax.while_loop`` freezes a finished instance's carry.  The later form
is one launch over the whole batch, a batch grid axis in K1, K2, K4 and
K5 (what Pallas gives a vmapped ``pallas_call``), and with it one worker
per card.

``solve_lasso_sharded`` takes the JAX package's arguments and solves the
whole sample batch with ``admm_core`` on the mesh's first device: its
ladder of Q⁻¹ is K3a and K3b on a card, and its stopping and ρ-descent
decisions are global, as the all-reduces the JAX partitioner puts there
make them.  Splitting the samples over several cards waits for a
multi-card run that shows it pays; it would be an option of
``admm_core_prepared`` (a list of shards), not a second loop.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.problem import QPProblem, SOCPProblem
from ..models.reduced import full_space_pd_problem
from ..ops.admm import admm_core
from ..ops.barrier import make_phase1_linear_oracle, make_qp_oracle
from ..ops.ipm import barrier_solve
from ..ops.pd import pd_solve
from ..ops.socp import make_phase1_socp_oracle, make_socp_oracle
from ..ops.socp_pd import cone_operator, socp_pd_solve
from .mesh import batch_sharding


def _single_linear(prob, x0, cfg, num_constraints, eq_gate, use_phase1):
    # LP or QP (make_qp_oracle takes the diagonal path for LPs only)
    oracle = make_qp_oracle(prob, try_diag=cfg.try_diag)
    p1 = make_phase1_linear_oracle(prob) if use_phase1 else None
    return barrier_solve(oracle, prob.A, prob.b, x0, cfg,
                         num_constraints=num_constraints, eq_gate=eq_gate,
                         t0=cfg.t0, p1_oracle=p1)


def _single_socp(prob, x0, cfg, num_constraints, eq_gate, use_phase1):
    # the equality pair rides in the (A, b) slots, as the single-instance
    # driver passes (F, g)
    oracle = make_socp_oracle(prob)
    p1 = make_phase1_socp_oracle(prob) if use_phase1 else None
    return barrier_solve(oracle, prob.F, prob.g, x0, cfg,
                         num_constraints=num_constraints, eq_gate=eq_gate,
                         t0=cfg.t0, p1_oracle=p1)


def _single_pd(prob, x0, cfg):
    """One primal-dual Mehrotra solve in full space: LP/QP by ops/pd.py
    (bounds stacked into the inequality block, equalities handed over),
    SOCP by the conic engine of ops/socp_pd.py.  No phase one."""
    if isinstance(prob, SOCPProblem):
        G, h, q = cone_operator(prob)
        return socp_pd_solve(G, h, q, x0, cfg, P=prob.P, F=prob.F,
                             g=prob.g, lb=prob.lb, ub=prob.ub)
    return pd_solve(full_space_pd_problem(prob, x0.dtype), x0, cfg,
                    A=prob.A, b=prob.b)


def _instance(prob_batch, i, device):
    """Instance ``i`` of a stacked problem, on ``device``."""
    return type(prob_batch)(**{
        f.name: (None if getattr(prob_batch, f.name) is None
                 else getattr(prob_batch, f.name)[i].to(device))
        for f in dataclasses.fields(prob_batch)})


def _stack_results(results, device):
    """One result of the engines' type from per-instance results: tensors
    stacked on ``device``, host scalars and arrays as numpy arrays with a
    leading batch dimension, nested results stacked alike."""
    first = results[0]
    out = {}
    for name in first._fields:
        vals = [getattr(r, name) for r in results]
        v0 = vals[0]
        if v0 is None:
            out[name] = None
        elif isinstance(v0, torch.Tensor):
            out[name] = torch.stack([v.to(device) for v in vals])
        elif isinstance(v0, tuple):
            out[name] = _stack_results(vals, device)
        else:
            out[name] = np.stack([np.asarray(v) for v in vals])
    return type(first)(**out)


def solve_batch(prob_batch, x0_batch, cfg, mesh=None, axis="batch",
                algorithm="barrier"):
    """Solve a batch of same-shaped LP/QP/SOCP instances.

    Args:
      prob_batch: LPProblem/QPProblem/SOCPProblem whose tensors carry a
        leading batch dimension (``stack_problems``; SOCP cone tensors
        (B, K, M, n)).
      x0_batch: (B, n) starting points (strictly interior for the
        barrier, or phase one runs; ``"pd"`` takes any start).
      mesh: optional ``Mesh``; the batch is split over ``axis`` in
        contiguous shards (``batch_sharding``), each instance solved on
        its shard's device, the results gathered on the first device.
      algorithm: "barrier" (default) or "pd" (ops/pd.py for LP/QP,
        whose bounds must then be finite; ops/socp_pd.py for SOCP).

    Returns the engines' result with a leading batch dimension on every
    field: IPMResult ("barrier", its phase-one record per instance),
    PDResult or SOCPPDResult ("pd").  The JAX package's ``allow_stream``
    (its streaming kernel kept out of batches) has no counterpart: the
    port has no stream gate on Hopper.
    """
    if isinstance(prob_batch, SOCPProblem):
        kind = "socp"
    elif isinstance(prob_batch, QPProblem):
        kind = "qp"
    else:
        kind = "lp"
    if algorithm not in ("barrier", "pd"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    if algorithm == "pd" and kind in ("lp", "qp"):
        # as in the JAX package, whose vmapped pd path cannot drop ±inf
        # bound rows per instance: reject them up front
        for bname in ("lb", "ub"):
            bv = getattr(prob_batch, bname, None)
            if bv is not None and not bool(torch.isfinite(bv).all()):
                raise ValueError(
                    "solve_batch(algorithm='pd') requires finite bounds "
                    f"(±inf entries in {bname}); omit the bound instead")
    use_phase1 = True if kind == "socp" else prob_batch.C is not None
    n = x0_batch.shape[-1]
    num_constraints = int(prob_batch.num_ineq_constraints)
    eq_gate = float(cfg.eq_gate if cfg.eq_gate is not None
                    else (1e-4 * n if kind == "lp" else 1e-3))
    B = x0_batch.shape[0]
    if mesh is None:
        shards = [(x0_batch.device, 0, B)]
    else:
        shards = batch_sharding(mesh, axis, x0_batch.ndim).shards(B)
    single = _single_socp if kind == "socp" else _single_linear
    results = []
    for device, lo, hi in shards:
        for i in range(lo, hi):
            prob = _instance(prob_batch, i, device)
            x0 = x0_batch[i].to(device)
            if algorithm == "pd":
                results.append(_single_pd(prob, x0, cfg))
            else:
                results.append(single(prob, x0, cfg, num_constraints,
                                      eq_gate, use_phase1))
    return _stack_results(results, shards[0][0])


def stack_problems(problems):
    """Stack same-structure problems into one batched problem; a field
    that is None in every problem stays None."""
    problems = list(problems)
    kind = type(problems[0])
    if any(type(p) is not kind for p in problems):
        raise ValueError("stack_problems: problems of different types")
    out = {}
    for f in dataclasses.fields(kind):
        vals = [getattr(p, f.name) for p in problems]
        if all(v is None for v in vals):
            out[f.name] = None
        elif any(v is None for v in vals):
            raise ValueError(f"stack_problems: field {f.name!r} is None in "
                             "some problems only")
        else:
            out[f.name] = torch.stack(vals)
    return kind(**out)


def solve_lasso_sharded(A, b, reg, cfg, mesh, axis="batch"):
    """Batched LASSO over the samples of ``mesh``: A, b and the
    per-sample λ are gathered onto the first device of ``axis`` and
    solved there by ``admm_core`` (see the module docstring), so the
    iterations and X are those of ``solve_lasso``.  Returns an
    ADMMResult on that device."""
    dt = cfg.torch_dtype
    dev = batch_sharding(mesh, axis).shards(1)[0][0]

    def tensor(v):
        if isinstance(v, torch.Tensor):
            return v.to(dtype=dt, device=dev)
        return torch.as_tensor(np.asarray(v), dtype=dt, device=dev)

    A, b, reg = tensor(A), tensor(b), torch.atleast_1d(tensor(reg))
    if b.ndim < 2:
        b = b[:, None]
    return admm_core(A, b, reg, cfg, max(b.shape[1], reg.shape[0]))
