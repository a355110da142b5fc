"""Barrier (outer) loop and phase one (counterpart of
interiorpoint_tpu/ops/ipm.py).

The JAX package compiles the whole solve into one program of
``lax.while_loop``s.  Here the loops run on the host: each stage is one
call of the state->state ``body`` (the same ``make_outer_body`` /
``make_phase1_body`` functions), each Newton step inside it one device
step plus one counted host read (ops/newton.py), and each stage one more
read of its objective and equality residual.  The reference semantics
are the JAX package's:

* best-iterate tracking gated on equality feasibility;
* stop when a converged Newton step fails to improve the objective;
* duality-gap stop num_constraints/t < ε, t advanced only when the loop
  continues (so the exit t serves the dual recovery λ* = 1/(t·s));
* phase one runs iff the initial feasibility slack is ≥ 1, with
  t ← min(t·μ, (n+1)/ε).

Given a ``checkpoint_path``, ``phase1_solve`` and ``barrier_solve`` write
their state to it after every stage (utils/checkpoint.py, an atomic
replace), and ``resume=True`` continues from the stage last written, as
the JAX package's host-stepped dispatch does.  A phase one that ends
without a feasible point then skips the main loop and keeps its own
checkpoint, so that a resume continues phase one.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils import checkpoint
from . import sync
from .newton import newton_feasible, newton_infeasible


class Phase1Result(NamedTuple):
    x: torch.Tensor       # feasible point (slack variable stripped)
    s: float              # final phase-one objective (feasibility slack)
    outer_iters: int
    newton_iters: int


class IPMResult(NamedTuple):
    x: torch.Tensor              # best iterate
    v: Optional[torch.Tensor]    # final equality dual (None: no equalities)
    value: float                 # best objective
    dual_gap: float
    t: float                     # final barrier parameter
    outer_iters: int
    inner_iters: np.ndarray      # (max_outer_iters,) Newton counts, 0-padded
    obj_vals: np.ndarray         # (max_outer_iters,) objective trace, NaN-padded
    phase1: Optional[Phase1Result]
    bt_hist: Optional[np.ndarray] = None   # (J,) accepted-candidate counts


class Phase1State(NamedTuple):
    z: torch.Tensor
    t: float
    it: int
    newton_iters: int
    done: bool


def _augment(x0):
    return torch.cat([x0, torch.zeros(1, dtype=x0.dtype, device=x0.device)])


def phase1_init(p1_oracle, x0, cfg) -> Phase1State:
    """Start at [x0, −min slack(x0) + 1]."""
    s0 = -p1_oracle.min_slack(_augment(x0)) + 1.0
    return Phase1State(z=torch.cat([x0, s0.reshape(1)]),
                       t=float(cfg.phase1_t0), it=0, newton_iters=0,
                       done=False)


def make_phase1_body(p1_oracle, cfg):
    """One phase-one stage as a state->state function."""
    n = p1_oracle.n - 1
    p1cfg = dataclasses.replace(cfg,
                                max_inner_iters=cfg.phase1_max_inner_iters,
                                kkt_strategy="cholesky")

    def body(s: Phase1State) -> Phase1State:
        res = newton_feasible(p1_oracle, s.z, s.t, p1cfg, phase1_flag=True,
                              phase1_tol=cfg.phase1_tol)
        done = sync.read(res.x[-1]) < -cfg.phase1_tol
        t_new = min(s.t * cfg.mu, (n + 1.0) / cfg.epsilon)
        return Phase1State(z=res.x, t=t_new, it=s.it + 1,
                           newton_iters=s.newton_iters + res.iters,
                           done=done)

    return body


def phase1_solve(p1_oracle, x0, cfg, *, state=None,
                 checkpoint_path=None) -> Phase1Result:
    """Barrier loop over the augmented phase-one problem
    min s s.t. slackᵢ(x) + s ≥ 0; ``x0`` excludes the slack variable.
    ``state``: the Phase1State to continue from (default: the start at
    x0); ``checkpoint_path``: where to save the state after each stage."""
    body = make_phase1_body(p1_oracle, cfg)
    st = state if state is not None else phase1_init(p1_oracle, x0, cfg)
    while not st.done and st.it < cfg.max_outer_iters:
        st = body(st)
        if checkpoint_path is not None:
            checkpoint.save_p1_state(checkpoint_path, st)
    return Phase1Result(x=st.z[:-1], s=sync.read(st.z[-1]),
                        outer_iters=st.it, newton_iters=st.newton_iters)


class OuterState(NamedTuple):
    x: torch.Tensor
    v: torch.Tensor         # empty when no equalities
    t: float
    it: int
    best_x: torch.Tensor
    best_obj: float
    last_obj: float
    dual_gap: float
    inner_iters: np.ndarray
    obj_vals: np.ndarray
    bt_hist: np.ndarray
    done: bool


def outer_init(x_start, v0, t0, A, cfg, num_constraints=0) -> OuterState:
    m_eq = A.shape[0] if A is not None else 0
    if v0 is None:
        v0 = torch.zeros(m_eq, dtype=x_start.dtype, device=x_start.device)
    return OuterState(
        x=x_start, v=v0, t=float(t0), it=0, best_x=x_start,
        best_obj=float("inf"), last_obj=float("nan"),
        dual_gap=float(num_constraints),
        inner_iters=np.zeros(cfg.max_outer_iters, dtype=np.int64),
        obj_vals=np.full(cfg.max_outer_iters, np.nan),
        bt_hist=np.zeros(cfg.max_linesearch_steps, dtype=np.int64),
        done=False)


def make_outer_body(oracle, A, b, cfg, *, num_constraints: int,
                    eq_gate: float):
    """One outer (centering) stage as a state->state function."""
    has_eq = A is not None

    def body(s: OuterState) -> OuterState:
        if has_eq:
            res = newton_infeasible(oracle, A, b, s.x, s.v, s.t, cfg)
            v_new = res.v
            eq_norm = torch.linalg.norm(A @ res.x - b)
        else:
            res = newton_feasible(oracle, s.x, s.t, cfg)
            v_new = s.v
            eq_norm = torch.zeros((), dtype=res.x.dtype,
                                  device=res.x.device)
        obj_val, eq_n = sync.read_list(torch.stack([oracle.obj(res.x),
                                                    eq_norm]))
        eq_ok = (eq_n < eq_gate) if has_eq else True
        improved = obj_val < s.best_obj
        take = eq_ok and improved
        # a converged Newton step that failed to improve: stop
        break_improve = eq_ok and not improved and res.success
        traced_obj = obj_val if eq_ok else s.last_obj
        obj_vals = s.obj_vals.copy()
        obj_vals[s.it] = traced_obj
        inner_iters = s.inner_iters.copy()
        inner_iters[s.it] = res.iters
        gap_new = num_constraints / s.t
        done = break_improve or gap_new < cfg.epsilon
        return OuterState(
            x=res.x, v=v_new, t=s.t if done else s.t * cfg.mu, it=s.it + 1,
            best_x=res.x if take else s.best_x,
            best_obj=obj_val if take else s.best_obj,
            last_obj=traced_obj,
            dual_gap=s.dual_gap if break_improve else gap_new,
            inner_iters=inner_iters, obj_vals=obj_vals,
            bt_hist=s.bt_hist + res.bt_hist, done=done)

    return body


def barrier_solve(oracle, A, b, x0, cfg, *, num_constraints: int,
                  eq_gate: float, t0, v0=None, p1_oracle=None,
                  checkpoint_path=None, resume: bool = False) -> IPMResult:
    """Barrier outer loop shared by the LP/QP/SOCP drivers.
    ``p1_oracle``: phase one runs iff the initial feasibility slack is
    ≥ 1.  ``checkpoint_path``/``resume``: see the module docstring."""
    ck = (checkpoint.load_outer_state(checkpoint_path)
          if checkpoint_path is not None and resume else None)
    resume_outer = ck is not None and any(k.startswith("state_")
                                          for k in ck)
    p1_failed = False
    if resume_outer:
        st = checkpoint.restore_outer_state(
            outer_init(x0, v0, t0, A, cfg, num_constraints), ck)
        p1 = checkpoint.restore_phase1(ck, x0)
    else:
        if p1_oracle is not None:
            p1_state = None
            if ck is not None:
                p1_state = checkpoint.restore_p1_state(
                    phase1_init(p1_oracle, x0, cfg), ck)
            if p1_state is not None or sync.read(
                    -p1_oracle.min_slack(_augment(x0)) + 1.0) >= 1.0:
                p1 = phase1_solve(p1_oracle, x0, cfg, state=p1_state,
                                  checkpoint_path=checkpoint_path)
                # no feasible point: keep the phase-one checkpoint, so
                # that a resume continues phase one (the driver raises)
                p1_failed = (checkpoint_path is not None
                             and not p1.s < -cfg.phase1_tol)
            else:
                p1 = Phase1Result(x=x0, s=float("-inf"), outer_iters=0,
                                  newton_iters=0)
            x_start = p1.x
        else:
            p1 = None
            x_start = x0
        st = outer_init(x_start, v0, t0, A, cfg, num_constraints)

    body = make_outer_body(oracle, A, b, cfg,
                           num_constraints=num_constraints, eq_gate=eq_gate)
    while not p1_failed and not st.done and st.it < cfg.max_outer_iters:
        st = body(st)
        if checkpoint_path is not None:
            checkpoint.save_outer_state(checkpoint_path, st, p1)
    return IPMResult(
        x=st.best_x, v=st.v if A is not None else None, value=st.best_obj,
        dual_gap=st.dual_gap, t=st.t, outer_iters=st.it,
        inner_iters=st.inner_iters, obj_vals=st.obj_vals, phase1=p1,
        bt_hist=st.bt_hist)
