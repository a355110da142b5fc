"""Solve-state checkpoints: terminal warm starts and mid-solve resume
(counterpart of interiorpoint_tpu/utils/checkpoint.py).

* **Terminal warm start** (``save_state``/``load_state``/``warm_solve``):
  snapshot a finished solve and start a later one from it.
* **Mid-solve resume**: the barrier loops of ops/ipm.py are host-stepped,
  so ``solve(checkpoint_path=p)`` has ``phase1_solve`` and
  ``barrier_solve`` write their whole state (``Phase1State`` or
  ``OuterState``) to ``p`` after every stage, with an atomic replace, and
  ``solve(checkpoint_path=p, resume=True)`` continues from the last
  completed stage, restoring the tensors onto the solver's device and
  type.  Nothing else lives across a stage boundary (K2's preconditioner
  carry is made anew in every ``newton_feasible`` call), so on one device
  a resumed solve repeats the uninterrupted one exactly.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _np(v):
    """numpy copy of a tensor (on any device), an array or a scalar."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_state(path, solver):
    """Snapshot a solved driver's terminal state to ``path`` (.npz)."""
    if not solver.optimal:
        raise ValueError("solve() before saving state")
    res = solver._result
    np.savez(path, x=_np(res.x),
             v=(_np(res.v) if res.v is not None else np.zeros(0)),
             t=_np(res.t), value=_np(res.value),
             dual_gap=_np(res.dual_gap))


def load_state(path):
    """Load a snapshot: a dict usable as solve() warm-start kwargs,
    ``solver.solve(x0=state['x'], t0=state['t'])``."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def warm_solve(solver, state):
    """Solve again from a snapshot's iterate and barrier parameter (phase
    one runs if the iterate is not strictly feasible for the problem)."""
    return solver.solve(x0=state["x"], t0=float(state["t"]))


# ---------------------------------------------------------------------------
# Mid-solve resume: the barrier loops' states <-> .npz (atomic replace).
# ---------------------------------------------------------------------------


def _atomic_savez(path, data):
    tmp = str(path) + ".tmp.npz"
    np.savez(tmp, **data)
    os.replace(tmp, path)


def save_outer_state(path, state, phase1=None):
    """Persist an OuterState (ops/ipm.py) after a completed stage, and the
    Phase1Result that preceded it; write-then-replace, so a kill during
    the write leaves the last good checkpoint."""
    data = {f"state_{k}": _np(v) for k, v in state._asdict().items()}
    if phase1 is not None:
        data.update(p1_x=_np(phase1.x), p1_s=_np(phase1.s),
                    p1_outer=_np(phase1.outer_iters),
                    p1_newton=_np(phase1.newton_iters))
    _atomic_savez(path, data)


def save_p1_state(path, st):
    """Persist a Phase1State (ops/ipm.py) after a completed phase-one
    stage, so that a kill during phase one is resumable too."""
    _atomic_savez(path, {f"p1state_{k}": _np(v)
                         for k, v in st._asdict().items()})


def load_outer_state(path):
    """The raw arrays of a mid-solve checkpoint, or None when the file
    does not exist (the solve then starts afresh)."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


_TRACES = ("inner_iters", "obj_vals", "bt_hist")


def _restore_namedtuple(template, data, prefix):
    """Rebuild a state NamedTuple from checkpoint arrays in the types of
    ``template`` (made by the same init function for the resuming
    solve): tensors onto the template's device and dtype, Python scalars
    as such.  A trace (``_TRACES``) shorter than the template's, because
    the checkpointed run had a smaller cap, fills the head of the
    template's array; a longer one raises rather than drop history."""
    kwargs = {}
    for k, tv in template._asdict().items():
        arr = data[f"{prefix}{k}"]
        if isinstance(tv, torch.Tensor):
            if tuple(arr.shape) != tuple(tv.shape):
                raise ValueError(
                    f"checkpoint field {k!r} has shape {arr.shape} but the "
                    f"resuming problem expects {tuple(tv.shape)}")
            val = torch.as_tensor(arr, dtype=tv.dtype, device=tv.device)
        elif isinstance(tv, np.ndarray):
            val = arr.astype(tv.dtype)
            if val.shape != tv.shape:
                if (k in _TRACES and val.ndim == 1 and tv.ndim == 1
                        and val.shape[0] < tv.shape[0]):
                    head = tv.copy()
                    head[:val.shape[0]] = val
                    val = head
                else:
                    raise ValueError(
                        f"checkpoint field {k!r} has shape {val.shape} but "
                        f"the resuming config expects {tv.shape}; resume "
                        "with caps (max_outer_iters / "
                        "max_linesearch_steps) at least as large as the "
                        "checkpointed run's")
        else:
            val = type(tv)(arr.item())
        kwargs[k] = val
    return template.__class__(**kwargs)


def restore_outer_state(template, data):
    """An OuterState from ``load_outer_state``'s arrays (template from
    ops/ipm.py ``outer_init``)."""
    return _restore_namedtuple(template, data, "state_")


def restore_p1_state(template, data):
    """A Phase1State from checkpoint arrays (template from ops/ipm.py
    ``phase1_init``)."""
    return _restore_namedtuple(template, data, "p1state_")


def restore_phase1(data, like):
    """The Phase1Result recorded in a checkpoint (its x on the device and
    in the type of the tensor ``like``), or None."""
    if "p1_x" not in data:
        return None
    from ..ops.ipm import Phase1Result

    return Phase1Result(
        x=torch.as_tensor(data["p1_x"], dtype=like.dtype,
                          device=like.device),
        s=float(data["p1_s"]), outer_iters=int(data["p1_outer"]),
        newton_iters=int(data["p1_newton"]))
