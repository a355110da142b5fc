"""Structured solve metrics (JSON lines).

The reference has no structured observability — `print` gated by
``suppress_print`` plus ad-hoc lists (reference: LPSolver.py:593-627,
LassoSolver.py:115-117; SURVEY.md §5 "no logging library, no structured
metrics").  This module is the TPU-framework upgrade: every driver
solve can emit ONE machine-readable JSON record (problem shape, solver
configuration fingerprint, iteration counters, backtracking histogram,
objective/gap, wall time) to an append-only .jsonl sink, suitable for
fleet-level dashboards over many production solves.

Activation is process-global so the reference-parity constructor
signatures stay untouched:

    from interiorpoint_tpu_torch.utils import metrics
    metrics.enable("/var/log/ip_solves.jsonl")   # or IPTPU_METRICS env
    ...
    metrics.disable()

When disabled (the default), the drivers still populate
``solver.last_metrics`` with the same record for ad-hoc inspection at
zero I/O cost.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

_active_path: Optional[str] = os.environ.get("IPTPU_METRICS") or None


def enable(path: str) -> None:
    """Route every subsequent solve record to ``path`` (JSON lines,
    append; parent directory must exist)."""
    global _active_path
    _active_path = str(path)


def disable() -> None:
    global _active_path
    _active_path = None


def enabled() -> bool:
    return _active_path is not None


def emit(record: Dict[str, Any]) -> None:
    """Append one record to the active sink; no-op when disabled."""
    if _active_path is None:
        return
    line = json.dumps(record, sort_keys=True)
    with open(_active_path, "a") as f:
        f.write(line + "\n")


def _jsonable(v):
    import numpy as np

    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


def solve_record(kind: str, *, n: int, num_constraints: int,
                 num_eq: int, value: float, dual_gap: Optional[float],
                 outer_iters: int, newton_iters: int,
                 backtrack_hist=None, wall_s: Optional[float] = None,
                 phase1_ran: bool = False,
                 extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Assemble the canonical per-solve record (see module docstring)."""
    rec: Dict[str, Any] = {
        "ts": time.time(),
        "kind": kind,
        "n": int(n),
        "num_constraints": int(num_constraints),
        "num_eq": int(num_eq),
        "value": float(value),
        "outer_iters": int(outer_iters),
        "newton_iters": int(newton_iters),
        "phase1_ran": bool(phase1_ran),
    }
    if dual_gap is not None:
        rec["dual_gap"] = float(dual_gap)
    if wall_s is not None:
        rec["wall_s"] = float(wall_s)
    if backtrack_hist is not None:
        rec["backtrack_hist"] = [int(v) for v in backtrack_hist]
    if extra:
        rec.update({k: _jsonable(v) for k, v in extra.items()})
    return rec
