"""MIPLIB LP-relaxation instance loader (counterpart of
interiorpoint_tpu/utils/miplib.py; ``solve_lp_npy`` solves through the
port's ``LPSolver``).

Format matches the reference's ``test_LP_sparse`` reader exactly
(reference: testSolver.py:292-301): one ``.npy`` stream containing, in
order, c, A, b, C, d, upper_bound, lower_bound via sequential ``np.load``
calls.  The reference repo lists ``30n20b8.npy`` and ``aflow40b.npy`` in
this format (blobs absent upstream — .MISSING_LARGE_BLOBS)."""

from __future__ import annotations

import numpy as np


def load_lp_npy(path):
    """Load (c, A, b, C, d, upper_bound, lower_bound) from a stacked .npy
    stream (reference: testSolver.py:292-301)."""
    with open(path, "rb") as f:
        c = np.load(f)
        A = np.load(f)
        b = np.load(f)
        C = np.load(f)
        d = np.load(f)
        up_bnd = np.load(f)
        lo_bnd = np.load(f)
    return c, A, b, C, d, up_bnd, lo_bnd


def save_lp_npy(path, c, A, b, C, d, up_bnd, lo_bnd):
    """Writer for the same format (used to regenerate the missing upstream
    blobs from MPS sources or for regression fixtures)."""
    with open(path, "wb") as f:
        for arr in (c, A, b, C, d, up_bnd, lo_bnd):
            np.save(f, np.asarray(arr))


def solve_lp_npy(path, device=None, **solver_kwargs):
    """Load and solve an instance in one call on ``device`` (default the
    GPU, as every entry point of the port); returns the LPSolver."""
    from ..models.lp import LPSolver

    c, A, b, C, d, ub, lb = load_lp_npy(path)
    solver = LPSolver(c=c, A=A, b=b, C=C, d=d, lower_bound=lb,
                      upper_bound=ub, device=device, **solver_kwargs)
    solver.solve()
    return solver
