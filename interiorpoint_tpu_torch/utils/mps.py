"""MPS reader and LP-relaxation converter (a copy of
interiorpoint_tpu/utils/mps.py, which is pure numpy).

Fills the reference's missing MPS pipeline: ``testLPSolver.ipynb`` runs
MPS benchmarks through a ``performanceTest.py`` module that is absent
from the reference repo (SURVEY.md §2.3 #17), and the MIPLIB ``.npy``
blobs it produced are listed in ``.MISSING_LARGE_BLOBS``.  This module
parses (fixed- or free-format) MPS, relaxes integrality, and emits the
(c, A, b, C, d, ub, lb) layout of utils/miplib.py — so the upstream
instances are regenerable from their public MPS sources with
``scripts/fetch_miplib.py``.

Scope: NAME/ROWS/COLUMNS/RHS/RANGES/BOUNDS/OBJSENSE sections, integer
markers (relaxed), the standard bound keys (UP LO FX FR MI PL BV UI LI),
and L/G/E rows with RANGES semantics.  Dense output (the solver's dense
path is what consumes it — reference: testSolver.py:278-435).
"""

from __future__ import annotations

import gzip

import numpy as np


def parse_mps(path):
    """Parse an MPS file (optionally .gz) into a plain dict:
    {name, sense, obj_row, rows: {name: type}, row_order, cols,
     col_order, rhs, ranges, bounds}."""
    opener = gzip.open if str(path).endswith(".gz") else open
    rows = {}
    row_order = []
    obj_row = None
    cols = {}          # col -> {row: coef}
    col_order = []
    rhs = {}
    ranges = {}
    bounds = {}        # col -> list of (key, value-or-None)
    name = ""
    sense = "MIN"
    section = None
    with opener(path, "rt") as f:
        for raw in f:
            line = raw.rstrip("\n")
            if not line.strip() or line.lstrip().startswith("*"):
                continue
            if not line[0].isspace():
                parts = line.split()
                section = parts[0].upper()
                if section == "NAME" and len(parts) > 1:
                    name = parts[1]
                # one-line form "OBJSENSE MAX" (sense on the header line;
                # emitted by several writers, accepted by HiGHS/Gurobi)
                if section == "OBJSENSE" and len(parts) > 1:
                    sense = parts[1].upper()[:3]
                if section == "ENDATA":
                    break
                continue
            parts = line.split()
            if section == "OBJSENSE":
                sense = parts[0].upper()[:3]
            elif section == "ROWS":
                rtype = parts[0].upper()
                rname = parts[1]
                if rtype == "N":
                    if obj_row is None:
                        obj_row = rname
                    # extra free rows are ignored (standard MPS)
                else:
                    rows[rname] = rtype
                    row_order.append(rname)
            elif section == "COLUMNS":
                if len(parts) >= 3 and parts[1].upper() == "'MARKER'":
                    continue   # INTORG/INTEND: integrality relaxed
                cname = parts[0]
                if cname not in cols:
                    cols[cname] = {}
                    col_order.append(cname)
                for i in range(1, len(parts) - 1, 2):
                    cols[cname][parts[i]] = float(parts[i + 1])
            elif section in ("RHS", "RANGES"):
                # the leading set name is optional (free-format MPS):
                # "SET ROW VAL [ROW VAL]" has an odd token count, the
                # nameless "ROW VAL [ROW VAL]" an even one
                start = 1 if len(parts) % 2 == 1 else 0
                target = rhs if section == "RHS" else ranges
                for i in range(start, len(parts) - 1, 2):
                    target[parts[i]] = float(parts[i + 1])
            elif section == "BOUNDS":
                key = parts[0].upper()
                if key in ("UP", "LO", "FX", "UI", "LI"):
                    # value-carrying keys: "KEY BNDSET COL VAL", or the
                    # free-format 3-token "KEY COL VAL" (no set name)
                    try:
                        if len(parts) >= 4:
                            cname, val = parts[2], float(parts[3])
                        elif len(parts) == 3:
                            cname, val = parts[1], float(parts[2])
                        else:
                            raise IndexError
                    except (ValueError, IndexError):
                        raise ValueError(
                            f"BOUNDS {key} line missing its value: "
                            f"{line!r}") from None
                else:   # FR/MI/PL/BV take no value
                    cname = parts[2] if len(parts) > 2 else parts[1]
                    val = None
                bounds.setdefault(cname, []).append((key, val))
    return dict(name=name, sense=sense, obj_row=obj_row, rows=rows,
                row_order=row_order, cols=cols, col_order=col_order,
                rhs=rhs, ranges=ranges, bounds=bounds)


def lp_relaxation(parsed, big=1e9):
    """Dense LP relaxation in the reference layout
    (c, A, b, C, d, ub, lb) — min c.x s.t. Ax=b, Cx<=d, lb<=x<=ub.

    G rows enter C negated; RANGES add the opposite-side row per the
    standard semantics (L row r: d-|r| <= a.x <= d; G row: d <= a.x <=
    d+|r|; E row: two-sided by sign of r).  Default variable bounds are
    [0, +inf); infinities are clamped to ``big`` so the barrier solver
    (which requires finite boxes in its .npy benchmark path) gets the
    reference-format arrays unchanged.  Maximization negates c.
    """
    n = len(parsed["col_order"])
    col_idx = {cname: j for j, cname in enumerate(parsed["col_order"])}

    c = np.zeros(n)
    obj_row = parsed["obj_row"]
    for cname, entries in parsed["cols"].items():
        if obj_row in entries:
            c[col_idx[cname]] = entries[obj_row]
    if parsed["sense"] == "MAX":
        c = -c

    eq_rows, le_rows = [], []   # (coef-dict, rhs)
    for rname in parsed["row_order"]:
        rtype = parsed["rows"][rname]
        rv = parsed["rhs"].get(rname, 0.0)
        coefs = {cname: entries[rname]
                 for cname, entries in parsed["cols"].items()
                 if rname in entries}
        rng = parsed["ranges"].get(rname)
        if rtype == "E":
            if rng is None:
                eq_rows.append((coefs, rv))
            else:
                lo, hi = (rv, rv + abs(rng)) if rng > 0 else \
                    (rv - abs(rng), rv)
                le_rows.append((coefs, hi))
                le_rows.append(({k: -v for k, v in coefs.items()}, -lo))
        elif rtype == "L":
            le_rows.append((coefs, rv))
            if rng is not None:
                le_rows.append(({k: -v for k, v in coefs.items()},
                                -(rv - abs(rng))))
        elif rtype == "G":
            le_rows.append(({k: -v for k, v in coefs.items()}, -rv))
            if rng is not None:
                le_rows.append((coefs, rv + abs(rng)))

    def densify(row_list):
        M = np.zeros((len(row_list), n))
        r = np.zeros(len(row_list))
        for i, (coefs, rv) in enumerate(row_list):
            for cname, v in coefs.items():
                M[i, col_idx[cname]] = v
            r[i] = rv
        return M, r

    A, b = densify(eq_rows)
    C, d = densify(le_rows)

    lb = np.zeros(n)
    ub = np.full(n, big)
    for cname, entries in parsed["bounds"].items():
        j = col_idx.get(cname)
        if j is None:
            continue
        for key, val in entries:
            if key in ("UP", "UI"):
                ub[j] = val
                # negative upper bound with default lower 0: standard MPS
                # quirk sets the lower bound to -inf
                if val is not None and val < 0 and lb[j] == 0.0:
                    lb[j] = -big
            elif key in ("LO", "LI"):
                lb[j] = val
            elif key == "FX":
                lb[j] = ub[j] = val
            elif key == "FR":
                lb[j], ub[j] = -big, big
            elif key == "MI":
                lb[j] = -big
            elif key == "PL":
                ub[j] = big
            elif key == "BV":
                lb[j], ub[j] = 0.0, 1.0
    lb = np.minimum(lb, ub)
    return c, A, b, C, d, ub, lb


def mps_to_npy(mps_path, npy_path, big=1e9):
    """Convert an MPS file to the reference's stacked .npy layout
    (utils/miplib.py) and return the arrays."""
    from .miplib import save_lp_npy

    arrays = lp_relaxation(parse_mps(mps_path), big=big)
    save_lp_npy(npy_path, *arrays)
    return arrays
