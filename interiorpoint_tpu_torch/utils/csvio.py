"""Benchmark CSV reader/writer, schema-compatible with the reference
(a copy of interiorpoint_tpu/utils/csvio.py, which is pure numpy).

Schema (reference: testSolver.py:248-271, parsed by parseAndPlot.py:7-141):
a header line ``num_tests,N`` followed by one value per (dimension,
repetition) cell, written row-major.  Zeros denote skipped runs and are
treated as NaN when parsing (reference: parseAndPlot.py:86-93).
"""

from __future__ import annotations

import numpy as np


def write_results(path, arr):
    """Write a (num_tests, N) matrix with the reference header line."""
    arr = np.asarray(arr)
    num_tests, N = arr.shape
    with open(path, "w") as f:
        f.write(f"{num_tests},{N}\n")
        for row in arr:
            f.write(",".join(repr(float(v)) for v in row) + "\n")


def read_results(path, mask_zeros=True):
    """Read a reference-format results CSV → (num_tests, N) array with
    skipped (zero) runs as NaN."""
    with open(path) as f:
        header = f.readline().strip().split(",")
        num_tests, N = int(header[0]), int(float(header[1]))
        rows = [
            [float(v) for v in line.strip().split(",") if v != ""]
            for line in f if line.strip()
        ]
    flat = np.asarray([v for row in rows for v in row], dtype=np.float64)
    arr = flat.reshape(num_tests, -1)[:, :N]
    if mask_zeros:
        arr = np.where(arr == 0.0, np.nan, arr)
    return arr


def mean_over_reps(arr):
    """Per-dimension means, ignoring skipped runs
    (reference: parseAndPlot.py:86-93 semantics)."""
    return np.nanmean(arr, axis=1)
