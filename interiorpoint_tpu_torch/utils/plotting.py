"""Benchmark-result analysis and plotting (a copy of
interiorpoint_tpu/utils/plotting.py, which is numpy and matplotlib).

Port target: reference parseAndPlot.py — CSV parsing (:7-141), average
relative error vs oracle truth with non-convergence masking (:411-482), and
timing plots (:177-409).  Matplotlib imports are deferred so headless
environments can use the numeric parts freely.
"""

from __future__ import annotations

import numpy as np

from .csvio import mean_over_reps, read_results


def calculate_average_relative_error(truth, test_results, lasso=False,
                                     verbose=False):
    """Average relative error vs oracle truth, masking non-converged
    (inf) and skipped (zero) runs (reference: parseAndPlot.py:411-482)."""
    truth = np.asarray(truth)
    test_results = np.asarray(test_results)
    if not lasso:
        num_tests, N = truth.shape
        dim_wise = []
        for test in range(num_tests):
            t_row, r_row = truth[test], test_results[test]
            mask = (r_row != np.inf) & (r_row != 0) & ~np.isnan(r_row)
            if verbose:
                print(f"Test {test + 1} had {(~mask).sum()} of {N} "
                      "iterations not converge")
            if mask.sum() == 0:
                dim_wise.append(np.inf)
                continue
            rel = np.abs(t_row[mask] - r_row[mask]) / t_row[mask]
            dim_wise.append(rel.sum() / mask.sum())
        return sum(dim_wise) / num_tests

    num_tests, N, num_problems = truth.shape
    dim_wise = []
    for test in range(num_tests):
        for n in range(N):
            t_row = truth[test, n]
            r_row = test_results[test, n]
            mask = (r_row != np.inf) & ~np.isnan(r_row)
            if verbose:
                print(f"Test {test + 1}, iteration {n + 1} had "
                      f"{num_problems - mask.sum()} of {num_problems} "
                      "problems not converge")
            if mask.sum() == 0:
                dim_wise.append(np.inf)
                continue
            rel = np.abs(t_row[mask] - r_row[mask]) / t_row[mask]
            dim_wise.append(rel.sum() / mask.sum())
    return sum(dim_wise) / len(dim_wise)


def _stats_over_reps(res):
    """(mean, std) per dimension row, NaN-masking skipped runs."""
    res = np.asarray(res, dtype=np.float64)
    mean = np.nanmean(res, axis=1)
    std = np.nanstd(res, axis=1)
    return mean, std


def plot_family(results, dims, labels, origin, outdir,
                formats=("LinearLinePlot", "LogarithmicLinePlot",
                         "errorbarLinear", "errorbarLogarithmic",
                         "LinearBarPlot", "LogarithmicBarPlot")):
    """The reference's six timing-plot styles per problem class
    (reference: parseAndPlot.py:177-409): linear/log line plots, linear/
    log errorbar plots (std over reps), linear/log grouped bar plots.
    Writes ``<origin>average<style>.png`` files into ``outdir`` using the
    reference's naming scheme and returns the written paths.

    ``results``: list of (num_dims, reps) arrays or CSV paths (reference
    format); ``labels``: one per series; ``dims``: dimension per row.
    """
    import os

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(outdir, exist_ok=True)
    stats = []
    for res in results:
        if isinstance(res, str):
            res = read_results(res)
        stats.append(_stats_over_reps(res))
    nd = min(len(m) for m, _ in stats)
    dims = list(dims)[:nd]
    x = np.arange(nd)
    written = []

    def _save(fname):
        path = os.path.join(outdir, fname)
        plt.xlabel("Dimension n")
        plt.ylabel("Average solving time [s]")
        plt.legend()
        plt.savefig(path, dpi=120, bbox_inches="tight")
        plt.clf()
        written.append(path)

    for log in (False, True):
        style = "LogarithmicLinePlot" if log else "LinearLinePlot"
        if style not in formats:
            continue
        plt.figure(figsize=(10, 5))
        plt.title(f"Graph of average solving times for {origin}")
        for (mean, _), lab in zip(stats, labels):
            plt.plot(x, mean[:nd], marker="o", label=lab)
        plt.xticks(ticks=x, labels=dims)
        if log:
            plt.yscale("log")
        _save(f"{origin}average{style}.png")

    for log in (False, True):
        style = "errorbarLogarithmic" if log else "errorbarLinear"
        if style not in formats:
            continue
        plt.figure(figsize=(10, 5))
        plt.title(f"Average solving times for {origin} with errorbars")
        for (mean, std), lab in zip(stats, labels):
            plt.errorbar(x, mean[:nd], yerr=std[:nd], label=lab,
                         capsize=3)
        plt.xticks(ticks=x, labels=dims)
        if log:
            plt.yscale("log")
        _save(f"{origin}{style}.png")

    width = 0.8 / max(1, len(stats))
    for log in (False, True):
        style = "LogarithmicBarPlot" if log else "LinearBarPlot"
        if style not in formats:
            continue
        plt.figure(figsize=(10, 5))
        plt.title(f"Bar plot of average solving times for {origin}")
        for i, ((mean, _), lab) in enumerate(zip(stats, labels)):
            plt.bar(x + i * width, mean[:nd], width, label=lab)
        plt.xticks(x + width * (len(stats) - 1) / 2, dims)
        if log:
            plt.yscale("log")
        _save(f"{origin}average{style}.png")

    plt.close("all")
    return written


def plot_backtrack_distribution(bt_hist, beta=0.6, ax=None, label=None):
    """Distribution of accepted line-search candidates: bin j = Newton
    steps that accepted sigma = beta^j, i.e. took j backtracks
    (reference instrumentation: testing/plots/backtrack_distribution.png,
    SURVEY.md §5).  ``bt_hist`` is IPMResult.bt_hist or a driver's
    ``backtrack_hist``."""
    import matplotlib.pyplot as plt

    if ax is None:
        ax = plt.subplot()
    h = np.asarray(bt_hist)
    last = int(np.max(np.nonzero(h)[0])) + 1 if h.any() else 1
    ax.bar(np.arange(last), h[:last])
    if label:
        ax.set_title(label)
    ax.set_xlabel("backtracking steps j (accepted sigma = beta^j)")
    ax.set_ylabel("Newton steps")
    return ax


def plot_timing_comparison(results, dims, labels=None, title="",
                           logy=True, ax=None):
    """Mean solve time vs problem dimension for several solver columns
    (reference plot styles: parseAndPlot.py:177-409).

    ``results``: list of (num_tests, N) arrays or paths to reference-format
    CSVs; ``dims``: dimension per row.
    """
    import matplotlib.pyplot as plt

    if ax is None:
        ax = plt.subplot()
    for i, res in enumerate(results):
        if isinstance(res, str):
            res = read_results(res)
        means = mean_over_reps(res)
        label = labels[i] if labels else f"series {i}"
        ax.plot(dims[: len(means)], means, marker="o", label=label)
    ax.set_xlabel("problem dimension n")
    ax.set_ylabel("mean solve time (s)")
    if logy:
        ax.set_yscale("log")
    ax.set_title(title)
    ax.legend()
    return ax
