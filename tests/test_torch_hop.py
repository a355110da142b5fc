"""The refined solve's accounting on the CPU: chip_smoke.py's record of
``ip_refined_solve`` calls by the shape of M (``hop_recording``,
``hop_by_shape``, ``merge_by_shape``; its kernels line splits the main
path's launches and operator passes by shape with them), the per-state
rows of the kernels line (``hop_by_state``), and chip_ab.py's reading of
``--hop`` lines (``_numbers``).  The kernels of csrc/hop.cu are held
against their plain versions on the card by chip_smoke.py; their plain
twins against the JAX package by tests/test_torch_pd_step.py and
tests/test_torch_socp_step.py."""
import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (one torch thread per worker)
import chip_ab
import chip_smoke
from interiorpoint_tpu_torch.ops import pd_step as ps
from interiorpoint_tpu_torch.ops import refine
from interiorpoint_tpu_torch.ops import socp_step as ks


def _system(seed, k, r, quad):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    C = t(rng.uniform(-2, 2, (k, r)))
    w = t(np.exp(rng.uniform(np.log(1e-3), 0.0, k)))
    P = None
    if quad:
        A = rng.uniform(-1, 1, (r, r))
        P = t(A.T @ A + np.eye(r))
    W, dsc, _ = refine.factor_inverse_device(
        ps._Plain, ps._Plain.gram(C.float(), w, None if P is None
                                  else P.float()))
    return C, w, P, W, dsc, t(rng.standard_normal(r))


def test_hop_recording_counts_every_solve_by_shape(monkeypatch):
    """With the CUDA wrapper standing in for the plain solve, the recorder
    sees the calls made through pd_step's and socp_step's _Cuda (K4
    inherits K1's wrapper), and hop_by_shape sums launches and operator
    passes (rounds + PCG rounds + stalled) per shape as the kernel's
    device tally counts them; the undo restores the wrapper."""
    monkeypatch.setattr(ps._Cuda, "refined_solve",
                        staticmethod(ps._Plain.refined_solve))
    wrapper = ps._Cuda.refined_solve
    chip_smoke.HOP_CALLS.clear()
    undo = chip_smoke.hop_recording()
    try:
        counts = []
        for seed, (k, r, quad), ops in ((1, (40, 8, False), ps._Cuda),
                                        (2, (40, 8, False), ps._Cuda),
                                        (3, (30, 6, True), ks._Cuda)):
            C, w, P, W, dsc, b = _system(seed, k, r, quad)
            out = ops.refined_solve(C, w, P, W, dsc, b, 3, 1e-12)
            counts.append(out[4].tolist())
    finally:
        undo()
    assert ps._Cuda.refined_solve is wrapper
    got = chip_smoke.hop_by_shape(chip_smoke.HOP_CALLS)
    chip_smoke.HOP_CALLS.clear()

    def passes(c):
        return c[0] + c[2] + c[1]

    assert got == {
        "40x8": {"launches": 2,
                 "passes": passes(counts[0]) + passes(counts[1])},
        "30x6+P": {"launches": 1, "passes": passes(counts[2])}}
    assert all(c[0] >= 1 for c in counts)


def test_hop_by_shape_counts_the_pcg_and_its_result():
    """A stalled solve's passes: its rounds, its PCG rounds and the pass
    over the PCG's result; an empty record gives no shapes."""
    calls = [(2200, 200, False, torch.tensor([3, 0, 0, 0], dtype=torch.int32)),
             (2200, 200, False, torch.tensor([1, 1, 48, 0], dtype=torch.int32)),
             (4010, 950, True, torch.tensor([1, 1, 29, 1], dtype=torch.int32))]
    assert chip_smoke.hop_by_shape(calls) == {
        "2200x200": {"launches": 2, "passes": 3 + 1 + 48 + 1},
        "4010x950+P": {"launches": 1, "passes": 1 + 29 + 1}}
    assert chip_smoke.hop_by_shape([]) == {}


def test_merge_by_shape_adds_rows_in_place():
    total = {"2200x200": {"launches": 2, "passes": 7}}
    out = chip_smoke.merge_by_shape(total, {
        "2200x200": {"launches": 1, "passes": 3},
        "11000x1000": {"launches": 4, "passes": 12}})
    assert out is total
    assert total == {"2200x200": {"launches": 3, "passes": 10},
                     "11000x1000": {"launches": 4, "passes": 12}}


def _pieces(shape, qp, scale):
    info = {"operator.shape": list(shape), "operator.qp": qp}
    ms = {}
    for i, tag in enumerate(("h_apply", "solve", "solve_pcg")):
        ms[tag] = [scale * (i + 1), 10 * scale * (i + 1), None]
        info[tag + ".queued_ms"] = scale * (i + 0.5)
        info[tag + ".bound"] = {"bound_ms": scale / 10 * (i + 1)}
        if tag != "h_apply":
            info[tag + ".counts"] = [[3 - i, i, 0, 0], [3 - i, i, 0, 0]]
    return {"pieces_info": info, "pieces_ms": ms}


@pytest.mark.parametrize("with_k4", [False, True])
def test_hop_by_state_rows(with_k4):
    """One row per timed state present, in HOP_STATES order, with the
    operator's shape, both solve paths' counts and each entry's times."""
    results = {("K1", "lp1000_auto"): _pieces((2200, 200), False, 1.0),
               ("K1", "lp5000_pd"): _pieces((11000, 1000), False, 2.0)}
    if with_k4:
        results[("K4", "socp1000_barrier", "first")] = _pieces(
            (4010, 950), True, 3.0)
    rows = chip_smoke.hop_by_state(results)
    assert [r["state"] for r in rows] == (
        ["lp1000_auto first", "lp5000_pd first"]
        + (["socp1000_barrier first"] if with_k4 else []))
    last = rows[-1]
    assert last["shape"] == ([4010, 950] if with_k4 else [11000, 1000])
    assert last["qp"] is with_k4
    s = 3.0 if with_k4 else 2.0
    assert last["h_apply"] == {"ms": s, "plain_ms": 10 * s,
                               "queued_ms": s * 0.5, "bound_ms": s / 10}
    assert last["solve"]["counts"] == [2, 1, 0, 0]
    assert last["solve_pcg"]["ms"] == 3 * s
    assert "counts" not in last["h_apply"]


def test_chip_ab_reads_hop_lines():
    """--summary reads every number of a --hop record and leaves out its
    lists (the counts)."""
    rec = {"tag": "change", "mode": "hop", "times": {
        "lp1000_auto 2200x200 solve": {"ms": 0.09, "device_ms": 0.04,
                                       "host_ms": 0.05, "bound_ms": 0.003,
                                       "counts": [3, 0, 0, 0]}}}
    got = chip_ab._numbers(rec)
    key = "lp1000_auto 2200x200 solve"
    assert got == {(key, "ms"): [0.09], (key, "device_ms"): [0.04],
                   (key, "host_ms"): [0.05], (key, "bound_ms"): [0.003]}
    assert [s[1] for s in chip_ab.HOP_STATES] == [
        "lp1000_auto", "socp1000_barrier", "lp5000_pd"]


@pytest.mark.parametrize("tally,want", [
    # two solves: one of 3 rounds, one of 1 round, 48 PCG rounds and the
    # pass over the PCG's result
    ({"operator_passes": 53, "rounds": 4, "pcg_rounds": 48, "solves": 2},
     1),
    ({"operator_passes": 6, "rounds": 6, "pcg_rounds": 0, "solves": 2}, 0),
    ({"operator_passes": 0, "rounds": 0, "pcg_rounds": 0, "solves": 0},
     None),
    (None, None)])
def test_chip_ab_rows_refined_counts(tally, want):
    """--rows reports a row's refined solves with its stalled solves (the
    passes the rounds and PCG rounds leave over), and --summary reads
    them per row; rows without refined solves report none."""
    rec = {} if tally is None else {"refined_solves_first_solve": tally}
    got = chip_ab.refined_counts(rec)
    if want is None:
        assert got is None
        return
    assert got == {**tally, "stalled": want}
    line = {"tag": "change", "row": "lp5000_pd", "solve_s": [0.1, 0.1, 0.1],
            "median": 0.1, "steps": 41, "p1": None, "ms_per_step": 2.4,
            "syncs": 43, "ladder_s": None, "refined": got}
    nums = chip_ab._numbers(line)
    assert nums[("lp5000_pd", "refined stalled")] == [want]
    assert nums[("lp5000_pd", "refined operator_passes")] == [
        tally["operator_passes"]]
    assert nums[("lp5000_pd", "steps")] == [41]


def test_chip_ab_split_pcg_rounds_per_step(tmp_path, capsys):
    """--split gives each trace's PCG rounds per step from its refined
    solves' counts (None for a trace that did not keep them)."""
    import json
    stats = [[0.0] * 12, [1.0] * 12]
    recs = [{"tag": "parent", "mode": "trace", "row": "lp5000_pd",
             "plain": False, "iterations": 2, "stats": stats,
             "solves": [[[3, 0, 0, 0], [3, 0, 0, 0]],
                        [[1, 1, 48, 0], [2, 1, 7, 1]]]},
            {"tag": "change", "mode": "trace", "row": "lp5000_pd",
             "plain": False, "iterations": 2, "stats": stats}]
    log = tmp_path / "trace.log"
    log.write_text("".join(json.dumps(r) + "\n" for r in recs))
    chip_ab.split(str(log))
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["iterations"] == [2, 2]
    assert out["pcg_rounds_per_step"] == [None, [0, 55]]
