"""K2's block-LDL factor on the CPU: the work count behind its bound in
chip_smoke.py (``ldl_factor_work``, fed by the plain factor's stats), the
comparison of two factors' per-tile iterations (``ldl_tiles_apart``), the
seeded Hs that refuses rung 0 at a late tile (``late_fail_hs``, whose
failure path chip_smoke.py holds the CUDA factor to), and the CUDA
wrapper's flag words (``hybrid._LDL_FLAGS``)."""
import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (one torch thread per worker)
import chip_smoke
from interiorpoint_tpu_torch.ops import hybrid
from interiorpoint_tpu_torch.ops.chol import flag_words
from interiorpoint_tpu_torch.ops.newton_step import _Plain


def _stats_256():
    rng = np.random.default_rng(200)
    Q, _ = np.linalg.qr(rng.standard_normal((200, 200)))
    H = (Q * np.logspace(0, 3, 200)) @ Q.T
    Hs = _Plain.equilibrate(torch.as_tensor(H, dtype=torch.float32),
                            hybrid.LDL_BLK)[0]
    st = torch.full((2, 2), float("nan"))
    _, _, bad = hybrid.ldl_factor_plain(Hs, 0.0, stats=st)
    assert int(bad) == 0
    return st.tolist()


def test_ldl_factor_work_counts_each_tiles_iterations():
    """At np = 256 (two tiles, both passing): per tile 3 power iterations,
    the residual product and two 128³ products per Newton–Schulz
    iteration; stage 0's one panel and one trailing tile."""
    b = hybrid.LDL_BLK
    tiles = _stats_256()
    its = [t[1] for t in tiles]
    assert all(i >= 1 for i in its)
    want = sum(6.0 * b ** 2 + 2.0 * b ** 3 + 4.0 * b ** 3 * i for i in its)
    want += 2.0 * b ** 3 * 2
    assert chip_smoke.ldl_factor_work(256, tiles) == want
    # the old count (the trailing updates only, np³/3) left most out
    assert want > 10 * 256 ** 3 / 3.0


@pytest.mark.parametrize("tiles, stages", [
    ([[0.5, 40.0], [float("nan")] * 2], 0),
    ([[1e-9, 8.0], [2e-4, 40.0], [float("nan")] * 2], 1),
    ([[1e-9, 8.0], [2e-4, 40.0], [float("nan"), 0.0]], 1),
], ids=["first_tile_fails", "second_of_three_fails",
        "plain_stats_after_the_failed_tile"])
def test_ldl_factor_work_stops_at_a_failed_tile(tiles, stages):
    """A tile that missed its gate counts its iterations but no panels or
    updates; tiles after it count nothing (the plain factor's stats give
    them [NaN, 0])."""
    b, nb = hybrid.LDL_BLK, len(tiles)
    want = 0.0
    for k, (_, its) in enumerate(tiles[:stages + 1]):
        want += 6.0 * b ** 2 + 2.0 * b ** 3 + 4.0 * b ** 3 * its
        if k < stages:
            m = nb - k - 1
            want += 2.0 * b ** 3 * (m + m * (m + 1) // 2)
    assert chip_smoke.ldl_factor_work(nb * b, tiles) == want


def test_ldl_tiles_apart_on_the_plain_factors_own_stats():
    """The plain factor's stats against themselves and against a copy one
    iteration off on every tile: no tile apart."""
    tiles = _stats_256()
    off = [[f2, its + 1] for f2, its in tiles]
    assert chip_smoke.ldl_tiles_apart(tiles, tiles) == []
    assert chip_smoke.ldl_tiles_apart(off, tiles) == []


NAN = float("nan")


@pytest.mark.parametrize("cuda, plain, apart", [
    # converged tiles: two iterations apart is reported
    ([[1e-7, 9.0], [2e-7, 8.0]], [[1e-7, 9.0], [3e-7, 6.0]], [[1, 8.0, 6.0]]),
    # tile 0 at its cap in one factor: nothing compared from there
    ([[5e-6, 40.0], [2e-7, 14.0]], [[8e-7, 31.0], [3e-7, 4.0]], []),
    # tile 1 diverged in both: the count to 1e10 is not compared, nor
    # anything after it
    ([[1e-7, 9.0], [3e10, 35.0], [NAN, NAN]],
     [[1e-7, 10.0], [2e10, 31.0], [NAN, 0.0]], []),
], ids=["converged_two_apart", "cap_stops_the_comparison",
        "divergence_stops_the_comparison"])
def test_ldl_tiles_apart(cuda, plain, apart):
    """Tiles compared up to the first one either factor left short of its
    target (the cap or divergence)."""
    assert chip_smoke.ldl_tiles_apart(cuda, plain) == apart


def test_late_fail_hs_refuses_rung0_at_its_tile():
    """The plain factor of late_fail_hs(1024, 6) passes tiles 0–5 and
    misses its gate at tile 6 (at rung 0)."""
    Hs = chip_smoke.late_fail_hs(1024, 6, device="cpu")
    st = torch.full((8, 2), float("nan"))
    _, Dinv, bad = hybrid.ldl_factor_plain(Hs, 0.0, stats=st)
    g = hybrid.NS_TILE_GATE2
    assert int(bad) == 1
    assert [f2 <= g for f2, _ in st.tolist()[:7]] == [True] * 6 + [False]
    assert not bool(torch.isfinite(Dinv[768:896]).any())


def test_ldl_flags_count_calls_and_grow():
    """The flag words are zeroed once per allocation; each factor gets the
    next call number, and a wider factor a fresh, zeroed set."""
    dev = torch.device("cpu")
    hybrid._LDL_FLAGS.pop(dev, None)
    f1, c1 = flag_words(hybrid._LDL_FLAGS, dev, 10)
    f2, c2 = flag_words(hybrid._LDL_FLAGS, dev, 10)
    assert f2 is f1 and (c1, c2) == (1, 2)
    assert f1.dtype == torch.int64 and int(f1.abs().sum()) == 0
    f3, c3 = flag_words(hybrid._LDL_FLAGS, dev, 40)
    assert f3.numel() == 40 and c3 == 1 and int(f3.abs().sum()) == 0
    hybrid._LDL_FLAGS.pop(dev, None)
