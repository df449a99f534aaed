"""The yardstick counts the same cells for the same pairs however they are
batched, and never more than the pairs' own work."""

import itertools

import numpy as np

from portbench import yardstick


def pairs_cells(L):
    return sum(float(L[i]) * L[j] for i, j in
               itertools.combinations_with_replacement(range(len(L)), 2))


def test_cells_equal_the_pairs_sum():
    rng = np.random.default_rng(3)
    L = rng.integers(30, 500, 57)
    assert yardstick.self_pair_cells(L) == pairs_cells(L)


def test_cells_the_same_however_batched():
    """Pair blocks of any split: the blocks on the diagonal are
    all-vs-alls of their own, the others full rectangles."""
    rng = np.random.default_rng(4)
    L = rng.integers(30, 500, 64)
    whole = pairs_cells(L)
    for blocks in (2, 5, 16):
        parts = np.array_split(L, blocks)
        total = sum(yardstick.self_pair_cells(p) for p in parts)
        total += sum(float(a.sum()) * float(b.sum())
                     for a, b in itertools.combinations(parts, 2))
        assert total == whole


def test_least_time():
    L = np.array([100, 200])
    nbytes, ops = yardstick.sw_align_work(L)
    cells = 100 * 100 + 100 * 200 + 200 * 200
    assert ops == 17 * cells
    assert yardstick.least_seconds(nbytes, ops) == max(
        nbytes / 3.35e12, ops / 67e12)
    mb, mo = yardstick.mu_sweep_work(L)
    assert mo == 10 * cells and mb == 2 * 300 + 4 * 3
