"""The frozen yardstick: the card's peaks and the operations and bytes of a
kernel's work, counted from the inputs alone (chain lengths and pairs), so
that they read the same whatever implements the work.

Copied from chip_smoke.py (``PEAK_BYTES_S``, ``PEAK_FP32_S``, ``CELL_OPS``,
``bound``, and the byte counts of its phase 2), with the cells counted to
the chains' ends instead of a launch's padded shape.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, at its full 700 W: device memory bandwidth
# and the float32 rate outside the tensor cores (none of these kernels is
# a matrix product)
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
# float32 operations of one DP cell: the recurrence's adds and maxima or
# compares; the profile-fed kernels add the 7 adds of the 8-feature score
CELL_OPS = {"mu_sweep": 10, "sw_align": 17}
# profile features of a chain (DSSParams.features of every mode)
N_FEATURES = 8


def least_seconds(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of bytes over the
    bandwidth and operations over the float32 rate."""
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_FP32_S)


def self_pair_cells(lengths: np.ndarray) -> float:
    """Sum of LA x LB over an all-vs-all's pairs (i, j >= i)."""
    L = np.asarray(lengths, np.float64)
    return float((L.sum() ** 2 + (L * L).sum()) / 2)


def mu_sweep_work(lengths: np.ndarray) -> tuple:
    """(bytes, operations) of the Mu filter over an all-vs-all of chains
    of ``lengths`` that all take the device path: each chain's forward and
    reversed letters read once, a score written a pair, 10 operations a
    cell of the forward scores (the reversed ones, needed only above the
    forward gate, are not counted: a lower bound of the work)."""
    L = np.asarray(lengths, np.float64)
    n = len(L)
    pairs = n * (n + 1) / 2
    return 2 * L.sum() + 4 * pairs, CELL_OPS["mu_sweep"] * self_pair_cells(L)


def sw_align_work(lengths: np.ndarray) -> tuple:
    """(bytes, operations) of SW with traceback over every pair of an
    all-vs-all (the --verysensitive path, where every pair reaches stage
    3): each chain's profile read once, 4 bits of traceback written a cell
    and the best score and cell a pair, 17 operations a cell."""
    L = np.asarray(lengths, np.float64)
    n = len(L)
    pairs = n * (n + 1) / 2
    cells = self_pair_cells(L)
    return (N_FEATURES * L.sum() + cells / 2 + 12 * pairs,
            CELL_OPS["sw_align"] * cells)
