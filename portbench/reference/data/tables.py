# Frozen copy of reseek_tpu_torch/data/tables.py (commit f533a72), the benchmark's plain
# reference: imports renamed, nothing else changed.
"""Trained tables: log-odds matrices, Mu matrix, bin thresholds, centroids.

The heavy numeric tables live in tables.npz (extracted from the reference's
baked C++ array literals by tools/extract_tables.py).  The small threshold
tables below are the trained float-feature discretization bins
(reference src/valuetoint.cpp) — a value v maps to the first bin i with
v < T[i], else to len(T) (= bin 15).
"""

from __future__ import annotations

import functools
import os
from typing import Dict

import numpy as np

_NPZ = os.path.join(os.path.dirname(__file__), "tables.npz")

# Float-feature bin thresholds, 15 each → 16 bins (src/valuetoint.cpp:6-184).
BIN_THRESHOLDS: Dict[str, tuple] = {
    "NENDist": (4.417, 4.647, 4.841, 5.052, 5.286, 5.589, 6.055, 6.536,
                7.007, 7.485, 7.999, 8.559, 9.166, 9.873, 11.18),
    "RENDist": (6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20),
    "DstNxtHlx": (6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 18, 20, 24, 28),
    "StrandDens": (0.02212, 0.07567, 0.1134, 0.1394, 0.1605, 0.1796, 0.1982,
                   0.2172, 0.2378, 0.2615, 0.2893, 0.3227, 0.3627, 0.4111,
                   0.4778),
    "NormDens": (0.241, 0.3399, 0.4115, 0.4699, 0.5204, 0.5655, 0.6065,
                 0.6443, 0.6803, 0.715, 0.7496, 0.7854, 0.8233, 0.8655,
                 0.917),
    "HelixDens": (0.03015, 0.06112, 0.1127, 0.1683, 0.2115, 0.2455, 0.275,
                  0.3033, 0.3309, 0.3589, 0.3885, 0.4227, 0.4647, 0.5258,
                  0.6343),
    "PMDist": (9.994, 12.06, 13.65, 14.98, 16.3, 17.57, 18.82, 20.06, 21.33,
               22.64, 23.93, 24.86, 26.38, 28.84, 32.77),
    # Note: ValueToInt_DstPrvHlx has a leading 0 threshold (valuetoint.cpp:148)
    "DstPrvHlx": (0, 6, 7, 8, 9, 10.81, 12.59, 14.01, 15.25, 16.62, 18.21,
                  19.98, 22, 24.6, 28.82),
    "NX": (20.65, 23.54, 25.62, 27.43, 29.14, 30.76, 32.3, 33.78, 35.22,
           36.61, 37.96, 39.34, 40.77, 42.39, 44.47),
}


class Tables:
    """Loaded trained tables with convenient accessors."""

    def __init__(self, npz_path: str = _NPZ):
        self._d = dict(np.load(npz_path))

    def score_mx(self, feature: str) -> np.ndarray:
        """Per-feature log-odds substitution matrix, float32 [A, A]."""
        return self._d[f"{feature}_S_ij"]

    def freq_mx(self, feature: str) -> np.ndarray:
        return self._d[f"{feature}_f_ij"]

    def bg_freqs(self, feature: str) -> np.ndarray:
        return self._d[f"{feature}_f_i"]

    @property
    def mu_score_mx(self) -> np.ndarray:
        """36x36 float32 Mu substitution matrix (src/mumx_data.cpp:3)."""
        return self._d["ScoreMx_Mu"]

    @property
    def mu_score_mx_int8(self) -> np.ndarray:
        """36x36 int8 Mu matrix used by the 8-bit filter SW (mumx_data.cpp:42)."""
        return self._d["IntScoreMx_Mu"]

    @property
    def mu_prefilter_mx_int8(self) -> np.ndarray:
        """36x36 int8 matrix used by the k-mer prefilter's seed scoring and
        diagonal HSPs (Mu_S_ij_i8, src/mumx_data.cpp:81)."""
        return self._d["Mu_S_ij_i8"]

    @property
    def conf_centroids(self) -> np.ndarray:
        """16x9 float64 k-means centroids for the Conf letter (myss.cpp:70-85)."""
        return self._d["ConfCentroids"]

    def weighted_score_mx(self, feature: str, weight: float) -> np.ndarray:
        """weight * log-odds, float32 — matches ApplyWeights
        (src/dssparams.cpp:344-364: w (f32) * mx (f32))."""
        return (np.float32(weight) * self.score_mx(feature)).astype(np.float32)


@functools.lru_cache(maxsize=1)
def get_tables() -> Tables:
    return Tables()

