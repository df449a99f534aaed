# Frozen copy of reseek_tpu_torch/ops/substmx.py (commit f533a72), the benchmark's plain
# reference: imports renamed; only the weighted tables that the native SW
# and MKF take (the port's numpy matrix builders left out).
"""Weighted substitution tables w_f * M_f, float32, as the reference's
SetSMx_NoRev sums them a cell at a time (src/dssaligner.cpp:529-611) in
native/sw.cpp and native/mkf.cpp."""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np

from portbench.reference.data.tables import get_tables


@functools.lru_cache(maxsize=8)
def weighted_matrices(features: Tuple[str, ...],
                      weights: Tuple[float, ...]) -> Dict[str, np.ndarray]:
    """w_f * log-odds matrix per feature, float32 (ApplyWeights,
    src/dssparams.cpp:344-364)."""
    t = get_tables()
    return {f: t.weighted_score_mx(f, w) for f, w in zip(features, weights)}
