# Frozen copy of reseek_tpu_torch/ops/lddt.py (commit f533a72), the benchmark's plain
# reference: imports renamed; the native path only (its switch and numpy
# fallback left out), built by portbench/reference/build.py.
"""LDDT over aligned columns, exact replica of GetLDDT_mu_fast
(src/lddt.cpp:63-124): R0=15, thresholds {0.5, 1, 2, 4}, per-column
preserved/considered counts, averaged over all columns, in native C++
(native/lddt.cpp)."""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from portbench.reference import build


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    # -ffp-contract=off: only the EXPLICIT fmaf calls fuse, matching the
    # reference's contracted d^2 and nothing else
    lib = build.load("lddt", "-ffp-contract=off")
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.lddt_pair.restype = ctypes.c_float
    lib.lddt_pair.argtypes = [f32p, f32p, ctypes.c_int, i64p, i64p]
    return lib


def lddt_mu_fast(coords_q: np.ndarray, coords_t: np.ndarray,
                 pos_q: np.ndarray, pos_t: np.ndarray) -> float:
    """coords_*: float32 [L,3]; pos_*: int arrays of aligned column positions.

    Column pairs (i<j): considered if either chain's distance^2 <= R0^2;
    each of 4 thresholds adds preserved if |d1-d2| <= t.  Column score =
    preserved/considered (f32), final = mean of column scores over ALL
    columns (src/lddt.cpp:110-123)."""
    n = len(pos_q)
    if n == 0:
        return 0.0
    cq = np.ascontiguousarray(coords_q[pos_q], np.float32)
    ct = np.ascontiguousarray(coords_t[pos_t], np.float32)
    cons = np.empty(n, np.int64)
    pres = np.empty(n, np.int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    return float(_lib().lddt_pair(
        cq.ctypes.data_as(f32p), ct.ctypes.data_as(f32p), n,
        cons.ctypes.data_as(i64p), pres.ctypes.data_as(i64p)))

