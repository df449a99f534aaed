# Frozen copy of reseek_tpu_torch/align/mkf_native.py (commit f533a72), the benchmark's plain
# reference: imports renamed; the native path only (its switch and numpy
# fallback left out), built by portbench/reference/build.py.
"""ctypes binding for the native MKF aligner (native/mkf.cpp)."""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np

from portbench.reference import build
from portbench.reference.constants import ALPHA_SIZES, DSSParams
from portbench.reference.data.tables import get_tables
from portbench.reference.ops.substmx import weighted_matrices


# mkf_align has no global state (all buffers are caller-owned), so
# concurrent calls are safe and run GIL-free (ctypes releases the GIL for
# the foreign call)
@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load("mkf")
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.mkf_align.restype = ctypes.c_int
    lib.mkf_align.argtypes = [
        u8p, ctypes.c_int, u8p, ctypes.c_int,
        u8p, u8p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int8),
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    return lib


@functools.lru_cache(maxsize=4)
def _packed_weights(features: Tuple[str, ...],
                    weights: Tuple[float, ...]) -> np.ndarray:
    mats = weighted_matrices(features, weights)
    w = np.zeros((len(features), 32, 32), np.float32)
    for f, name in enumerate(features):
        a = ALPHA_SIZES[name]
        w[f, :a, :a] = mats[name]
    return np.ascontiguousarray(w)


def align_mkf_native(q, t, params: DSSParams
                     ) -> Tuple[float, int, int, str, int, int]:
    """Returns (score, lo_a, lo_b, path, best_hsp, best_chain)."""
    lib = _lib()
    w = _packed_weights(params.features, params.weights)
    int_mx = np.ascontiguousarray(get_tables().mu_score_mx_int8)
    pq = np.ascontiguousarray(q.profile)
    pt = np.ascontiguousarray(t.profile)
    lq, lt = len(q), len(t)
    lets_q = np.ascontiguousarray(q.mu_letters)
    lets_t = np.ascontiguousarray(t.mu_letters)
    score = ctypes.c_float()
    lo_a = ctypes.c_int()
    lo_b = ctypes.c_int()
    plen = ctypes.c_int()
    cap = lq + lt + 16
    buf = ctypes.create_string_buffer(cap)
    best_hsp = ctypes.c_int()
    best_chain = ctypes.c_int()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ok = lib.mkf_align(
            lets_q.ctypes.data_as(u8p), lq, lets_t.ctypes.data_as(u8p), lt,
            pq.ctypes.data_as(u8p), pt.ctypes.data_as(u8p),
            ctypes.c_int(pq.shape[0]),
            w.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            int_mx.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            ctypes.c_int(params.mkf_x1), ctypes.c_int(params.mkf_min_hsp_score),
            ctypes.c_float(params.mkf_x2), ctypes.c_float(params.gap_open),
            ctypes.c_float(params.gap_ext),
            ctypes.c_float(params.mkf_min_mega_hsp_score),
            ctypes.byref(score), ctypes.byref(lo_a), ctypes.byref(lo_b),
            buf, ctypes.c_int(cap), ctypes.byref(plen),
            ctypes.byref(best_hsp), ctypes.byref(best_chain))
    if not ok:
        return (0.0, 0, 0, "", best_hsp.value, best_chain.value)
    return (float(score.value), lo_a.value, lo_b.value,
            buf.raw[: plen.value].decode("ascii"),
            best_hsp.value, best_chain.value)
