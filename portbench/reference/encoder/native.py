# Frozen copy of reseek_tpu_torch/encoder/native.py (commit f533a72), the benchmark's plain
# reference: imports renamed; the native path only (its switch and numpy
# fallback left out), built by portbench/reference/build.py.
"""ctypes binding for the native DSS encoder (native/dss_encoder.cpp).

Trained constants (Conf centroids, bin thresholds) are passed in from
portbench.reference.data so the numeric source of truth stays in one place.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from portbench.reference import build
from portbench.reference.chain import Chain
from portbench.reference.constants import ALL_FEATURES
from portbench.reference.data.tables import BIN_THRESHOLDS, get_tables

_BIN_ORDER = ["NormDens", "NENDist", "HelixDens", "StrandDens",
              "DstNxtHlx", "DstPrvHlx", "NX", "RENDist", "PMDist"]


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load("dss_encoder")
    lib.dss_encode.restype = ctypes.c_int
    lib.dss_encode.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_uint8)]
    if lib.dss_feature_count() != len(ALL_FEATURES):
        raise RuntimeError("native/dss_encoder.cpp: feature count "
                           f"{lib.dss_feature_count()}, want "
                           f"{len(ALL_FEATURES)}")
    return lib


@functools.lru_cache(maxsize=1)
def _constants():
    cent = np.ascontiguousarray(get_tables().conf_centroids, np.float64)
    bins = np.ascontiguousarray(
        np.stack([np.asarray(BIN_THRESHOLDS[f], np.float64)
                  for f in _BIN_ORDER]))
    return cent, bins


def encode_features(chain: Chain) -> dict:
    """All feature letters via the native encoder."""
    lib = _lib()
    L = len(chain)
    coords = np.ascontiguousarray(chain.coords, np.float32)
    out = np.zeros((len(ALL_FEATURES), max(L, 1)), np.uint8)
    cent, bins = _constants()
    # no lock: dss_encode uses only caller-owned buffers (its lazy AA
    # tables are C++ magic-statics, thread-safe init), and ctypes drops
    # the GIL for the call, so encodes run truly in parallel
    rc = lib.dss_encode(
        coords.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        chain.seq.encode("latin-1"), L,
        cent.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        bins.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise RuntimeError(f"dss_encode failed ({rc}) on {chain.label}")
    return {name: out[i, :L].copy() for i, name in enumerate(ALL_FEATURES)}
