"""ctypes binding for the native DSS encoder (native/dss_encoder.cpp).

The shared library is compiled on demand with g++ and cached next to the
package; trained constants (Conf centroids, bin thresholds) are passed in
from reseek_tpu_torch.data so the numeric source of truth stays in one place.
Falls back silently to the numpy encoder when no compiler is available.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from reseek_tpu_torch.chain import Chain
from reseek_tpu_torch.constants import ALL_FEATURES
from reseek_tpu_torch.data.tables import BIN_THRESHOLDS, get_tables

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "native", "dss_encoder.cpp")
_BIN_ORDER = ["NormDens", "NENDist", "HelixDens", "StrandDens",
              "DstNxtHlx", "DstPrvHlx", "NX", "RENDist", "PMDist"]

_lock = threading.Lock()


@functools.lru_cache(maxsize=1)
def _lib() -> Optional[ctypes.CDLL]:
    if os.environ.get("RESEEK_NATIVE", "1") == "0":
        return None
    cache_dir = os.path.join(os.path.dirname(os.path.dirname(_SRC)),
                             "_build")
    so_path = os.path.join(cache_dir, "libdssenc.so")
    try:
        # the lock guards compile-and-load only: two threads racing the
        # first encode must not both run g++ against the same .tmp path
        # (the lru_cache alone doesn't serialize concurrent first calls)
        with _lock:
            if (not os.path.exists(so_path)
                    or os.path.getmtime(so_path) < os.path.getmtime(_SRC)):
                os.makedirs(cache_dir, exist_ok=True)
                # per process: test workers build at once
                tmp = f"{so_path}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O2", "-march=native", "-shared", "-fPIC",
                     _SRC, "-o", tmp],
                    check=True, capture_output=True)
                os.replace(tmp, so_path)
            lib = ctypes.CDLL(so_path)
    except Exception:
        return None
    lib.dss_encode.restype = ctypes.c_int
    lib.dss_encode.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_uint8)]
    if lib.dss_feature_count() != len(ALL_FEATURES):
        return None
    return lib


@functools.lru_cache(maxsize=1)
def _constants():
    cent = np.ascontiguousarray(get_tables().conf_centroids, np.float64)
    bins = np.ascontiguousarray(
        np.stack([np.asarray(BIN_THRESHOLDS[f], np.float64)
                  for f in _BIN_ORDER]))
    return cent, bins


def available() -> bool:
    return _lib() is not None


def encode_features(chain: Chain) -> Optional[dict]:
    """All feature letters via the native encoder; None if unavailable."""
    lib = _lib()
    if lib is None:
        return None
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
        return None
    return {name: out[i, :L].copy() for i, name in enumerate(ALL_FEATURES)}
