"""ctypes binding for the native score-only profile SW (native/sw.cpp).

Bit-identical to ops/sw_np.sw_score over ops/substmx.build_smx (the
reference SWFast + SetSMx_NoRev pair) — the production host path for
per-chain self-reversal scores.  Falls back to None when no compiler is
available; callers then use the numpy replica.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from reseek_tpu_torch.constants import DSSParams

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "native", "sw.cpp")
_lock = threading.Lock()


@functools.lru_cache(maxsize=1)
def _lib() -> Optional[ctypes.CDLL]:
    if os.environ.get("RESEEK_NATIVE", "1") == "0":
        return None
    cache_dir = os.path.join(os.path.dirname(os.path.dirname(_SRC)),
                             "_build")
    so_path = os.path.join(cache_dir, "libsw.so")
    try:
        with _lock:
            if (not os.path.exists(so_path)
                    or os.path.getmtime(so_path) < os.path.getmtime(_SRC)):
                os.makedirs(cache_dir, exist_ok=True)
                subprocess.run(
                    ["g++", "-O2", "-march=native", "-ffp-contract=off",
                     "-shared", "-fPIC", _SRC, "-o", so_path + ".tmp"],
                    check=True, capture_output=True)
                os.replace(so_path + ".tmp", so_path)
            lib = ctypes.CDLL(so_path)
    except Exception:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int)
    lib.sw_score_profile.restype = ctypes.c_float
    lib.sw_score_profile.argtypes = [
        u8p, ctypes.c_int, u8p, ctypes.c_int, ctypes.c_int, f32p,
        ctypes.c_float, ctypes.c_float]
    lib.sw_score_letters.restype = ctypes.c_float
    lib.sw_score_letters.argtypes = [
        u8p, ctypes.c_int, u8p, ctypes.c_int, f32p, ctypes.c_int,
        ctypes.c_float, ctypes.c_float]
    lib.sw_align_profile.restype = ctypes.c_int
    lib.sw_align_profile.argtypes = [
        u8p, ctypes.c_int, u8p, ctypes.c_int, ctypes.c_int, f32p,
        ctypes.c_float, ctypes.c_float, f32p, i32p, i32p,
        ctypes.c_char_p, ctypes.c_int, i32p]
    return lib


def available() -> bool:
    return _lib() is not None


def sw_score_profile_native(params: DSSParams, prof_a: np.ndarray,
                            prof_b: np.ndarray) -> Optional[float]:
    """Best local SW score of two uint8 [F, L] profiles under `params`
    (gap penalties + weighted feature matrices); None if the native
    library is unavailable."""
    lib = _lib()
    if lib is None:
        return None
    from reseek_tpu_torch.align.mkf_native import _packed_weights
    w = _packed_weights(params.features, params.weights)
    pa = np.ascontiguousarray(prof_a)
    pb = np.ascontiguousarray(prof_b)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    return float(lib.sw_score_profile(
        pa.ctypes.data_as(u8p), int(pa.shape[1]),
        pb.ctypes.data_as(u8p), int(pb.shape[1]),
        int(pa.shape[0]), w.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_float(params.gap_open), ctypes.c_float(params.gap_ext)))


def sw_score_letters_native(a: np.ndarray, b: np.ndarray, mx: np.ndarray,
                            open_: float, ext: float) -> Optional[float]:
    """Best local SW score of two uint8 letter sequences over a float32
    [A, A] substitution table (the Mu-filter kernel); None when the
    native library is unavailable."""
    lib = _lib()
    if lib is None:
        return None
    aa = np.ascontiguousarray(a, np.uint8)
    bb = np.ascontiguousarray(b, np.uint8)
    m = np.ascontiguousarray(mx, np.float32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    return float(lib.sw_score_letters(
        aa.ctypes.data_as(u8p), len(aa), bb.ctypes.data_as(u8p), len(bb),
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), int(m.shape[1]),
        ctypes.c_float(open_), ctypes.c_float(ext)))


def sw_align_profile_native(params: DSSParams, prof_a: np.ndarray,
                            prof_b: np.ndarray):
    """Full local alignment of two uint8 [F, L] profiles: returns
    (score, lo_a, lo_b, path) like ops/sw_np.sw_align (bit-identical),
    or None when the native library is unavailable."""
    lib = _lib()
    if lib is None:
        return None
    from reseek_tpu_torch.align.mkf_native import _packed_weights
    w = _packed_weights(params.features, params.weights)
    pa = np.ascontiguousarray(prof_a)
    pb = np.ascontiguousarray(prof_b)
    la, lb = int(pa.shape[1]), int(pb.shape[1])
    score = ctypes.c_float()
    lo_a = ctypes.c_int()
    lo_b = ctypes.c_int()
    plen = ctypes.c_int()
    cap = la + lb + 2
    buf = ctypes.create_string_buffer(cap)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ok = lib.sw_align_profile(
        pa.ctypes.data_as(u8p), la, pb.ctypes.data_as(u8p), lb,
        int(pa.shape[0]), w.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_float(params.gap_open), ctypes.c_float(params.gap_ext),
        ctypes.byref(score), ctypes.byref(lo_a), ctypes.byref(lo_b),
        buf, cap, ctypes.byref(plen))
    if not ok:
        return 0.0, 0, 0, ""
    return (float(score.value), lo_a.value, lo_b.value,
            buf.raw[: plen.value].decode("ascii"))
