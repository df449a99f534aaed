# Frozen copy of reseek_tpu_torch/ops/sw_native.py (commit f533a72), the benchmark's plain
# reference: imports renamed; the native path only (its switch and numpy
# fallback left out), built by portbench/reference/build.py.
"""ctypes binding for the native profile and Mu-letter SW (native/sw.cpp):
the reference SWFast over SetSMx_NoRev, for the per-chain self-reversal
scores, the Mu filter and the full alignment of a pair."""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from portbench.reference import build
from portbench.reference.constants import DSSParams


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load("sw", "-ffp-contract=off")
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


def sw_score_profile_native(params: DSSParams, prof_a: np.ndarray,
                            prof_b: np.ndarray) -> float:
    """Best local SW score of two uint8 [F, L] profiles under `params`
    (gap penalties + weighted feature matrices)."""
    lib = _lib()
    from portbench.reference.align.mkf_native import _packed_weights
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
                            open_: float, ext: float) -> float:
    """Best local SW score of two uint8 letter sequences over a float32
    [A, A] substitution table (the Mu-filter kernel)."""
    lib = _lib()
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
    (score, lo_a, lo_b, path)."""
    lib = _lib()
    from portbench.reference.align.mkf_native import _packed_weights
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
