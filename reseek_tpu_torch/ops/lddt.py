"""LDDT over aligned columns, exact replica of GetLDDT_mu_fast
(src/lddt.cpp:63-124): R0=15, thresholds {0.5, 1, 2, 4}, per-column
preserved/considered counts, averaged over all columns.

Two implementations with identical float32 semantics: a native C++ one
(native/lddt.cpp, ~30x faster — the production host path, used for the
device-LDDT boundary recompute and the MKF pipeline) and the numpy
reference below (differential-test target, fallback)."""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "native", "lddt.cpp")
_lock = threading.Lock()


@functools.lru_cache(maxsize=1)
def _lib() -> Optional[ctypes.CDLL]:
    if os.environ.get("RESEEK_NATIVE", "1") == "0":
        return None
    cache_dir = os.path.join(os.path.dirname(os.path.dirname(_SRC)),
                             "_build")
    so_path = os.path.join(cache_dir, "liblddt.so")
    try:
        with _lock:
            if (not os.path.exists(so_path)
                    or os.path.getmtime(so_path) < os.path.getmtime(_SRC)):
                os.makedirs(cache_dir, exist_ok=True)
                # -ffp-contract=off: only the EXPLICIT fmaf calls fuse,
                # matching the reference's contracted d^2 and nothing else
                subprocess.run(
                    ["g++", "-O2", "-march=native", "-ffp-contract=off",
                     "-shared", "-fPIC", _SRC, "-o", so_path + ".tmp"],
                    check=True, capture_output=True)
                os.replace(so_path + ".tmp", so_path)
            lib = ctypes.CDLL(so_path)
    except Exception:
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.lddt_pair.restype = ctypes.c_float
    lib.lddt_pair.argtypes = [f32p, f32p, ctypes.c_int, i64p, i64p]
    return lib

R0 = np.float32(15.0)
R0_SQ = R0 * R0
THRESHOLDS = (np.float32(0.5), np.float32(1.0), np.float32(2.0),
              np.float32(4.0))


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
    lib = _lib()
    if lib is not None:
        cq = np.ascontiguousarray(coords_q[pos_q], np.float32)
        ct = np.ascontiguousarray(coords_t[pos_t], np.float32)
        cons = np.empty(n, np.int64)
        pres = np.empty(n, np.int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        i64p = ctypes.POINTER(ctypes.c_int64)
        return float(lib.lddt_pair(
            cq.ctypes.data_as(f32p), ct.ctypes.data_as(f32p), n,
            cons.ctypes.data_as(i64p), pres.ctypes.data_as(i64p)))
    return lddt_mu_fast_np(coords_q, coords_t, pos_q, pos_t)


def lddt_mu_fast_np(coords_q: np.ndarray, coords_t: np.ndarray,
                    pos_q: np.ndarray, pos_t: np.ndarray) -> float:
    """Numpy reference implementation (see lddt_mu_fast)."""
    n = len(pos_q)
    if n == 0:
        return 0.0
    cq = coords_q[pos_q]  # [n,3] f32
    ct = coords_t[pos_t]

    def d2mat(c):
        # GetDist2 (src/pdbchain.cpp:320-340) as compiled with GCC FMA
        # contraction: dy*dy rounded, then two fused multiply-adds:
        # d2 = fma(dz, dz, fma(dx, dx, f32(dy*dy)))
        from reseek_tpu_torch.fp import fma32
        d = c[:, None, :] - c[None, :, :]
        dy2 = d[..., 1] * d[..., 1]
        return fma32(d[..., 2], d[..., 2], fma32(d[..., 0], d[..., 0], dy2))

    d1_sq = d2mat(cq)
    d2_sq = d2mat(ct)
    iu, ju = np.triu_indices(n, k=1)
    a1 = d1_sq[iu, ju]
    a2 = d2_sq[iu, ju]
    consider = ~((a1 > R0_SQ) & (a2 > R0_SQ))

    d1 = np.sqrt(a1[consider])
    d2 = np.sqrt(a2[consider])
    diff = np.abs(d1 - d2)
    npres = sum((diff <= t).astype(np.int64) for t in THRESHOLDS)

    considered = np.zeros(n, np.int64)
    preserved = np.zeros(n, np.int64)
    ic = iu[consider]
    jc = ju[consider]
    np.add.at(considered, ic, 4)
    np.add.at(considered, jc, 4)
    np.add.at(preserved, ic, npres)
    np.add.at(preserved, jc, npres)

    scores = np.where(considered > 0,
                      preserved.astype(np.float32)
                      / considered.astype(np.float32),
                      np.float32(0.0)).astype(np.float32)
    total = np.cumsum(scores, dtype=np.float32)[-1]  # sequential f32 sum
    return float(np.float32(total) / np.float32(n))
