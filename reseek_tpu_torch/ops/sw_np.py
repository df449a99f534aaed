"""Smith-Waterman, affine gaps, local, float32 — exact replica of the
reference kernel's per-cell arithmetic and tie-breaking (src/sw.cpp:79-212),
vectorized over anti-diagonals.

The reference scans rows with rolling M/D/I state.  Every cell's value
depends only on cells in earlier anti-diagonals, and each cell performs an
identical fixed sequence of float32 adds/maxes, so a wavefront evaluation
produces bit-identical H values and identical traceback decisions:

  H(i,j)   = select(H(i-1,j-1), E(i,j), F(i,j), 0-floor) + S(i,j)
  E(i,j)   = max_pref_open(H(i-2,j-1)+open, E(i-1,j)+ext)   # gap consuming A
  F(i,j)   = max_pref_open(H(i-1,j-2)+open, F(i,j-1)+ext)   # gap consuming B

Tie rules (sw.cpp:134-149,169-191): E beats match only if strictly greater,
F beats the running max only if strictly greater, 0 wins ties (restart),
gap-open wins ties against gap-extend.  Best cell = first row-major maximum
with strict improvement.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

NEG = np.float32(-9e9)  # reference MINUS_INFINITY (src/xdpmem.h:6)

# traceback encoding: 2 low bits = match source, then gap-open preference
_SRC_M, _SRC_D, _SRC_I, _SRC_S = 0, 1, 2, 3
_BIT_MD, _BIT_MI = 4, 8


def _shift(a: np.ndarray, k: int) -> np.ndarray:
    """Shift values toward higher i by k, filling with NEG."""
    if k == 0:
        return a
    out = np.full_like(a, NEG)
    out[k:] = a[:-k]
    return out


def _forward(S: np.ndarray, open_: np.float32, ext: np.float32,
             want_tb: bool):
    LA, LB = S.shape
    H = np.full((LA, LB), NEG, np.float32)
    TB = np.zeros((LA, LB), np.uint8) if want_tb else None

    iidx = np.arange(LA)
    h2 = np.full(LA, NEG, np.float32)  # H on diagonal d-2
    h3 = np.full(LA, NEG, np.float32)  # H on diagonal d-3
    e1 = np.full(LA, NEG, np.float32)  # E on diagonal d-1
    f1 = np.full(LA, NEG, np.float32)  # F on diagonal d-1
    h1 = np.full(LA, NEG, np.float32)

    for d in range(LA + LB - 1):
        lo = max(0, d - LB + 1)
        hi = min(d, LA - 1)
        valid = (iidx >= lo) & (iidx <= hi)

        # E(i,j) = pref_open(H(d-3)[i-2]+open, E(d-1)[i-1]+ext)
        e_open = _shift(h3, 2) + open_
        e_ext = _shift(e1, 1) + ext
        e_pref = e_open >= e_ext
        e = np.where(e_pref, e_open, e_ext)
        # F(i,j) = pref_open(H(d-3)[i-1]+open, F(d-1)[i]+ext)
        f_open = _shift(h3, 1) + open_
        f_ext = f1 + ext
        f_pref = f_open >= f_ext
        f = np.where(f_pref, f_open, f_ext)

        m = _shift(h2, 1)
        src = np.zeros(LA, np.uint8)
        better_e = e > m
        m = np.where(better_e, e, m)
        src = np.where(better_e, _SRC_D, src).astype(np.uint8)
        better_f = f > m
        m = np.where(better_f, f, m)
        src = np.where(better_f, _SRC_I, src).astype(np.uint8)
        restart = np.float32(0.0) >= m
        m = np.where(restart, np.float32(0.0), m)
        src = np.where(restart, _SRC_S, src).astype(np.uint8)

        ii = iidx[lo: hi + 1]
        jj = d - ii
        sdiag = np.full(LA, NEG, np.float32)
        sdiag[lo: hi + 1] = S[ii, jj]
        h = np.where(valid, m + sdiag, NEG)
        H[ii, jj] = h[lo: hi + 1]

        if want_tb:
            # match-source bits live at cell (i, j=d-i)
            TB[ii, jj] |= src[lo: hi + 1]
            # The gap-open preference for E(i,j) was decided by cell
            # (i-1, j), and for F(i,j) by cell (i, j-1) — both on
            # diagonal d-1 (sw.cpp:169-191).
            ok = ii - 1 >= 0
            TB[ii[ok] - 1, jj[ok]] |= np.where(
                e_pref[ii[ok]], _BIT_MD, 0).astype(np.uint8)
            ok2 = jj - 1 >= 0
            TB[ii[ok2], jj[ok2] - 1] |= np.where(
                f_pref[ii[ok2]], _BIT_MI, 0).astype(np.uint8)

        h3, h2, h1 = h2, h1, h
        e1 = np.where(valid, e, NEG)
        f1 = np.where(valid, f, NEG)

    return H, TB


def sw_score(S: np.ndarray, open_: float, ext: float) -> float:
    """Best local score (0 if none positive)."""
    H, _ = _forward(S, np.float32(open_), np.float32(ext), want_tb=False)
    best = float(H.max()) if H.size else 0.0
    return best if best > 0 else 0.0


def sw_align(S: np.ndarray, open_: float, ext: float
             ) -> Tuple[float, int, int, str]:
    """Best local alignment: (score, loA, loB, path of M/D/I).

    D consumes A (query), I consumes B (target), per the reference
    convention (sw.cpp:53-71)."""
    if S.size == 0:
        return 0.0, 0, 0, ""
    H, TB = _forward(S, np.float32(open_), np.float32(ext), want_tb=True)
    flat = np.argmax(H)  # first row-major max == reference strict-> scan
    best_i, best_j = divmod(int(flat), S.shape[1])
    best = float(H[best_i, best_j])
    if best <= 0.0:
        return 0.0, 0, 0, ""

    # TraceBackBitSW (src/sw.cpp:8-77), start at (besti+1, bestj+1) state M
    i, j = best_i + 1, best_j + 1
    state = "M"
    path = []
    while True:
        path.append(state)
        if state == "M":
            t = TB[i - 1, j - 1]
            src = t & 3
            if src == _SRC_D:
                state = "D"
            elif src == _SRC_I:
                state = "I"
            elif src == _SRC_S:
                break
            i -= 1
            j -= 1
        elif state == "D":
            t = TB[i - 1, j]
            state = "M" if (t & _BIT_MD) else "D"
            i -= 1
        else:  # I
            t = TB[i, j - 1]
            state = "M" if (t & _BIT_MI) else "I"
            j -= 1
    path.reverse()
    # the M appended at loop index i corresponds to H-cell (i-1, j-1), so
    # the alignment starts at (i-1, j-1) (sw.cpp:40-45 with the +1 offsets)
    return best, i - 1, j - 1, "".join(path)


def sw_gapless_score(S: np.ndarray) -> int:
    """Gapless local SW over an integer substitution matrix: the Mu-filter
    fallback used when SIMD SW is unavailable (SWFastPinopGapless,
    src/swfastpinopgapless.cpp:6-46).  Row-sweep recurrence
    x[i, j] = max(x[i-1, j-1], 0) + S[i, j], vectorized over j."""
    la, lb = S.shape
    s32 = S.astype(np.int32)
    prev = np.zeros(lb + 1, np.int32)   # prev[j+1] = x[i-1, j]
    best = np.int32(0)
    for i in range(la):
        cur = np.maximum(prev[:-1], 0) + s32[i]
        b = cur.max() if lb else np.int32(0)
        if b > best:
            best = b
        prev[1:] = cur
    return int(best)
