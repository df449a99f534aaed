"""Global (Needleman-Wunsch) alignment — exact replica of the reference's
ViterbiFastMem (src/viterbifastmem.cpp:32-187) used by -global, evaluated
over anti-diagonals (every dependency is on an earlier anti-diagonal, so
each cell performs the identical float32 op sequence as the row-scan).

Semantics worth noting (matched bit-for-bit):
  - gap states open from M only; defaults open=-1, ext=-0.05,
    term_open=term_ext=0
  - D gaps in column 0 and column LB are terminal-priced (free by
    default); I gaps are terminal-priced only at the FIRST column step
    (so a leading I gap costs term_open then STANDARD ext per residue —
    viterbifastmem.cpp:60-64,121-125) and along the last row
  - tie rules: M-open wins ties in the inner D/I updates (>=), ext wins
    ties in the last-row I update (strict >), the match source and final
    state prefer M, then D (strict > to displace)
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

NEG = np.float32(-9e9)

_DM, _IM, _MD, _MI = 1, 2, 4, 8  # tracebit.h:4-7


def nw_align(S: np.ndarray, open_: float = -1.0, ext: float = -0.05,
             term_open: float = 0.0, term_ext: float = 0.0
             ) -> Tuple[float, str]:
    """Returns (score, path of M/D/I).  S: float32 [LA, LB]."""
    la, lb = S.shape
    if la == 0 or lb == 0:
        return 0.0, ""
    f32 = np.float32
    open_, ext = f32(open_), f32(ext)
    term_open, term_ext = f32(term_open), f32(term_ext)
    S = S.astype(np.float32, copy=False)

    # per-column prices: D update (columns 0 and LB terminal,
    # viterbifastmem.cpp:60-64,128-141); inner I update (column 0 only)
    d_open = np.full(lb + 1, open_, f32)
    d_ext = np.full(lb + 1, ext, f32)
    d_open[0] = d_open[lb] = term_open
    d_ext[0] = d_ext[lb] = term_ext
    i_open = np.full(lb + 1, open_, f32)
    i_ext = np.full(lb + 1, ext, f32)
    i_open[0] = term_open
    i_ext[0] = term_ext

    ii = np.arange(la + 1)
    nd = la + lb + 1  # anti-diagonals of the (LA+1) x (LB+1) grid

    def diag_arr():
        return np.full(la + 1, NEG, f32)

    m_cur = diag_arr()
    m_cur[0] = f32(0.0)          # DPM[0][0] = 0
    m_next = diag_arr()          # DPM on diag s+1 (filled two steps ahead)
    d_cur = diag_arr()
    i_cur = diag_arr()

    TB = np.zeros((la + 1, lb + 1), np.uint8)

    for s in range(nd - 1):
        jj = s - ii
        on = (jj >= 0) & (jj <= lb)
        jc = np.clip(jj, 0, lb)
        src = on & (ii <= la - 1) & (jj <= lb - 1)  # inner source cells

        # --- D[s+1]: DPD[i+1][j] for i <= LA-1, all j (incl. j == LB)
        d_from = on & (ii <= la - 1)
        dm = m_cur + d_open[jc]
        dd = d_cur + d_ext[jc]
        d_pref = dm >= dd
        d_val = np.where(d_pref, dm, dd)

        # --- I[s+1]: DPI[i][j+1] for i <= LA-1, j <= LB-1
        i_from = src
        im = m_cur + i_open[jc]
        ie = i_cur + i_ext[jc]
        i_pref = im >= ie
        i_val = np.where(i_pref, im, ie)
        # last row (i == LA): DPI[LA][j+1] for j in 1..LB-1, ext wins ties
        j_la = s - la
        last_i_on = 1 <= j_la <= lb - 1
        if last_i_on:
            li_m = f32(m_cur[la] + term_open)
            li_e = f32(i_cur[la] + term_ext)
            last_take_open = bool(li_m > li_e)
            last_i_val = li_m if last_take_open else li_e

        # --- M[s+2]: DPM[i+1][j+1] = max(M, D, I at (i, j)) + S[i][j]
        xm = m_cur.copy()
        mbits = np.zeros(la + 1, np.uint8)
        bd = d_cur > xm
        xm = np.where(bd, d_cur, xm)
        mbits = np.where(bd, np.uint8(_DM), mbits)
        bi = i_cur > xm
        xm = np.where(bi, i_cur, xm)
        mbits = np.where(bi, np.uint8(_IM), mbits)
        sdiag = diag_arr()
        sel = np.flatnonzero(src)
        sdiag[sel] = S[sel, jj[sel]]
        m_val = xm + sdiag

        # traceback bits at the SOURCE cell (i, j)
        bits = np.where(src, mbits, np.uint8(0))
        bits = np.where(d_from & d_pref, bits | np.uint8(_MD), bits)
        bits = np.where(i_from & i_pref, bits | np.uint8(_MI), bits)
        onsel = np.flatnonzero(on & (bits > 0))
        TB[onsel, jj[onsel]] |= bits[onsel]
        if last_i_on and last_take_open:
            TB[la, j_la] |= np.uint8(_MI)

        # rotate to diag s+1
        d_next = diag_arr()
        d_next[1:] = np.where(d_from[:-1], d_val[:-1], NEG)
        i_next = np.where(i_from, i_val, NEG)
        if last_i_on:
            i_next[la] = last_i_val
        m_after = diag_arr()                        # becomes diag s+2
        m_after[1:] = np.where(src[:-1], m_val[:-1], NEG)
        m_cur, m_next = m_next, m_after
        d_cur = d_next
        i_cur = i_next

    # diag la+lb holds cell (LA, LB) at index LA
    final_m = f32(m_cur[la])
    final_d = f32(d_cur[la])
    final_i = f32(i_cur[la])
    score = final_m
    state = "M"
    if final_d > score:
        score, state = final_d, "D"
    if final_i > score:
        score, state = final_i, "I"

    # TraceBackBitMem (src/tracebackbitmem.cpp:8-70)
    i, j = la, lb
    path = []
    while not (i == 0 and j == 0):
        path.append(state)
        if state == "M":
            t = TB[i - 1, j - 1]
            state = "D" if (t & _DM) else ("I" if (t & _IM) else "M")
            i -= 1
            j -= 1
        elif state == "D":
            t = TB[i - 1, j]
            state = "M" if (t & _MD) else "D"
            i -= 1
        else:
            t = TB[i, j - 1]
            state = "M" if (t & _MI) else "I"
            j -= 1
    path.reverse()
    return float(score), "".join(path)
