"""Mu k-mer filter (MKF) seeded alignment path for long chains.

Faithful host implementation of the reference's long-chain route
(src/mukmerfilter.cpp, src/chainer.cpp, src/xdrophsp.cpp,
src/xdropfwd.cpp, src/xdropbwd.cpp, src/mergefwdback.cpp):

  1. query Mu 3-mers -> hash table with up to HASHW=4 positions per k-mer
  2. target k-mer hits -> ungapped +/- x-drop diagonal extension (int8 Mu
     scores, X1=8), keep HSPs with score >= 50 that improve the best
  3. 1-D chaining of HSP query intervals (classic sweep DP)
  4. re-score chained HSPs with the full multi-feature profile; reject if
     total < MinMegaHSPScore; else banded gapped x-drop (X2=8) around the
     best HSP's best 8-mer, fwd+bwd merged

On TPU this path exists for output parity with the reference; chains that
fit the SW buckets can alternatively take the full-SW path (more exact,
and fast on the MXU/VPU) via DSSParams.mkfl.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from reseek_tpu_torch.align.pipeline import AlignResult, EncodedChain
from reseek_tpu_torch.constants import DSSParams
from reseek_tpu_torch.data.tables import get_tables
from reseek_tpu_torch.ops.substmx import weighted_matrices

HASHW = 4
NO_POS = 0xFFFF
MINUS_INF = np.float32(-9e9)


def build_kmer_hash(kmers: np.ndarray, dict_size: int) -> np.ndarray:
    """[dict_size, HASHW] uint16 of first HASHW query positions per k-mer
    (src/mukmerfilter.cpp:208-225)."""
    ht = np.full((dict_size, HASHW), NO_POS, np.uint16)
    fill = np.zeros(dict_size, np.int8)
    for pos, kmer in enumerate(kmers):
        w = fill[kmer]
        if w < HASHW:
            ht[kmer, w] = pos
            fill[kmer] = w + 1
    return ht


def mu_xdrop(int_mx: np.ndarray, lets_q: np.ndarray, lets_t: np.ndarray,
             pos_q: int, pos_t: int, x: int) -> Tuple[int, int, int, int]:
    """Ungapped +/- x-drop extension from a seed (mukmerfilter.cpp:105-175).
    Returns (score, lo_i, lo_j, length)."""
    lq, lt = len(lets_q), len(lets_t)
    # forward including the seed position
    nf = min(lq - pos_q, lt - pos_t)
    best_fwd = 0
    fwd_len = 0
    if nf > 0:
        s = int_mx[lets_q[pos_q: pos_q + nf], lets_t[pos_t: pos_t + nf]]
        cum = np.cumsum(s.astype(np.int64))
        cmax = np.maximum.accumulate(cum)
        cmax0 = np.maximum(cmax, 0)
        brk = np.flatnonzero(cum + x < cmax0)
        kstop = brk[0] + 1 if len(brk) else nf
        seg = cum[:kstop]
        m = seg.max() if kstop else 0
        if m > 0:
            best_fwd = int(m)
            fwd_len = int(np.argmax(seg)) + 1
    # backward from pos-1
    nb = min(pos_q, pos_t)
    best_rev = 0
    rev_len = 0
    if nb > 0:
        qi = lets_q[pos_q - 1:: -1][:nb]
        ti = lets_t[pos_t - 1:: -1][:nb]
        s = int_mx[qi, ti]
        cum = np.cumsum(s.astype(np.int64))
        cmax = np.maximum.accumulate(cum)
        cmax0 = np.maximum(cmax, 0)
        brk = np.flatnonzero(cum + x < cmax0)
        kstop = brk[0] + 1 if len(brk) else nb
        seg = cum[:kstop]
        m = seg.max() if kstop else 0
        if m > 0:
            best_rev = int(m)
            rev_len = int(np.argmax(seg)) + 1
    lo_i = pos_q - rev_len
    lo_j = pos_t - rev_len
    return best_fwd + best_rev, lo_i, lo_j, fwd_len + rev_len


def chain_hsps(los: List[int], his: List[int],
               scores: List[float]) -> Tuple[float, List[int]]:
    """1-D interval chaining sweep (src/chainer.cpp:31-194)."""
    n = len(los)
    if n == 0:
        return 0.0, []
    bps = []  # (pos, is_hi, index): Lo sorts before Hi at equal pos
    for i in range(n):
        bps.append((los[i], 0, i))
        bps.append((his[i], 1, i))
    bps.sort(key=lambda t: (t[0], t[1]))
    tb = [None] * n
    chain_scores = np.full(n, MINUS_INF, np.float32)
    best_end = None
    for pos, is_hi, idx in bps:
        if not is_hi:
            tb[idx] = best_end
            if best_end is None:
                chain_scores[idx] = np.float32(scores[idx])
            else:
                chain_scores[idx] = chain_scores[best_end] \
                    + np.float32(scores[idx])
        else:
            if best_end is None or chain_scores[idx] > chain_scores[best_end]:
                best_end = idx
    idxs = []
    total = 0.0
    i = best_end
    while i is not None:
        total += scores[i]
        idxs.append(i)
        i = tb[i]
    return total, idxs


@dataclasses.dataclass
class MKFResult:
    best_hsp_score: int = 0
    best_chain_score: int = 0
    chain_lois: List[int] = dataclasses.field(default_factory=list)
    chain_lojs: List[int] = dataclasses.field(default_factory=list)
    chain_lens: List[int] = dataclasses.field(default_factory=list)


def mkf_find_chain(q: EncodedChain, t: EncodedChain,
                   params: DSSParams,
                   ht_q: Optional[np.ndarray] = None) -> MKFResult:
    """Steps 1-3: k-mer hits -> HSPs -> chain (mukmerfilter.cpp:316-464)."""
    res = MKFResult()
    int_mx = get_tables().mu_score_mx_int8.astype(np.int32)
    dict_size = 36 ** params.mkf_pattern.count("1")
    if ht_q is None:
        ht_q = build_kmer_hash(q.mu_kmers, dict_size)
    lets_q = q.mu_letters
    lets_t = t.mu_letters

    hits = ht_q[t.mu_kmers]  # [KT, HASHW] uint16
    min_hsp = params.mkf_min_hsp_score
    x1 = params.mkf_x1
    lois: List[int] = []
    lojs: List[int] = []
    lens: List[int] = []
    scores: List[int] = []
    best = 0
    for pos_t in range(hits.shape[0]):
        for w in range(HASHW):
            pos_q = int(hits[pos_t, w])
            if pos_q == NO_POS:
                continue
            score, lo_i, lo_j, ln = mu_xdrop(int_mx, lets_q, lets_t,
                                             pos_q, pos_t, x1)
            if score >= min_hsp and score > best:
                best = score
                if lo_i not in lois:
                    lois.append(lo_i)
                    lojs.append(lo_j)
                    lens.append(ln)
                    scores.append(score)
    res.best_hsp_score = best
    if not lois:
        return res
    his = [lo + ln - 1 for lo, ln in zip(lois, lens)]
    chain_score, idxs = chain_hsps(lois, his, [float(s) for s in scores])
    res.best_chain_score = int(chain_score)
    for idx in idxs:
        res.chain_lois.append(lois[idx])
        res.chain_lojs.append(lojs[idx])
        res.chain_lens.append(lens[idx])
    return res


class _SubstScorer:
    """Per-position multi-feature match score (SubstScore,
    src/xdrophsp.cpp:8-33): float32 feature-ordered accumulation."""

    def __init__(self, params: DSSParams, prof_a: np.ndarray,
                 prof_b: np.ndarray):
        mats = weighted_matrices(params.features, params.weights)
        self.mats = [mats[f] for f in params.features]
        self.pa = prof_a
        self.pb = prof_b

    def __call__(self, pos_a: int, pos_b: int) -> np.float32:
        total = np.float32(0.0)
        for k, m in enumerate(self.mats):
            total = np.float32(total + m[self.pa[k, pos_a],
                                         self.pb[k, pos_b]])
        return total

    def row(self, pos_a: int, lo_b: int, hi_b: int) -> np.ndarray:
        """Vectorized scores for one A position against B range [lo, hi)."""
        s = self.mats[0][self.pa[0, pos_a], self.pb[0, lo_b:hi_b]].copy()
        for k in range(1, len(self.mats)):
            s += self.mats[k][self.pa[k, pos_a], self.pb[k, lo_b:hi_b]]
        return s

    def diag(self, lo_a: int, lo_b: int, n: int) -> np.ndarray:
        idx_a = np.arange(lo_a, lo_a + n)
        idx_b = np.arange(lo_b, lo_b + n)
        s = self.mats[0][self.pa[0, idx_a], self.pb[0, idx_b]].copy()
        for k in range(1, len(self.mats)):
            s += self.mats[k][self.pa[k, idx_a], self.pb[k, idx_b]]
        return s


def mega_hsp_score(scorer: _SubstScorer, lo_i: int, lo_j: int,
                   ln: int) -> np.float32:
    """GetMegaHSPScore (src/dssaligner.cpp:488-527): feature-major f32 sum."""
    total = np.float32(0.0)
    idx_a = np.arange(lo_i, lo_i + ln)
    idx_b = np.arange(lo_j, lo_j + ln)
    for k, m in enumerate(scorer.mats):
        vals = m[scorer.pa[k, idx_a], scorer.pb[k, idx_b]]
        acc = np.cumsum(np.concatenate(([total], vals)),
                        dtype=np.float32)[-1]
        total = np.float32(acc)
    return total


def xdrop_fwd(scorer, x: float, open_: float, ext: float,
              lo_a: int, la: int, lo_b: int, lb: int
              ) -> Tuple[float, str]:
    """Banded gapped forward x-drop extension — transliteration of
    XDropFwd (src/xdropfwd.cpp:71-386).  Returns (score, path)."""
    f32 = np.float32
    x = f32(x)
    open_ = f32(open_)
    ext = f32(ext)
    abs_open = f32(-open_)
    abs_ext = f32(-ext)
    LA = la - lo_a
    LB = lb - lo_b
    if LA == 1 or LB == 1:
        s = scorer(lo_a, lo_b)
        return (float(s), "M") if s > 0 else (float(s), "")

    mrow = np.full(LB + 2, MINUS_INF, f32)  # index shifted by +1 (Mrow[-1])
    drow = np.full(LB + 2, MINUS_INF, f32)
    tbm = {}  # (i, j) -> bits

    def MR(j):
        return mrow[j + 1]

    def MRset(j, v):
        mrow[j + 1] = v

    best = f32(0.0)
    besti = bestj = 0
    prev_jlo = prev_jhi = 0
    jlo = jhi = 1
    m0 = best
    tb = np.zeros((LA + 2, LB + 2), np.uint8)
    DM, IM, MD, MI = 1, 2, 4, 8

    i = 1
    while i <= LA:
        if jlo == prev_jlo:
            MRset(jlo - 1, MINUS_INF)
            drow[jlo] = MINUS_INF
        endj = min(prev_jhi + 1, LB)
        for j in range(endj + 1, min(jhi + 1, LB) + 1):
            MRset(j - 1, MINUS_INF)
            drow[j] = MINUS_INF

        next_jlo = None
        next_jhi = None
        i0 = MINUS_INF
        j = jlo
        while j <= jhi:
            bits = 0
            saved_m0 = m0
            xm = m0
            if drow[j] > xm:
                xm = drow[j]
                bits = DM
            if i0 > xm:
                xm = i0
                bits = IM
            m0 = MR(j)
            s = scorer(lo_a + i - 1, lo_b + j - 1)
            s = f32(s + xm)
            MRset(j, s)
            h = f32(s - best + x)
            if h > 0:
                next_jlo = j + 1 if next_jlo is None else min(next_jlo, j + 1)
                next_jhi = j + 1  # plain assignment (xdropfwd.cpp:201)
            if h > abs_open:
                next_jlo = j if next_jlo is None else min(next_jlo, j)
            if h > abs_ext and j == jhi and jhi + 1 < LB:
                jhi += 1
                new_endj = max(min(jhi + 1, LB), endj)
                for j2 in range(endj + 1, new_endj + 1):
                    if j2 - 1 > j:
                        MRset(j2 - 1, MINUS_INF)
                    drow[j2] = MINUS_INF
                endj = new_endj
            if s >= best:
                best = s
                besti, bestj = i, j

            if j != jlo:
                md = f32(saved_m0 + open_)
                drow[j] = f32(drow[j] + ext)
                if md >= drow[j]:
                    drow[j] = md
                    bits |= MD
                h = f32(drow[j] - best + x)
                if h > 0:
                    next_jlo = j - 1 if next_jlo is None \
                        else min(next_jlo, j - 1)
                    # max(UINT_MAX, .) is absorbing in the reference
                    # (xdropfwd.cpp:257): unset stays unset -> full row
                    if next_jhi is not None:
                        next_jhi = max(next_jhi, j - 1)

            mi = f32(saved_m0 + open_)
            i0 = f32(i0 + ext)
            if mi >= i0:
                i0 = mi
                bits |= MI
            h = f32(i0 - best + x)
            if h > 0:
                next_jlo = j + 1 if next_jlo is None else min(next_jlo, j + 1)
                if next_jhi is not None:
                    next_jhi = max(next_jhi, j + 1)
            if h > abs_ext and j == jhi and jhi + 1 < LB:
                jhi += 1
                new_endj = max(min(jhi + 1, LB), endj)
                for j2 in range(endj + 1, new_endj + 1):
                    MRset(j2 - 1, MINUS_INF)
                    drow[j2] = MINUS_INF
                endj = new_endj

            tb[i, j] = bits
            j += 1

        if jhi < LB:
            jhi1 = jhi + 1
            tb[i, jhi1] = 0
            md = f32(m0 + open_)
            drow[jhi1] = f32(drow[jhi1] + ext)
            if md >= drow[jhi1]:
                drow[jhi1] = md
                tb[i, jhi1] = MD
        if next_jlo is None:
            break
        prev_jlo, prev_jhi = jlo, jhi
        jlo = min(next_jlo, LB)
        jhi = LB if next_jhi is None else min(next_jhi, LB)
        if jlo == prev_jlo:
            m0 = MINUS_INF
            drow[jlo] = MINUS_INF
        else:
            m0 = MR(jlo - 1)
        i += 1

    if best <= 0:
        return 0.0, ""
    # TraceBack (src/xdropfwd.cpp:10-67) with the GetTBBit* offsets
    # (src/swtrace.h:6-41): M reads TB[i][j], D reads TB[i][j+1],
    # I reads TB[i+1][j]; stop at i==1 or j==1.
    i, j = besti, bestj
    state = "M"
    path = []
    while True:
        path.append(state)
        if i == 1 or j == 1:
            break
        if state == "M":
            t = tb[i, j]
            state = "D" if (t & DM) else ("I" if (t & IM) else "M")
            i -= 1
            j -= 1
        elif state == "D":
            t = tb[i, j + 1]
            state = "M" if (t & MD) else "D"
            i -= 1
        else:
            t = tb[i + 1, j]
            state = "M" if (t & MI) else "I"
            j -= 1
    path.reverse()
    return float(best), "".join(path)


def xdrop_bwd(scorer, x, open_, ext, hi_a, la, hi_b, lb):
    """Backward extension via coordinate reversal (src/xdropbwd.cpp)."""
    rla, rlb = hi_a + 1, hi_b + 1

    class Rev:
        def __call__(self, pa, pb):
            return scorer(rla - pa - 1, rlb - pb - 1)

    score, path = xdrop_fwd(Rev(), x, open_, ext, 0, rla, 0, rlb)
    return score, path[::-1]


def xdrop_hsp(q: EncodedChain, t: EncodedChain, params: DSSParams,
              lo_i: int, lo_j: int, ln: int
              ) -> Tuple[float, int, int, str]:
    """Gapped x-drop around the best 8-mer of an HSP
    (src/xdrophsp.cpp:42-150).  Returns (score, lo_a, lo_b, path)."""
    scorer = _SubstScorer(params, q.profile, t.profile)
    K = 8
    la, lb = len(q), len(t)
    lo_a = lo_i + ln // 2
    lo_b = lo_j + ln // 2
    v = scorer.diag(lo_i, lo_j, ln)
    best_mer = np.float32(0.0)
    for start in range(0, ln - K + 1):
        mer = np.float32(np.cumsum(v[start: start + K],
                                   dtype=np.float32)[-1])
        if mer > best_mer:
            best_mer = mer
            lo_a = lo_i + start
            lo_b = lo_j + start
    if min(lo_a, lo_b) < K // 2:
        lo_a += K // 2
        lo_b += K // 2

    x = float(params.mkf_x2)
    score_fwd, fwd_path = xdrop_fwd(scorer, x, params.gap_open,
                                    params.gap_ext, lo_a, la, lo_b, lb)
    score_bwd, bwd_path = xdrop_bwd(scorer, x, params.gap_open,
                                    params.gap_ext, lo_a - 1, la,
                                    lo_b - 1, lb)
    total = score_fwd + score_bwd
    if total < 10:
        return 0.0, 0, 0, ""
    # MergeFwdBwd (src/mergefwdback.cpp)
    if bwd_path:
        nm = bwd_path.count("M")
        nd = bwd_path.count("D")
        ni = bwd_path.count("I")
        out_lo_a = lo_a - (nm + nd)
        out_lo_b = lo_b - (nm + ni)
    else:
        out_lo_a, out_lo_b = lo_a, lo_b
    return total, out_lo_a, out_lo_b, bwd_path + fwd_path


def align_mkf(q: EncodedChain, t: EncodedChain, params: DSSParams,
              ht_q: Optional[np.ndarray] = None,
              use_native: bool = True) -> AlignResult:
    """Full MKF route: AlignMKF + PostAlignMKF
    (src/dssaligner.cpp:1387-1437)."""
    from reseek_tpu_torch.search.engine import finish_result

    if use_native and ht_q is None:
        from reseek_tpu_torch.align.mkf_native import align_mkf_native
        nat = align_mkf_native(q, t, params)
        if nat is not None:
            score, lo_a, lo_b, path, best_hsp, best_chain = nat
            res = AlignResult(query=q.label, target=t.label,
                              fwd_score=score, lo_a=lo_a, lo_b=lo_b,
                              path=path, best_hsp_score=best_hsp,
                              best_chain_score=best_chain)
            if path:
                finish_result(res, q, t, params)
            return res

    res = AlignResult(query=q.label, target=t.label)
    chain = mkf_find_chain(q, t, params, ht_q)
    if chain.best_chain_score <= 0:
        return res
    scorer = _SubstScorer(params, q.profile, t.profile)
    mega_total = np.float32(0.0)
    best_mega = np.float32(0.0)
    best_idx = 0
    for idx in range(len(chain.chain_lois)):
        mega = mega_hsp_score(scorer, chain.chain_lois[idx],
                              chain.chain_lojs[idx], chain.chain_lens[idx])
        if mega > best_mega:
            best_mega = mega
            best_idx = idx
        mega_total = np.float32(mega_total + mega)
    if mega_total < params.mkf_min_mega_hsp_score:
        return res
    score, lo_a, lo_b, path = xdrop_hsp(
        q, t, params, chain.chain_lois[best_idx],
        chain.chain_lojs[best_idx], chain.chain_lens[best_idx])
    res.fwd_score = score
    res.lo_a, res.lo_b, res.path = lo_a, lo_b, path
    if path:
        finish_result(res, q, t, params)
    return res


def should_use_mkf(q: EncodedChain, t: EncodedChain,
                   params: DSSParams) -> bool:
    """DoMKF (src/dssaligner.cpp:715-732)."""
    if len(q.mu_kmers) == 0 or len(t.mu_kmers) == 0:
        return False
    return len(q) >= params.mkfl or len(t) >= params.mkfl
