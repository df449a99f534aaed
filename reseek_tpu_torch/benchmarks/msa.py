"""MSA structure-quality scorers: DALI score/Z and column-map LDDT.

Counterparts of the reference's MSA scoring suite:
  DALI score     src/dali.cpp:93-139 (DaliLite dpscorefun, lookup-table
                 envelope weight, theta diagonal term)
  DALI Z         src/daliscorer.cpp:19-29 (fitted mean/sigma vs sqrt(L1*L2))
  MSA LDDT       src/lddt_muscle.cpp:36-103 (GetLDDTChainPair_muscle:
                 R0 gate on d1 only, thresholds {0.5, 1, 2, 4})
  core columns   src/daliscorer.cpp:112-132 (<=10%+1 gaps, no lowercase)
All scorers are vectorized numpy over aligned-column index arrays
(position -1 = gapped/excluded, the reference's UINT_MAX).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from reseek_tpu_torch.chain import Chain

DALI_D = 20.0
DALI_D0 = 0.2
DALI_THETA = 0.2
LDDT_R0 = 15.0
LDDT_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)

# integer-binned envelope weights exp(-(i/D)^2), i = 0..99
# (src/dali.cpp:23-55: Weight() rounds y to the nearest int and clamps)
_WEIGHT_TABLE = np.exp(-(np.arange(100, dtype=np.float64) / DALI_D) ** 2)


def dali_pair_score(d1: np.ndarray, d2: np.ndarray) -> np.ndarray:
    """DALI_dpscorefun over distance arrays (src/dali.cpp:93-110)."""
    diff = np.abs(d1 - d2)
    mean = (d1 + d2) / 2
    iy = np.clip((mean + 0.5).astype(np.int64), 0, 99)
    w = _WEIGHT_TABLE[iy]
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(mean > 0, diff / np.where(mean > 0, mean, 1.0), 0.0)
    score = np.where(mean > 100, 0.0,
                     np.where(mean > 0, w * (DALI_D0 - ratio),
                              w * DALI_D0))
    return score


def dali_score(q: Chain, t: Chain, pos_q: np.ndarray,
               pos_t: np.ndarray, r0: float = float("inf")) -> float:
    """GetDALIScore (src/dali.cpp:141-148): off-diagonal elastic sum +
    Lali * theta.  r0 gates distance pairs like DALIScorer::m_DALI_R0
    (src/zscorer.cpp:42: skip when either distance exceeds R0; the
    msta_score Z15 column uses r0=15)."""
    lali = len(pos_q)
    if lali == 0:
        return 0.0
    dq = q.dist_matrix()[np.ix_(pos_q, pos_q)].astype(np.float64)
    dt = t.dist_matrix()[np.ix_(pos_t, pos_t)].astype(np.float64)
    s = dali_pair_score(dq, dt)
    if np.isfinite(r0):
        s = np.where((dq > r0) | (dt > r0), 0.0, s)
    np.fill_diagonal(s, 0.0)
    return float(s.sum()) + lali * DALI_THETA


def dali_z(score: float, l1: int, l2: int) -> float:
    """GetDALIZFromScoreAndLengths (src/daliscorer.cpp:19-29)."""
    n12 = np.sqrt(float(l1) * float(l2))
    x = min(n12, 400.0)
    mean = 7.9494 + 0.70852 * x + 2.5895e-4 * x * x - 1.9156e-6 * x ** 3
    if n12 > 400:
        mean += n12 - 400.0
    sigma = 0.5 * mean
    return (score - mean) / max(1.0, sigma)


def lddt_msa_pair(q: Chain, t: Chain, col_to_pos_q: np.ndarray,
                  col_to_pos_t: np.ndarray) -> float:
    """GetLDDTChainPair_muscle (src/lddt_muscle.cpp:36-103): per aligned
    column i, fraction of distance pairs (d1 <= R0, j != i) preserved
    within the thresholds; average over considered columns.  Position -1
    = excluded column."""
    both = (col_to_pos_q >= 0) & (col_to_pos_t >= 0)
    pq = col_to_pos_q[both]
    pt = col_to_pos_t[both]
    n = len(pq)
    if n == 0:
        return 0.0
    d1 = q.dist_matrix()[np.ix_(pq, pq)].astype(np.float64)
    d2 = t.dist_matrix()[np.ix_(pt, pt)].astype(np.float64)
    offdiag = ~np.eye(n, dtype=bool)
    in_r0 = (d1 <= LDDT_R0) & offdiag
    diff = np.abs(d1 - d2)
    preserved = np.zeros_like(d1, dtype=np.int64)
    for thr in LDDT_THRESHOLDS:
        preserved += (diff <= thr)
    nr_considered = in_r0.sum(axis=1) * len(LDDT_THRESHOLDS)
    nr_preserved = np.where(in_r0, preserved, 0).sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        scores = np.where(nr_considered > 0,
                          nr_preserved / np.maximum(nr_considered, 1), 0.0)
    return float(scores.mean())


def lddt_foldmason(chains: Dict[int, Chain],
                   maps: Sequence[np.ndarray],
                   core_mask: Optional[np.ndarray] = None) -> float:
    """Whole-MSA foldmason LDDT (GetLDDT_foldmason,
    src/lddt_foldmason.cpp:6-98): mean over (core-eligible) columns of
    the mean over aligned sequence pairs of the pair's per-column LDDT
    (R0=15 gate on the FIRST sequence's distance — SYMM_First default,
    src/daliscorer.h:29,39 — thresholds strict-< {0.5,1,2,4}).

    chains: seq index -> Chain for rows with structures; maps: per-row
    col->pos arrays (-1 = gap/excluded)."""
    if not maps:
        return 0.0
    n_cols = len(maps[0])
    idxs = sorted(chains)
    total = np.zeros(n_cols, np.float64)
    nseq_pairs = np.zeros(n_cols, np.int64)
    for a in range(len(idxs)):
        i = idxs[a]
        mi = maps[i]
        di_full = chains[i].dist_matrix().astype(np.float64)
        for b in range(a + 1, len(idxs)):
            j = idxs[b]
            mj = maps[j]
            both = (mi >= 0) & (mj >= 0)
            cols = np.flatnonzero(both)
            n = len(cols)
            if n == 0:
                continue
            di = di_full[np.ix_(mi[cols], mi[cols])]
            dj = chains[j].dist_matrix().astype(
                np.float64)[np.ix_(mj[cols], mj[cols])]
            offdiag = ~np.eye(n, dtype=bool)
            consider = (di <= LDDT_R0) & offdiag  # SYMM_First
            d_l = np.abs(di - dj)
            isum = ((d_l < 0.5).astype(np.int64) + (d_l < 1.0)
                    + (d_l < 2.0) + (d_l < 4.0))
            num = np.where(consider, isum / 4.0, 0.0).sum(axis=1)
            cnt = consider.sum(axis=1)
            pair_score = np.where(cnt > 0, num / np.maximum(cnt, 1), 0.0)
            total[cols] += pair_score
            nseq_pairs[cols] += 1
    col_scores = np.where(nseq_pairs > 0,
                          total / np.maximum(nseq_pairs, 1), 0.0)
    eligible = (np.ones(n_cols, bool) if core_mask is None
                else core_mask.astype(bool))
    n_considered = int(eligible.sum())
    if n_considered == 0:
        return 0.0
    return float(col_scores[eligible].sum() / n_considered)


# ---------------------------------------------------------------------------
# MSA handling (DALIScorer::SetMSA / GetColToPos / SetCore)

def read_msa_fasta(path: str) -> List[Tuple[str, str]]:
    out, label, parts = [], None, []
    with open(path) as f:
        for line in f:
            line = line.rstrip()
            if not line:
                continue
            if line.startswith(">"):
                if label is not None:
                    out.append((label, "".join(parts)))
                label = line[1:].split()[0]
                parts = []
            else:
                parts.append(line)
    if label is not None:
        out.append((label, "".join(parts)))
    return out


def _is_gap(c: np.ndarray) -> np.ndarray:
    return (c == ord("-")) | (c == ord("."))


def core_columns(rows: Sequence[str]) -> np.ndarray:
    """SetCore (src/daliscorer.cpp:112-132): <= nseqs/10 + 1 gaps and no
    lowercase letters."""
    mat = np.array([np.frombuffer(r.encode("ascii"), np.uint8)
                    for r in rows])
    gaps = _is_gap(mat).sum(axis=0)
    lower = ((mat >= ord("a")) & (mat <= ord("z"))).sum(axis=0)
    max_gaps = len(rows) // 10 + 1
    return (gaps <= max_gaps) & (lower == 0)


def col_to_pos(row: str, core: Optional[np.ndarray] = None) -> np.ndarray:
    """GetColToPos (src/daliscorer.cpp:309-330): -1 for gap, lowercase,
    or non-core column; else the ungapped position."""
    c = np.frombuffer(row.encode("ascii"), np.uint8)
    gap = _is_gap(c)
    lower = (c >= ord("a")) & (c <= ord("z"))
    pos = np.cumsum(~gap) - 1
    out = np.where(gap | lower, -1, pos)
    if core is not None:
        out = np.where(core, out, -1)
    return out.astype(np.int64)


def _match_chains(msa: Sequence[Tuple[str, str]],
                  chains: Sequence[Chain]) -> Dict[int, Chain]:
    """DALIScorer::SetSeqIdxToChainIdx (src/daliscorer.cpp:134-162):
    an MSA sequence matches a chain iff its UNGAPPED UPPERCASED row
    equals the chain sequence exactly — labels are never consulted, and
    duplicate chain sequences resolve to the LAST loaded chain
    (m_SeqToChainIdx operator[] overwrite, daliscorer.cpp:95).
    Unmatched sequences are simply absent from the result (the
    MissingSeqOk path; strict callers raise on missing keys)."""
    by_seq: Dict[str, Chain] = {}
    for c in chains:
        by_seq[c.seq.upper()] = c  # last wins
    out: Dict[int, Chain] = {}
    for i, (_label, row) in enumerate(msa):
        ungapped = "".join(ch for ch in row if ch not in "-.").upper()
        c = by_seq.get(ungapped)
        if c is not None:
            out[i] = c
    return out


def score_msa(msa_path: str, chains: Sequence[Chain], metric: str = "lddt",
              core: bool = False):
    """All-pairs MSA scoring (cmd_lddt_msa src/lddt_msa.cpp:10-62 /
    cmd_daliscore_msa).  Returns (rows, mean) where rows =
    (label1, label2, value|None)."""
    msa = read_msa_fasta(msa_path)
    rows = [r for _, r in msa]
    core_mask = core_columns(rows) if core else None
    matched = _match_chains(msa, chains)
    maps = [col_to_pos(r, core_mask) for r in rows]
    out = []
    total, count = 0.0, 0
    for i in range(len(msa)):
        for j in range(i + 1, len(msa)):
            li, lj = msa[i][0], msa[j][0]
            if i not in matched or j not in matched:
                out.append((li, lj, None))
                continue
            ci, cj = matched[i], matched[j]
            if metric == "lddt":
                v = lddt_msa_pair(ci, cj, maps[i], maps[j])
                out.append((li, lj, v))
                total += v
            else:
                both = (maps[i] >= 0) & (maps[j] >= 0)
                s = dali_score(ci, cj, maps[i][both], maps[j][both])
                z = dali_z(s, len(ci), len(cj))
                out.append((li, lj, (s, z)))
                total += z
            count += 1
    return out, (total / count if count else 0.0)


# --------------------------------------------------------------------------
# Windowed per-column LDDT (-msta_lddtmuw / -msta_lddtmuw1,
# src/msta_lddtmuw.cpp / src/msta_lddtmuw1.cpp)
# --------------------------------------------------------------------------

_DBL_MAX = float(np.finfo(np.float64).max)


def dist_mx_window(dist: np.ndarray, pos: int, w: int) -> np.ndarray:
    """DALIScorer::GetDistMxWindow (src/msta_lddtmuw1.cpp:72-104):
    (2w+1)x(2w+1) slice of the chain distance matrix centred at pos,
    DBL_MAX outside the chain, 0 diagonal."""
    n = 2 * w + 1
    L = dist.shape[0]
    mx = np.full((n, n), _DBL_MAX)
    np.fill_diagonal(mx, 0.0)
    if pos < 0:  # gap column: UINT_MAX position -> everything off-chain
        return mx
    for i in range(n):
        pi = pos - w + i
        if pi < 0 or pi >= L:
            continue
        for j in range(i + 1, n):
            pj = pos - w + j
            if pj < 0 or pj >= L:
                continue
            mx[i, j] = mx[j, i] = float(dist[pi, pj])
    return mx


def lddt_score_window(mx1: np.ndarray, mx2: np.ndarray, w: int) -> float:
    """DALIScorer::GetLDDTScoreWindow (src/msta_lddtmuw1.cpp:20-70),
    ported VERBATIM including the reference's unsigned-index quirk: the
    inner loop runs `jj` from the UNSIGNED window index i+2 (not the
    signed offset ii+2), so for w=2 exactly one distance pair
    (pos-2, pos+2) is evaluated per window."""
    total = 0.0
    nr_cols = 0
    for ii in range(-w, w + 1):
        i = ii + w
        for jj in range(i + 2, w + 1):
            j = jj + w
            nr_cols += 1
            d1 = mx1[i, j]
            d2 = mx2[i, j]
            if d1 == _DBL_MAX or d2 == _DBL_MAX:
                continue
            if d1 > LDDT_R0:
                continue
            diff = abs(d1 - d2)
            nr_preserved = sum(1 for t in LDDT_THRESHOLDS if diff <= t)
            total += nr_preserved / len(LDDT_THRESHOLDS)
    return total / nr_cols if nr_cols else 0.0


class LddtMuW:
    """Per-column windowed LDDT over an MSA (DALIScorer::GetLDDTMuWCol /
    GetLDDTMuW1).  maps[s][col] = ungapped position or -1; dist matrices
    computed lazily per chain."""

    def __init__(self, msa, matched, maps):
        self.msa = msa
        self.matched = matched
        self.maps = maps
        self._dists = {}

    def _dist(self, s):
        if s not in self._dists:
            self._dists[s] = self.matched[s].dist_matrix().astype(
                np.float64)
        return self._dists[s]

    def col_score(self, col: int, w: int) -> float:
        """GetLDDTMuWCol (src/msta_lddtmuw.cpp:27-65): mean pair window
        score over ALL seq pairs (the reference divides by the full pair
        count, not the number of scored pairs)."""
        n_seq = len(self.msa)
        mxs = {}
        for s in range(n_seq):
            if s not in self.matched:
                continue
            pos = int(self.maps[s][col])
            if pos < 0:
                continue
            mxs[s] = dist_mx_window(self._dist(s), pos, w)
        total = 0.0
        for i in range(n_seq):
            if i not in mxs:
                continue
            for j in range(i + 1, n_seq):
                if j not in mxs:
                    continue
                total += lddt_score_window(mxs[i], mxs[j], w)
        pair_count = n_seq * (n_seq - 1) // 2
        return total / pair_count if pair_count else 0.0

    def query_score(self, q_seq_idx: int, col: int, w: int) -> float:
        """GetLDDTMuW1 (src/msta_lddtmuw1.cpp:106-141): mean window score
        of the query column vs every other present sequence (divides by
        the number actually scored)."""
        pos_q = int(self.maps[q_seq_idx][col])
        q_mx = dist_mx_window(self._dist(q_seq_idx), pos_q, w)
        total, n = 0.0, 0
        for s in range(len(self.msa)):
            if s == q_seq_idx or s not in self.matched:
                continue
            pos = int(self.maps[s][col])
            if pos < 0:
                continue
            total += lddt_score_window(
                q_mx, dist_mx_window(self._dist(s), pos, w), w)
            n += 1
        return total / n if n else 0.0


def lddt_muw_setup(msa_path: str, chains):
    """Shared setup for the msta-lddtmuw commands: MSA rows, label->chain
    match (sequence-identity fallback), per-seq col->pos maps."""
    msa = read_msa_fasta(msa_path)
    rows = [r for _, r in msa]
    matched = _match_chains(msa, chains)
    maps = [col_to_pos(r) for r in rows]
    return LddtMuW(msa, matched, maps)
