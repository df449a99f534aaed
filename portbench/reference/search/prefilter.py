# Frozen copy of reseek_tpu_torch/search/prefilter.py (commit f533a72), the benchmark's plain
# reference: imports renamed; the native path only (its switch and numpy
# fallback left out), built by portbench/reference/build.py.
"""Mu k-mer two-hit-diagonal prefilter for big-DB searches.

Re-designs the reference's MMseqs2-style prefilter
(src/prefiltermu.cpp, src/mudex.cpp, src/mermx.cpp, src/muprefilter.cpp,
src/rankedscoresbag.cpp) as a chunked scan:

  - spaced 5-mers, pattern "1110011" (offsets 0,1,2,5,6), dict 36^5;
    k-mers whose self-score < 36 are masked out on both sides
  - idxq mode (<=100 query chains, src/muprefilter.cpp:70-80): the query
    index is expanded with each query k-mer's score>=36 neighborhood; the
    k-mer itself is indexed twice (direct + own neighborhood,
    src/mudex.cpp:125-176), so one exact target match is already a two-hit
  - idxt mode (>100 queries): the index holds plain query k-mers and each
    target k-mer's neighborhood is enumerated at scan time
  - index layout: kmer-sorted entry arrays + 16-bit prefix finger (memory
    stays proportional to the query set, unlike the reference's 60M-slot
    counting sort); lookups and the two-hit/diagonal-HSP inner loops run
    in native code (native/prefilter.cpp), scanning thousands of targets
    per call across threads
  - diagonals above the 14-bit cap are skipped; diagonals hit >=2 times
    are scored with an ungapped Kadane scan (reset rule of
    src/prefiltermu.cpp:12-48); per (query, target) the best diagonal
    score is kept
  - per-query top-B (1500) target lists (RankedScoresBag); ties at the
    rank-B cutoff are broken by ascending target index (the reference's
    boundary tie set depends on thread scheduling, so any tie-break is
    within its behavior envelope)

The alignment phase (PostMuFilter equivalent) consumes the selected
(query, target) candidate pairs with sensitive parameters.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from portbench.reference import build
from portbench.reference.data.tables import get_tables

PATTERN = "1110011"
OFFSETS = np.array([0, 1, 2, 5, 6], np.int64)
K_SPAN = 7
K = 5
DICT_SIZE = 36 ** 5
MIN_KMER_PAIR_SCORE = 36
RSB_SIZE = 1500
MASK14 = (1 << 14) - 1
MAX_QUERY_CHAINS_FOR_QUERY_NEIGHBORHOOD = 100


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load("prefilter", "-std=c++17", "-pthread")
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i8p = ctypes.POINTER(ctypes.c_int8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.pf_hoods.restype = ctypes.c_int64
    lib.pf_hoods.argtypes = [i64p, ctypes.c_int64, ctypes.c_int32, i8p,
                             i64p, i64p, ctypes.c_int64]
    lib.pf_scan.restype = ctypes.c_int64
    lib.pf_scan.argtypes = [
        u32p, u32p, u16p, u32p, ctypes.c_int64,           # index
        u16p, u8p, i64p, ctypes.c_int32,                  # queries
        u8p, i64p, i32p, ctypes.c_int32,                  # targets
        i8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, u16p, ctypes.c_int64]                 # outputs
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def spaced_kmers(mu_letters: np.ndarray) -> np.ndarray:
    """Spaced 5-mer codes at each start position, int64 [L-6] (first letter
    most significant, src/mudex.cpp:517-537); -1 where the k-mer's
    self-score is below MIN_KMER_PAIR_SCORE."""
    L = len(mu_letters)
    n = L - K_SPAN + 1
    if n <= 0:
        return np.zeros(0, np.int64)
    lets = mu_letters.astype(np.int64)
    cols = np.stack([lets[o: o + n] for o in OFFSETS])  # [5, n]
    kmers = np.zeros(n, np.int64)
    for c in cols:
        kmers = kmers * 36 + c
    s = get_tables().mu_prefilter_mx_int8
    self_diag = np.diag(s).astype(np.int64)
    self_scores = np.zeros(n, np.int64)
    for c in cols:
        self_scores += self_diag[c]
    return np.where(self_scores >= MIN_KMER_PAIR_SCORE, kmers, -1)


def hoods_flat(uniq: np.ndarray, min_score: int = MIN_KMER_PAIR_SCORE
               ) -> Tuple[np.ndarray, np.ndarray]:
    """For each k-mer in `uniq`, every 5-mer with pair score >= min_score
    (GetHighScoringKmers sets, src/mermx.cpp:616).  Returns (flat codes,
    offsets[n+1])."""
    uniq = np.ascontiguousarray(uniq, np.int64)
    lib = _lib()
    mumx = np.ascontiguousarray(get_tables().mu_prefilter_mx_int8, np.int8)
    cap = max(int(len(uniq)) * 4096, 1 << 16)
    offs = np.zeros(len(uniq) + 1, np.int64)
    while True:
        out = np.empty(cap, np.int64)
        n = lib.pf_hoods(_ptr(uniq, ctypes.c_int64), len(uniq),
                         min_score, _ptr(mumx, ctypes.c_int8),
                         _ptr(out, ctypes.c_int64),
                         _ptr(offs, ctypes.c_int64), cap)
        if n < 0:
            raise RuntimeError("pf_hoods: hood overflow")
        if n <= cap:
            return out[:n], offs
        cap = int(n)


class QueryKmerIndex:
    """kmer -> [(query idx, query pos)] sorted-entry index with a 16-bit
    prefix finger; optional query-side neighborhood expansion (the
    reference's MuDex with m_AddNeighborhood, src/mudex.cpp:125-227)."""

    def __init__(self, query_mu: List[np.ndarray],
                 add_neighborhood: bool = True):
        self.n_queries = len(query_mu)
        self.query_mu = query_mu
        self.add_neighborhood = add_neighborhood

        occ_kmer: List[np.ndarray] = []
        occ_qidx: List[np.ndarray] = []
        occ_qpos: List[np.ndarray] = []
        for qi, mu in enumerate(query_mu):
            km = spaced_kmers(mu)
            pos = np.flatnonzero(km >= 0)
            occ_kmer.append(km[pos])
            occ_qidx.append(np.full(len(pos), qi, np.int64))
            occ_qpos.append(pos)
        kmer = (np.concatenate(occ_kmer) if occ_kmer
                else np.zeros(0, np.int64))
        qidx = (np.concatenate(occ_qidx) if occ_qidx
                else np.zeros(0, np.int64))
        qpos = (np.concatenate(occ_qpos) if occ_qpos
                else np.zeros(0, np.int64))

        if add_neighborhood and len(kmer):
            uniq, inv = np.unique(kmer, return_inverse=True)
            flat, offs = hoods_flat(uniq)
            seg_len = (offs[1:] - offs[:-1])[inv] + 1  # hood + direct entry
            starts = offs[:-1][inv]
            total = int(seg_len.sum())
            cum = np.cumsum(seg_len)
            first = cum - seg_len
            pos_in_seg = np.arange(total, dtype=np.int64) - np.repeat(
                first, seg_len)
            # slot 0 of each segment = the k-mer itself, then its hood
            codes = np.empty(total, np.int64)
            direct = pos_in_seg == 0
            codes[direct] = kmer
            codes[~direct] = flat[(np.repeat(starts, seg_len)
                                   + pos_in_seg - 1)[~direct]]
            kmer = codes
            qidx = np.repeat(qidx, seg_len)
            qpos = np.repeat(qpos, seg_len)

        order = np.argsort(kmer, kind="stable")
        self.kmers_sorted = kmer[order].astype(np.uint32)
        self.qidx_sorted = np.ascontiguousarray(qidx[order], np.uint32)
        self.qpos_sorted = np.ascontiguousarray(qpos[order], np.uint16)
        pre = (self.kmers_sorted >> np.uint32(10)).astype(np.int64)
        cnt = np.bincount(pre, minlength=1 << 16)
        self.finger16 = np.zeros((1 << 16) + 1, np.uint32)
        self.finger16[1:] = np.cumsum(cnt, dtype=np.uint64).astype(np.uint32)
        self.qlens = np.array([len(m) for m in query_mu], np.uint16)
        self.qcat = (np.concatenate(query_mu).astype(np.uint8)
                     if query_mu else np.zeros(0, np.uint8))
        self.qoff = np.zeros(len(query_mu) + 1, np.int64)
        self.qoff[1:] = np.cumsum([len(m) for m in query_mu])

@dataclasses.dataclass
class PrefilterResult:
    """Per query: top-B candidate target indices (and diag scores)."""

    query_targets: List[List[Tuple[int, int]]]  # per query [(tidx, score)]

    def target_to_queries(self) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        for qi, lst in enumerate(self.query_targets):
            for tidx, _s in lst:
                out.setdefault(tidx, []).append(qi)
        return out


# The reference's g_CharToLetterMu maps 'K'->11 and 'L'->10 (swapped,
# src/alpha.cpp:3291+ rows 75-76) while Mu FASTA is written with the
# natural 'A'+letter mapping (GetFeatureChar).  The search pipeline
# round-trips QUERY Mu sequences through ASCII (MuSeqSource m_ASCII=true
# + ToLetters) while internally-encoded targets stay numeric — so
# reference queries (and any FASTA-loaded sequences) have letters 10 and
# 11 exchanged.  Replicated here for selection parity.
_KL_SWAP = np.arange(36, dtype=np.uint8)
_KL_SWAP[10], _KL_SWAP[11] = 11, 10

_MU_CHARS = ("ABCDEFGHIJKLMNOPQRSTUVWXYZ" "abcdefghij")


def _swap_kl(mu: np.ndarray) -> np.ndarray:
    return _KL_SWAP[mu]


def mu_from_ascii(seq: str) -> np.ndarray:
    """ASCII Mu sequence -> letters via g_CharToLetterMu semantics
    (natural A..Z a..j positions with the K/L values swapped)."""
    tab = np.full(256, 255, np.uint8)
    for i, c in enumerate(_MU_CHARS):
        tab[ord(c)] = i
    tab[ord("K")], tab[ord("L")] = 11, 10
    lets = tab[np.frombuffer(seq.encode("latin-1"), np.uint8)]
    if (lets == 255).any():
        bad = chr(seq.encode("latin-1")[int(np.argmax(lets == 255))])
        raise ValueError(f"invalid Mu character {bad!r}")
    return lets


def read_mu_fasta(path: str) -> Tuple[List[str], List[np.ndarray]]:
    """Mu-letter FASTA (e.g. from `convert --feature-fasta --alpha Mu`,
    or the reference's -dbmu input, src/search.cpp:96-99)."""
    labels: List[str] = []
    seqs: List[np.ndarray] = []
    cur: List[str] = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if labels:
                    seqs.append(mu_from_ascii("".join(cur)))
                labels.append(line[1:].split()[0] if len(line) > 1 else "")
                cur = []
            elif line:
                cur.append(line)
    if labels:
        seqs.append(mu_from_ascii("".join(cur)))
    return labels, seqs


class RankedScoresBag:
    """Per-query top-B target selection (src/rankedscoresbag.cpp) over
    accumulated (query, target, score) chunks.

    Memory is bounded like the reference's lazy 2B truncation
    (rankedscoresbag.h:23): once the accumulated rows exceed a
    compaction threshold, each query's list is cut to its top-B (score
    desc, tidx asc — same order as finish(), so compaction never changes
    the final selection)."""

    COMPACT_ROWS = 1 << 22

    def __init__(self, n_queries: int, top_b: int = RSB_SIZE):
        self.n_queries = n_queries
        self.top_b = top_b
        self._q: List[np.ndarray] = []
        self._t: List[np.ndarray] = []
        self._s: List[np.ndarray] = []
        self._rows = 0

    def add_chunk(self, q: np.ndarray, t: np.ndarray,
                  s: np.ndarray) -> None:
        if len(q):
            self._q.append(np.asarray(q, np.int64))
            self._t.append(np.asarray(t, np.int64))
            self._s.append(np.asarray(s, np.int64))
            self._rows += len(q)
            if (self._rows > self.COMPACT_ROWS
                    and self._rows > 2 * self.top_b * self.n_queries):
                self._compact()

    def _sorted_topb(self):
        """(q, t, s) concatenated, ordered (q asc, score desc, tidx asc)
        and cut to top-B per query."""
        q = np.concatenate(self._q)
        t = np.concatenate(self._t)
        s = np.concatenate(self._s)
        order = np.lexsort((t, -s, q))
        q, t, s = q[order], t[order], s[order]
        starts = np.searchsorted(q, np.arange(self.n_queries))
        ends = np.searchsorted(q, np.arange(self.n_queries), "right")
        keep = np.zeros(len(q), bool)
        for qi in range(self.n_queries):
            a = int(starts[qi])
            b = min(int(ends[qi]), a + self.top_b)
            keep[a:b] = True
        return q[keep], t[keep], s[keep]

    def _compact(self) -> None:
        q, t, s = self._sorted_topb()
        self._q, self._t, self._s = [q], [t], [s]
        self._rows = len(q)

    def finish(self) -> PrefilterResult:
        out: List[List[Tuple[int, int]]] = [
            [] for _ in range(self.n_queries)]
        if self._q:
            q, t, s = self._sorted_topb()
            starts = np.searchsorted(q, np.arange(self.n_queries))
            ends = np.searchsorted(q, np.arange(self.n_queries), "right")
            for qi in range(self.n_queries):
                a, b = int(starts[qi]), int(ends[qi])
                out[qi] = [(int(t[i]), int(s[i])) for i in range(a, b)]
        return PrefilterResult(query_targets=out)


class MuPrefilter:
    """Streaming prefilter: feed target chunks, then finish() for the
    per-query top-B lists.  Queries are Mu letter arrays that have already
    had the reference's ASCII round-trip applied where appropriate
    (see search drivers)."""

    def __init__(self, query_mu: List[np.ndarray],
                 mode: Optional[str] = None, top_b: int = RSB_SIZE,
                 threads: int = 0, ascii_roundtrip: bool = True):
        if mode is None:
            mode = ("idxq" if len(query_mu)
                    <= MAX_QUERY_CHAINS_FOR_QUERY_NEIGHBORHOOD else "idxt")
        # "exact": no neighborhoods on either side — the reference's
        # standalone -prefilter_mu command (src/cmd_prefiltermu.cpp:50-80,
        # MuDex m_AddNeighborhood defaults false there)
        if mode not in ("idxq", "idxt", "exact"):
            raise ValueError(f"bad prefilter mode {mode!r}")
        if ascii_roundtrip:
            query_mu = [_swap_kl(np.asarray(m, np.uint8)) for m in query_mu]
        else:
            query_mu = [np.asarray(m, np.uint8) for m in query_mu]
        self.mode = mode
        self.idxt = mode == "idxt"
        self.index = QueryKmerIndex(query_mu,
                                    add_neighborhood=(mode == "idxq"))
        self.query_mu = query_mu
        self.top_b = top_b
        self.threads = threads if threads > 0 else (os.cpu_count() or 1)
        self.s = get_tables().mu_prefilter_mx_int8
        self.bag = RankedScoresBag(len(query_mu), top_b)
        self._mumx = np.ascontiguousarray(self.s, np.int8)

    def add_targets(self, t_mu_list: Sequence[np.ndarray],
                    tids: Sequence[int]) -> None:
        if not len(t_mu_list):
            return
        lib = _lib()
        tcat = np.concatenate([np.asarray(m, np.uint8) for m in t_mu_list])
        toff = np.zeros(len(t_mu_list) + 1, np.int64)
        toff[1:] = np.cumsum([len(m) for m in t_mu_list])
        tids_arr = np.ascontiguousarray(tids, np.int32)
        idx = self.index
        cap = max(len(t_mu_list) * 64, 1 << 16)
        while True:
            out_q = np.empty(cap, np.int32)
            out_t = np.empty(cap, np.int32)
            out_s = np.empty(cap, np.uint16)
            n = lib.pf_scan(
                _ptr(idx.kmers_sorted, ctypes.c_uint32),
                _ptr(idx.qidx_sorted, ctypes.c_uint32),
                _ptr(idx.qpos_sorted, ctypes.c_uint16),
                _ptr(idx.finger16, ctypes.c_uint32),
                len(idx.kmers_sorted),
                _ptr(idx.qlens, ctypes.c_uint16),
                _ptr(idx.qcat, ctypes.c_uint8),
                _ptr(idx.qoff, ctypes.c_int64), idx.n_queries,
                _ptr(tcat, ctypes.c_uint8), _ptr(toff, ctypes.c_int64),
                _ptr(tids_arr, ctypes.c_int32), len(t_mu_list),
                _ptr(self._mumx, ctypes.c_int8),
                1 if self.idxt else 0, MIN_KMER_PAIR_SCORE, self.threads,
                _ptr(out_q, ctypes.c_int32), _ptr(out_t, ctypes.c_int32),
                _ptr(out_s, ctypes.c_uint16), cap)
            if n >= 0:
                self.bag.add_chunk(out_q[:n], out_t[:n], out_s[:n])
                return
            cap = int(-n)

    def finish(self) -> PrefilterResult:
        return self.bag.finish()


def prefilter_search(query_mu: List[np.ndarray],
                     target_mu_iter: Iterable[Tuple[int, np.ndarray]],
                     top_b: int = RSB_SIZE,
                     mode: Optional[str] = None,
                     chunk: int = 4096,
                     ascii_roundtrip: bool = True) -> PrefilterResult:
    """Run the full prefilter over an (index, mu_letters) target stream.

    ascii_roundtrip=True mirrors the production -search pipeline where
    QUERY Mu letters round-trip through ASCII (K/L swap) while targets
    stay numeric; pass False when BOTH sides come from Mu FASTA (the
    standalone -prefilter_mu command), where both are already in
    g_CharToLetterMu space and no extra swap must be applied."""
    pf = MuPrefilter(query_mu, top_b=top_b, mode=mode,
                     ascii_roundtrip=ascii_roundtrip)
    buf_mu: List[np.ndarray] = []
    buf_ti: List[int] = []
    for tidx, t_mu in target_mu_iter:
        buf_mu.append(np.asarray(t_mu, np.uint8))
        buf_ti.append(tidx)
        if len(buf_mu) >= chunk:
            pf.add_targets(buf_mu, buf_ti)
            buf_mu, buf_ti = [], []
    if buf_mu:
        pf.add_targets(buf_mu, buf_ti)
    return pf.finish()
