# Frozen copy of reseek_tpu_torch/align/pipeline.py (commit f533a72), the benchmark's plain
# reference: imports renamed; the native SW only (the port's switch and
# numpy fallbacks left out).
"""Per-pair alignment pipeline: Mu filter -> substitution profile SW ->
test statistic -> P-value.  Mirrors DSSAligner (src/dssaligner.cpp) with
exact float32 semantics, one pair at a time.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from portbench.reference.chain import Chain
from portbench.reference.constants import (DSSParams, StatSig, TS_DP_WEIGHT,
                                  TS_L_ADD, TS_LDDT_WEIGHT, TS_REV_WEIGHT)
from portbench.reference.encoder.dss import DSSEncoding, encode_chain, mu_kmers
from portbench.reference.ops.lddt import lddt_mu_fast
from portbench.reference.ops.sw_native import (sw_align_profile_native,
                                               sw_score_letters_native,
                                               sw_score_profile_native)

FLT_MAX = float(np.finfo(np.float32).max)

# parasail 8-bit saturation: the striped kernel tracks the biased int8
# running max and flags SATURATED once it exceeds maxp = INT8_MAX -
# (matrix_max + 1) (src/parasail.cpp:585,731: bias INT8_MIN, matrix max 4),
# i.e. once the true score exceeds 250, and then returns INT8_MAX - bias
# = 255.  The reference rewrites the FWD score to 777
# (src/parasail_mu.cpp:135-139) but reads the REV score before its 777
# assignment (src/parasail_mu.cpp:152-156), so a saturated rev stays 255.
MU_SAT_LIMIT = 250.0
MU_SAT_SCORE = 777.0      # forced fwd score on saturation
MU_SAT_REV_SCORE = 255.0  # saturated rev keeps parasail's clamped value


@dataclasses.dataclass
class EncodedChain:
    """Per-chain state bundle — the reference's ChainBag (src/chainbag.h)."""

    chain: Chain
    enc: DSSEncoding
    profile: np.ndarray          # uint8 [F, L]
    mu_letters: np.ndarray       # uint8 [L]
    mu_kmers: np.ndarray         # int64
    self_rev_score: float = FLT_MAX

    @property
    def label(self) -> str:
        return self.chain.label

    def __len__(self) -> int:
        return len(self.chain)


def encode_for_search(chain: Chain, params: DSSParams,
                      with_self_rev: bool = True) -> EncodedChain:
    """Encode + profile + Mu letters/kmers + self-reversal score, like
    ProfileLoader (src/profileloader.cpp:50-60)."""
    enc = encode_chain(chain)
    ec = EncodedChain(
        chain=chain,
        enc=enc,
        profile=enc.profile(params),
        mu_letters=enc.mu_letters,
        mu_kmers=mu_kmers(enc.mu_letters, params.mkf_pattern),
    )
    if with_self_rev:
        ec.self_rev_score = self_rev_score(ec, params)
    return ec


def self_rev_score(ec: EncodedChain, params: DSSParams) -> float:
    """Full SW of the chain against its own reversal (the reversed chain is
    re-encoded: DSS features are not reversal-symmetric).
    Reference: GetSelfRevScore (src/alignpair.cpp:7-25) with Omega=0; note
    chains >= MKFL take the MKF route here too (profileloader.cpp passes
    Mu k-mers, so DoMKF applies)."""
    rev = ec.chain.reversed()
    rev_enc = encode_chain(rev)
    rev_profile = rev_enc.profile(params)
    if len(ec) >= params.mkfl and len(ec.mu_kmers) > 0:
        from portbench.reference.align.mkf import align_mkf
        # Reference quirk (src/alignpair.cpp:20-22): the reversed TARGET is
        # given the FORWARD chain's Mu letters/k-mers, so the k-mer stage
        # chains the trivial self-diagonal while the mega re-score uses the
        # reversed profile — which nearly always rejects, giving ~0.
        rev_ec = EncodedChain(
            chain=rev, enc=rev_enc, profile=rev_profile,
            mu_letters=ec.mu_letters,
            mu_kmers=ec.mu_kmers)
        return align_mkf(ec, rev_ec, params).fwd_score
    return max(sw_score_profile_native(params, ec.profile, rev_profile),
               0.0)


@dataclasses.dataclass
class AlignResult:
    query: str
    target: str
    fwd_score: float = 0.0
    lo_a: int = 0
    lo_b: int = 0
    hi_a: int = 0
    hi_b: int = 0
    path: str = ""
    ids: int = 0
    gaps: int = 0
    lddt: float = 0.0
    ts: float = -FLT_MAX           # NewTestStatistic (newts column)
    old_ts: float = -FLT_MAX       # old TestStatistic: never set by the
                                   # standard pipeline (ts column,
                                   # src/dssaligner.cpp:907-928)
    pvalue: float = FLT_MAX
    evalue: float = FLT_MAX
    qual: float = 0.0
    mu_score: float = 0.0
    best_hsp_score: int = 0        # MKF m_BestHSPScore (muhsp column)
    best_chain_score: int = 0      # MKF m_BestChainScore (muchain column)
    global_score: float = -9999.0  # -global Viterbi score (gscore column)

    @property
    def cols(self) -> int:
        return len(self.path)


import functools


@functools.lru_cache(maxsize=1)
def _mu_mx_f32() -> np.ndarray:
    from portbench.reference.data.tables import get_tables
    return np.ascontiguousarray(
        get_tables().mu_score_mx_int8.astype(np.float32))


def _mu_sw_score(a: np.ndarray, b: np.ndarray, open_: float,
                 ext: float) -> float:
    """Mu-letter SW score (parasail recurrences), integer-exact."""
    return sw_score_letters_native(a, b, _mu_mx_f32(), open_, ext)


class PairAligner:
    """Pair alignment state machine (reference DSSAligner,
    src/dssaligner.cpp:793-945)."""

    def __init__(self, params: DSSParams):
        self.params = params
        self.n_aligned = 0
        self.n_mu_input = 0
        self.n_mu_discarded = 0

    # ---- Mu filter (Omega gate) -------------------------------------

    def mu_filter_score(self, q: EncodedChain, t: EncodedChain) -> float:
        """fwd SW on Mu letters; if fwd < OmegaFwd -> 0; else fwd - rev
        (src/parasail_mu.cpp:120-161, gap open 2 / ext 1; every mode
        preset uses parasail, use_para)."""
        p = self.params
        open_, ext = -float(p.para_mu_gap_open), -float(p.para_mu_gap_ext)
        fwd = _mu_sw_score(q.mu_letters, t.mu_letters, open_, ext)
        if fwd > MU_SAT_LIMIT:
            fwd = MU_SAT_SCORE
        if fwd < p.omega_fwd:
            return 0.0
        rev = _mu_sw_score(q.mu_letters[::-1], t.mu_letters, open_, ext)
        if rev > MU_SAT_LIMIT:
            rev = MU_SAT_REV_SCORE
        return fwd - rev

    def mu_filter(self, q: EncodedChain, t: EncodedChain) -> bool:
        p = self.params
        if p.omega <= 0:
            return True
        self.n_mu_input += 1
        score = self.mu_filter_score(q, t)
        if score < p.omega:
            self.n_mu_discarded += 1
            return False
        return True

    # ---- Full alignment ---------------------------------------------

    def align(self, q: EncodedChain, t: EncodedChain,
              apply_filter: bool = True) -> Optional[AlignResult]:
        """AlignQueryTarget (src/dssaligner.cpp:793-831).  Returns None when
        the pair is rejected by the Mu filter.  Long chains route through
        the MKF seeded path, bypassing the Mu filter."""
        from portbench.reference.align.mkf import align_mkf, should_use_mkf
        if should_use_mkf(q, t, self.params):
            return align_mkf(q, t, self.params)
        self.n_aligned += 1
        mu_score = 0.0
        if apply_filter:
            p = self.params
            if p.omega > 0:
                self.n_mu_input += 1
                mu_score = self.mu_filter_score(q, t)
                if mu_score < p.omega:
                    self.n_mu_discarded += 1
                    return None
        res = self.align_no_accel(q, t)
        res.mu_score = mu_score
        return res

    def align_no_accel(self, q: EncodedChain,
                       t: EncodedChain) -> AlignResult:
        p = self.params
        score, lo_a, lo_b, path = sw_align_profile_native(p, q.profile,
                                                          t.profile)
        res = AlignResult(query=q.label, target=t.label, fwd_score=score,
                          lo_a=lo_a, lo_b=lo_b, path=path)
        self.calc_evalue(res, q, t)
        return res

    # ---- Significance -----------------------------------------------

    def calc_evalue(self, res: AlignResult, q: EncodedChain,
                    t: EncodedChain) -> None:
        """TS/P/E computation (src/dssaligner.cpp:852-904), float32 ops in
        the reference's order."""
        p = self.params
        if res.fwd_score < p.min_fwd_score:
            return

        n_m = res.path.count("M")
        n_d = res.path.count("D")
        n_i = res.path.count("I")
        res.hi_a = res.lo_a + n_m + n_d - 1
        res.hi_b = res.lo_b + n_m + n_i - 1
        res.ids = n_m
        res.gaps = n_d + n_i

        pos_q, pos_t = _path_positions(res.lo_a, res.lo_b, res.path)
        res.lddt = lddt_mu_fast(q.chain.coords, t.chain.coords, pos_q, pos_t)

        sa, sb = q.self_rev_score, t.self_rev_score
        if sa != FLT_MAX and sb != FLT_MAX:
            rev_dp = np.float32(np.float32(sa) + np.float32(sb)) / np.float32(2)
        else:
            rev_dp = np.float32(0.0)

        la, lb = len(q), len(t)
        res.ts = float(_ts_value(np.float32(res.lddt),
                                 np.float32(res.fwd_score), rev_dp, la, lb))
        res.pvalue = StatSig.pvalue(res.ts)
        res.evalue = StatSig.evalue(res.ts)
        res.qual = StatSig.qual(res.ts)


def _ts_value(lddt, fwd, rev_dp, la, lb):
    """TS in the float32 op order of the compiled reference
    (src/dssaligner.cpp:883-889 with GCC FMA contraction, see fp.py):
      num = fms(dpw, fwd, f32(revtsw*rev_dp)); q = num/(L+ladd);
      ts  = fma(lddtw, lddt, q).  Vectorized over numpy arrays."""
    from portbench.reference.fp import fma32, fms32
    f32 = np.float32
    L = (np.asarray(la, f32) + np.asarray(lb, f32)).astype(f32) / f32(2)
    num = fms32(f32(TS_DP_WEIGHT), fwd,
                (f32(TS_REV_WEIGHT) * np.asarray(rev_dp, f32)).astype(f32))
    q = (num / (L + f32(TS_L_ADD)).astype(f32)).astype(f32)
    return fma32(f32(TS_LDDT_WEIGHT), lddt, q)


def _path_positions(lo_a: int, lo_b: int, path: str):
    pos_q, pos_t = [], []
    a, b = lo_a, lo_b
    for c in path:
        if c == "M":
            pos_q.append(a)
            pos_t.append(b)
            a += 1
            b += 1
        elif c == "D":
            a += 1
        else:
            b += 1
    return np.asarray(pos_q, np.int64), np.asarray(pos_t, np.int64)
