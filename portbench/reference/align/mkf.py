# Frozen copy of reseek_tpu_torch/align/mkf.py (commit f533a72), the benchmark's plain
# reference: imports renamed; the native path only (the port's Python MKF
# left out): align_mkf and should_use_mkf.
"""Mu k-mer filter (MKF) seeded alignment path for long chains, the
reference's long-chain route (src/mukmerfilter.cpp, src/chainer.cpp,
src/xdrophsp.cpp, src/xdropfwd.cpp, src/xdropbwd.cpp,
src/mergefwdback.cpp), in native C++ (native/mkf.cpp):

  1. query Mu 3-mers -> hash table with up to HASHW=4 positions per k-mer
  2. target k-mer hits -> ungapped +/- x-drop diagonal extension (int8 Mu
     scores, X1=8), keep HSPs with score >= 50 that improve the best
  3. 1-D chaining of HSP query intervals (classic sweep DP)
  4. re-score chained HSPs with the full multi-feature profile; reject if
     total < MinMegaHSPScore; else banded gapped x-drop (X2=8) around the
     best HSP's best 8-mer, fwd+bwd merged
"""

from __future__ import annotations

from portbench.reference.align.pipeline import AlignResult, EncodedChain
from portbench.reference.constants import DSSParams


def align_mkf(q: EncodedChain, t: EncodedChain,
              params: DSSParams) -> AlignResult:
    """Full MKF route: AlignMKF + PostAlignMKF
    (src/dssaligner.cpp:1387-1437)."""
    from portbench.reference.align.finish import finish_result
    from portbench.reference.align.mkf_native import align_mkf_native
    score, lo_a, lo_b, path, best_hsp, best_chain = align_mkf_native(
        q, t, params)
    res = AlignResult(query=q.label, target=t.label, fwd_score=score,
                      lo_a=lo_a, lo_b=lo_b, path=path,
                      best_hsp_score=best_hsp, best_chain_score=best_chain)
    if path:
        finish_result(res, q, t, params)
    return res


def should_use_mkf(q: EncodedChain, t: EncodedChain,
                   params: DSSParams) -> bool:
    """DoMKF (src/dssaligner.cpp:715-732)."""
    if len(q.mu_kmers) == 0 or len(t.mu_kmers) == 0:
        return False
    return len(q) >= params.mkfl or len(t) >= params.mkfl
