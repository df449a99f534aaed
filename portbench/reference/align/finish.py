"""LDDT and TS/P/E of a host alignment with a path: frozen copy of
``finish_result`` and ``_finish_from_lddt`` of
reseek_tpu_torch/search/engine.py (commit f533a72), the MKF route's finish,
without the device engine around them."""

from __future__ import annotations

import numpy as np

from portbench.reference.align.pipeline import (FLT_MAX, AlignResult,
                                                EncodedChain,
                                                _path_positions, _ts_value)
from portbench.reference.constants import DSSParams, StatSig
from portbench.reference.ops.lddt import lddt_mu_fast


def _finish_from_lddt(res: AlignResult, q: EncodedChain, t: EncodedChain,
                      p: DSSParams, lddt: float) -> None:
    """TS/P/E from a precomputed LDDT, float32 order of
    src/dssaligner.cpp:852-904."""
    n_m = res.path.count("M")
    n_d = res.path.count("D")
    n_i = res.path.count("I")
    res.hi_a = res.lo_a + n_m + n_d - 1
    res.hi_b = res.lo_b + n_m + n_i - 1
    res.ids = n_m
    res.gaps = n_d + n_i
    res.lddt = lddt
    sa, sb = q.self_rev_score, t.self_rev_score
    if sa != FLT_MAX and sb != FLT_MAX:
        rev_dp = np.float32(np.float32(sa) + np.float32(sb)) / np.float32(2)
    else:
        rev_dp = np.float32(0.0)
    res.ts = float(_ts_value(np.float32(res.lddt),
                             np.float32(res.fwd_score), rev_dp,
                             len(q), len(t)))
    res.pvalue = StatSig.pvalue(res.ts)
    res.evalue = StatSig.evalue(res.ts)
    res.qual = StatSig.qual(res.ts)


def finish_result(res: AlignResult, q: EncodedChain, t: EncodedChain,
                  p: DSSParams) -> None:
    """LDDT and TS/P/E of a host alignment with a path (the MKF route's
    finish)."""
    if res.fwd_score < p.min_fwd_score:
        return
    pos_q, pos_t = _path_positions(res.lo_a, res.lo_b, res.path)
    lddt = lddt_mu_fast(q.chain.coords, t.chain.coords, pos_q, pos_t)
    _finish_from_lddt(res, q, t, p, lddt)
