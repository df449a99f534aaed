"""Frozen copy of the per-pair host search of reseek_tpu_torch/search/
host.py (commit f533a72): the emit rules of ``SearchDriver``, the encode of
``_encode_all``, the all-vs-all pair order of ``self_search`` and the -fast
stage 2 of ``_fast_align_host``.  Cut to what the benchmark's reference
runs (no -global, -aln, trace or run statistics); the rest is as copied,
imports renamed."""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, TextIO

from portbench.reference.align.output import format_row
from portbench.reference.align.pipeline import (FLT_MAX as _FLT_MAX,
                                                AlignResult, EncodedChain,
                                                PairAligner,
                                                encode_for_search,
                                                self_rev_score)
from portbench.reference.constants import DSSParams


@dataclasses.dataclass
class SearchOptions:
    columns: List[str]
    max_evalue: float = 10.0     # DBSearcher::m_MaxEvalue default
    no_self: bool = False
    mode: str = "sensitive"
    scores_are_not_evalues: bool = False  # disable the E-value gate
                                          # (src/dbsearcher.cpp:260)


class SearchDriver:
    def __init__(self, params: DSSParams, options: SearchOptions,
                 out: TextIO):
        self.params = params
        self.options = options
        self.out = out
        self.aligner = PairAligner(params)
        self.hit_count = 0

    def _reject(self, res: AlignResult) -> bool:
        if self.options.scores_are_not_evalues:
            return False
        return res.evalue > self.options.max_evalue

    def emit(self, res: AlignResult, q: EncodedChain, t: EncodedChain,
             up: bool) -> None:
        if self._reject(res):
            return
        if self.options.no_self and q.label == t.label:
            return
        self.hit_count += 1
        self.out.write(format_row(self.options.columns, res, q, t, up))
        self.out.write("\n")


def _encode_all(chains, params: DSSParams,
                with_self_rev: bool) -> List[EncodedChain]:
    """Encode chains for search on a thread pool (the native encoder
    releases the GIL)."""
    def one(c):
        if isinstance(c, EncodedChain):
            if with_self_rev and c.self_rev_score == _FLT_MAX:
                c.self_rev_score = self_rev_score(c, params)
            return c
        return encode_for_search(c, params, with_self_rev=with_self_rev)

    chains = list(chains)
    if len(chains) < 8:
        return [one(c) for c in chains]
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 2) as tp:
        return list(tp.map(one, chains))


def self_search_pairs(ecs: List[EncodedChain]):
    """The all-vs-all's pairs in the order self_search aligns and emits
    them (src/runself.cpp): (i, j >= i) ascending."""
    n = len(ecs)
    return [(i, j) for i in range(n) for j in range(i, n)]


def emit_pair(drv: SearchDriver, ecs: List[EncodedChain], i: int, j: int,
              res: Optional[AlignResult]) -> None:
    """self_search's emit of pair (i, j): nothing without a path, the self
    pair once, other pairs Up then Down."""
    if res is None or not res.path:
        return
    if drv.options.no_self and i == j:
        return
    drv.emit(res, ecs[i], ecs[j], True)
    if i != j:
        drv.emit(res, ecs[i], ecs[j], False)


def _fast_align_host(drv: SearchDriver, q_ecs: List[EncodedChain],
                     survivor_iter, t2q, sens: DSSParams) -> None:
    """Stage 2 on the native host kernels, parallel over targets like the
    reference's PostMuFilter ChainBag scan (src/postmufilter.cpp:116-208):
    each worker encodes its target, computes its self-rev and aligns it
    against the listed queries (native SW/MKF/LDDT release the GIL);
    emission stays in ascending-target order."""
    for ec in q_ecs:
        if ec.self_rev_score == _FLT_MAX:
            ec.self_rev_score = self_rev_score(ec, sens)

    def process(item):
        tidx, c = item
        t_ec = (c if isinstance(c, EncodedChain)
                else encode_for_search(c, sens))
        if t_ec.self_rev_score == _FLT_MAX:
            t_ec.self_rev_score = self_rev_score(t_ec, sens)
        pa = PairAligner(sens)  # per-task: no shared-counter races
        rows = []
        for qi in t2q[tidx]:
            res = pa.align(q_ecs[qi], t_ec)
            if res is not None and res.path:
                rows.append((qi, res))
        return t_ec, rows, pa

    n_workers = min(32, (os.cpu_count() or 2))
    with ThreadPoolExecutor(max_workers=n_workers) as pool:
        for t_ec, rows, pa in pool.map(process, survivor_iter):
            for qi, res in rows:
                drv.emit(res, q_ecs[qi], t_ec, True)
