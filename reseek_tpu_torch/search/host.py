"""The host engine: the per-pair search drivers on the native host
kernels, copied from reseek_tpu/search/driver.py without its device
branches.

Host reference implementation mirroring DBSearcher semantics
(src/dbsearcher.cpp, src/runself.cpp, src/runquery.cpp): pair enumeration,
E-value acceptance, dual-orientation output rows.  search/driver.py runs
it on ``engine="host"``, and the device engine (search/engine.py) is held
to it byte for byte.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Iterable, List, Optional, TextIO

from reseek_tpu_torch.align.output import format_row
from reseek_tpu_torch.align.pipeline import (FLT_MAX as _FLT_MAX,
                                             AlignResult, EncodedChain,
                                             PairAligner, encode_for_search)
from reseek_tpu_torch.chain import Chain
from reseek_tpu_torch.constants import DSSParams


@dataclasses.dataclass
class SearchOptions:
    columns: List[str]
    max_evalue: float = 10.0     # DBSearcher::m_MaxEvalue default
    no_self: bool = False
    mode: str = "sensitive"
    global_aln: bool = False     # -global (src/runself.cpp:48-56)
    scores_are_not_evalues: bool = False  # disable the E-value gate
                                          # (src/dbsearcher.cpp:260)
    aln_out: Optional[TextIO] = None      # -aln pretty blocks
                                          # (src/prettyaln.cpp:27-99)
    trace_labels: Optional[tuple] = None  # -label1/-label2 per-pair
                                          # explain (dssaligner.cpp:734-791)


class SearchDriver:
    def __init__(self, params: DSSParams, options: SearchOptions,
                 out: TextIO = sys.stdout):
        import time
        self.params = params
        self.options = options
        self.out = out
        self.aligner = PairAligner(params)
        self.hit_count = 0
        self.processed_pairs = 0
        self.query_count = 0
        self.t0 = time.time()

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
        if self.options.aln_out is not None:
            from reseek_tpu_torch.align.prettyaln import pretty_aln
            pretty_aln(self.options.aln_out, res, q, t, up)

    def run_stats(self, n_threads: int = 1) -> None:
        """End-of-run stats (DBSearcher::RunStats, src/dbsearcher.cpp:29-56
        + DSSAligner::Stats, src/dssaligner.cpp:1088-1098)."""
        import time

        from reseek_tpu_torch.utils.logger import (get_logger, int_to_str,
                                             secs_to_hhmmss)
        lg = get_logger()
        secs = max(time.time() - self.t0, 1.0)
        pairs_per_sec = self.processed_pairs / secs
        lg.progress_log("\n")
        lg.progress_log("%10.10s  Search time\n" % secs_to_hhmmss(secs))
        if self.options.max_evalue == float("inf"):
            lg.progress_log("%10.10s  Hits\n" % int_to_str(self.hit_count))
        else:
            lg.progress_log("%10.10s  Hits (max E-value %.3g)\n"
                            % (int_to_str(self.hit_count),
                               self.options.max_evalue))
        if self.query_count:
            lg.progress_log("%10.10s  Query chains\n"
                            % int_to_str(self.query_count))
            lg.progress_log("%10.1f  Chains/sec\n"
                            % (self.query_count / secs))
        lg.progress_log("%10.10s  Comparisons/sec\n"
                        % int_to_str(int(pairs_per_sec)))
        if n_threads > 1:
            lg.progress_log(
                "%10.10s  Comparisons/sec/thread (%u threads)\n"
                % (int_to_str(int(pairs_per_sec / n_threads)), n_threads))
        a = self.aligner
        lg.log("DSSAligner::Stats() alns %d, mufil %d/%d %.1f%%\n"
               % (a.n_aligned, a.n_mu_input, a.n_mu_discarded,
                  100.0 * a.n_mu_discarded / a.n_mu_input
                  if a.n_mu_input else 0.0))

    def trace_pair(self, q: EncodedChain, t: EncodedChain) -> None:
        """-label1/-label2 explain mode (AlignQueryTarget_Trace,
        src/dssaligner.cpp:734-791): logs the per-pair routing, filter
        decisions, scores and path prefix for one chain pair."""
        from reseek_tpu_torch.align.mkf import should_use_mkf
        from reseek_tpu_torch.utils.logger import get_logger
        lg = get_logger()
        lg.log("\n______________________________________\n")
        lg.log("A>%s(%u)\n" % (q.label, len(q)))
        lg.log("B>%s(%u)\n" % (t.label, len(t)))
        p = self.params
        if should_use_mkf(q, t, p):
            lg.log("DoMKF()=true\n")
            res = self.aligner.align(q, t)
            lg.log("m_BestChainScore=%d\n" % res.best_chain_score)
            lg.log("AlnFwdScore=%.3g\n" % res.fwd_score)
        else:
            if p.omega > 0:
                lg.log("Omega > 0\n")
                score = self.aligner.mu_filter_score(q, t)
                ok = score >= p.omega
                lg.log("MuFilterScore=%.3g\n" % score)
                lg.log("MuFilterOk=%c\n" % ("T" if ok else "F"))
                if not ok:
                    return
            res = self.aligner.align(q, t, apply_filter=False)
            lg.log("AlnFwdScore=%.3g\n" % res.fwd_score)
        e = res.evalue
        lg.log("EvalueA=%.3g\n" % e if e > 1e5 else "EvalueA=%.1f\n" % e)
        lg.log("Path=(%u)%.10s...\n" % (len(res.path), res.path))

    def align_and_emit(self, q: EncodedChain, t: EncodedChain,
                      both_orientations: bool = True) -> Optional[AlignResult]:
        res = self.aligner.align(q, t)
        if res is None or not res.path:
            return res
        self.emit(res, q, t, True)
        if both_orientations:
            self.emit(res, q, t, False)
        return res


def self_search(chains: List[Chain], params: DSSParams,
                options: SearchOptions, out: TextIO) -> SearchDriver:
    """All-vs-all (src/runself.cpp): pairs (i, j >= i), self pair emitted
    once, other pairs in both orientations, on the per-pair host path;
    -global runs the host global path."""
    if options.global_aln:
        return _self_search_global(chains, params, options, out)
    ecs = _encode_all(chains, params, with_self_rev=True)
    drv = SearchDriver(params, options, out)
    n = len(ecs)
    drv.query_count = n
    _maybe_trace(drv, ecs, options)
    for i in range(n):
        for j in range(i, n):
            if options.no_self and i == j:
                continue
            drv.processed_pairs += 1
            drv.align_and_emit(ecs[i], ecs[j], both_orientations=(i != j))
    return drv


def _encode_all(chains, params: DSSParams,
                with_self_rev: bool) -> List[EncodedChain]:
    """Encode chains for search; pre-encoded EncodedChains (e.g. loaded
    from an .rsdx artifact, io/artifact.py) pass through with only the
    missing self-rev scores computed (the artifact's -dbmu-and-more role,
    src/search.cpp:96-99)."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from reseek_tpu_torch.align.pipeline import FLT_MAX, self_rev_score

    def one(c):
        if isinstance(c, EncodedChain):
            if with_self_rev and c.self_rev_score == FLT_MAX:
                c.self_rev_score = self_rev_score(c, params)
            return c
        return encode_for_search(c, params, with_self_rev=with_self_rev)

    chains = list(chains)
    if len(chains) < 8:
        return [one(c) for c in chains]
    # the native encoder releases the GIL inside its ctypes call, so a
    # thread pool uses all host cores (reference: all-core OpenMP encode)
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 2) as tp:
        return list(tp.map(one, chains))


def _maybe_trace(drv: SearchDriver, ecs: List[EncodedChain],
                 options: SearchOptions) -> None:
    """-label1/-label2: log the one-pair pipeline trace when both labels
    are present (src/dssaligner.cpp:793-807)."""
    if not options.trace_labels:
        return
    l1, l2 = options.trace_labels
    by_label = {ec.label: ec for ec in ecs}
    if l1 in by_label and l2 in by_label:
        drv.trace_pair(by_label[l1], by_label[l2])


def _self_search_global(chains: List[Chain], params: DSSParams,
                        options: SearchOptions, out: TextIO) -> SearchDriver:
    """-global all-vs-all (src/runself.cpp:48-56 +
    AlignQueryTarget_Global, src/global.cpp:7-33): Mu filter, then global
    Viterbi with free terminal gaps; no E-value is computed, so rows are
    only emitted with scores_are_not_evalues."""
    from reseek_tpu_torch.ops.nw import nw_align
    from reseek_tpu_torch.ops.substmx import build_smx
    ecs = [encode_for_search(c, params, with_self_rev=False)
           for c in chains]
    drv = SearchDriver(params, options, out)
    n = len(ecs)
    for i in range(n):
        for j in range(i, n):
            if options.no_self and i == j:
                continue
            q, t = ecs[i], ecs[j]
            if params.omega > 0 and not drv.aligner.mu_filter(q, t):
                continue
            smx = build_smx(params, q.profile, t.profile)
            score, path = nw_align(smx)
            if not path:
                continue
            res = AlignResult(query=q.label, target=t.label,
                              fwd_score=0.0, lo_a=0, lo_b=0, path=path,
                              global_score=score)
            n_m = path.count("M")
            res.hi_a = res.lo_a + n_m + path.count("D") - 1
            res.hi_b = res.lo_b + n_m + path.count("I") - 1
            res.ids = n_m
            res.gaps = len(path) - n_m
            drv.emit(res, q, t, True)
            if i != j:
                drv.emit(res, q, t, False)
    return drv


def query_search(queries: Iterable[Chain], db_chains,
                 params: DSSParams, options: SearchOptions,
                 out: TextIO) -> SearchDriver:
    """Query-vs-DB scan (src/runquery.cpp, note the role inversion: each
    streamed chain becomes the 'A' side, the loaded set is scanned as
    targets, output orientation flipped back).

    `db_chains` is a chain list, any iterable, or a PATH (streamed)."""
    if isinstance(db_chains, str):
        from reseek_tpu_torch.io.reader import iter_chains
        db_iter = (c for c in iter_chains(db_chains) if len(c) > 0)
    else:
        db_iter = iter(db_chains)
    # role inversion (src/search.cpp:39-60 + src/runquery.cpp:31-79): the
    # QUERY file is loaded in memory, the -db side is streamed as the
    # DSSAligner 'A' side, and output orientation is flipped back
    q_ecs = _encode_all(list(queries), params, with_self_rev=True)
    drv = SearchDriver(params, options, out)
    from reseek_tpu_torch.align.pipeline import self_rev_score
    for tc in db_iter:
        t = (tc if isinstance(tc, EncodedChain)
             else encode_for_search(tc, params))
        if t.self_rev_score == _FLT_MAX:
            t.self_rev_score = self_rev_score(t, params)
        drv.query_count += 1
        for q in q_ecs:
            drv.processed_pairs += 1
            res = drv.aligner.align(t, q)
            if res is None or not res.path:
                continue
            drv.emit(res, t, q, False)
    return drv


def fast_search(queries: List[Chain], db, params: DSSParams,
                options: SearchOptions, out: TextIO,
                dbmu: Optional[str] = None,
                prefilter_mode: Optional[str] = None) -> SearchDriver:
    """Big-DB prefilter pipeline (-fast -db, src/search.cpp:62-112):
    (1) Mu k-mer two-hit prefilter streams the whole DB and keeps the
    top-1500 targets per query; (2) only surviving targets are re-read
    (random access for .bca) and aligned with SENSITIVE parameters
    (PostMuFilter, src/postmufilter.cpp:116-208; one output row per hit).

    `db` is a path (streamed; memory stays proportional to the query set
    plus the survivor set) or an in-memory chain list.  `dbmu` names a
    Mu-letter FASTA of the DB so stage 1 skips DB encoding entirely
    (reference -dbmu, src/search.cpp:96-99).

    Stage 2 runs the per-target host scan (_fast_align_host)."""
    from reseek_tpu_torch.constants import DSSParams as _P
    from reseek_tpu_torch.encoder.dss import encode_chain
    from reseek_tpu_torch.search.prefilter import prefilter_search

    sens = _P.create("sensitive")
    # encode queries ONCE with sensitive params (Mu letters are
    # param-independent, so the prefilter reuses these encodes)
    q_ecs = _encode_all(queries, sens, with_self_rev=False)
    q_mu = [ec.mu_letters for ec in q_ecs]

    db_is_path = isinstance(db, str)
    n_targets = 0

    def target_mu_stream():
        nonlocal n_targets
        if dbmu is not None:
            from reseek_tpu_torch.io.mufasta import iter_mu_fasta
            for i, (_label, letters) in enumerate(iter_mu_fasta(dbmu)):
                n_targets = i + 1
                yield i, letters
        elif db_is_path:
            from reseek_tpu_torch.io.reader import iter_chains
            i = 0
            for c in iter_chains(db):
                if len(c) == 0:
                    continue
                n_targets = i + 1
                yield i, encode_chain(c).mu_letters
                i += 1
        else:
            n_targets = len(db)
            for i, c in enumerate(db):
                yield i, (c.mu_letters if isinstance(c, EncodedChain)
                          else encode_chain(c).mu_letters)

    pf = prefilter_search(q_mu, target_mu_stream(), mode=prefilter_mode)

    drv = SearchDriver(sens, options, out)
    drv.query_count = len(q_ecs)
    t2q = pf.target_to_queries()
    tidxs = sorted(t2q)

    # survivor chains, in ascending target-index order
    def survivor_chains():
        if db_is_path and db.lower().endswith(".bca"):
            # re-read by index, like PostMuFilter's BCAData::ReadChain
            # (src/postmufilter.cpp:164)
            from reseek_tpu_torch.io.bca import BCAReader
            with BCAReader(db) as r:
                for tidx in tidxs:
                    yield tidx, r.read_chain(tidx)
        elif db_is_path:
            # formats without random access: one more sequential pass
            from reseek_tpu_torch.io.reader import iter_chains
            idx = 0
            want = set(tidxs)
            for c in iter_chains(db):
                if len(c) == 0:
                    continue
                if idx in want:
                    yield idx, c
                idx += 1
        else:
            for tidx in tidxs:
                yield tidx, db[tidx]

    _fast_align_host(drv, q_ecs, survivor_chains(), t2q, sens)
    drv.processed_pairs = len(q_ecs) * n_targets
    return drv


def _fast_align_host(drv: SearchDriver, q_ecs: List[EncodedChain],
                     survivor_iter, t2q, sens: DSSParams) -> None:
    """Stage 2 on the native host kernels, parallel over targets like the
    reference's PostMuFilter ChainBag scan (src/postmufilter.cpp:116-208):
    each worker encodes its target, computes its self-rev and aligns it
    against the listed queries (native SW/MKF/LDDT release the GIL);
    emission stays in ascending-target order."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from reseek_tpu_torch.align.pipeline import PairAligner, self_rev_score

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
            drv.aligner.n_aligned += pa.n_aligned
            drv.aligner.n_mu_input += pa.n_mu_input
            drv.aligner.n_mu_discarded += pa.n_mu_discarded
            for qi, res in rows:
                drv.emit(res, q_ecs[qi], t_ec, True)


def _fast_align_emit(drv: SearchDriver, q_ecs: List[EncodedChain],
                     t_ec: EncodedChain, q_indices) -> None:
    for qi in q_indices:
        res = drv.aligner.align(q_ecs[qi], t_ec)
        if res is None or not res.path:
            continue
        drv.emit(res, q_ecs[qi], t_ec, True)
