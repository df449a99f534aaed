"""Search drivers, counterpart of ``reseek_tpu.search.driver``: the
all-vs-all ``self_search``, query-vs-DB ``query_search`` and the -fast
pipeline ``fast_search``, each with its device branch on the port's engine
(search/engine.py).

The host layer (encode, the Mu prefilter, PairAligner, SearchDriver, emit,
the native MKF and exact-SW kernels) is the port's copy of reseek_tpu's,
and ``engine="host"`` runs the per-pair host engine of search/host.py,
which the device engine is held to byte for byte.  ``engine="auto"`` is
the device engine: on ``device`` (default "cuda", which raises without a
card) or on the devices of ``mesh``; the host engine runs only when it is
asked for.  ``mesh`` (parallel/mesh.py: a Mesh or a sequence of devices)
deals the engine's work over several devices with identical output; on
the host and -global paths it is ignored, with a warning, as in
reseek_tpu.
"""

from __future__ import annotations

import itertools
import math
import os
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, List, Optional, TextIO

import numpy as np
import torch

from reseek_tpu_torch.align.pipeline import (FLT_MAX, EncodedChain,
                                             self_rev_score)
from reseek_tpu_torch.chain import Chain
from reseek_tpu_torch.constants import DSSParams
from reseek_tpu_torch.device import DeviceLike, host_cores, resolve
from reseek_tpu_torch.encoder.dss import encode_chain
from reseek_tpu_torch.parallel.mesh import MeshLike, as_mesh
from reseek_tpu_torch.search import host
from reseek_tpu_torch.search.engine import DeviceSelfSearch
from reseek_tpu_torch.search.host import (SearchDriver, SearchOptions,
                                          _encode_all, _maybe_trace)
from reseek_tpu_torch.search.prefilter import prefilter_search
from reseek_tpu_torch.utils.spans import Spans


def _pool() -> ThreadPoolExecutor:
    """Host pool for self-rev, MKF long pairs and encodes; one core is
    left for the main thread, which drives the device."""
    return ThreadPoolExecutor(max_workers=max(1, min(32, host_cores() - 1)))


def _engine_for(name: str, engine: str, mesh, host_only: bool) -> str:
    """The engine to run: "auto" is "device" (whose device, by default
    "cuda", raises without a card: the host engine is never a silent
    substitute); warns when a mesh is given but the run takes a host path
    (``host_only``: -global)."""
    if engine == "auto":
        engine = "device"
    if engine not in ("device", "host"):
        raise ValueError(f"unknown engine {engine!r}")
    if mesh is not None and (engine != "device" or host_only):
        warnings.warn(f"{name}: mesh is ignored on the host/global path; "
                      "running single-device", stacklevel=3)
    return engine


def _need_all(options: SearchOptions) -> bool:
    """With the E-gate off, rows without E-values are emitted, so pairs
    below MinFwdScore still need their paths (no prepass)."""
    return options.scores_are_not_evalues or math.isinf(options.max_evalue)


def self_search(chains: List[Chain], params: DSSParams,
                options: SearchOptions, out: TextIO, engine: str = "auto",
                device: DeviceLike = None,
                mesh: MeshLike = None) -> SearchDriver:
    """All-vs-all (src/runself.cpp): pairs (i, j >= i), the self pair
    emitted once, other pairs in both orientations.

    engine: "device" runs the port's engine on ``device`` (default
    "cuda", which raises without a card), or on the devices of ``mesh``;
    "auto" is "device"; "host" runs the per-pair host engine
    (search/host.py).  -global (options.global_aln) runs the host global
    path whatever the engine, as reseek_tpu does.  With the device engine
    the returned driver carries ``device_stats``, the call's span recorder
    (utils/spans.py) as a dict: host-clock walls of the whole call
    (``wall_s``) and of its parts, encode and upload (``encode_s``), stage
    1 (``stage1_s``), the wait on the pool's self-rev scores
    (``selfrev_wait_s``), stage 3's launch and fetch (``stage3_s``), the
    host finish (``finish_s``; of it the LDDT band checks,
    ``finish_bands_s``, and the exact host recomputes,
    ``finish_recompute_s``), the wait on the MKF pairs (``mkf_wait_s``)
    and the output (``emit_s``: muscore backfill, sort, rows); and the
    counts ``survivors`` (stage 1's), ``stage3_pairs``, ``finish_pairs``
    (those given a result), ``recomputed_pairs`` and ``emitted_pairs``
    (stage-3 pairs that wrote a row)."""
    mesh = as_mesh(mesh)
    engine = _engine_for("self_search", engine, mesh, options.global_aln)
    if engine == "host" or options.global_aln:
        return host.self_search(chains, params, options, out)
    spans = Spans()
    with spans.call("self_search"):
        drv = _self_search_device(chains, params, options, out,
                                  resolve(device) if mesh is None else None,
                                  mesh, spans)
    drv.device_stats = spans.stats()
    return drv


def _self_search_device(chains: List[Chain], params: DSSParams,
                        options: SearchOptions, out: TextIO,
                        device: Optional[torch.device], mesh,
                        spans: Spans) -> SearchDriver:
    """Batched all-vs-all on the port's device engine; long-chain
    (MKF-routed) pairs run on the host path for reference parity.  Its
    parts are timed on ``spans``, the call's recorder."""
    with spans.span("encode"):
        ecs = _encode_all(chains, params, with_self_rev=False)
        pipe = DeviceSelfSearch(ecs, params, device=device,
                                with_rev_profiles=False, mesh=mesh,
                                spans=spans)
    have_selfrev = all(ec.self_rev_score != FLT_MAX for ec in ecs)

    drv = SearchDriver(params, options, out)
    n = len(ecs)
    drv.query_count = n
    drv.processed_pairs = n * (n + 1) // 2
    _maybe_trace(drv, ecs, options)
    lens = np.array([len(ec) for ec in ecs])
    long_set = [int(j) for j in np.flatnonzero(lens >= params.mkfl)]
    # pairs with max length >= mkfl skip the device path and are aligned on
    # the host MKF route, in a thread pool concurrent with the device
    # stages (the native MKF kernel releases the GIL)
    long_pairs = []
    seen = set()
    for j in long_set:
        for i in range(n):
            a, b = (i, j) if i <= j else (j, i)
            if (a, b) not in seen:
                seen.add((a, b))
                long_pairs.append((a, b))
    pool = _pool()
    try:
        sr_futs = {}
        if not have_selfrev:
            # self-rev on the host pool (native exact SW; long chains take
            # the MKF quirk path inside self_rev_score), overlapped with
            # the device stage-1 filter
            sr_futs = {i: pool.submit(self_rev_score, ecs[i], params)
                       for i, ec in enumerate(ecs)
                       if ec.self_rev_score == FLT_MAX}
        survivors = pipe.stage1_survivors()
        spans.count("survivors", len(survivors))
        with spans.span("selfrev_wait"):
            for i, f in sr_futs.items():
                ecs[i].self_rev_score = f.result()
        # TS needs both self-rev scores: long pairs can finish now, and
        # overlap with the stage-3 survivor alignment below
        mkf_futs = [(a, b, pool.submit(drv.aligner.align, ecs[a], ecs[b]))
                    for a, b in long_pairs]
        need_all = _need_all(options)
        by_pair = pipe.align_survivors(
            survivors, need_all_paths=need_all,
            evalue_gate=None if need_all else options.max_evalue)
        with spans.span("mkf_wait"):
            for a, b, f in mkf_futs:
                res = f.result()
                if res is not None and res.path:
                    by_pair[(a, b)] = res
    finally:
        pool.shutdown(wait=True)
    with spans.span("emit"):
        # the muscore column is not produced by the mask-only stage 1;
        # backfill it for emitted pairs from the host filter
        if "muscore" in options.columns:
            for (i, j), res in by_pair.items():
                if res.mu_score == 0.0 and not (lens[i] >= params.mkfl
                                                or lens[j] >= params.mkfl):
                    res.mu_score = drv.aligner.mu_filter_score(ecs[i],
                                                               ecs[j])
        # emit in the reference's single-thread order: (i, j >= i)
        # ascending, Up row then Down row (src/runself.cpp:53-66); count
        # the stage-3 pairs (not the MKF route's) that wrote a row
        emitted = 0
        for (i, j) in sorted(by_pair):
            if options.no_self and i == j:
                continue
            res = by_pair[(i, j)]
            q, t = ecs[i], ecs[j]
            hits = drv.hit_count
            drv.emit(res, q, t, True)
            if i != j:
                drv.emit(res, q, t, False)
            if drv.hit_count > hits and (i, j) not in seen:
                emitted += 1
        spans.count("emitted_pairs", emitted)
    return drv


def query_search(queries: Iterable[Chain], db_chains, params: DSSParams,
                 options: SearchOptions, out: TextIO, engine: str = "auto",
                 device: DeviceLike = None, mesh: MeshLike = None,
                 chunk_size: Optional[int] = None) -> SearchDriver:
    """Query-vs-DB scan (src/runquery.cpp; role inversion: each DB chain
    is the 'A' side, the query set is scanned as targets, and the output
    orientation is flipped back).

    db_chains: a chain list, any iterable, or a PATH (streamed).  The DB
    side runs in chunks of ``chunk_size`` chains (default
    $RESEEK_QUERY_CHUNK or 4096), so memory stays proportional to the
    queries plus one chunk.  engine, device and mesh as in
    ``self_search``."""
    mesh = as_mesh(mesh)
    engine = _engine_for("query_search", engine, mesh, False)
    if engine == "host":
        return host.query_search(queries, db_chains, params, options, out)
    dev = resolve(device) if mesh is None else None
    if isinstance(db_chains, str):
        from reseek_tpu_torch.io.reader import iter_chains
        db_iter = (c for c in iter_chains(db_chains) if len(c) > 0)
    else:
        db_iter = iter(db_chains)
    if chunk_size is None:
        chunk_size = int(os.environ.get("RESEEK_QUERY_CHUNK", "4096"))
    spans = Spans()
    with spans.call("query_search"):
        drv = _query_search_device(list(queries), db_iter, params, options,
                                   out, dev, chunk_size, mesh, spans)
    drv.device_stats = spans.stats()
    return drv


def _query_search_device(queries: List[Chain], db_iter, params: DSSParams,
                         options: SearchOptions, out: TextIO,
                         device: Optional[torch.device], chunk_size: int,
                         mesh, spans: Spans) -> SearchDriver:
    """Query-vs-DB on the port's engine, DB side chunked: per chunk, one
    engine over queries + chunk chains runs the Mu filter on the explicit
    pair rectangle, then align_survivors; self-rev and the long (MKF)
    pairs run on the host pool, and chunk N+1's encode overlaps chunk N's
    device stages.  Its parts are timed on ``spans``, the call's recorder,
    summed over chunks: the walls of ``self_search``'s ``device_stats``
    (the wait for a chunk's encode and its upload under ``encode``; no
    finish parts where no pair reached stage 3) and the counts
    ``chunks``, ``mu_pairs`` (pairs into stage 1), ``survivors``,
    ``stage3_pairs``, ``finish_pairs`` and ``recomputed_pairs``."""
    with spans.span("encode"):
        q_ecs = _encode_all(queries, params, with_self_rev=False)
    nq = len(q_ecs)
    drv = SearchDriver(params, options, out)
    need_all = _need_all(options)
    for k in ("chunks", "mu_pairs", "survivors"):
        spans.count(k, 0)
    pool = _pool()
    try:
        # query self-rev once, before the chunk loop
        sr_futs = {i: pool.submit(self_rev_score, q_ecs[i], params)
                   for i, ec in enumerate(q_ecs)
                   if ec.self_rev_score == FLT_MAX}
        with spans.span("selfrev_wait"):
            for i, f in sr_futs.items():
                q_ecs[i].self_rev_score = f.result()

        # the DB iterator is consumed serially: the next chunk's encode is
        # submitted only after the previous one resolved
        def encode_chunk():
            chunk = list(itertools.islice(db_iter, chunk_size))
            if not chunk:
                return None
            return _encode_all(chunk, params, with_self_rev=False)

        pending = pool.submit(encode_chunk)
        first_chunk = True
        while True:
            with spans.span("encode"):
                t_ecs = pending.result()
                if t_ecs is None:
                    break
                pending = pool.submit(encode_chunk)
                ecs = q_ecs + t_ecs
                nt = len(t_ecs)
                pipe = DeviceSelfSearch(ecs, params, device=device,
                                        with_rev_profiles=False, mesh=mesh,
                                        spans=spans)
            if first_chunk:
                _maybe_trace(drv, ecs, options)
                first_chunk = False
            drv.query_count += nt
            drv.processed_pairs += nq * nt
            lens = np.array([len(ec) for ec in ecs])
            sr_futs = {i: pool.submit(self_rev_score, ecs[i], params)
                       for i, ec in enumerate(ecs)
                       if ec.self_rev_score == FLT_MAX}
            # the pair rectangle, A side = DB chain (index nq + ti), B side
            # = query
            qi, ti = np.meshgrid(np.arange(nq), np.arange(nt),
                                 indexing="ij")
            pairs = np.stack([nq + ti.ravel(), qi.ravel()], axis=1)
            is_long = ((lens[pairs[:, 0]] >= params.mkfl)
                       | (lens[pairs[:, 1]] >= params.mkfl))
            long_pairs = pairs[is_long]
            dev_pairs = pairs[~is_long]
            spans.count("mu_pairs", len(dev_pairs))
            mu_vals = {}
            if params.omega > 0 and len(dev_pairs):
                mu = pipe.stage1_scores(dev_pairs)
                if "muscore" in options.columns:
                    mu_vals = {(int(a), int(b)): float(v)
                               for (a, b), v in zip(dev_pairs, mu)}
                dev_pairs = dev_pairs[mu >= params.omega]
            spans.count("survivors", len(dev_pairs))
            with spans.span("selfrev_wait"):
                for i, f in sr_futs.items():
                    ecs[i].self_rev_score = f.result()
            mkf_futs = [(int(a) - nq, int(b),
                         pool.submit(drv.aligner.align, ecs[a], ecs[b]))
                        for a, b in long_pairs]
            dev_results = pipe.align_survivors(
                dev_pairs, need_all_paths=need_all,
                evalue_gate=None if need_all else options.max_evalue)
            spans.count("chunks")
            # the stage-1 values, keyed (DB, query) as the pairs ran; the
            # long pairs keep the host aligner's
            for key, v in mu_vals.items():
                if key in dev_results:
                    dev_results[key].mu_score = v
            by_pair = {(a - nq, b): r
                       for (a, b), r in dev_results.items() if r.path}
            with spans.span("mkf_wait"):
                for t_i, q_i, f in mkf_futs:
                    res = f.result()
                    if res is not None and res.path:
                        by_pair[(t_i, q_i)] = res
            # reference row order: per DB chain in stream order, each vs
            # the query set, orientation flipped back (src/runquery.cpp)
            with spans.span("emit"):
                for t_i in range(nt):
                    for q_i in range(nq):
                        res = by_pair.get((t_i, q_i))
                        if res is not None:
                            drv.emit(res, ecs[nq + t_i], ecs[q_i], False)
    finally:
        pool.shutdown(wait=True)
    return drv


def _mu_letters(chains: Iterable[Chain]):
    """Mu letters of each chain, in order, encoded in batches on a thread
    pool (the native encoder releases the GIL)."""
    with ThreadPoolExecutor(max_workers=host_cores()) as tp:
        it = iter(chains)
        while True:
            batch = list(itertools.islice(it, 1024))
            if not batch:
                return
            yield from tp.map(lambda c: encode_chain(c).mu_letters, batch)


def fast_search(queries: List[Chain], db, params: DSSParams,
                options: SearchOptions, out: TextIO,
                dbmu: Optional[str] = None, engine: str = "auto",
                device: DeviceLike = None, mesh: MeshLike = None,
                prefilter_mode: Optional[str] = None) -> SearchDriver:
    """The big-DB prefilter pipeline (-fast -db, src/search.cpp:62-112):
    (1) the Mu k-mer prefilter streams the whole DB and keeps the
    top-1500 targets per query; (2) only the surviving targets are re-read
    (random access for .bca, a second pass otherwise) and aligned with
    SENSITIVE parameters (PostMuFilter, src/postmufilter.cpp:116-208; one
    row per hit, query side up).

    db: a path (streamed) or a chain list; dbmu: a Mu-letter FASTA of the
    DB, so stage 1 skips encoding it (-dbmu); prefilter_mode: None,
    "idxq" or "idxt" as in reseek_tpu.  engine "device" aligns the
    candidates on the port's engine (on ``device``, or dealt over the
    devices of ``mesh``); "host" runs the host engine's fast_search;
    "auto" needs the device as "device" does, and aligns on the device
    engine from $RESEEK_FAST_DEVICE_MIN (20,000) candidate pairs, below
    that on the host stage 2 (reseek_tpu's own rule: small candidate sets
    finish sooner on the host).  The returned driver carries
    ``fast_stats``: the engine, ``candidates``, ``targets_read`` (the
    survivors read), and the call's span recorder (utils/spans.py) as a
    dict: the walls of the prefilter (``prefilter_s``: the queries' encode
    and the k-mer scan) and of stage 2 (``align_s``), and on the device
    engine those of ``_fast_align_device`` within it."""
    mesh = as_mesh(mesh)
    if engine == "host":
        _engine_for("fast_search", engine, mesh, False)
        return host.fast_search(queries, db, params, options, out,
                                dbmu=dbmu, prefilter_mode=prefilter_mode)
    if engine not in ("auto", "device"):
        raise ValueError(f"unknown engine {engine!r}")
    # "auto" and "device" both need the device (cuda raises without a
    # card), whichever stage 2 the candidate count picks below
    dev = resolve(device) if mesh is None else None
    spans = Spans()
    sens = DSSParams.create("sensitive")
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
            for i, mu in enumerate(_mu_letters(
                    c for c in iter_chains(db) if len(c) > 0)):
                n_targets = i + 1
                yield i, mu
        else:
            n_targets = len(db)
            enc = iter(list(_mu_letters(
                c for c in db if not isinstance(c, EncodedChain))))
            for i, c in enumerate(db):
                yield i, (c.mu_letters if isinstance(c, EncodedChain)
                          else next(enc))

    with spans.span("prefilter"):
        # queries encode once with sensitive params (Mu letters do not
        # depend on the parameters, so the prefilter reuses them)
        q_ecs = _encode_all(queries, sens, with_self_rev=False)
        pf = prefilter_search([ec.mu_letters for ec in q_ecs],
                              target_mu_stream(), mode=prefilter_mode)
    drv = SearchDriver(sens, options, out)
    drv.query_count = len(q_ecs)
    t2q = pf.target_to_queries()
    tidxs = sorted(t2q)

    def survivor_chains():
        """(target index, chain) of the survivors, ascending."""
        if db_is_path and db.lower().endswith(".bca"):
            # random access by index, like PostMuFilter's
            # BCAData::ReadChain (src/postmufilter.cpp:164)
            from reseek_tpu_torch.io.bca import BCAReader
            with BCAReader(db) as r:
                for tidx in tidxs:
                    yield tidx, r.read_chain(tidx)
        elif db_is_path:
            # formats without random access: one more sequential pass
            from reseek_tpu_torch.io.reader import iter_chains
            want = set(tidxs)
            idx = 0
            for c in iter_chains(db):
                if len(c) == 0:
                    continue
                if idx in want:
                    yield idx, c
                idx += 1
        else:
            for tidx in tidxs:
                yield tidx, db[tidx]

    n_cand = sum(len(v) for v in t2q.values())
    if engine == "auto":
        min_dev = int(os.environ.get("RESEEK_FAST_DEVICE_MIN", "20000"))
        engine = _engine_for(
            "fast_search", "device" if n_cand >= min_dev else "host", mesh,
            False)
    with spans.span("align"):
        if engine == "device":
            _fast_align_device(drv, q_ecs, survivor_chains(), t2q, sens,
                               options, dev, spans, mesh)
        else:
            host._fast_align_host(drv, q_ecs, survivor_chains(), t2q, sens)
    drv.processed_pairs = len(q_ecs) * n_targets
    drv.fast_stats = {"engine": engine, "candidates": n_cand,
                      "targets_read": len(tidxs), **spans.stats()}
    return drv


def _fast_align_device(drv: SearchDriver, q_ecs: List[EncodedChain],
                       survivor_iter, t2q, sens: DSSParams,
                       options: SearchOptions,
                       device: Optional[torch.device], spans: Spans,
                       mesh=None) -> None:
    """Stage 2 of the -fast pipeline on the port's engine, on ``device``
    or the devices of ``mesh`` (PostMuFilter's parallel ChainBag scan as
    device batches): the surviving targets run
    in chunks of $RESEEK_FAST_CHUNK (4096); per chunk, one engine over
    queries + chunk targets runs the Mu filter on the candidate pairs
    (query side = A, PostMuFilter's orientation), then align_survivors;
    self-rev and long (MKF) pairs on the host pool.  Rows come out as on
    the host path: per target ascending, its listed queries in order.
    Its parts are timed on ``spans``, the caller's recorder, summed over
    chunks: the walls of ``self_search``'s ``device_stats`` (the wait for
    a chunk's encode and its upload under ``encode``) and the counts
    ``chunks``, ``mu_pairs`` (pairs into stage 1), ``mkf_pairs``,
    ``survivors``, ``stage3_pairs``, ``finish_pairs`` and
    ``recomputed_pairs``."""
    chunk_size = int(os.environ.get("RESEEK_FAST_CHUNK", "4096"))
    nq = len(q_ecs)
    need_all = _need_all(options)
    for k in ("mu_pairs", "survivors", "mkf_pairs", "chunks"):
        spans.count(k, 0)
    pool = _pool()
    try:
        sr_futs = {i: pool.submit(self_rev_score, q_ecs[i], sens)
                   for i, ec in enumerate(q_ecs)
                   if ec.self_rev_score == FLT_MAX}
        with spans.span("selfrev_wait"):
            for i, f in sr_futs.items():
                q_ecs[i].self_rev_score = f.result()

        # chunk N+1's target encode overlaps chunk N's device stages
        def encode_chunk():
            chunk = list(itertools.islice(survivor_iter, chunk_size))
            if not chunk:
                return None
            return ([tidx for tidx, _ in chunk],
                    _encode_all([c for _, c in chunk], sens,
                                with_self_rev=False))

        pending = pool.submit(encode_chunk)
        while True:
            with spans.span("encode"):
                got = pending.result()
                if got is None:
                    break
                pending = pool.submit(encode_chunk)
                t_order, t_ecs = got
                ecs = list(q_ecs) + list(t_ecs)
                pipe = DeviceSelfSearch(ecs, sens, device=device,
                                        with_rev_profiles=False, mesh=mesh,
                                        spans=spans)
            tpos = {tidx: k for k, tidx in enumerate(t_order)}
            lens = np.array([len(ec) for ec in ecs])
            pairs = np.array([(qi, nq + tpos[tidx])
                              for tidx in t_order for qi in t2q[tidx]],
                             np.int64).reshape(-1, 2)
            is_long = ((lens[pairs[:, 0]] >= sens.mkfl)
                       | (lens[pairs[:, 1]] >= sens.mkfl))
            sr_futs = {i: pool.submit(self_rev_score, ecs[i], sens)
                       for i, ec in enumerate(ecs)
                       if ec.self_rev_score == FLT_MAX}
            dev_pairs = pairs[~is_long]
            spans.count("mu_pairs", len(dev_pairs))
            spans.count("mkf_pairs", int(is_long.sum()))
            mu_vals = {}
            if sens.omega > 0 and len(dev_pairs):
                mu = pipe.stage1_scores(dev_pairs)
                if "muscore" in options.columns:
                    mu_vals = {(int(a), int(b)): float(v)
                               for (a, b), v in zip(dev_pairs, mu)}
                dev_pairs = dev_pairs[mu >= sens.omega]
            spans.count("survivors", len(dev_pairs))
            with spans.span("selfrev_wait"):
                for i, f in sr_futs.items():
                    ecs[i].self_rev_score = f.result()
            mkf_futs = [(int(a), int(b),
                         pool.submit(drv.aligner.align, ecs[a], ecs[b]))
                        for a, b in pairs[is_long]]
            by_pair = pipe.align_survivors(
                dev_pairs, need_all_paths=need_all,
                evalue_gate=None if need_all else options.max_evalue)
            spans.count("chunks")
            with spans.span("mkf_wait"):
                for a, b, f in mkf_futs:
                    res = f.result()
                    if res is not None and res.path:
                        by_pair[(a, b)] = res
            for key, v in mu_vals.items():
                if key in by_pair:
                    by_pair[key].mu_score = v
            with spans.span("emit"):
                for tidx in t_order:
                    t_ec = t_ecs[tpos[tidx]]
                    for qi in t2q[tidx]:
                        res = by_pair.get((qi, nq + tpos[tidx]))
                        if res is not None and res.path:
                            drv.emit(res, q_ecs[qi], t_ec, True)
    finally:
        pool.shutdown(wait=True)
