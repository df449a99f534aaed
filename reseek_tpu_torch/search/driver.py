"""All-vs-all self search, counterpart of ``reseek_tpu.search.driver``'s
``self_search`` and ``_self_search_device``.

The host layer (encode, PairAligner, SearchDriver, emit, the native MKF
and exact-SW kernels) is reseek_tpu's own; this module only swaps the
device engine for the port's (search/engine.py).
"""

from __future__ import annotations

import math
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, TextIO

import numpy as np
import torch

from reseek_tpu.align.pipeline import FLT_MAX, self_rev_score
from reseek_tpu.chain import Chain
from reseek_tpu.constants import DSSParams
from reseek_tpu.search import driver as host_driver
from reseek_tpu.search.driver import (SearchDriver, SearchOptions,
                                      _encode_all, _fwd_displayed,
                                      _maybe_trace)
from reseek_tpu_torch.device import DeviceLike, resolve
from reseek_tpu_torch.search.engine import DeviceSelfSearch


def self_search(chains: List[Chain], params: DSSParams,
                options: SearchOptions, out: TextIO, engine: str = "auto",
                device: DeviceLike = None, mesh=None) -> SearchDriver:
    """All-vs-all (src/runself.cpp): pairs (i, j >= i), the self pair
    emitted once, other pairs in both orientations.

    engine: "device" runs the port's engine on ``device`` (default
    "cuda", which raises without a card); "host" runs reseek_tpu's
    per-pair host path; "auto" is "device" on CUDA when a card is present,
    else "host".  With the device engine the returned driver carries
    ``device_stats``: host-clock walls of encode, stage 1, stage 3 and the
    host finish (``*_s``) and the stage-1 survivor count."""
    if mesh is not None:
        raise NotImplementedError("self_search: multi-GPU is not ported yet")
    if options.global_aln:
        raise NotImplementedError("self_search: -global is not ported yet")
    if engine == "auto":
        engine = "device" if torch.cuda.is_available() else "host"
    if engine == "host":
        return host_driver.self_search(chains, params, options, out,
                                       engine="host")
    if engine != "device":
        raise ValueError(f"unknown engine {engine!r}")
    return _self_search_device(chains, params, options, out,
                               resolve(device))


def _self_search_device(chains: List[Chain], params: DSSParams,
                        options: SearchOptions, out: TextIO,
                        device: torch.device) -> SearchDriver:
    """Batched all-vs-all on the port's device engine; long-chain
    (MKF-routed) pairs run on the host path for reference parity."""
    t0 = time.perf_counter()
    ecs = _encode_all(chains, params, with_self_rev=False)
    have_selfrev = all(ec.self_rev_score != FLT_MAX for ec in ecs)
    pipe = DeviceSelfSearch(ecs, params, device=device)
    t_encode = time.perf_counter() - t0

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
    # leave one core for the main thread, which drives the device
    pool = ThreadPoolExecutor(
        max_workers=max(1, min(32, (os.cpu_count() or 4) - 1)))
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
        for i, f in sr_futs.items():
            ecs[i].self_rev_score = f.result()
        # TS needs both self-rev scores: long pairs can finish now, and
        # overlap with the stage-3 survivor alignment below
        mkf_futs = [(a, b, pool.submit(drv.aligner.align, ecs[a], ecs[b]))
                    for a, b in long_pairs]
        need_all = (options.scores_are_not_evalues
                    or math.isinf(options.max_evalue))
        by_pair = pipe.align_survivors(
            survivors, evalue_gate=None if need_all else options.max_evalue,
            fwd_displayed=_fwd_displayed(options))
        for a, b, f in mkf_futs:
            res = f.result()
            if res is not None and res.path:
                by_pair[(a, b)] = res
    finally:
        pool.shutdown(wait=True)
    # the muscore column is not produced by the mask-only stage 1;
    # backfill it for emitted pairs from the host filter
    if "muscore" in options.columns:
        for (i, j), res in by_pair.items():
            if res.mu_score == 0.0 and not (lens[i] >= params.mkfl
                                            or lens[j] >= params.mkfl):
                res.mu_score = drv.aligner.mu_filter_score(ecs[i], ecs[j])
    # emit in the reference's single-thread order: (i, j >= i) ascending,
    # Up row then Down row (src/runself.cpp:53-66)
    for (i, j) in sorted(by_pair):
        if options.no_self and i == j:
            continue
        res = by_pair[(i, j)]
        q, t = ecs[i], ecs[j]
        drv.emit(res, q, t, True)
        if i != j:
            drv.emit(res, q, t, False)
    drv.device_stats = {"encode_s": t_encode,
                        **{k + "_s": v for k, v in pipe.seconds.items()},
                        "survivors": len(survivors)}
    return drv
