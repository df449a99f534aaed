#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (reseek_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:
  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
     fails without a CUDA device;
  1. builds the CUDA kernels from reseek_tpu_torch/csrc with nvcc
     (build seconds, ptxas registers / shared memory / spills);
  2. holds each kernel against its plain PyTorch version on the card, at
     the shapes of the q100 self-search (stage-1 block plan, stage-3
     chunk shapes), and times both (CUDA events, warm); then again on
     seeded random ragged, wide and tie-prone inputs;
  3. the q100 sensitive all-vs-all through reseek_tpu_torch's
     self_search(engine="device", device="cuda"): the TSV must equal
     reseek_tpu's host engine byte for byte, and every kernel must have
     been launched by that run; cold wall, warm median of 3, stage walls;
  4. the 1,024-chain replica (q100 chains plus 0.25 A Gaussian coordinate
     noise, seed 17, labels <label>/r<k>) through the same entry; every
     chain below the MKF length threshold must report its self hit.
The last two lines are a JSON object of per-kernel results and
{"ok": true, "device": {...}}.  Imports no JAX.
"""

from __future__ import annotations

import io
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
Q100 = os.path.join(ROOT, "tests", "golden", "q100.cal")
COLUMNS = "query+target+qlo+qhi+tlo+thi+evalue+cigar"
MODE = "sensitive"
REPLICA_CHAINS = 1024
REPLICA_SEED = 17
REPLICA_NOISE = 0.25
LDDT_TOL = 1e-6
# kernel -> (CUDA source, the TPU kernel or JAX scan it replaces)
KERNELS = {
    "mu_sweep": ("reseek_tpu_torch/csrc/mu_sweep.cu",
                 "reseek_tpu/ops/sw_sweep.py:206"),
    "sw_traceback": ("reseek_tpu_torch/csrc/sw_traceback.cu",
                     "reseek_tpu/ops/sw_pallas.py:252"),
    "walk_traceback": ("reseek_tpu_torch/csrc/postalign.cu",
                       "reseek_tpu/ops/postalign_jax.py:20"),
    "lddt": ("reseek_tpu_torch/csrc/postalign.cu",
             "reseek_tpu/ops/postalign_jax.py:79"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({exc})"


def time_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean milliseconds per call on the current stream (CUDA events)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _band(dp: int, la: int, lb: int, device) -> torch.Tensor:
    """[Dp, 1, LA] mask of the skewed traceback's valid cells, 0 <= d-i <
    LB (the kernel leaves the rest unwritten)."""
    d = torch.arange(dp, device=device)[:, None, None]
    i = torch.arange(la, device=device)[None, None, :]
    return (d - i >= 0) & (d - i < lb)


def phase_build() -> None:
    from reseek_tpu_torch import kernels
    info = kernels.build()
    print(f"[1] build: {info.seconds:.2f} s -> {info.path.name}")
    for line in info.log.splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill",
                                   "smem")):
            print("    ptxas:", line.strip().removeprefix("ptxas info    : "))
    kernels.lib()


def phase_kernels(pipe, survivors: np.ndarray) -> dict:
    """Each kernel against its plain version at the main path's shapes.
    Returns {kernel: {max_abs_err, ms, plain_ms}} (times at the largest
    shape)."""
    from reseek_tpu_torch.ops.postalign import (lddt_batch, lddt_batch_ref,
                                                walk_traceback_batch,
                                                walk_traceback_batch_ref)
    from reseek_tpu_torch.ops.sw_sweep import mu_sw_scores, mu_sw_scores_ref
    from reseek_tpu_torch.ops.sw_wavefront import (sw_traceback,
                                                   sw_traceback_ref)
    from reseek_tpu_torch.search.engine import aligned_coords
    p = pipe.params
    res = {k: {"max_abs_err": 0.0, "ms": None, "plain_ms": None, "cells": -1,
               "shape": None} for k in KERNELS}

    def record(name, err, cells, shape, ms_fn, plain_fn, reps):
        r = res[name]
        r["max_abs_err"] = max(r["max_abs_err"], float(err))
        if cells > r["cells"]:
            r["cells"] = cells
            r["shape"] = shape
            r["ms"] = time_ms(ms_fn, reps)
            r["plain_ms"] = time_ms(plain_fn, 1)

    # K1: first block of every stage-1 shape group
    o, e = -float(p.para_mu_gap_open), -float(p.para_mu_gap_ext)
    for (lea, leb, ca, cb), starts in pipe.stage1_block_plan().items():
        ba, bb, _, _ = starts[0]
        a, b, _, _ = pipe.stage1_letters(lea, leb, ca, cb, ba, bb)
        got = mu_sw_scores(a, b, pipe.mumx, o, e)
        want = mu_sw_scores_ref(a, b, pipe.mumx, o, e)
        if not torch.equal(got, want):
            fail(f"mu_sweep != plain at {(lea, leb, ca, cb)}")
        print(f"[2] mu_sweep  B={a.shape[0]} LA={lea} LB={leb}: equal")
        record("mu_sweep", (got - want).abs().max(), a.shape[0] * lea * leb,
               (a.shape[0], lea, leb),
               lambda: mu_sw_scores(a, b, pipe.mumx, o, e),
               lambda: mu_sw_scores_ref(a, b, pipe.mumx, o, e), 5)

    # K2-K4: first chunk of every stage-3 shape
    go, ge = float(p.gap_open), float(p.gap_ext)
    seen = set()
    for lea, leb, chunk, ia, ib in pipe.stage3_plan(survivors):
        if (lea, leb) in seen:
            continue
        seen.add((lea, leb))
        s = pipe.stage3_smx(lea, leb, ia, ib)
        nb = s.shape[0]
        cells = nb * lea * leb
        best, bi, bj, tb = sw_traceback(s, go, ge)
        rbest, rbi, rbj, rtb = sw_traceback_ref(s, go, ge)
        band = _band(tb.shape[0], lea, leb, s.device).expand_as(tb)
        if not (torch.equal(best, rbest) and torch.equal(bi, rbi)
                and torch.equal(bj, rbj)
                and torch.equal(tb[band], rtb[band])):
            fail(f"sw_traceback != plain at {(nb, lea, leb)}")
        record("sw_traceback", (best - rbest).abs().max(), cells,
               (nb, lea, leb), lambda: sw_traceback(s, go, ge),
               lambda: sw_traceback_ref(s, go, ge), 3)

        walk = walk_traceback_batch(tb, best, bi, bj)
        rwalk = walk_traceback_batch_ref(tb, best, bi, bj)
        if not all(torch.equal(x, y) for x, y in zip(walk, rwalk)):
            fail(f"walk_traceback != plain at {(nb, lea, leb)}")
        record("walk_traceback", 0.0, cells, (nb, lea, leb),
               lambda: walk_traceback_batch(tb, best, bi, bj),
               lambda: walk_traceback_batch_ref(tb, best, bi, bj), 5)

        cq, ct, valid, n_m = aligned_coords(walk[3], bi, bj, ia, ib,
                                            pipe.coords, min(lea, leb))
        lddt, risky = lddt_batch(cq, ct, valid, n_m)
        rlddt, rrisky = lddt_batch_ref(cq, ct, valid, n_m)
        err = (lddt - rlddt).abs()[~rrisky].max() if bool(
            (~rrisky).any()) else torch.zeros(())
        if not torch.equal(risky, rrisky) or float(err) > LDDT_TOL:
            fail(f"lddt != plain at {(nb, lea, leb)}: err {float(err)}")
        record("lddt", err, int(n_m.sum()) * min(lea, leb),
               (nb, min(lea, leb)), lambda: lddt_batch(cq, ct, valid, n_m),
               lambda: lddt_batch_ref(cq, ct, valid, n_m), 5)
        print(f"[2] stage-3 kernels B={nb} LA={lea} LB={leb}: equal "
              f"(lddt err {float(err):.3g}, risky {int(risky.sum())})")
    for name, r in res.items():
        if r["ms"] is None:
            fail(f"{name}: no main-path shape to compare at")
        print(f"[2] {name} at {r['shape']}: kernel {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms, max_abs_err {r['max_abs_err']:.3g}")
    return res


def phase_tie_prone(mumx) -> None:
    """Each kernel against its plain version on seeded random inputs the
    q100 shapes do not reach: ragged rows, wide rows (the other lane-count
    variants), tie-prone integer substitution scores, a pair with no
    positive cell, 0.1 A-rounded coordinates."""
    from reseek_tpu_torch.ops.postalign import (lddt_batch, lddt_batch_ref,
                                                walk_traceback_batch,
                                                walk_traceback_batch_ref)
    from reseek_tpu_torch.ops.sw_sweep import mu_sw_scores, mu_sw_scores_ref
    from reseek_tpu_torch.ops.sw_wavefront import (sw_traceback,
                                                   sw_traceback_ref)
    rng = np.random.default_rng(0)
    dev = mumx.device

    def ragged(n, la, lb):
        """[n, la, lb] mask of cells past random per-row lengths."""
        na = rng.integers(1, la + 1, (n, 1, 1))
        nb = rng.integers(1, lb + 1, (n, 1, 1))
        return ((np.arange(la)[None, :, None] >= na)
                | (np.arange(lb)[None, None, :] >= nb))

    for la, lb in ((130, 77), (300, 2048), (64, 4100)):
        a = rng.integers(0, 36, (37, la)).astype(np.uint8)
        b = rng.integers(0, 36, (37, lb)).astype(np.uint8)
        a[ragged(37, la, 1)[:, :, 0]] = 36
        b[ragged(37, 1, lb)[:, 0, :]] = 36
        a, b = torch.tensor(a, device=dev), torch.tensor(b, device=dev)
        if not torch.equal(mu_sw_scores(a, b, mumx, -2.0, -1.0),
                           mu_sw_scores_ref(a, b, mumx, -2.0, -1.0)):
            fail(f"mu_sweep != plain on random letters {(la, lb)}")
    for la, lb in ((40, 24), (600, 130), (2048, 40)):
        s = rng.integers(-3, 4, (24, la, lb)).astype(np.float32)
        s[ragged(24, la, lb)] = -9e9
        s[1] = -1.0
        s = torch.tensor(s, device=dev)
        got = sw_traceback(s, -1.5, -0.25)
        want = sw_traceback_ref(s, -1.5, -0.25)
        band = _band(got[3].shape[0], la, lb, dev).expand_as(got[3])
        if not (all(torch.equal(x, y) for x, y in zip(got[:3], want[:3]))
                and torch.equal(got[3][band], want[3][band])
                and all(torch.equal(x, y) for x, y in zip(
                    walk_traceback_batch(*got[3:], *got[:3]),
                    walk_traceback_batch_ref(*got[3:], *got[:3])))):
            fail(f"sw_traceback/walk != plain on tie-prone {(la, lb)}")
    for m in (7, 700, 2048):
        walk = np.cumsum(rng.normal(0, 2.2, (20, m, 3)), axis=1)
        cq = np.round(walk, 1).astype(np.float32)
        ct = np.round(walk + rng.normal(0, 0.7, walk.shape), 1).astype(
            np.float32)
        ncols = rng.integers(0, m + 1, 20).astype(np.int32)
        valid = np.arange(m)[None, :] < ncols[:, None]
        args = [torch.tensor(x, device=dev) for x in (cq, ct, valid, ncols)]
        (got, risky), (want, wrisky) = lddt_batch(*args), lddt_batch_ref(*args)
        if not torch.equal(risky, wrisky) or float(
                (got - want).abs().max()) > LDDT_TOL:
            fail(f"lddt != plain on random coordinates (M={m})")
    print("[2] random and tie-prone inputs: every kernel equals its plain "
          "version")


def run_search(chains, engine: str):
    from reseek_tpu.align.output import parse_columns
    from reseek_tpu.constants import DSSParams
    from reseek_tpu.search.driver import SearchOptions
    out = io.StringIO()
    options = SearchOptions(columns=parse_columns(COLUMNS), mode=MODE)
    params = DSSParams.create(MODE)
    t0 = time.perf_counter()
    if engine == "host":
        from reseek_tpu.search.driver import self_search
        drv = self_search(chains, params, options, out, engine="host")
    else:
        from reseek_tpu_torch.search.driver import self_search
        drv = self_search(chains, params, options, out, engine="device",
                          device="cuda")
        torch.cuda.synchronize()
    return out.getvalue(), time.perf_counter() - t0, drv


def phase_q100(chains) -> dict:
    from reseek_tpu_torch.ops import kernel_wrappers
    n = len(chains)
    pairs = n * (n + 1) // 2
    want, host_s, _ = run_search(chains, "host")
    print(f"[3] host engine: {len(want.splitlines())} rows, {host_s:.2f} s")
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    got, cold_s, drv = run_search(chains, "device")
    launches = {k: w.launches for k, w in wrappers.items()}
    if got != want:
        fail("q100 TSV differs from the host engine")
    for k, c in launches.items():
        if c <= 0:
            fail(f"kernel {k} was not launched by the q100 search")
    print(f"[3] device engine: {len(got.splitlines())} rows byte-identical,"
          f" cold {cold_s:.2f} s, launches {launches}")
    torch.cuda.reset_peak_memory_stats()
    warm, stats = [], []
    for _ in range(3):
        text, secs, d = run_search(chains, "device")
        if text != want:
            fail("warm q100 TSV differs from the host engine")
        warm.append(secs)
        stats.append(d.device_stats)
    med = statistics.median(warm)
    st = stats[warm.index(med)]
    print(f"[3] warm median {med:.3f} s ({warm}), {pairs / med:.1f} pairs/s "
          f"over {pairs} pairs; stages {json.dumps(st)}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return launches


def phase_replica(base) -> None:
    from reseek_tpu.chain import Chain
    from reseek_tpu.constants import DSSParams
    rng = np.random.default_rng(REPLICA_SEED)
    chains = []
    for k in range(REPLICA_CHAINS):
        c = base[k % len(base)]
        noise = rng.normal(0, REPLICA_NOISE, c.coords.shape).astype(
            np.float32)
        chains.append(Chain(f"{c.label}/r{k // len(base)}", c.seq,
                            c.coords + noise))
    pairs = REPLICA_CHAINS * (REPLICA_CHAINS + 1) // 2
    torch.cuda.reset_peak_memory_stats()
    text, secs, drv = run_search(chains, "device")
    rows = [line.split("\t") for line in text.splitlines()]
    self_hits = {r[0] for r in rows if r[0] == r[1]}
    mkfl = DSSParams.create(MODE).mkfl
    short = {c.label for c in chains if len(c) < mkfl}
    if not short <= self_hits:
        fail(f"replica: {len(short - self_hits)} chains lack a self hit")
    print(f"[4] replica {REPLICA_CHAINS} chains: {secs:.2f} s, "
          f"{pairs / secs:.1f} pairs/s over {pairs} pairs, {len(rows)} rows "
          f"(hits {drv.hit_count}), stages {json.dumps(drv.device_stats)}, "
          f"peak {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")


def main() -> int:
    card = card_line()
    print(f"[0] card: {card}")
    print(f"[0] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    if not os.path.isdir(os.path.join(ROOT, "reseek_tpu_torch")):
        fail("reseek_tpu_torch not found: run from a checkout of the "
             "repository")
    from reseek_tpu.io.reader import read_chains
    from reseek_tpu.constants import DSSParams
    from reseek_tpu.search.driver import _encode_all
    from reseek_tpu_torch.device import disable_tf32
    from reseek_tpu_torch.search.engine import DeviceSelfSearch
    disable_tf32()
    kind = torch.cuda.get_device_name(0)
    print(f"[0] device: {kind} x {torch.cuda.device_count()}")

    phase_build()
    chains = read_chains(Q100)
    params = DSSParams.create(MODE)
    pipe = DeviceSelfSearch(_encode_all(chains, params, with_self_rev=False),
                            params, device="cuda")
    survivors = pipe.stage1_survivors()
    print(f"[2] q100 stage-1 survivors: {len(survivors)}")
    res = phase_kernels(pipe, survivors)
    phase_tie_prone(pipe.mumx)
    del pipe
    launches = phase_q100(chains)
    phase_replica(chains)

    print(card)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "max_abs_err": res[k]["max_abs_err"],
         "ms": res[k]["ms"], "plain_ms": res[k]["plain_ms"]}
        for k, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
