#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (reseek_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py             # every phase
    python3 chip_smoke.py --kernels   # phases 0-2 only
    python3 chip_smoke.py --stage1    # phases 0-1, the replica's stage 1
    python3 chip_smoke.py --walk      # phases 0-1, the walk alone
    python3 chip_smoke.py --sweep     # phases 0-1, the float sweep alone
    python3 chip_smoke.py --sass [NAME]   # phases 0-1, kernels' SASS opcodes
    python3 chip_smoke.py --bench-cmds    # phases 0-1, then phase 10
    python3 chip_smoke.py --io-cmds       # phases 0-1, then phase 11
    python3 chip_smoke.py --msa-cmds      # phases 0-1, then phase 12
    python3 chip_smoke.py --long          # phases 0-1, then phase 13
    python3 chip_smoke.py --long --parent DIR   # and the long entries'
                                          # times in the tree at DIR
    python3 chip_smoke.py --bands     # phases 0-1, the band kernel's rules
    python3 chip_smoke.py --mu-bands  # phases 0-1, the Mu band kernel's
    python3 chip_smoke.py --fwd-exact # phases 0-1, then phase 14

Phases, in order; any failure exits non-zero and prints no result:
  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
     fails without a CUDA device;
  1. builds the CUDA kernels from reseek_tpu_torch/csrc with nvcc, one
     process per source in parallel (build seconds, ptxas registers /
     shared memory / spills), and, beside them, the native host code of
     reseek_tpu_torch/native with g++ (the host engine's kernels: every
     library must load);
  2. holds each kernel against its plain PyTorch version on the card, at
     the shapes of the q100 searches (stage-1 block plan, stage-3 chunk
     shapes, the self-reversal batches and the survivors' stage-2
     batches), and times both (CUDA events behind a device spin, warm),
     the three kernels fed by the profiles (with traceback, the exact
     score and the float sweep) also beside the substitution gather-sum
     (profile_smx) they absorb, the walk beside its chain bound; then again on seeded random
     ragged, wide, rectangular, tall and tie-prone inputs (the float
     sweep up to 8,192 columns, and on pairs whose path crosses a warp
     boundary through a gap), and the walk on paths across many of its
     windows and row tiles;
  3. the q100 sensitive all-vs-all through reseek_tpu_torch's
     self_search(engine="device", device="cuda"): the TSV must equal the
     port's host engine (engine="host", the native host code) byte for
     byte; cold wall, warm median of 3, stage walls;
  4. the 1,024-chain replica (q100 chains plus 0.25 A Gaussian coordinate
     noise, seed 17, labels <label>/r<k>) through the same entry; every
     chain below the MKF length threshold must report its self hit;
  5. device self-reversal scores (the exact score-only wavefront) on q100
     and on the replica: equal to the host self_rev_score for every chain
     below the MKF length threshold;
  6. query-vs-DB, sensitive, the 100 q100 queries against the replica in
     DB chunks of 512, then once more under torch.profiler (device busy:
     the union of the CUDA kernel intervals, and the largest kernels): the
     rows of five queries must equal the host engine's query_search of
     those queries; 10 queries x q100 byte-identical to the host, also
     with the E-bound stage-2 prepass (the float row sweep) forced on;
  7. -fast (prefilter idxq, device stage 2): the 100 q100 queries against
     a 10,240-chain replica written as .cal; the five queries' rows must
     equal the host engine's fast_search of those queries; 10 queries x
     q100 byte-identical to the host;
  8. the mesh (every visible card, or ("cuda:0", "cuda:0") on one): the
     q100 self-search and query-vs-DB 100 x 1,024 dealt over it, each
     byte-equal to its one-device run of phases 3 and 6; the 10 x q100
     query with the E-bound prepass forced on, byte-equal to the host;
     the device self-rev scores of phase 5's two sets, equal to phase 5's;
     each kernel's launches per device (every stage-1/3 kernel on every
     card; the stage-2 kernels on every card their chunks are dealt to),
     mesh and one-device walls;
  9. multi-process -fast: the 10,240-chain replica written as .bca, the
     100 q100 queries through the CLI (--engine device) in one process,
     then in two Gloo rank processes (--nprocs 2), then the two again
     with --resume: rank 0's -o must equal the one-process output each
     time, rank 1 must not create its -o, every rank of the first
     two-rank run must launch the stage-1/3 kernels and every resumed
     rank must reuse its rows and launch nothing; the three walls;
 10. the benchmark commands through the CLI, in-process: on the 139
     chains of tests/golden/sepq_set.cal, scop40bench --sensitive and
     --fast, distmx, calibrate and calibrate2 --benchlevel sf on the
     device engine (--engine device) must print and write what the host
     engine does, byte for byte, and the sensitive SEPQs must lie within
     5e-4 of the reference binary's; then scop40bench --fast on a
     2,048-chain labeled replica (the 101 chains below fast mode's MKF
     length, 0.25 A noise, seed 17, labels <dom>_r<k>/<scopid> and their
     lookup): every chain has its self hit, the stage-1/3 kernels
     launch, the SEPQs lie in [0, 1]; wall, pairs/s, stages, peak memory;
 11. the structure I/O, format and pair-alignment commands through the
     CLI, in-process (phase_io_cmds: convert's round trips and .rsdx
     index, the device searches of the .rsdx and the .bca against the
     host engine, the reference spelling, alignpair, test-xdrop, the
     Foldseek DB round trip, align-bags / alignselfrev / tracealn), and
     the graft entry points of reseek_tpu_torch/graft_entry.py: entry()
     against its plain version and dryrun_multichip over the mesh;
 12. the MSA scoring, training and diagnostic commands through the CLI,
     in-process (phase_msa_cmds: each output against the reference
     binary's in tests/golden where there is one, else a digest; the
     reference spelling; mukmerfilter "Obsolete"), then the legacy
     square-bucket engine (phase_legacy, reseek_tpu_torch/search/
     batched.py) on the q100 chains: its kernels against their plain
     versions at buckets 96, 384 and 1,536, its self-reversal scores
     bit-equal to the host's, batched_self_search equal pair for pair to
     the host PairAligner, the five stage kernels launched and the float
     sweep not; then timed on the 1,024-chain replica, every chain below
     the MKF length with its self hit;
 13. --verysensitive past the kernels' column limits (phase_long): chains
     of 8,000 and 12,000 residues made of q100 chains end to end, and the
     12,000-residue one with 0.25 A noise (seed 17), beside the 8
     shortest q100 chains.  Each long-column variant at a shape the main
     path gives it (sw_align and sw_score_profiles, the band kernel, at
     the 8,000 x 12,000 pairs' 2 x 8,192 x 16,384, and score only at the
     self-rev's 1 x 16,384 x 16,384; the Mu filter's band kernel at the
     legacy bucket, 2 x 12,032 x 12,032, at one pair of it, on a ragged
     batch there whose A sides end mid-band, and on two whole stage-1
     blocks of the --omega search, short rows against the 16,384 edge (R
     = 4) and its largest, 128 pairs of 16,384 x 16,384 (R = 8, blocks
     queued), the plain version on their distinct pairs; LDDT at 2 x
     12,000, at one pair of it, at M = 7,681 and at 8 x 8,000) against its
     plain version (bit-equal; LDDT within 1e-6, risky equal), the band
     kernels also on tie-prone
     random pairs (3 x 600 x 8,448: a best cell repeated in two bands, a
     pair with no positive cell, two-letter features) and below the
     column limit on stage-3 chunks of the long chains (8 x 8,192 x
     8,192 at R = 4, 32 x 4,096 x 512 at R = 8), with their rows a lane,
     band height, blocks in flight, SMs a pair and chain bound, and the
     walk on the first gate's traceback; the device
     self-reversal scores equal to the host's; the self-search and the
     12,000-residue query against the
     11 chains and one of 20,000 residues (stage-3 edge 32,768)
     byte-equal to the host engine, every long chain with its self hit;
     a --verysensitive --omega 12 self-search (the Mu filter back on, as
     a user's --omega turns it) of the 8,000- and 12,000-residue chains
     and the 8 short ones byte-equal to the host engine, launching
     mu_sweep_long; the legacy engine (sensitive filters, MKF routing off)
     on the two long chains and the 8 short ones equal to the host
     PairAligner pair for pair.  With --parent DIR, first the long
     entries' times (the band SW entries, mu_sweep_long, lddt_long) in
     the tree at DIR and in this one, each in a subprocess, their outputs
     bit-equal.
 14. the forward score the host finish takes as exact (phase_fwd_exact):
     one job of the benchmark's scop40.fast cell (512 domains drawn by
     portbench's generator from FWD_EXACT_SEED) through self_search on
     the card;
     on every one of its stage-3 pairs, those the E-gate skips included,
     the SW kernels' score must equal the host SW (_exact_fwd_score) bit
     for bit; the pairs compared, the finish's recomputes and walls.
--bands times the band kernel against the shared-memory kernel, and its
R = 4 against R = 8, at BAND_SHAPES (phase_bands), the rules of
ops/sw_align.py's sw_align_uses_bands and rows_per_lane; --mu-bands the
Mu filter's band kernel at R = 4 and R = 8 against the shared-memory
kernel at MU_BAND_SHAPES and the --omega search's stage-1 blocks past
8,192 columns (phase_mu_bands), the rules of ops/sw_sweep.py's
mu_uses_global and mu_band_rows.
Each kernel must have been launched by the run of the phase that KERNELS
names for it (counts set to 0 just before that run, read just after);
the query, -fast, mesh and phase 11's searches must launch every
stage-1/3 kernel too, entry()'s fn the score-only kernel, and phase 12's
legacy engine the kernels of its four stages (mu_sweep, sw_score,
sw_align, walk_traceback, lddt); phase 13's runs the long variants that
LONG_KERNELS names.
The last two lines are a JSON object of per-kernel results (times, the
bound the card could reach at the timed shape and what binds it) and
{"ok": true, "device": {...}}.  Imports neither JAX nor reseek_tpu: the
oracle is the port's own host engine, which the CPU tests hold
byte-equal to reseek_tpu's.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
Q100 = os.path.join(ROOT, "tests", "golden", "q100.cal")
SEPQ_CAL = os.path.join(ROOT, "tests", "golden", "sepq_set.cal")
SEPQ_LOOKUP = os.path.join(ROOT, "tests", "golden", "sepq_set.lookup")
# the reference binary's -scop40bench on sepq_set (sensitive), and the
# tolerance of the port's SEPQs against it
SEPQ_REF = {"SEPQ0.1": 0.3831, "SEPQ1": 0.6057, "SEPQ10": 0.6405}
SEPQ_TOL = 5e-4
BENCH_CHAINS = 2048
COLUMNS = "query+target+qlo+qhi+tlo+thi+evalue+cigar"
MODE = "sensitive"
DEVICE = "cuda"
REPLICA_CHAINS = 1024
FAST_DB_CHAINS = 10240
REPLICA_SEED = 17
REPLICA_NOISE = 0.25
LDDT_TOL = 1e-6
SWEEP_TOL = 1e-3          # float row sweep vs the exact wavefront score
QUERY_CHUNK = 512
RANK_TIMEOUT = 400        # seconds for a run of the CLI's rank processes
FIVE = [18, 21, 22, 26, 40]
TEN = list(range(10))
# the 16 q100 chains (245-1,231 residues) of phase 11's pair alignments
IO_SUBSET = [18, 21, 22, 26, 40, 46, 50, 64, 69, 72, 94, 95, 96, 97, 98, 99]
# kernel -> (CUDA source, the TPU kernel or JAX scan it replaces, the run
# that must launch it)
KERNELS = {
    "mu_sweep": ("reseek_tpu_torch/csrc/mu_wavefront.cu",
                 "reseek_tpu/ops/sw_sweep.py:327", "q100"),
    "sw_score_sweep": ("reseek_tpu_torch/csrc/sw_sweep.cu",
                       "reseek_tpu/ops/sw_sweep.py:206", "query_prepass"),
    "sw_align": ("reseek_tpu_torch/csrc/sw_align.cu",
                 "reseek_tpu/ops/sw_pallas.py:252", "q100"),
    "sw_score": ("reseek_tpu_torch/csrc/sw_align.cu",
                 "reseek_tpu/ops/sw_pallas.py:166", "self_rev"),
    "walk_traceback": ("reseek_tpu_torch/csrc/postalign.cu",
                       "reseek_tpu/ops/postalign_jax.py:20", "q100"),
    "lddt": ("reseek_tpu_torch/csrc/postalign.cu",
             "reseek_tpu/ops/postalign_jax.py:79", "q100"),
}
# the kernels that every pair-list search (query-vs-DB, -fast) launches
SEARCH_KERNELS = ("mu_sweep", "sw_align", "walk_traceback", "lddt")
# phase 13: the long chains' lengths (residues), the gap between their
# pieces along x (A; clear of LDDT's 15 A radius), and the mode of the
# searches
LONG_LENGTHS = (8000, 12000)
LONG_GAP = 50.0
LONG_MODE = "verysensitive"
# phase 13: the chain of ~20,000 residues added to the searches (stage-3
# edge 32,768), and the tie-prone band gates' shape: 3 pairs of 600 rows
# (5 bands of 128, the last of 88) x 8,448 columns, the best cell of the
# first pair in two bands
LONG_XL = 20000
TIE_SHAPE = (3, 600, 8448)
# --bands: the shapes (pairs, LA, LB) at which sw_align ("align") and
# sw_score_profiles ("score") run by the shared-memory kernel (up to 8,192
# columns) and by the band kernel at R = 4 and R = 8: phase 2's largest
# stage-3 chunk and self-rev batch, stage-3 chunks at edges 4,096 and
# 8,192 (one to eight pairs), rectangular ones of short columns up to the
# most pairs a chunk past 2,048 rows holds (2^26 cells), phase 13's gate
# shape and the self-rev's
BAND_SHAPES = ((213, 512, 512, ("align",)), (37, 512, 512, ("score",)),
               (1, 8192, 8192, ("align",)), (8, 8192, 8192, ("align",)),
               (8, 4096, 4096, ("align",)), (32, 4096, 512, ("align",)),
               (128, 4096, 128, ("align",)), (64, 8192, 128, ("align",)),
               (64, 4096, 256, ("align",)), (32, 8192, 256, ("align",)),
               (2, 4096, 256, ("align",)), (16, 8192, 512, ("align",)),
               (2, 4096, 512, ("align",)), (16, 4096, 1024, ("align",)),
               (2, 8192, 16384, ("align", "score")),
               (1, 16384, 16384, ("align", "score")))
# long-column variant -> (CUDA source, the TPU kernel it replaces, the
# run of phase 13 that must launch it)
LONG_KERNELS = {
    "sw_align_long": ("reseek_tpu_torch/csrc/sw_align.cu",
                      "reseek_tpu/ops/sw_pallas.py:252", "search"),
    "sw_score_long": ("reseek_tpu_torch/csrc/sw_align.cu",
                      "reseek_tpu/ops/sw_pallas.py:166", "self_rev"),
    "lddt_long": ("reseek_tpu_torch/csrc/postalign.cu",
                  "reseek_tpu/ops/postalign_jax.py:79", "search"),
    "mu_sweep_long": ("reseek_tpu_torch/csrc/mu_wavefront.cu",
                      "reseek_tpu/ops/sw_sweep.py:327", "omega"),
}
# phase 13: --omega of the self-search that turns the Mu filter back on
# under --verysensitive (a user's flag), whose stage-1 blocks of the long
# chains take mu_sweep_long
LONG_OMEGA = 12.0
# --mu-bands: the shapes (pairs, LA, LB) at which the Mu filter runs by
# the shared-memory kernel (up to 8,192 columns) and by the band kernel at
# R = 4 and R = 8: the legacy bucket past the limit, tall shapes with few
# pairs below it; then the stage-1 blocks of the --omega self-search that
# take the band kernel (phase_mu_bands adds them from its block plan)
MU_BAND_SHAPES = ((2, 12032, 12032), (1, 12032, 12032), (2, 4096, 4096),
                  (2, 8192, 8192), (8, 2048, 8192))
# phase 14: the benchmark cell one of whose jobs the forward-score gate
# compares, and the seed of the job's draw
FWD_EXACT_CELL = "scop40.fast"
FWD_EXACT_SEED = 3180001001
# the native host code, built with g++ at first use (module of the port,
# its loader _lib)
NATIVE = ("encoder.native", "align.mkf_native", "ops.lddt", "ops.sw_native",
          "search.prefilter")
# The card's published peaks (H100 SXM data sheet, at its full 700 W):
# device memory bandwidth and the float32 rate outside the tensor cores
# (none of these kernels is a matrix product).  A kernel's bound is the
# larger of its bytes (each input read once, each output written once)
# over the first and its operations over the second.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
# float32 operations of one DP cell: the recurrence's adds and maxima or
# compares (the profile-fed kernels add the 7 adds of the 8-feature
# score); LDDT's per unordered column pair: two squared distances, two
# roots, the difference and its four threshold compares
CELL_OPS = {"mu_sweep": 10, "sw_score_sweep": 17, "sw_score": 17,
            "sw_align": 17}
LDDT_PAIR_OPS = 24
# the walk's chain bound: one shared-memory load-to-use latency a step, an
# estimate in SM cycles (the card's maximum SM clock from nvidia-smi)
SMEM_LATENCY_CYCLES = 30
# the SW wavefront's chain bound: LA + LB dependent cells of the gap
# extension's add, compare and select (E down a column, F along a row),
# ~4 cycles each, an estimate
CELL_CHAIN_CYCLES = 12
# the device spin that time_ms queues its calls behind (~10 ms)
SPIN_CYCLES = 20_000_000


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line(query: str = "name,power.limit") -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({exc})"


@functools.lru_cache(maxsize=1)
def sm_clock_hz() -> float:
    """The first card's maximum SM clock (nvidia-smi clocks.max.sm)."""
    line = card_line("clocks.max.sm").splitlines()[0]
    try:
        return float(line.split()[0]) * 1e6
    except (IndexError, ValueError):
        fail(f"no SM clock from nvidia-smi: {line!r}")


def time_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean milliseconds per call on the current stream (CUDA events).  The
    calls are queued behind a device spin of SPIN_CYCLES, so a kernel
    shorter than its wrapper's host time is timed on the device, not at
    the rate the host launches it."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


class Launches:
    """Kernel launch counts of one run: ``with Launches() as n: run()``
    sets every wrapper's counts to 0 on entry and leaves {kernel: count}
    in ``n.counts`` and {kernel: {device: count}} in ``n.by_device`` on
    exit."""

    def __enter__(self):
        from reseek_tpu_torch.ops import kernel_wrappers
        self.wrappers = kernel_wrappers()
        for w in self.wrappers.values():
            w.launches = 0
            w.by_device.clear()
        return self

    def __exit__(self, *exc):
        self.counts = {k: w.launches for k, w in self.wrappers.items()}
        self.by_device = {k: dict(w.by_device)
                          for k, w in self.wrappers.items()}
        return False

    def require(self, names, what: str) -> None:
        for k in names:
            if self.counts[k] <= 0:
                fail(f"kernel {k} was not launched by {what}")

    def require_devices(self, devices, what: str, names=None) -> None:
        """Fail unless every one of ``devices`` had a launch of each kernel
        in ``names`` (of any kernel when None)."""
        per = ([self.by_device[k] for k in names] if names is not None
               else [{d: sum(n.get(d, 0) for n in self.by_device.values())
                      for d in devices}])
        idle = sorted({d for n in per for d in devices if not n.get(d)})
        if idle:
            fail(f"{what} launched {'no kernel' if names is None else names}"
                 f" on {idle}")


def device_busy(fn) -> tuple:
    """Run ``fn`` once under torch.profiler (CPU and CUDA activity):
    (host wall to a synchronize, device busy seconds = the union of the
    CUDA kernel intervals, [(kernel, seconds)] of the 8 largest)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        fail("the profiler saw no device time")
    busy, end, by_name = 0.0, float("-inf"), {}
    for a, b, name in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return wall, busy * 1e-6, top


def bound(nbytes: float, ops: float):
    """(least milliseconds the card could take, what binds it)."""
    by_bytes = nbytes / PEAK_BYTES_S * 1e3
    by_ops = ops / PEAK_FP32_S * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def phase_build() -> None:
    """The CUDA kernels (nvcc) and the native host code (g++), all
    compilers started together."""
    import importlib
    from reseek_tpu_torch import kernels
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(NATIVE) + 1) as tp:
        cuda = tp.submit(kernels.build)
        native = {m: tp.submit(importlib.import_module(
            "reseek_tpu_torch." + m)._lib) for m in NATIVE}
        info = cuda.result()
        libs = {m: f.result() for m, f in native.items()}
    missing = [m for m, lib in libs.items() if lib is None]
    if missing:
        fail(f"native host code did not build or load: {missing}")
    print(f"[1] build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{info.seconds:.2f} s) -> {info.path.name}; native "
          f"{sorted(os.path.basename(lib._name) for lib in libs.values())}")
    for line in info.log.splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill",
                                   "smem")):
            print("    ptxas:", line.strip().removeprefix("ptxas info    : "))
    kernels.lib()


def gather_sum(pipe, lea: int, leb: int, ia, ib, prof_b=None):
    """The profile substitution tensor [n, lea, leb] of sorted-index pairs
    (ia, ib), the B side from ``prof_b`` (default: the profiles): the
    gather-sum that the profile-fed kernels absorb, their yardstick."""
    from reseek_tpu_torch.ops.smx import profile_codes, profile_smx
    prof_b = pipe.prof if prof_b is None else prof_b
    ca = profile_codes(pipe.prof[ia, :, :lea], pipe.offsets, pipe.pad_code)
    cb = profile_codes(prof_b[ib, :, :leb], pipe.offsets, pipe.pad_code)
    return profile_smx(ca, cb, pipe.w)


def phase_sass(pattern: str) -> None:
    """Opcode counts of the SASS of each kernel whose mangled name holds
    ``pattern``, from cuobjdump -sass of the library phase 1 built: what
    a kernel issues, beside the ptxas report."""
    import collections
    import re
    import shutil
    from reseek_tpu_torch import kernels
    exe = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([exe, "-sass", str(kernels.build().path)],
                          capture_output=True, text=True, timeout=300).stdout
    op = re.compile(r"/\*[0-9a-f]{4,}\*/\s+"        # the address
                    r"(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)")   # opcode
    for block in text.split("Function : ")[1:]:
        name = block.split()[0]
        if pattern in name:
            ops = collections.Counter(m.group(1) for m in op.finditer(block))
            print(f"[sass] {name}: {sum(ops.values())} instructions; "
                  + ", ".join(f"{k} {n}" for k, n in ops.most_common(20)))


def phase_kernels(pipe, survivors: np.ndarray) -> dict:
    """Each kernel against its plain version at the main path's shapes.
    Returns {kernel: {max_abs_err, ms, plain_ms, bound_ms, bound_by, ...}}
    (times and bound at the largest shape; the profile-fed kernels also
    with ``smx_ms``, the gather-sum they absorb, timed alone)."""
    from reseek_tpu_torch.ops.postalign import (lddt_batch, lddt_batch_ref,
                                                walk_traceback_batch,
                                                walk_traceback_batch_ref)
    from reseek_tpu_torch.ops.sw_align import (sw_align, sw_align_ref,
                                               sw_score_profiles,
                                               sw_score_profiles_ref)
    from reseek_tpu_torch.ops.sw_sweep import (mu_lane_bits, mu_sw_scores,
                                               mu_sw_scores_ref,
                                               sw_score_sweep,
                                               sw_score_sweep_profiles_ref,
                                               sweep_layout)
    from reseek_tpu_torch.search.engine import aligned_coords
    p = pipe.params
    res = {k: {"max_abs_err": 0.0, "ms": None, "plain_ms": None, "cells": -1,
               "shape": None} for k in KERNELS}

    def record(name, err, cells, shape, ms_fn, plain_fn, reps, nbytes, ops,
               extra=(), values=None):
        """Keep the error; time at the largest shape, with its bound, the
        ``extra`` (key, timed function) pairs and the computed ``values``
        ({key: value})."""
        r = res[name]
        r["max_abs_err"] = max(r["max_abs_err"], float(err))
        if cells > r["cells"]:
            r["cells"] = cells
            r["shape"] = shape
            r["ms"] = time_ms(ms_fn, reps)
            r["plain_ms"] = time_ms(plain_fn, 1)
            r["bound_ms"], r["bound_by"] = bound(nbytes, ops)
            for key, fn in extra:
                r[key] = time_ms(fn, reps)
            r.update(values or {})

    # K1: first block of every stage-1 shape group (the self-search), then
    # the first batch of every stage-1 shape of query-vs-DB and -fast
    # (stage1_scores on explicit pairs: all ordered q100 pairs)
    o, e = -float(p.para_mu_gap_open), -float(p.para_mu_gap_ext)
    mt = pipe.mu_table
    n = len(pipe.ecs)
    inputs = [pipe.stage1_letters(*key, *starts[0][:2])[:2]
              for key, starts in pipe.stage1_block_plan().items()]
    seen = set()
    for _rr, _v, a, b in pipe.stage1_pair_letters(np.stack(np.meshgrid(
            np.arange(n), np.arange(n), indexing="ij"), -1).reshape(-1, 2)):
        if (a.shape[1], b.shape[1]) not in seen:
            seen.add((a.shape[1], b.shape[1]))
            inputs.append((a, b))
    for a, b in inputs:
        bsz, lea, leb = a.shape[0], a.shape[1], b.shape[1]
        got = mu_sw_scores(a, b, mt, o, e)
        want = mu_sw_scores_ref(a, b, mt.mumx, o, e)
        if not torch.equal(got, want):
            fail(f"mu_sweep != plain at {(bsz, lea, leb)}")
        print(f"[2] mu_sweep B={bsz} LA={lea} LB={leb}: equal (int"
              f"{mu_lane_bits(lea, leb, mt.smax, mt.smin, int(o), int(e))})")
        cells = bsz * lea * leb
        record("mu_sweep", (got - want).abs().max(), cells,
               (bsz, lea, leb), lambda: mu_sw_scores(a, b, mt, o, e),
               lambda: mu_sw_scores_ref(a, b, mt.mumx, o, e), 5,
               a.numel() + b.numel() + 2 * mt.tab16.numel() + 4 * bsz,
               cells * CELL_OPS["mu_sweep"])
    # the largest scores: self-pairs of the best-scoring diagonal letter,
    # an odd batch, in both lane types (int16 pairs at 1,024 a side, int32
    # at 8,192, where the score 4 x 8,192 leaves int16)
    diag = mt.mumx.diagonal()[:36]
    best = int(diag.argmax())
    for le, bsz, bits in ((1024, 5, 16), (8192, 3, 32)):
        if mu_lane_bits(le, le, mt.smax, mt.smin, int(o), int(e)) != bits:
            fail(f"mu_sweep at {le} x {le} would not run int{bits}")
        a = torch.full((bsz, le), best, dtype=torch.uint8, device=DEVICE)
        a[1, le // 2:] = 36        # one shorter pair
        got = mu_sw_scores(a, a, mt, o, e)
        want = mu_sw_scores_ref(a, a, mt.mumx, o, e)
        top = float(diag[best]) * le
        if not torch.equal(got, want) or float(got.max()) != top:
            fail(f"mu_sweep != plain on self-pairs at {le} ({got.tolist()}"
                 f", plain {want.tolist()}, top {top})")
        print(f"[2] mu_sweep self-pairs {bsz} x {le} x {le} (int{bits}): "
              f"equal, top score {top:.0f}")

    # K2-K4: first chunk of every stage-3 shape; the stage-3 kernel reads
    # the profiles, and is timed beside the gather-sum it absorbs
    go, ge = float(p.gap_open), float(p.gap_ext)
    nf = pipe.prof.shape[1]
    seen = set()
    for lea, leb, chunk, ia, ib in pipe.stage3_plan(survivors):
        if (lea, leb) in seen:
            continue
        seen.add((lea, leb))
        nb = len(ia)
        cells = nb * lea * leb
        args = (pipe.prof, ia, ib, pipe.table, lea, leb, go, ge)
        best, bi, bj, tb = got = sw_align(*args)
        want = sw_align_ref(*args)
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            fail(f"sw_align != plain at {(nb, lea, leb)}")
        record("sw_align", (best - want[0]).abs().max(), cells,
               (nb, lea, leb), lambda: sw_align(*args),
               lambda: sw_align_ref(*args), 3,
               nb * nf * (lea + leb) + 4 * pipe.table.blocks.numel()
               + cells // 2 + 12 * nb, cells * CELL_OPS["sw_align"],
               [("smx_ms", lambda: gather_sum(pipe, lea, leb, ia, ib))])

        walk = walk_traceback_batch(tb, best, bi, bj, lea)
        rwalk = walk_traceback_batch_ref(tb, best, bi, bj, lea)
        if not all(torch.equal(x, y) for x, y in zip(walk, rwalk)):
            fail(f"walk_traceback != plain at {(nb, lea, leb)}")
        # data-dependent: the path cells read, the codes and ends written;
        # beside it the chain bound (the longest path, a shared-memory
        # latency a step)
        record("walk_traceback", 0.0, cells, (nb, lea, leb),
               lambda: walk_traceback_batch(tb, best, bi, bj, lea),
               lambda: walk_traceback_batch_ref(tb, best, bi, bj, lea), 20,
               int(walk[2].sum()) + walk[3].numel() + 24 * nb, 0,
               values={"chain_bound_ms": int(walk[2].max())
                       * SMEM_LATENCY_CYCLES / sm_clock_hz() * 1e3})

        # LDDT's columns as the engine caps them: the chunk's largest
        # shorter-chain length
        m = pipe.m_cap(chunk)
        cq, ct, valid, n_m = aligned_coords(walk[3], bi, bj, ia, ib,
                                            pipe.coords, m)
        lddt, risky = lddt_batch(cq, ct, valid, n_m)
        rlddt, rrisky = lddt_batch_ref(cq, ct, valid, n_m)
        err = (lddt - rlddt).abs()[~rrisky].max() if bool(
            (~rrisky).any()) else torch.zeros(())
        if not torch.equal(risky, rrisky) or float(err) > LDDT_TOL:
            fail(f"lddt != plain at {(nb, lea, leb)}: err {float(err)}")
        nm = n_m.long()
        # the bound counts each unordered column pair once, as the
        # function needs (the reference's upper triangle)
        record("lddt", err, int(n_m.sum()) * m,
               (nb, m), lambda: lddt_batch(cq, ct, valid, n_m),
               lambda: lddt_batch_ref(cq, ct, valid, n_m), 5,
               8 * cq.numel() + valid.numel() + 4 * nb + 5 * nb,
               int((nm * (nm - 1) // 2).sum()) * LDDT_PAIR_OPS,
               [(f"cluster{c}_ms", functools.partial(
                   lddt_batch, cq, ct, valid, n_m, cluster=c))
                for c in (1, 2, 4, 8)])
        print(f"[2] stage-3 kernels B={nb} LA={lea} LB={leb}: equal "
              f"(lddt err {float(err):.3g}, risky {int(risky.sum())})")

    # K5 the exact score from the profiles at the self-reversal batches
    # (each chain below mkfl against its reversed profile), timed beside
    # the gather-sum it no longer needs
    own = pipe.order[:pipe.dev_end]
    for le, _rows, ia, ib in pipe.stage2_plan(np.stack([own, own], 1)):
        nb = len(ia)
        args = (pipe.prof, pipe.prof_rev, ia, ib, pipe.table, le, le, go, ge)
        got, want = sw_score_profiles(*args), sw_score_profiles_ref(*args)
        if not torch.equal(got, want):
            fail(f"sw_score != plain at the self-rev {(nb, le, le)}")
        cells = nb * le * le
        record("sw_score", (got - want).abs().max(), cells, (nb, le, le),
               lambda: sw_score_profiles(*args),
               lambda: sw_score_profiles_ref(*args), 5,
               2 * nb * nf * le + 4 * pipe.table.blocks.numel() + 4 * nb,
               cells * CELL_OPS["sw_score"],
               [("smx_ms", lambda: gather_sum(pipe, le, le, ia, ib,
                                              pipe.prof_rev))])
        print(f"[2] sw_score self-rev B={nb} L={le}: equal")
    # K6 the float sweep from the profiles at the survivors' stage-2
    # batches: bit-equal to its plain version (the gather-sum, then the row
    # sweep), and within SWEEP_TOL of the exact score of the same pairs,
    # which equals its own plain version there; timed beside the
    # gather-sum it no longer needs.  Its bound counts the cells this data
    # needs: rows and columns up to each pair's chain ends (no other cell
    # can raise the best); the full squares' in square_bound_ms
    lens = torch.as_tensor(pipe.sorted_lens)
    for le, _rows, ia, ib in pipe.stage2_plan(survivors):
        nb = len(ia)
        args = (pipe.prof, pipe.prof, ia, ib, pipe.table, le, le, go, ge)
        got = sw_score_sweep(*args)
        want = sw_score_sweep_profiles_ref(*args)
        if not torch.equal(got, want):
            fail(f"sw_score_sweep != plain at {(nb, le, le)}")
        exact = sw_score_profiles(*args)
        if not torch.equal(exact, sw_score_profiles_ref(*args)):
            fail(f"sw_score != plain at the survivors' {(nb, le, le)}")
        off = float((got - exact).abs().max())
        if off > SWEEP_TOL:
            fail(f"sw_score_sweep differs from sw_score by {off} at "
                 f"{(nb, le, le)}")
        cells = nb * le * le
        real = int((lens[ia.cpu()].clamp(max=le)
                    * lens[ib.cpu()].clamp(max=le)).sum())
        nbytes = 2 * nb * nf * le + 4 * pipe.table.blocks.numel() + 4 * nb
        record("sw_score_sweep", (got - want).abs().max(), cells,
               (nb, le, le), lambda: sw_score_sweep(*args),
               lambda: sw_score_sweep_profiles_ref(*args), 5, nbytes,
               real * CELL_OPS["sw_score_sweep"],
               [("smx_ms", lambda: gather_sum(pipe, le, le, ia, ib))],
               values={"square_bound_ms": bound(
                   nbytes, cells * CELL_OPS["sw_score_sweep"])[0]})
        print(f"[2] sw_score_sweep B={nb} L={le}: equal (V, warps a pair "
              f"{sweep_layout(le)}; vs sw_score {off:.3g}); sw_score equal;"
              f" real cells {real}")
    for name, r in res.items():
        if r["ms"] is None:
            fail(f"{name}: no main-path shape to compare at")
        smx = "".join(f", {k} {v:.4f}" for k, v in extra_times(r).items())
        print(f"[2] {name} at {r['shape']}: kernel {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}){smx}, max_abs_err {r['max_abs_err']:.3g}")
    return res


def extra_times(r: dict) -> dict:
    """The extra timings of a kernel's phase-2 result: the profile-fed
    kernels' gather-sum yardstick, the float sweep's other warp counts,
    LDDT's times per cluster size, the float sweep's full-square bound."""
    return {k: v for k, v in r.items() if k.endswith("_ms")
            and k not in ("ms", "plain_ms", "bound_ms")}


def phase_tie_prone(pipe) -> None:
    """Each kernel against its plain version on seeded random inputs the
    q100 shapes do not reach: ragged rows, wide rows (the other lane-count
    variants), random profiles on rectangular and tall shapes (several
    passes of the stage-3 kernel) and tie-prone ones (two letters a
    feature), a pair with no positive cell, the float sweep on such
    profiles up to MAX_LB and on paths through a gap across a warp
    boundary, 0.1 A-rounded coordinates."""
    from reseek_tpu_torch.ops.postalign import (lddt_batch, lddt_batch_ref,
                                                walk_traceback_batch,
                                                walk_traceback_batch_ref)
    from reseek_tpu_torch.ops.smx import flat_layout
    from reseek_tpu_torch.ops.sw_align import (FeatureTable, sw_align,
                                               sw_align_ref, sw_score_profiles,
                                               sw_score_profiles_ref)
    from reseek_tpu_torch.ops.sw_sweep import (mu_sw_scores, mu_sw_scores_ref,
                                               sw_score_sweep,
                                               sw_score_sweep_profiles_ref,
                                               sweep_layout)
    rng = np.random.default_rng(0)
    mt, table = pipe.mu_table, pipe.table
    dev = mt.mumx.device
    go, ge = float(pipe.params.gap_open), float(pipe.params.gap_ext)

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
        if not torch.equal(mu_sw_scores(a, b, mt, -2.0, -1.0),
                           mu_sw_scores_ref(a, b, mt.mumx, -2.0, -1.0)):
            fail(f"mu_sweep != plain on random letters {(la, lb)}")
    # stage 3 on random profiles [n, F, L]: ragged chain ends (PAD_BYTE
    # past them), row 0 all padding (pair 1 has no positive cell); few =
    # two letters a feature, so scores tie everywhere; the last case has
    # three features (the kernel is specialised for the default eight)
    off3, _, w3 = flat_layout(("AA", "Conf", "NENDist"), (0.5, 0.3, 0.2))
    table3 = FeatureTable.build(torch.tensor(w3, device=dev),
                                torch.tensor(off3, dtype=torch.int64,
                                             device=dev))
    def profiles(tab, n, length, few):
        """[n, F, length] uint8 profiles on the card: PAD_BYTE past random
        chain ends, row 0 all padding; few: two letters a feature."""
        prof = np.full((n, len(tab.sizes), length), 255, np.uint8)
        for k in range(1, n):
            ln = rng.integers(1, length + 1)
            for f, size in enumerate(tab.sizes):
                prof[k, f, :ln] = rng.integers(0, 2 if few else size, ln)
        return torch.tensor(prof, device=dev)

    for tab, n, length, la, lb, few in ((table, 24, 600, 600, 130, False),
                                        (table, 24, 256, 40, 256, True),
                                        (table, 24, 1100, 1024, 1100, True),
                                        (table, 16, 2100, 2100, 300, False),
                                        (table, 6, 9000, 8500, 96, False),
                                        (table3, 24, 700, 700, 300, False)):
        prof = profiles(tab, n, length, few)
        ia = torch.tensor(rng.integers(0, n, n), device=dev)
        ib = torch.tensor(rng.integers(0, n, n), device=dev)
        ia[1] = 0
        for o, e in ((go, ge), (-1.5, -0.25)):
            args = (prof, ia, ib, tab, la, lb, o, e)
            got, want = sw_align(*args), sw_align_ref(*args)
            walk = walk_traceback_batch(got[3], *got[:3], la)
            rwalk = walk_traceback_batch_ref(got[3], *got[:3], la)
            if not (all(torch.equal(x, y) for x, y in zip(got, want))
                    and all(torch.equal(x, y) for x, y in zip(walk, rwalk))
                    and float(got[0][1]) == 0.0):
                fail(f"sw_align/walk != plain on random profiles "
                     f"{(la, lb, few, o, e)}")
            sargs = (prof, prof, ia, ib, tab, la, lb, o, e)
            score = sw_score_profiles(*sargs)
            if not (torch.equal(score, sw_score_profiles_ref(*sargs))
                    and torch.equal(score, got[0])):
                fail(f"sw_score != plain or sw_align's best "
                     f"{(la, lb, few, o, e)}")
    # float sweep on random profiles: ragged chain ends, row 0 all padding
    # (pair 1 has no positive cell), few = two letters a feature; every
    # lane-count variant (V = 1-16 at one warp a pair, 2-16 warps up to
    # MAX_LB), the 8-feature table and table3, both penalty pairs; within
    # SWEEP_TOL of the exact score where its plain version is quick
    for tab, n, la, lb, few in ((table, 12, 40, 24, False),
                                (table, 12, 70, 50, True),
                                (table, 12, 2048, 96, True),
                                (table3, 12, 600, 130, False),
                                (table, 12, 200, 400, False),
                                (table, 12, 300, 600, True),
                                (table, 8, 100, 2048, False),
                                (table3, 6, 50, 4100, False),
                                (table, 4, 40, 8192, True)):
        prof = profiles(tab, n, max(la, lb), few)
        ia = torch.tensor(rng.integers(0, n, n), device=dev)
        ib = torch.tensor(rng.integers(1, n, n), device=dev)
        ia[1] = 0
        for o, e in ((go, ge), (-1.5, -0.25)):
            args = (prof, prof, ia, ib, tab, la, lb, o, e)
            sweep = sw_score_sweep(*args)
            if not (torch.equal(sweep, sw_score_sweep_profiles_ref(*args))
                    and float(sweep[1]) == 0.0
                    and (la * lb > 2e5 or float((sweep - sw_score_profiles(
                        *args)).abs().max()) <= SWEEP_TOL)):
                fail(f"sw_score_sweep != plain on random profiles "
                     f"{(la, lb, few, o, e)}")
    # a path whose gap opens in the last columns of a warp and resumes in
    # the next warp or a later one: the B side is a q100 chain with g
    # random columns inserted after column cw - 2 + d (cw a warp's first
    # column; d = 1 puts one random column first), so the path's F term
    # at column cw or cw + 1 is one a warp reads after its barrier
    lens = torch.as_tensor(pipe.sorted_lens)
    nf = pipe.prof.shape[1]
    for la, cw, g in ((400, 256, 150), (712, 512, 600), (700, 512, 4000)):
        src = int(torch.nonzero(lens >= la).flatten()[0])
        a = pipe.prof[src, :, :la].cpu().numpy()
        prof = np.full((3, nf, la + g + 1), 255, np.uint8)
        prof[0, :, :la] = a
        for d in (0, 1):
            ins = np.stack([rng.integers(0, k, g) for k in table.sizes])
            first = np.stack([rng.integers(0, k, d) for k in table.sizes])
            prof[1 + d, :, :la + g + d] = np.concatenate(
                [first, a[:, :cw - 1], ins, a[:, cw - 1:]], 1)
        prof = torch.tensor(prof, device=dev)
        zero = torch.zeros(2, dtype=torch.int64, device=dev)
        ib = torch.tensor([1, 2], device=dev)
        lb = la + g + 1
        args = (prof, prof, zero, ib, table, la, lb, go, ge)
        sweep = sw_score_sweep(*args)
        head = sw_score_sweep_profiles_ref(prof, prof, zero, ib, table,
                                           cw - 1, cw, go, ge)
        if not (torch.equal(sweep, sw_score_sweep_profiles_ref(*args))
                and bool((sweep > head).all())):
            fail(f"sw_score_sweep != plain, or the gap unused, on a gap "
                 f"after column {cw - 2} ({sweep.tolist()}, head "
                 f"{head.tolist()})")
        print(f"[2] sw_score_sweep across a warp boundary at {cw} "
              f"({la} x {lb}, V and warps {sweep_layout(lb)}): equal, "
              f"{[round(x, 2) for x in sweep.tolist()]} above the head "
              f"{[round(x, 2) for x in head.tolist()]}")
    # 20 pairs at three widths, then chunks of 1-3 pairs at 1,024 and
    # 2,048 columns (several blocks a pair)
    for m, n in ((7, 20), (700, 20), (2048, 20), (1024, 1), (1024, 3),
                 (2048, 1), (2048, 2), (2048, 3)):
        walk = np.cumsum(rng.normal(0, 2.2, (n, m, 3)), axis=1)
        cq = np.round(walk, 1).astype(np.float32)
        ct = np.round(walk + rng.normal(0, 0.7, walk.shape), 1).astype(
            np.float32)
        ncols = rng.integers(m // 2 if n < 20 else 0, m + 1, n).astype(
            np.int32)
        valid = np.arange(m)[None, :] < ncols[:, None]
        args = [torch.tensor(x, device=dev) for x in (cq, ct, valid, ncols)]
        (got, risky), (want, wrisky) = lddt_batch(*args), lddt_batch_ref(*args)
        if not torch.equal(risky, wrisky) or float(
                (got - want).abs().max()) > LDDT_TOL:
            fail(f"lddt != plain on random coordinates {(n, m)}")
    print("[2] random and tie-prone inputs: every kernel equals its plain "
          "version")


def longest_run(codes: torch.Tensor, code: int) -> int:
    """The longest run of ``code`` in a path's codes."""
    best = run = 0
    for c in codes.tolist():
        run = run + 1 if c == code else 0
        best = max(best, run)
    return best


def phase_walk_paths(pipe) -> None:
    """The walk against its plain version, bit for bit, on paths that cross
    many of its windows and row tiles: q100 self-pairs at 512 and 1,100 a
    side (a long diagonal; 1,100 takes 8 rows a lane, five row tiles); a
    profile pair whose path runs a gap of 100 columns at the rows where
    two tiles meet (the B side is the A side with 100 random columns
    inserted at row 32 R), at 4 and 8 rows a lane; and seeded float
    substitution scores whose paths cross tiles, run the main diagonal or
    join through a 100-column gap, walked on the packed traceback of the
    plain wavefront."""
    from reseek_tpu_torch.ops.postalign import (PI, walk_traceback_batch,
                                                walk_traceback_batch_ref)
    from reseek_tpu_torch.ops.sw_align import (pack_tb, rows_per_lane,
                                               sw_align)
    from reseek_tpu_torch.ops.sw_wavefront import sw_traceback_ref
    rng = np.random.default_rng(6)
    go, ge = float(pipe.params.gap_open), float(pipe.params.gap_ext)
    dev = pipe.prof.device

    def check(what, tb, best, bi, bj, la, min_plen, gap=False):
        got = walk_traceback_batch(tb, best, bi, bj, la)
        want = walk_traceback_batch_ref(tb, best, bi, bj, la)
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            fail(f"walk_traceback != plain on {what}")
        plen = got[2][best > 0]
        if len(plen) == 0 or int(plen.min()) < min_plen:
            fail(f"walk on {what}: paths of {plen.tolist()} steps")
        if gap and min(longest_run(p, PI) for p in got[3][best > 0]) <= 64:
            fail(f"walk on {what}: no gap of more than 64 columns")
        print(f"[2] walk on {what}: equal, paths of {int(plen.min())}-"
              f"{int(plen.max())} steps")

    lens = torch.as_tensor(pipe.sorted_lens)
    for le in (512, 1100):
        idx = torch.nonzero(lens >= le).flatten()[:8].to(dev)
        best, bi, bj, tb = sw_align(pipe.prof, idx, idx, pipe.table, le, le,
                                    go, ge)
        check(f"{len(idx)} self-pairs of {le} x {le}", tb, best, bi, bj, le,
              le - 16)
    nf = pipe.prof.shape[1]
    for la in (400, 1100):
        cut = 32 * rows_per_lane(la, la + 100)
        src = int(torch.nonzero(lens >= la).flatten()[0])
        a = pipe.prof[src, :, :la].cpu().numpy()
        ins = np.stack([rng.integers(0, n, 100) for n in pipe.table.sizes])
        b = np.concatenate([a[:, :cut], ins.astype(np.uint8), a[:, cut:]], 1)
        prof = np.full((2, nf, la + 100), 255, np.uint8)
        prof[0, :, :la] = a
        prof[1] = b
        prof = torch.tensor(prof, device=dev)
        one = torch.zeros(1, dtype=torch.int64, device=dev)
        best, bi, bj, tb = sw_align(prof, one, one + 1, pipe.table, la,
                                    la + 100, go, ge)
        check(f"a 100-column gap at rows {cut - 1}/{cut}, {la} x {la + 100}",
              tb, best, bi, bj, la, la, gap=True)
    for shape, la, lb in (("tiles", 300, 200), ("diagonal", 260, 260),
                          ("gap", 200, 300)):
        s = rng.normal(-1.0, 1.0, (4, la, lb)).astype(np.float32)
        i, j = np.arange(la)[:, None], np.arange(lb)[None, :]
        on = {"tiles": i == j + 100, "diagonal": i == j,
              "gap": ((i == j) & (i <= 127))
              | ((j == i + 100) & (i >= 128))}[shape]
        s[:, on] = rng.normal(3.0, 0.5, (4, int(on.sum())))
        s[0] = -1.0
        best, bi, bj, tb = sw_traceback_ref(torch.tensor(s, device=dev),
                                            -1.5, -0.25)
        check(f"float scores, {shape} {la} x {lb}", pack_tb(tb, la, lb),
              best, bi, bj, la, 190, gap=shape == "gap")


def options(columns: str = COLUMNS, mode: str = MODE):
    from reseek_tpu_torch.align.output import parse_columns
    from reseek_tpu_torch.search.host import SearchOptions
    return SearchOptions(columns=parse_columns(columns), mode=mode)


def run_search(chains, engine: str, mesh=None):
    from reseek_tpu_torch.constants import DSSParams
    from reseek_tpu_torch.search.driver import self_search
    out = io.StringIO()
    params = DSSParams.create(MODE)
    t0 = time.perf_counter()
    if engine == "host":
        drv = self_search(chains, params, options(), out, engine="host")
    else:
        drv = self_search(chains, params, options(), out, engine="device",
                          device=DEVICE, mesh=mesh)
        torch.cuda.synchronize()
    return out.getvalue(), time.perf_counter() - t0, drv


def phase_q100(chains):
    """Returns (launch counts, the TSV, warm median wall)."""
    n = len(chains)
    pairs = n * (n + 1) // 2
    want, host_s, _ = run_search(chains, "host")
    print(f"[3] host engine: {len(want.splitlines())} rows, {host_s:.2f} s")
    with Launches() as launched:
        got, cold_s, drv = run_search(chains, "device")
    if got != want:
        fail("q100 TSV differs from the host engine")
    launched.require([k for k, v in KERNELS.items() if v[2] == "q100"],
                     "the q100 self-search")
    print(f"[3] device engine: {len(got.splitlines())} rows byte-identical,"
          f" cold {cold_s:.2f} s, launches {launched.counts}")
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
    return launched.counts, want, med


def replica(base, n: int, label=lambda lab, r: f"{lab}/r{r}"):
    """n chains: base cycled, plus Gaussian coordinate noise (seed
    REPLICA_SEED, REPLICA_NOISE A), labels ``label(label, k)`` for the
    k-th copy (default <label>/r<k>); the first 1,024 of any size are the
    same chains."""
    from reseek_tpu_torch.chain import Chain
    rng = np.random.default_rng(REPLICA_SEED)
    chains = []
    for k in range(n):
        c = base[k % len(base)]
        noise = rng.normal(0, REPLICA_NOISE, c.coords.shape).astype(
            np.float32)
        chains.append(Chain(label(c.label, k // len(base)), c.seq,
                            c.coords + noise))
    return chains


def phase_replica(chains) -> None:
    from reseek_tpu_torch.constants import DSSParams
    pairs = len(chains) * (len(chains) + 1) // 2
    torch.cuda.reset_peak_memory_stats()
    with Launches() as launched:
        text, secs, drv = run_search(chains, "device")
    rows = [line.split("\t") for line in text.splitlines()]
    self_hits = {r[0] for r in rows if r[0] == r[1]}
    mkfl = DSSParams.create(MODE).mkfl
    short = {c.label for c in chains if len(c) < mkfl}
    if not short <= self_hits:
        fail(f"replica: {len(short - self_hits)} chains lack a self hit")
    print(f"[4] replica {len(chains)} chains: {secs:.2f} s, "
          f"{pairs / secs:.1f} pairs/s over {pairs} pairs, {len(rows)} rows "
          f"(hits {drv.hit_count}), stages {json.dumps(drv.device_stats)}, "
          f"peak {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; "
          f"launches {launched.counts}")


def phase_walk_alone(pipe, survivors, reps: int = 20) -> None:
    """The walk alone at the largest q100 stage-3 chunk (the phase-2
    shape), timed through its wrapper with its defaults; only calls that
    earlier versions of the port have too, so that this script, copied
    into a checkout of another version, times that version's walk."""
    from reseek_tpu_torch.ops.postalign import walk_traceback_batch
    from reseek_tpu_torch.ops.sw_align import sw_align
    p = pipe.params
    lea, leb, _chunk, ia, ib = max(pipe.stage3_plan(survivors),
                                   key=lambda c: len(c[3]) * c[0] * c[1])
    best, bi, bj, tb = sw_align(pipe.prof, ia, ib, pipe.table, lea, leb,
                                float(p.gap_open), float(p.gap_ext))
    walk = walk_traceback_batch(tb, best, bi, bj, lea)
    ms = [time_ms(lambda: walk_traceback_batch(tb, best, bi, bj, lea), reps)
          for _ in range(3)]
    print(f"[w] walk at {(len(ia), lea, leb)}: {statistics.median(ms):.4f} "
          f"ms (of {[round(m, 4) for m in ms]}), longest path "
          f"{int(walk[2].max())} steps")


def phase_sweep_alone(pipe, survivors, reps: int = 5) -> None:
    """The float sweep alone at the largest survivors' stage-2 chunk (the
    phase-2 shape), three times each: the kernel, the gather-sum with the
    kernel (the stage-2 prepass's device work per chunk) and the
    gather-sum alone.  Only calls that earlier versions of the port have
    too, so that this script, copied into a checkout of a version whose
    sweep is fed a substitution tensor, times that version: there the
    kernel is timed on a prebuilt S."""
    import inspect
    from reseek_tpu_torch.ops import sw_sweep
    p = pipe.params
    go, ge = float(p.gap_open), float(p.gap_ext)
    le, _rows, ia, ib = max(pipe.stage2_plan(survivors),
                            key=lambda c: len(c[2]) * c[0] * c[0])
    smx = functools.partial(gather_sum, pipe, le, le, ia, ib)
    fed_s = len(inspect.signature(sw_sweep.sw_score_sweep).parameters) == 3
    if fed_s:
        s = smx()
        kernel = functools.partial(sw_sweep.sw_score_sweep, s, go, ge)

        def both():
            return sw_sweep.sw_score_sweep(smx(), go, ge)
    else:
        kernel = both = functools.partial(
            sw_sweep.sw_score_sweep, pipe.prof, pipe.prof, ia, ib,
            pipe.table, le, le, go, ge)
    got = {name: [time_ms(fn, reps) for _ in range(3)]
           for name, fn in (("kernel", kernel), ("smx+kernel", both),
                            ("smx", smx))}
    print(f"[p1] float sweep at {(len(ia), le, le)}, "
          f"{'fed S' if fed_s else 'fed the profiles'}: "
          + json.dumps({k: [round(x, 4) for x in v] for k, v in got.items()}))


def phase_stage1(chains, reps: int = 7) -> None:
    """Stage 1 of the 1,024-chain replica alone (the self-search's
    stage1_survivors, warm): the host walls of ``reps`` runs and their
    median, then one run under torch.profiler (device busy, the largest
    kernels)."""
    from reseek_tpu_torch.constants import DSSParams
    from reseek_tpu_torch.search.engine import DeviceSelfSearch
    from reseek_tpu_torch.search.host import _encode_all
    from reseek_tpu_torch.utils.spans import Spans
    params = DSSParams.create(MODE)
    pipe = DeviceSelfSearch(_encode_all(chains, params, with_self_rev=False),
                            params, device=DEVICE)
    n = len(pipe.stage1_survivors())
    walls = []
    for _ in range(reps):
        pipe.spans = Spans()     # this run's wall alone
        pipe.stage1_survivors()
        walls.append(pipe.seconds["stage1"])
    wall, busy, top = device_busy(pipe.stage1_survivors)
    print(f"[s1] replica stage 1: {n} survivors, median "
          f"{statistics.median(walls):.4f} s of {[round(w, 4) for w in walls]}"
          f"; profiled {wall:.4f} s, device busy {busy:.4f} s; largest "
          + ", ".join(f"{k[:40]} {s:.4f} s" for k, s in top[:4]))


def phase_self_rev(sets):
    """Device self-reversal scores against the host's, per chain set.
    Returns (the last set's launch counts, [(set name, chains, device
    scores, sw_score launches)])."""
    from reseek_tpu_torch.align.pipeline import self_rev_score
    from reseek_tpu_torch.constants import DSSParams
    from reseek_tpu_torch.search.host import _encode_all
    from reseek_tpu_torch.search.engine import DeviceSelfSearch
    params = DSSParams.create(MODE)
    counts, scores = {}, []
    for name, chains in sets:
        ecs = _encode_all(chains, params, with_self_rev=False)
        t0 = time.perf_counter()
        pipe = DeviceSelfSearch(ecs, params, device=DEVICE)
        t1 = time.perf_counter()
        with Launches() as launched:
            got = pipe.self_rev_scores_device()
        secs = time.perf_counter() - t1
        launched.require([k for k, v in KERNELS.items()
                          if v[2] == "self_rev"], f"{name} self-rev")
        short = [i for i, ec in enumerate(ecs) if len(ec) < params.mkfl]
        t2 = time.perf_counter()
        with ThreadPoolExecutor(os.cpu_count() or 2) as tp:
            want = np.float32(list(tp.map(
                lambda i: self_rev_score(ecs[i], params), short)))
        if not np.array_equal(got[short], want):
            bad = int((got[short] != want).sum())
            fail(f"{name} self-rev: {bad} chains differ from the host")
        print(f"[5] {name}: device self-rev of {len(short)} chains equals "
              f"the host; rev profiles {t1 - t0:.2f} s, device scores "
              f"{secs:.2f} s, host scores {time.perf_counter() - t2:.2f} s; "
              f"launches {launched.counts}")
        counts = launched.counts
        scores.append((name, chains, got, counts["sw_score"]))
    return counts, scores


def _rows_of(text: str, labels, col: int = 0) -> str:
    """The lines whose column ``col`` is one of ``labels``, in order."""
    keep = set(labels)
    return "".join(line + "\n" for line in text.splitlines()
                   if line.split("\t")[col] in keep)


def run_query(fn, queries, targets, **kw):
    """(TSV, wall, driver) of a sensitive query-vs-DB run of ``fn``."""
    from reseek_tpu_torch.constants import DSSParams
    out = io.StringIO()
    t0 = time.perf_counter()
    drv = fn(queries, targets, DSSParams.create(MODE), options(), out, **kw)
    return out.getvalue(), time.perf_counter() - t0, drv


def phase_query(q100, db):
    """Returns (the E-prepass run's launch counts, the 100 x DB TSV, its
    wall, the host's 10 x q100 TSV)."""
    from reseek_tpu_torch.search import driver as port
    dev = {"engine": "device", "device": DEVICE}
    with Launches() as launched:
        got, secs, drv = run_query(port.query_search, q100, db,
                                   chunk_size=QUERY_CHUNK, **dev)
    full_text, full_s = got, secs
    launched.require(SEARCH_KERNELS, "the query-vs-DB search")
    pairs = len(q100) * len(db)
    print(f"[6] query-vs-DB {len(q100)} x {len(db)}: {secs:.2f} s, "
          f"{pairs / secs:.1f} pairs/s over {pairs} pairs, "
          f"{len(got.splitlines())} rows; {json.dumps(drv.device_stats)}; "
          f"launches {launched.counts}")
    wall, busy, top = device_busy(lambda: run_query(
        port.query_search, q100, db, chunk_size=QUERY_CHUNK, **dev))
    print(f"[6] query-vs-DB, profiled: device busy {busy:.4f} s of "
          f"{wall:.3f} s ({100 * busy / wall:.2f}%); largest kernels "
          + ", ".join(f"{name[:60]} {s:.4f} s" for name, s in top))
    five = [q100[i] for i in FIVE]
    want, host_s, _ = run_query(port.query_search, five, db, engine="host")
    if _rows_of(got, [c.label for c in five]) != want or not want:
        fail("query-vs-DB: the five queries' rows differ from the host")
    print(f"[6] the five queries' {len(want.splitlines())} rows equal the "
          f"host's ({host_s:.2f} s on the host)")
    ten = [q100[i] for i in TEN]
    want, _, _ = run_query(port.query_search, ten, q100, engine="host")
    got, _, _ = run_query(port.query_search, ten, q100, **dev)
    os.environ["RESEEK_E_PREPASS_MIN"] = "1"
    try:
        with Launches() as prepass:
            got_pre, _, drv = run_query(port.query_search, ten, q100,
                                        **dev)
    finally:
        del os.environ["RESEEK_E_PREPASS_MIN"]
    if got != want or got_pre != want:
        fail("query-vs-DB 10 x q100 differs from the host")
    prepass.require([k for k, v in KERNELS.items()
                     if v[2] == "query_prepass"], "the E-bound prepass")
    print(f"[6] 10 x q100: {len(want.splitlines())} rows byte-identical, "
          f"also with the E-bound prepass (stage 2 "
          f"{drv.device_stats['stage2_s']:.3f} s); launches "
          f"{prepass.counts}")
    return prepass.counts, full_text, full_s, want


def phase_fast(q100, db_chains) -> None:
    from reseek_tpu_torch.constants import DSSParams
    from reseek_tpu_torch.io.cal import write_cal
    from reseek_tpu_torch.search import driver as port
    params = DSSParams.create("fast")

    def run(fn, queries, db, **kw):
        out = io.StringIO()
        t0 = time.perf_counter()
        drv = fn(queries, db, params, options(mode="fast"), out,
                 prefilter_mode="idxq", **kw)
        return out.getvalue(), time.perf_counter() - t0, drv

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"replica{len(db_chains)}.cal")
        t0 = time.perf_counter()
        write_cal(db_chains, path)
        print(f"[7] wrote {len(db_chains)} chains as .cal in "
              f"{time.perf_counter() - t0:.2f} s")
        with Launches() as launched:
            got, secs, drv = run(port.fast_search, q100, path,
                                 engine="device", device=DEVICE)
        launched.require(SEARCH_KERNELS, "the -fast search")
        st = drv.fast_stats
        pairs = len(q100) * len(db_chains)
        print(f"[7] -fast {len(q100)} x {len(db_chains)}: {secs:.2f} s, "
              f"{pairs / secs:.1f} pairs/s over {pairs} pairs "
              f"({st['candidates']} candidates, {st['mkf_pairs']} MKF "
              f"pairs, {st['candidates'] / secs:.1f} candidates/s), "
              f"{len(got.splitlines())} rows; {json.dumps(st)}; launches "
              f"{launched.counts}")
        five = [q100[i] for i in FIVE]
        want, host_s, _ = run(port.fast_search, five, path, engine="host")
    if _rows_of(got, [c.label for c in five]) != want or not want:
        fail("-fast: the five queries' rows differ from the host")
    print(f"[7] the five queries' {len(want.splitlines())} rows equal the "
          f"host's ({host_s:.2f} s on the host)")
    ten = [q100[i] for i in TEN]
    want, _, _ = run(port.fast_search, ten, Q100, engine="host")
    got, _, _ = run(port.fast_search, ten, Q100, engine="device",
                    device=DEVICE)
    if got != want or not want:
        fail("-fast 10 x q100 differs from the host")
    print(f"[7] 10 x q100: {len(want.splitlines())} rows byte-identical")


def mesh_devices():
    """Every visible card, or two positions on the one card."""
    n = torch.cuda.device_count()
    return (tuple(f"cuda:{i}" for i in range(n)) if n > 1
            else ("cuda:0", "cuda:0"))


def phase_mesh(q100, db, ref: dict) -> None:
    """Phase 8 on the mesh, each run held to its one-device result in
    ``ref``: "self" and "query" (TSV, wall) of phases 3 and 6, "ten" the
    10 x q100 TSV, "rev" phase 5's [(name, chains, scores, sw_score
    launches)]; launches per kernel and device."""
    from reseek_tpu_torch.constants import DSSParams
    from reseek_tpu_torch.search.host import _encode_all
    from reseek_tpu_torch.search import driver as port
    from reseek_tpu_torch.search.engine import DeviceSelfSearch
    mesh = mesh_devices()
    devices = {str(torch.device(d)) for d in mesh}

    def dealt(n: int) -> set:
        """The devices that one call dealing ``n`` chunks reaches: chunk k
        runs on mesh position k mod size."""
        return {str(torch.device(d)) for d in mesh[:min(len(mesh), n)]}

    print(f"[8] mesh {mesh}")
    for name, run, (want, single_s) in (
            ("q100 self-search",
             lambda: run_search(q100, "device", mesh=mesh), ref["self"]),
            (f"query-vs-DB {len(q100)} x {len(db)}",
             lambda: run_query(port.query_search, q100, db, mesh=mesh,
                               chunk_size=QUERY_CHUNK, engine="device"),
             ref["query"])):
        walls = []
        for _ in range(2):
            with Launches() as launched:
                got, secs, drv = run()
            if got != want:
                fail(f"mesh {name} differs from the one-device run")
            walls.append(secs)
        launched.require(SEARCH_KERNELS, f"the mesh {name}")
        launched.require_devices(devices, f"the mesh {name}", SEARCH_KERNELS)
        print(f"[8] mesh {name}: {len(want.splitlines())} rows byte-equal "
              f"to one device; walls {walls[0]:.3f} s, {walls[1]:.3f} s "
              f"(one device {single_s:.3f} s); stages "
              f"{json.dumps(drv.device_stats)}; launches by device "
              f"{json.dumps(launched.by_device)}")

    ten = [q100[i] for i in TEN]
    os.environ["RESEEK_E_PREPASS_MIN"] = "1"
    try:
        with Launches() as launched:
            got, _, drv = run_query(port.query_search, ten, q100, mesh=mesh,
                                    engine="device")
    finally:
        del os.environ["RESEEK_E_PREPASS_MIN"]
    if got != ref["ten"]:
        fail("mesh 10 x q100 with the E-bound prepass differs from the host")
    what = "the mesh E-bound prepass"
    launched.require(SEARCH_KERNELS + ("sw_score_sweep",), what)
    # its stage-2 call deals the survivors' edge groups (3 chunks at
    # 10 x q100) from position 0: at least two positions
    launched.require_devices(dealt(2), what, ["sw_score_sweep"])
    print(f"[8] mesh 10 x q100 with the E-bound prepass: "
          f"{len(got.splitlines())} rows byte-identical (stage 2 "
          f"{drv.device_stats['stage2_s']:.3f} s); launches by device "
          f"{json.dumps(launched.by_device)}")

    params = DSSParams.create(MODE)
    for name, chains, want, n in ref["rev"]:
        pipe = DeviceSelfSearch(_encode_all(chains, params,
                                            with_self_rev=False), params,
                                mesh=mesh)
        with Launches() as launched:
            got = pipe.self_rev_scores_device()
        if not np.array_equal(got, want, equal_nan=True):
            bad = int((~((got == want) | (np.isnan(got) & np.isnan(want))))
                      .sum())
            fail(f"mesh {name} self-rev: {bad} chains differ from one device")
        launched.require_devices(dealt(n), f"the mesh {name} self-rev",
                                 ["sw_score"])
        print(f"[8] mesh {name} self-rev: {int((~np.isnan(got)).sum())} "
              f"scores equal to one device; launches by device "
              f"{json.dumps(launched.by_device['sw_score'])}")
        del pipe


def _cli_ranks(args_of, nprocs: int, env, logdir: str) -> tuple:
    """Run ``nprocs`` processes of the port's CLI (``args_of(rank)``), all
    started together, their output to files in ``logdir``; fail unless
    every one exits 0 within RANK_TIMEOUT.  Returns (wall, [the JSON
    stats each rank printed, or None])."""
    logs = [os.path.join(logdir, f"rank{r}.log") for r in range(nprocs)]
    t0 = time.perf_counter()
    procs = []
    try:
        for r in range(nprocs):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "reseek_tpu_torch", "search",
                     *args_of(r)], cwd=ROOT, env=env, stdout=log,
                    stderr=subprocess.STDOUT))
        for p in procs:
            p.wait(timeout=max(1.0, RANK_TIMEOUT - (time.perf_counter()
                                                    - t0)))
    except subprocess.TimeoutExpired:
        fail(f"a rank ran past {RANK_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    stats = []
    for r, p in enumerate(procs):
        with open(logs[r]) as f:
            err = f.read()
        if p.returncode != 0:
            fail(f"rank {r} of {nprocs} exited {p.returncode}:\n{err[-4000:]}")
        mark = f"reseek_tpu_torch: rank {r}: "
        lines = [ln for ln in err.splitlines() if ln.startswith(mark)]
        stats.append(json.loads(lines[-1][len(mark):]) if lines else None)
    return wall, stats


def phase_multiprocess(db_chains) -> None:
    """-fast over two rank processes of the CLI (Gloo, one card shared
    when there is one): rank 0's -o equals the one-process command's on
    the same .bca, and again when both ranks resume from their rows."""
    from reseek_tpu_torch.io.bca import BCAWriter
    env = dict(os.environ, PYTHONPATH=ROOT, GLOO_SOCKET_IFNAME="lo")
    with tempfile.TemporaryDirectory() as tmp:
        db = os.path.join(tmp, f"replica{len(db_chains)}.bca")
        t0 = time.perf_counter()
        with BCAWriter(db) as w:
            for c in db_chains:
                w.write_chain(c)
        print(f"[9] wrote {len(db_chains)} chains as .bca in "
              f"{time.perf_counter() - t0:.2f} s")
        common = [Q100, "--fast", "--db", db, "--columns", COLUMNS,
                  "--engine", "device", "--device", DEVICE]
        one_fn = os.path.join(tmp, "one.tsv")
        one_s, _ = _cli_ranks(lambda r: common + ["-o", one_fn], 1, env,
                              tmp)
        with open(one_fn) as f:
            want = f.read()
        if not want:
            fail("-fast one process: no rows")
        print(f"[9] one process: {one_s:.2f} s, {len(want.splitlines())} "
              "rows")
        scratch = os.path.join(tmp, "scratch")
        os.mkdir(scratch)
        for run, extra in (("two ranks", []), ("resumed", ["--resume"])):
            coord = f"localhost:{_free_port()}"
            secs, stats = _cli_ranks(lambda r: common + [
                "-o", os.path.join(tmp, f"two{r}.tsv"), "--nprocs", "2",
                "--procid", str(r), "--coord", coord, "--scratch", scratch,
                *extra], 2, env, tmp)
            with open(os.path.join(tmp, "two0.tsv")) as f:
                got = f.read()
            if got != want:
                fail(f"-fast {run}: rank 0's rows differ from one process")
            if os.path.exists(os.path.join(tmp, "two1.tsv")):
                fail(f"-fast {run}: rank 1 created its -o")
            for r, st in enumerate(stats):
                if st is None:
                    fail(f"-fast {run}: rank {r} printed no stats")
                if extra:
                    if not st["reused"] or any(st["launches"].values()):
                        fail(f"-fast resumed: rank {r} did not reuse rows")
                elif not all(st["launches"][k] > 0 for k in SEARCH_KERNELS):
                    fail(f"-fast two ranks: rank {r} launched "
                         f"{st['launches']}")
            keys = ("range", "cores", "candidates", "reused", "prefilter_s",
                    "align_s", "wall_s", "launches")
            print(f"[9] {run}: {secs:.2f} s (one process {one_s:.2f} s), "
                  f"rank 0's rows byte-equal; per rank "
                  f"{json.dumps([{k: st[k] for k in keys} for st in stats])}")


def run_cmd(argv) -> tuple:
    """One command of the port's CLI, in-process, in either spelling:
    (stdout, stderr, the parsed arguments, on which a search-driven
    command leaves its driver as ``drv``)."""
    import contextlib
    from reseek_tpu_torch.__main__ import _reference_style, build_parser
    args = build_parser().parse_args(_reference_style(list(argv)))
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = args.fn(args)
    if rc != 0:
        fail(f"{' '.join(argv[:2])} exited {rc}:\n{err.getvalue()[-4000:]}")
    return out.getvalue(), err.getvalue(), args


def sepq_of(summary: str) -> dict:
    """{"SEPQ0.1": x, "SEPQ1": y, "SEPQ10": z} of a scop40bench summary."""
    try:
        got = dict(f.split("=") for f in summary.split())
        return {k: float(got[k]) for k in ("SEPQ0.1", "SEPQ1", "SEPQ10")}
    except (KeyError, ValueError):
        fail(f"scop40bench printed no SEPQ summary: {summary!r}")


def device_vs_host(cmd, argv, tmp: str, outputs=(), err_lines=()):
    """``cmd`` on the device engine and on the host engine: stdout, the
    files named by ``outputs`` (each run writes its own copy) and the
    stderr lines that start with one of ``err_lines`` must be byte-equal.
    Returns (the device run's stdout, the device wall, the host wall)."""
    runs = []
    for engine in ("device", "host"):
        paths = {o: os.path.join(tmp, f"{cmd}.{o}.{engine}")
                 for o in outputs}
        extra = [x for o in outputs for x in (f"--{o}", paths[o])]
        t0 = time.perf_counter()
        out, err, _ = run_cmd([cmd, *argv, *extra, "--engine", engine,
                               "--device", DEVICE])
        if engine == "device":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        files = {o: open(p, "rb").read() for o, p in paths.items()}
        kept = [ln for ln in err.splitlines() if ln.startswith(err_lines)]
        runs.append((out, files, kept, secs))
    (dev, dev_files, dev_err, dev_s), (host, host_files, host_err,
                                       host_s) = runs
    if dev != host:
        fail(f"{cmd} {' '.join(argv[1:])}: stdout differs from the host "
             f"engine:\n{dev}\n{host}")
    for o in outputs:
        if dev_files[o] != host_files[o] or not host_files[o]:
            fail(f"{cmd} {' '.join(argv[1:])}: --{o} differs from the host "
                 "engine (or is empty)")
    if dev_err != host_err or (err_lines and not host_err):
        fail(f"{cmd}: stderr {dev_err} differs from the host's {host_err}")
    return dev, dev_s, host_s


def phase_bench_cmds() -> None:
    """The SCOP40 benchmark and calibration commands through the port's
    CLI: on the 139 chains of sepq_set.cal the device engine's output
    byte-equal to the host engine's (sensitive SEPQs at the reference
    binary's), then scop40bench --fast on a 2,048-chain labeled replica of
    its chains below fast mode's MKF length."""
    from reseek_tpu_torch.constants import DSSParams
    from reseek_tpu_torch.io.cal import write_cal
    from reseek_tpu_torch.io.reader import read_chains
    with tempfile.TemporaryDirectory() as tmp:
        bench = ["--lookup", SEPQ_LOOKUP]
        for mode in ("sensitive", "fast"):
            out, dev_s, host_s = device_vs_host(
                "scop40bench", [SEPQ_CAL, f"--{mode}", *bench], tmp,
                ["output"])
            got = sepq_of(out)
            if mode == "sensitive":
                for k, ref in SEPQ_REF.items():
                    if abs(got[k] - ref) >= SEPQ_TOL:
                        fail(f"scop40bench --sensitive: {k} {got[k]} is not"
                             f" within {SEPQ_TOL} of the reference's {ref}")
            print(f"[10] scop40bench --{mode} on 139 chains: device "
                  f"{dev_s:.2f} s, host {host_s:.2f} s, byte-equal; "
                  f"{out.strip()}")
        _, dev_s, host_s = device_vs_host("distmx", [SEPQ_CAL], tmp,
                                          ["output"], ("maxts",))
        print(f"[10] distmx --fast: device {dev_s:.2f} s, host "
              f"{host_s:.2f} s, --output and maxts byte-equal")
        out, dev_s, host_s = device_vs_host("calibrate", [SEPQ_CAL], tmp,
                                            ["output"])
        print(f"[10] calibrate --fast: device {dev_s:.2f} s, host "
              f"{host_s:.2f} s, byte-equal; {out.strip().splitlines()[0]}")
        out, dev_s, host_s = device_vs_host(
            "calibrate2", [SEPQ_CAL, "--benchlevel", "sf"], tmp, ["output"])
        print(f"[10] calibrate2 --benchlevel sf: device {dev_s:.2f} s, "
              f"host {host_s:.2f} s, byte-equal; {out.strip()}")

        # the replica: chains below fast mode's MKF length, relabeled
        # <dom>_r<k>/<scopid> with the matching lookup
        mkfl = DSSParams.create("fast").mkfl
        base = [c for c in read_chains(SEPQ_CAL) if len(c) < mkfl]

        def label(lab, k):
            dom, _, scopid = lab.partition("/")
            return f"{dom}_r{k}/{scopid}"
        chains = replica(base, BENCH_CHAINS, label)
        cal = os.path.join(tmp, f"replica{BENCH_CHAINS}.cal")
        lookup = os.path.join(tmp, f"replica{BENCH_CHAINS}.lookup")
        with open(cal, "w") as f:
            write_cal(chains, f)
        with open(lookup, "w") as f:
            f.writelines("%s\t%s\n" % tuple(c.label.split("/", 1))
                         for c in chains)
        hits = os.path.join(tmp, "hits.tsv")
        n = len(chains)
        pairs = n * (n + 1) // 2
        torch.cuda.reset_peak_memory_stats()
        with Launches() as launched:
            t0 = time.perf_counter()
            out, _, args = run_cmd(["scop40bench", cal, "--fast", "--lookup",
                                    lookup, "--output", hits, "--engine",
                                    "device", "--device", DEVICE])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        launched.require(SEARCH_KERNELS, "the 2,048-chain scop40bench")
        with open(hits) as f:
            rows = [ln.split("\t") for ln in f.read().splitlines()]
        selfs = {r[0] for r in rows if r[0] == r[1]}
        lacking = {c.label for c in chains} - selfs
        if lacking:
            fail(f"scop40bench replica: {len(lacking)} chains lack a self "
                 f"hit, e.g. {sorted(lacking)[:3]}")
        got = sepq_of(out)
        if not all(0.0 <= v <= 1.0 for v in got.values()):
            fail(f"scop40bench replica: SEPQ outside [0, 1]: {got}")
        print(f"[10] scop40bench --fast, {n}-chain replica of {len(base)} "
              f"chains < {mkfl}: {secs:.2f} s, {pairs / secs:.1f} pairs/s "
              f"over {pairs} pairs, {len(rows)} hits, every self hit; "
              f"stages {json.dumps(args.drv.device_stats)}; {out.strip()}; "
              f"peak {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; "
              f"launches {launched.counts}")


def _digest(data: bytes) -> str:
    import hashlib
    return hashlib.sha256(data).hexdigest()[:16]


def phase_io_cmds(want_cal=None) -> dict:
    """Phase 11: the structure I/O, format and pair-alignment commands
    through the port's CLI, in-process, and the graft entry points
    (reseek_tpu_torch/graft_entry.py) on the card.  ``want_cal``: phase
    3's device TSV of q100.cal, when it ran, to count the rows that the
    .bca's integer coordinates change.  Returns the launch counts of the
    phase's device searches (both, summed).

    The gates: convert's .cal and .bca -> .cal byte-equal to q100.cal;
    the sensitive device search of the .rsdx that ``convert --index``
    builds from the .bca, and of the .bca itself, byte-equal to the host
    engine's search of the .bca (a .bca holds integer coordinates, so its
    chains are not bit-equal to the .cal's text), each launching the
    stage-1/3 kernels; the same search in the reference binary's spelling
    byte-equal; a chain aligned with itself spanning the chain, its
    superposed PDB within 1e-3 A of the input; test-xdrop equal to the
    reference binary's log; create-foldseekdb -> convert-foldseekdb back
    to q100.cal byte for byte; entry()'s exact score bit-equal to its
    plain version, with sw_score launched; dryrun_multichip over every
    card (two positions of cuda:0 on one).  align-bags, alignselfrev and
    tracealn on 16 chains must exit 0: their oracle is the CPU tests
    (tests/test_torch_cli_align.py holds them byte-equal to reseek_tpu),
    so here they print a digest and a wall."""
    from reseek_tpu_torch import graft_entry
    from reseek_tpu_torch.constants import DSSParams
    from reseek_tpu_torch.io.artifact import load_artifact
    from reseek_tpu_torch.io.cal import write_cal
    from reseek_tpu_torch.io.reader import read_chains
    from reseek_tpu_torch.ops.sw_align import sw_score_profiles_ref
    want_q100 = open(Q100, "rb").read()
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        def path(name):
            return os.path.join(tmp, name)

        t0 = time.perf_counter()
        run_cmd(["convert", Q100, "--bca", path("q100.bca"), "--cal",
                 path("q100.cal")])
        run_cmd(["convert", path("q100.bca"), "--cal", path("back.cal"),
                 "--index", path("q100.rsdx"), "--index-modes", MODE])
        for name in ("q100.cal", "back.cal"):
            if open(path(name), "rb").read() != want_q100:
                fail(f"convert: {name} differs from q100.cal")
        print(f"[11] convert q100.cal -> .bca and .cal, .bca -> .cal and "
              f".rsdx ({MODE}): both .cal byte-equal to q100.cal; "
              f"{time.perf_counter() - t0:.2f} s")

        search = ["--sensitive", "--columns", COLUMNS]
        t0 = time.perf_counter()
        run_cmd(["search", path("q100.bca"), *search, "-o",
                 path("host.tsv"), "--engine", "host"])
        host_s = time.perf_counter() - t0
        want = open(path("host.tsv")).read()
        params = DSSParams.create(MODE)
        for src, load in (("q100.rsdx", lambda p: load_artifact(
                              p, params, mode=MODE)),
                          ("q100.bca", read_chains)):
            t0 = time.perf_counter()
            load(path(src))
            load_s = time.perf_counter() - t0
            with Launches() as launched:
                t0 = time.perf_counter()
                _, _, args = run_cmd(["search", path(src), *search, "-o",
                                      path(src + ".tsv"), "--engine",
                                      "device", "--device", DEVICE])
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            if open(path(src + ".tsv")).read() != want or not want:
                fail(f"search {src} on the device engine differs from the "
                     "host engine's search of q100.bca")
            launched.require(SEARCH_KERNELS, f"search {src}")
            for k, n in launched.counts.items():
                counts[k] = counts.get(k, 0) + n
            print(f"[11] search {src} --sensitive --engine device: "
                  f"{len(want.splitlines())} rows byte-equal to the host "
                  f"engine's of q100.bca ({host_s:.2f} s); {secs:.2f} s; "
                  f"load {load_s:.3f} s, encode "
                  f"{args.drv.device_stats['encode_s']:.3f} s; launches "
                  f"{launched.counts}")
        if want_cal is not None:
            diff = len(set(want_cal.splitlines()) ^ set(want.splitlines()))
            print(f"[11] q100.bca's rows against q100.cal's (phase 3): "
                  f"{diff} rows differ in one of the two")
        run_cmd(["-search", path("q100.rsdx"), "-sensitive", "-columns",
                 COLUMNS, "-output", path("ref.tsv"), "-engine", "device",
                 "-device", DEVICE])
        if open(path("ref.tsv")).read() != want:
            fail("-search in the reference spelling differs")
        print("[11] -search q100.rsdx -sensitive ... (reference spelling): "
              "byte-equal")

        t0 = time.perf_counter()
        run_cmd(["chains2pdbs", Q100, "--outdir", path("pdbs")])
        chain = read_chains(Q100)[FIVE[0]]
        pdb = path(os.path.join("pdbs", chain.label.replace("/", "_")
                                + ".pdb"))
        out, _, _ = run_cmd(["alignpair", pdb, "--input2", pdb, "--output",
                             path("super.pdb"), "--aln", path("self.aln")])
        n = str(len(chain))
        if out.split("\t")[2:6] != ["1", n, "1", n]:
            fail(f"alignpair of {chain.label} with itself: {out.strip()}")
        dev = np.abs(read_chains(path("super.pdb"))[0].coords
                     - read_chains(pdb)[0].coords).max()
        if not dev < 1e-3:
            fail(f"alignpair: the superposed PDB is {dev} A off the input")
        print(f"[11] chains2pdbs, alignpair of {chain.label} with itself: "
              f"1-{n} both sides, superposed within {dev:.2e} A; "
              f"{time.perf_counter() - t0:.2f} s")

        run_cmd(["test-xdrop", "--log", path("xdrop.log")])
        with open(path("xdrop.log")) as f:
            body = "".join(ln for ln in f if not ln.startswith((
                "Finished", "Elapsed", "Max memory")))
        with open(os.path.join(ROOT, "tests", "golden",
                               "test_xdrop.txt")) as f:
            if body.rstrip("\n") != f.read().rstrip("\n"):
                fail("test-xdrop differs from the reference binary's log")
        print("[11] test-xdrop: equal to tests/golden/test_xdrop.txt")

        t0 = time.perf_counter()
        run_cmd(["convert", Q100, "--feature-fasta", path("q100.3di.fa")])
        run_cmd(["create-foldseekdb", Q100, "--3di", path("q100.3di.fa"),
                 "--output", path("fsdb")])
        run_cmd(["convert-foldseekdb", path("fsdb"), "--cal",
                 path("fsdb.cal"), "--3di", path("fsdb.3di.fa")])
        if open(path("fsdb.cal"), "rb").read() != want_q100:
            fail("create-foldseekdb -> convert-foldseekdb: the .cal "
                 "differs from q100.cal")
        if (open(path("fsdb.3di.fa"), "rb").read()
                != open(path("q100.3di.fa"), "rb").read()):
            fail("convert-foldseekdb: the 3Di FASTA differs")
        print(f"[11] create-foldseekdb -> convert-foldseekdb: .cal and 3Di "
              f"byte-equal to the source; {time.perf_counter() - t0:.2f} s")

        chains = read_chains(Q100)
        with open(path("q16.cal"), "w") as f:
            write_cal([chains[i] for i in IO_SUBSET], f)
        for argv in (["align-bags", path("q16.cal"), "--output",
                      path("bags.tsv")],
                     ["alignselfrev", path("q16.cal"), "--output",
                      path("selfrev.tsv")],
                     ["tracealn", path("q16.cal"), "--db", path("q16.cal"),
                      "--log", path("trace.log")]):
            t0 = time.perf_counter()
            run_cmd(argv)
            secs = time.perf_counter() - t0
            data = open(argv[-1], "rb").read()
            if argv[0] == "tracealn":
                data = b"".join(ln for ln in data.splitlines(True)
                                if not ln.startswith((b"Finished",
                                                      b"Elapsed")))
            lines = data.count(b"\n")
            print(f"[11] {argv[0]} on 16 chains: {secs:.2f} s, {lines} "
                  f"lines, sha256 {_digest(data)}")

    fn, args = graft_entry.entry(device=DEVICE)
    with Launches() as launched:
        got = fn(*args)
        torch.cuda.synchronize()
    launched.require(["sw_score"], "graft_entry.entry's fn")
    prof_a, prof_b, table = args
    pairs = torch.arange(prof_a.shape[0], device=prof_a.device)
    ref = sw_score_profiles_ref(prof_a, prof_b, pairs, pairs, table,
                                prof_a.shape[2], prof_a.shape[2],
                                params.gap_open, params.gap_ext)
    if not torch.equal(got, ref):
        fail(f"graft_entry.entry: {got.tolist()} != plain {ref.tolist()}")
    print(f"[11] graft_entry.entry on {DEVICE}: {got.tolist()} bit-equal "
          f"to the plain version")
    n = max(2, torch.cuda.device_count())
    t0 = time.perf_counter()
    graft_entry.dryrun_multichip(n, device=DEVICE)
    print(f"[11] graft_entry.dryrun_multichip({n}) over "
          f"{graft_entry.mesh_of(n, DEVICE)}: passed, "
          f"{time.perf_counter() - t0:.2f} s")
    return counts


MSTA = os.path.join(ROOT, "tests", "golden", "msta.afa")
MSTA_SET = os.path.join(ROOT, "tests", "golden", "msta_set.cal")
# the buckets at which phase 12 holds the legacy engine's kernels against
# their plain versions
LEGACY_BUCKETS = (96, 384, 1536)


def _golden(name: str) -> str:
    with open(os.path.join(ROOT, "tests", "golden", name)) as f:
        return f.read()


def phase_msa_cmds() -> None:
    """Phase 12, first part: the 22 MSA scoring, training and diagnostic
    commands through the port's CLI, in-process, on the in-repo inputs.
    Each output for which the reference binary's is in tests/golden must
    equal it byte for byte (msta-scores and daliscore-msas2 with their
    test directories' paths rewritten, msta-lddtmuw1 up to its trailing
    newlines); mudex must print the reference's occupancy lines and
    self-score quartiles; mukmerfilter must end in "Obsolete"; the
    reference spelling of lddt-msa and msta-lddtmuw must write the same
    bytes.  The others print a digest: their oracle is the CPU tests
    (tests/test_torch_cli_msa.py, tests/test_torch_cli_train.py hold them
    byte-equal to reseek_tpu)."""
    import shutil
    from reseek_tpu_torch.io.cal import write_cal
    from reseek_tpu_torch.io.reader import read_chains
    score = ["--input", MSTA_SET]
    with tempfile.TemporaryDirectory() as tmp:
        def path(name):
            return os.path.join(tmp, name)

        for sub, name in (("one", "fam1"), ("td1", "msta.afa"),
                          ("td2", "msta.afa")):
            os.makedirs(path(sub))
            shutil.copy(MSTA, os.path.join(path(sub), name))
        with open(path("accs.txt"), "w") as f:
            f.write("fam1\nmissing_fam\n")
        with open(path("accs2.txt"), "w") as f:
            f.write("msta.afa\n")
        recs = [r.partition("\n") for r in open(MSTA).read().split(">")[1:]]
        rows = [(lab.strip(), seq.replace("\n", "")) for lab, _, seq in recs]
        with open(path("dali.tsv"), "w") as f, \
                open(path("pairs.fa"), "w") as g:
            for i in range(len(rows)):
                for j in range(i + 1, len(rows)):
                    f.write("\t".join([rows[i][0], rows[j][0], "10.0", "0",
                                       "0", "0", "0", rows[i][1],
                                       rows[j][1]]) + "\n")
                    g.write(f">{rows[i][0]}\n{rows[i][1]}\n"
                            f">{rows[j][0]}\n{rows[j][1]}\n")
        with open(path("q16.cal"), "w") as f:
            write_cal([read_chains(Q100)[i] for i in IO_SUBSET], f)
        one = path("one") + "/"
        dirs = {"/tmp/msta_dir/": one, "/tmp/td1/": path("td1") + "/",
                "/tmp/td2/": path("td2") + "/"}

        def golden(name):
            text = _golden(name)
            for a, b in dirs.items():
                text = text.replace(a, b)
            return text

        # (argv, {output file: golden name, or None for a digest},
        # stdout's golden text or None)
        g = os.path.join(ROOT, "tests", "golden")
        cmds = [
            (["lddt-msa", MSTA, *score, "--output", path("l.tsv")],
             {"l.tsv": "lddt_msa.tsv"}, None),
            (["daliscore-msa", MSTA, *score, "--output", path("d.tsv")],
             {"d.tsv": "daliscore_msa.tsv"}, None),
            (["lddt-msa-foldmason", MSTA, *score, "--output",
              path("fm.tsv")], {"fm.tsv": "lddt_msa_foldmason.tsv"}, None),
            (["lddt-msas", path("accs.txt"), *score, "--testdir", one,
              "--output", path("ls.tsv")], {"ls.tsv": None}, None),
            (["daliscore-msas", path("accs.txt"), *score, "--testdir", one,
              "--output", path("ds.tsv")], {"ds.tsv": None}, None),
            (["daliscore-msas2", path("accs2.txt"), *score, "--testdir",
              path("td1"), "--testdir2", path("td2"), "--output",
              path("ds2.tsv")], {"ds2.tsv": "daliscore_msas2.tsv"}, None),
            (["daliscore-tsv", path("dali.tsv"), *score, "--output",
              path("dt.tsv")], {"dt.tsv": None}, None),
            (["lddt-bench", MSTA, *score], {}, "LDDT=0.7564 MSA=msta\n"),
            (["msta-score", MSTA, *score, "--output", path("ms.tsv")],
             {"ms.tsv": "msta_score.tsv"}, None),
            (["msta-scores", path("accs.txt"), *score, "--testdir", one,
              "--output", path("mss.tsv")], {"mss.tsv": "msta_scores.tsv"},
             None),
            (["msta-lddtmuw", MSTA, *score, "--label", "m0",
              "--lddtmuw-jalview", path("muw.jv"), "--lddtmuw-pymol",
              path("muw.pml")], {"muw.jv": "msta_lddtmuw.jalview",
                                 "muw.pml": "msta_lddtmuw_m0.pml"}, None),
            (["msta-lddtmuw1", MSTA, *score, "--label", "m0", "--output",
              path("muw1.txt")], {"muw1.txt": "msta_lddtmuw1_m0.txt"},
             None),
            (["msa2cmp", MSTA, *score, "--output", path("cmp.tsv")],
             {"cmp.tsv": "msa2cmp.tsv"}, None),
            (["musubstmx", "--output", path("mu.c")], {"mu.c": None}, None),
            (["mu-mapping", "--output", path("mumap.tsv")],
             {"mumap.tsv": None}, None),
            (["float-feature-bins", os.path.join(g, "ffb_pairs.fa"),
              "--train-cal", SEPQ_CAL, "--feature", "NENDist",
              "--alpha-size", "16", "--output", path("ffb.txt")],
             {"ffb.txt": None}, None),
            (["sscluster", path("q16.cal"), "-k", "8", "-n", "2000",
              "--output", path("ssc.txt")], {"ssc.txt": None}, None),
            (["train-features", MSTA_SET, "--alns", path("pairs.fa"),
              "--output", path("lo.tsv")], {"lo.tsv": None}, None),
            (["feature-stats"], {}, _golden("feature_stats.txt")),
            (["mudex", os.path.join(g, "q100.mu.fa"), "--log",
              path("mudex.log")], {}, (
                  "Validate OK\n"
                  "Max letters [1] = 3796 (14.0%)\n"
                  "Max letters [2] = 15285 (56.4%)\n"
                  "Max letters [3] = 6204 (22.9%)\n"
                  "Max letters [4] = 1424 (5.3%)\n"
                  "Max letters [5] = 409 (1.5%)\n")),
            (["binner", os.path.join(g, "binner_vals.tsv"), "--fieldnr", "2",
              "--bins", "8", "--output", path("h.tsv"), "--accum",
              path("a.tsv"), "--accumrev", path("r.tsv")],
             {"h.tsv": "binner_hist.tsv", "a.tsv": "binner_accum.tsv",
              "r.tsv": "binner_accumrev.tsv"}, None),
        ]
        for argv, files, stdout in cmds:
            t0 = time.perf_counter()
            out, _, _ = run_cmd(argv)
            secs = time.perf_counter() - t0
            if stdout is not None and out != stdout:
                fail(f"{argv[0]}: stdout differs from the reference's:\n"
                     f"{out}")
            notes = ["stdout equal to the reference's"] if stdout else []
            for name, gold in files.items():
                got = open(path(name)).read()
                if not got:
                    fail(f"{argv[0]}: {name} is empty")
                if gold is None:
                    if name == "ffb.txt":
                        got = "".join(
                            ln + "\n" for ln in got.splitlines()
                            if any(k in ln for k in ("ALPHA_SIZE", "BIN_T",
                                                     "expected")))
                        if got != _golden("ffb_nendist16.txt"):
                            fail("float-feature-bins: its lines are not "
                                 "the golden ffb_nendist16.txt")
                        notes.append("lines equal to ffb_nendist16.txt")
                    else:
                        # the temporary directory's name left out
                        got = got.replace(tmp, "").encode()
                        notes.append(f"{name} sha256 {_digest(got)}")
                    continue
                want = golden(gold)
                if argv[0] == "msta-lddtmuw1":
                    got, want = got.rstrip("\n"), want.rstrip("\n")
                if got != want:
                    fail(f"{argv[0]}: {name} is not the golden {gold}")
                notes.append(f"{name} equal to {gold}")
            if argv[0] == "mudex":
                want = ("SelfScores: N=60466176, Min=20, LoQ=43, Med=47, "
                        "HiQ=51, Max=75, Avg=47.3611")
                if want not in open(path("mudex.log")).read():
                    fail(f"mudex: the log lacks {want!r}")
                notes.append("log's SelfScores line the reference's")
            print(f"[12] {argv[0]}: {secs:.3f} s; {'; '.join(notes)}")
        try:
            run_cmd(["mukmerfilter"])
            fail("mukmerfilter did not exit")
        except SystemExit as exc:
            if str(exc) != "Obsolete":
                raise
        print("[12] mukmerfilter: SystemExit('Obsolete'), as the reference")
        for ref, want in (
                (["-lddt_msa", MSTA, "-input", MSTA_SET, "-output",
                  path("l_ref.tsv")], "l.tsv"),
                (["-msta_lddtmuw", MSTA, "-input", MSTA_SET, "-label", "m0",
                  "-lddtmuw_jalview", path("muw_ref.jv")], "muw.jv")):
            run_cmd(ref)
            if open(path(ref[-1])).read() != open(path(want)).read():
                fail(f"{ref[0]} (reference spelling) differs from the GNU "
                     "spelling's output")
            print(f"[12] {' '.join(ref[:1])} (reference spelling): "
                  f"byte-equal to {want}")


def legacy_vs_host(ecs, params, got, routed=()) -> None:
    """Fail unless batched_self_search's results ``got`` on ``ecs`` are
    the host PairAligner's hits (E-value <= 10) pair for pair, with its
    path, positions and float32 forward score, LDDT and TS; the pairs in
    ``routed`` (skipped by skip_pair) are not compared."""
    from reseek_tpu_torch.align.pipeline import PairAligner
    n = len(ecs)
    results = {(r.query, r.target): r for r in got}
    pa = PairAligner(params)
    kept = [(i, j) for i in range(n) for j in range(i, n)
            if (i, j) not in routed]
    with ThreadPoolExecutor(os.cpu_count() or 2) as tp:
        host = list(tp.map(lambda ij: pa.align(ecs[ij[0]], ecs[ij[1]]),
                           kept))
    n_checked = 0
    for (i, j), res in zip(kept, host):
        key = (ecs[i].label, ecs[j].label)
        if res is None or not res.path or res.evalue > 10.0:
            if key in results:
                fail(f"legacy engine: {key} returned, not by the host")
            continue
        r = results.get(key)
        if (r is None or r.path != res.path or (r.lo_a, r.lo_b) != (
                res.lo_a, res.lo_b) or any(
                np.float32(getattr(r, f)) != np.float32(getattr(res, f))
                for f in ("fwd_score", "lddt", "ts"))):
            fail(f"legacy engine: {key} differs from the host PairAligner")
        n_checked += 1
    if n_checked != len(got):
        fail(f"legacy engine: {len(got)} results, {n_checked} host hits")


def phase_legacy(chains, db) -> dict:
    """Phase 12, second part: the legacy square-bucket engine
    (reseek_tpu_torch/search/batched.py) on the card.  On the q100 chains
    (sensitive; buckets 96 to 1,536): its kernels against their plain
    versions on the first batch of buckets LEGACY_BUCKETS; the
    self-reversal scores of every chain bit-equal to the host's full SW
    against the reversed chain (and to self_rev_score for the chains below
    the MKF length, which take the MKF route on the host); every pair of
    batched_self_search (those the host aligns by MKF routed away by
    skip_pair) with the path, positions and float32 forward score, LDDT
    and TS of the host PairAligner, and no pair the host does not report.
    Each of the five kernels must launch, the float sweep never.  Then the
    1,024-chain replica: wall, pairs/s, stage walls, survivors; every
    chain below the MKF length has its self hit.  Returns the launch
    counts of the q100 run."""
    from reseek_tpu_torch.align.mkf import should_use_mkf
    from reseek_tpu_torch.align.pipeline import self_rev_score
    from reseek_tpu_torch.constants import DSSParams
    from reseek_tpu_torch.encoder.dss import encode_chain
    from reseek_tpu_torch.ops.postalign import (lddt_batch, lddt_batch_ref,
                                                walk_traceback_batch,
                                                walk_traceback_batch_ref)
    from reseek_tpu_torch.ops.sw_align import (sw_align, sw_align_ref,
                                               sw_score_profiles,
                                               sw_score_profiles_ref)
    from reseek_tpu_torch.ops.sw_sweep import (mu_lane_bits, mu_sw_scores,
                                               mu_sw_scores_ref)
    from reseek_tpu_torch.search.batched import (BatchedEngine, DeviceDB,
                                                 batched_self_search)
    from reseek_tpu_torch.search.engine import _exact_fwd_score, aligned_coords
    from reseek_tpu_torch.search.host import _encode_all
    params = DSSParams.create(MODE)
    ecs = _encode_all(chains, params, with_self_rev=False)
    n = len(ecs)
    with Launches() as launched:
        t0 = time.perf_counter()
        ldb = DeviceDB(ecs, params, with_rev_profiles=True, device=DEVICE)
        t1 = time.perf_counter()
        eng = BatchedEngine(ldb)
        srs = eng.self_rev_scores()
        t2 = time.perf_counter()
        with ThreadPoolExecutor(os.cpu_count() or 2) as tp:
            full = np.float32(list(tp.map(lambda ec: _exact_fwd_score(
                params, ec.profile, encode_chain(ec.chain.reversed()
                                                 ).profile(params)), ecs)))
            host_srs = np.float32(list(tp.map(
                lambda ec: self_rev_score(ec, params), ecs)))
        short = np.array([len(ec) < params.mkfl for ec in ecs])
        if not (np.array_equal(srs, full)
                and np.array_equal(srs[short], host_srs[short])):
            fail(f"legacy self_rev_scores differ from the host in "
                 f"{int((srs != full).sum())} chains")
        print(f"[12] legacy DeviceDB of {n} q100 chains (buckets "
              f"{ldb.buckets}, rev profiles): {t1 - t0:.2f} s; "
              f"self_rev_scores {t2 - t1:.3f} s, bit-equal to the host's "
              f"full SW for all {n} and to self_rev_score for the "
              f"{int(short.sum())} below {params.mkfl}")
        for ec, s in zip(ecs, host_srs):
            ec.self_rev_score = float(s)
        skipped = []
        t0 = time.perf_counter()
        got = batched_self_search(
            ecs, params, db=ldb, skipped=skipped,
            skip_pair=lambda i, j: should_use_mkf(ecs[i], ecs[j], params))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launched.require(["mu_sweep", "sw_score", "sw_align", "walk_traceback",
                      "lddt"], "the legacy engine on q100")
    if launched.counts["sw_score_sweep"]:
        fail("the legacy engine launched the float sweep")
    legacy_vs_host(ecs, params, got, set(skipped))
    print(f"[12] legacy batched_self_search on q100: {secs:.2f} s, "
          f"{len(got)} pairs equal to the host PairAligner (path, lo, "
          f"float32 fwd, LDDT, TS), {len(skipped)} MKF pairs skipped; "
          f"stages {json.dumps(ldb.stats)}; launches {launched.counts}")

    # the kernels at the first batch of three buckets of all the pairs,
    # against their plain versions
    p = params
    o, e = -float(p.para_mu_gap_open), -float(p.para_mu_gap_ext)
    go, ge = float(p.gap_open), float(p.gap_ext)
    pairs = np.stack(np.triu_indices(n), axis=1).astype(np.int64)
    lens = np.array([len(ec) for ec in ecs])
    seen = set()
    for bucket, chunk, nn, _rows in eng._bucketed(pairs):
        if bucket not in LEGACY_BUCKETS or bucket in seen:
            continue
        seen.add(bucket)
        ia, ib = eng._sides(chunk)
        b = ldb.mu[ib, :bucket]
        a2 = torch.cat([ldb.mu[ia, :bucket], ldb.mu_rev[ia, :bucket]])
        b2 = torch.cat([b, b])
        checks = {"mu_sweep": torch.equal(
            mu_sw_scores(a2, b2, ldb.mu_table, o, e),
            mu_sw_scores_ref(a2, b2, ldb.mu_table.mumx, o, e))}
        sargs = (ldb.prof, ldb.prof_rev, ia, ib, ldb.table, bucket, bucket,
                 go, ge)
        checks["sw_score"] = torch.equal(sw_score_profiles(*sargs),
                                         sw_score_profiles_ref(*sargs))
        aargs = (ldb.prof, ia, ib, ldb.table, bucket, bucket, go, ge)
        got_a, want_a = sw_align(*aargs), sw_align_ref(*aargs)
        checks["sw_align"] = all(torch.equal(x, y)
                                 for x, y in zip(got_a, want_a))
        walk = walk_traceback_batch(got_a[3], *got_a[:3], bucket)
        rwalk = walk_traceback_batch_ref(want_a[3], *want_a[:3], bucket)
        checks["walk_traceback"] = all(torch.equal(x, y)
                                       for x, y in zip(walk, rwalk))
        m_cap = int(np.minimum(lens[chunk[:, 0]], lens[chunk[:, 1]]).max())
        cq, ct, valid, n_m = aligned_coords(walk[3], got_a[1], got_a[2], ia,
                                            ib, ldb.coords, m_cap)
        err = float((lddt_batch(cq, ct, valid, n_m, with_risky=False)
                     - lddt_batch_ref(cq, ct, valid, n_m, with_risky=False)
                     ).abs().max())
        checks["lddt"] = err <= LDDT_TOL
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            fail(f"legacy bucket {bucket}: {bad} differ from their plain "
                 "versions")
        print(f"[12] legacy bucket {bucket}, batch {len(chunk)} ({nn} "
              f"pairs): mu_sweep, sw_score, sw_align, walk_traceback equal "
              f"to their plain versions, lddt within {LDDT_TOL} "
              f"(max_abs_err {err:.3g})")
    if seen != set(LEGACY_BUCKETS):
        fail(f"legacy: q100's pairs fill buckets {sorted(seen)} of "
             f"{LEGACY_BUCKETS}")
    # the Mu filter's int16x2 lanes at the largest preset bucket: the
    # highest score a 3,072 x 3,072 pair reaches (the best self-scoring
    # letter throughout), beside three pairs of seeded random letters
    mt = ldb.mu_table
    top = int(torch.diagonal(mt.mumx[:36, :36]).argmax())
    g = torch.Generator().manual_seed(REPLICA_SEED)
    a = torch.randint(0, 36, (4, 3072), generator=g, dtype=torch.uint8)
    b = torch.randint(0, 36, (4, 3072), generator=g, dtype=torch.uint8)
    a[0] = b[0] = top
    a, b = a.to(ldb.device), b.to(ldb.device)
    got = mu_sw_scores(a, b, mt, o, e)
    if (not torch.equal(got, mu_sw_scores_ref(a, b, mt.mumx, o, e))
            or float(got[0]) != mt.smax * 3072):
        fail(f"mu_sweep at 3,072 x 3,072: {got.tolist()}")
    bits = mu_lane_bits(3072, 3072, mt.smax, mt.smin, int(o), int(e))
    print(f"[12] mu_sweep at 4 x 3072 x 3072 (int{bits} lanes): equal "
          f"to the plain version, the top pair "
          f"{float(got[0]):.0f} = {mt.smax} x 3072")
    counts = launched.counts

    # the 1,024-chain replica, timed
    ecs = _encode_all(db, params, with_self_rev=False)
    n = len(ecs)
    t0 = time.perf_counter()
    ldb = DeviceDB(ecs, params, with_rev_profiles=True, device=DEVICE)
    eng = BatchedEngine(ldb)
    for ec, s in zip(ecs, eng.self_rev_scores()):
        ec.self_rev_score = float(s)
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    with Launches() as launched:
        skipped = []
        got = batched_self_search(
            ecs, params, db=ldb, skipped=skipped,
            skip_pair=lambda i, j: should_use_mkf(ecs[i], ecs[j], params))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
    launched.require(["mu_sweep", "sw_score", "sw_align", "walk_traceback",
                      "lddt"], "the legacy engine on the replica")
    selfs = {r.query for r in got if r.query == r.target}
    lacking = {ec.label for ec in ecs if len(ec) < params.mkfl} - selfs
    if lacking:
        fail(f"legacy replica: {len(lacking)} chains lack a self hit")
    pairs = n * (n + 1) // 2
    print(f"[12] legacy batched_self_search, replica of {n} chains: "
          f"{secs:.2f} s, {pairs / secs:.1f} pairs/s over {pairs} pairs "
          f"({len(skipped)} MKF pairs skipped), {len(got)} hits, every self "
          f"hit; DeviceDB + self-rev {t1 - t0:.2f} s; stages "
          f"{json.dumps(ldb.stats)}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; launches "
          f"{launched.counts}")
    return counts


def long_chain(base, n: int, label: str):
    """A chain of ``n`` residues made from ``base`` (the q100 chains) alone:
    the chains end to end, each piece translated LONG_GAP clear of the
    last along x, cut at n."""
    from reseek_tpu_torch.chain import Chain
    seqs, xyz, end, k = [], [], None, 0
    while sum(map(len, seqs)) < n:
        c = base[k % len(base)]
        k += 1
        x = c.coords.astype(np.float64)
        if end is not None:
            x[:, 0] += end + LONG_GAP - x[:, 0].min()
        end = x[:, 0].max()
        seqs.append(c.seq)
        xyz.append(x)
    return Chain(label, "".join(seqs)[:n], np.concatenate(xyz)[:n])


def long_chains(base):
    """Phase 13's long chains: one of each of LONG_LENGTHS residues (labels
    long<n>, long_chain), and a copy of the longest with replica()'s
    noise (seed REPLICA_SEED, REPLICA_NOISE A; label long<n>/r1)."""
    from reseek_tpu_torch.chain import Chain
    out = [long_chain(base, n, f"long{n}") for n in LONG_LENGTHS]
    top = out[-1]
    rng = np.random.default_rng(REPLICA_SEED)
    noise = rng.normal(0, REPLICA_NOISE, top.coords.shape).astype(np.float32)
    out.append(Chain(top.label + "/r1", top.seq, top.coords + noise))
    return out


def long_pipe(base):
    """Phase 13's kernel-gate engine: the long chains beside the 8 shortest
    of ``base`` (sorted short[:4] + long + short[4:]) on DEVICE ->
    (pipe, chains, long chains, {label: index})."""
    from reseek_tpu_torch.constants import DSSParams
    from reseek_tpu_torch.search.engine import DeviceSelfSearch
    from reseek_tpu_torch.search.host import _encode_all
    longs = long_chains(base)
    short = sorted(base, key=len)[:8]
    chains = short[:4] + longs + short[4:]
    params = DSSParams.create(LONG_MODE)
    ecs = _encode_all(chains, params, with_self_rev=False)
    pipe = DeviceSelfSearch(ecs, params, device=DEVICE)
    return pipe, chains, longs, {c.label: i for i, c in enumerate(chains)}


def mu_bucket_letters(pipe, ia, ib):
    """The Mu letters of the pairs (ia[k], ib[k]) (sorted indices) at the
    legacy engine's bucket past its last (DeviceDB): the longest chain's
    length rounded up to 256, square -> (a, b [B, le] uint8)."""
    le = -(-int(pipe.lens.max()) // 256) * 256
    return pipe.mu[ia, :le], pipe.mu[ib, :le]


def lddt_long_columns(longs, device=None):
    """Phase 13's LDDT gate columns, M = 12,000: the longest chain against
    its noisy copy, and against a copy with 0.5 A noise (seed 18) over
    11,000 valid columns -> (cq, ct [2, M, 3], valid [2, M], ncols [2])
    on ``device`` (DEVICE by default)."""
    device = device or DEVICE
    top, noisy = longs[-2], longs[-1]
    m = len(top)
    rng = np.random.default_rng(REPLICA_SEED + 1)
    other = top.coords + rng.normal(0, 2 * REPLICA_NOISE,
                                    top.coords.shape).astype(np.float32)
    cq = torch.tensor(np.stack([top.coords, top.coords]), device=device)
    ct = torch.tensor(np.stack([noisy.coords, other]), device=device)
    valid = torch.ones((2, m), dtype=torch.bool, device=device)
    valid[1, m * 11 // 12:] = False
    return cq, ct, valid, valid.sum(1).to(torch.int32)


def long_kernel_times(reps: int = 5) -> None:
    """The band entries (sw_align, sw_score_profiles past 8,192 columns)
    timed at phase 13's gate shape, 2 x 8,192 x 16,384, sw_score at the
    B = 1 self-rev shape and sw_align at the 8,000-residue pair's 1 x
    8,192 x 8,192 and on 8 pairs of the long chains at that edge (a full
    stage-3 chunk there); the Mu filter's long entry at the legacy bucket
    (2 x 12,032 x 12,032) and LDDT's at 2 x 12,000 (phase 13's gate
    inputs), by whichever reseek_tpu_torch is first on sys.path: phase
    13's --parent runs it on another tree's package in a subprocess.
    Prints one JSON line: {name: {"ms", "digest"}}, the digest of the
    outputs (best scores and cells; LDDT values and risky flags)."""
    import hashlib
    from reseek_tpu_torch.device import disable_tf32
    from reseek_tpu_torch.io.reader import read_chains
    from reseek_tpu_torch.ops.postalign import lddt_batch
    from reseek_tpu_torch.ops.sw_align import sw_align, sw_score_profiles
    from reseek_tpu_torch.ops.sw_sweep import mu_sw_scores
    disable_tf32()
    pipe, _chains, longs, at = long_pipe(read_chains(Q100))
    p = pipe.params
    go, ge = float(p.gap_open), float(p.gap_ext)
    a_orig = [at[longs[0].label], at[longs[2].label]]
    b_orig = [at[longs[1].label]] * 2
    ia, ib = pipe._sorted_idx(np.asarray(a_orig)), pipe._sorted_idx(
        np.asarray(b_orig))
    la = int(pipe._edge_of(pipe.lens[a_orig[:1]])[0])
    lb = int(pipe.prof.shape[2])
    one = pipe._sorted_idx(np.asarray(b_orig[:1]))
    idx = sorted(set(a_orig) | set(b_orig))
    pairs = np.asarray([(x, y) for x in idx for y in idx][:8])
    ia8, ib8 = (pipe._sorted_idx(pairs[:, k]) for k in (0, 1))
    runs = {
        "sw_align_long": lambda: sw_align(pipe.prof, ia, ib, pipe.table, la,
                                          lb, go, ge),
        "sw_score_long": lambda: sw_score_profiles(
            pipe.prof, pipe.prof, ia, ib, pipe.table, la, lb, go, ge),
        "sw_score_long_b1": lambda: sw_score_profiles(
            pipe.prof, pipe.prof_rev, one, one, pipe.table, lb, lb, go, ge),
        "sw_align_8192": lambda: sw_align(pipe.prof, ia[:1], ia[:1],
                                          pipe.table, la, la, go, ge),
        "sw_align_8x8192": lambda: sw_align(pipe.prof, ia8, ib8, pipe.table,
                                            la, la, go, ge)}
    a_mu, b_mu = mu_bucket_letters(pipe, ia, ib)
    o, e = -float(p.para_mu_gap_open), -float(p.para_mu_gap_ext)
    cols = lddt_long_columns(longs)
    runs["mu_sweep_long"] = lambda: mu_sw_scores(a_mu, b_mu, pipe.mu_table,
                                                 o, e)
    runs["lddt_long"] = lambda: lddt_batch(*cols)
    out = {}
    for name, fn in runs.items():
        got = fn()
        got = got[:3] if isinstance(got, tuple) else (got,)
        digest = hashlib.sha256(b"".join(
            x.cpu().numpy().tobytes() for x in got)).hexdigest()[:16]
        out[name] = {"ms": time_ms(fn, reps), "digest": digest}
    print(json.dumps(out))


def tree_long_times(tree: str) -> dict:
    """long_kernel_times on the repository tree at ``tree`` (its own
    package and kernels, this script's code), in a subprocess."""
    code = ("import importlib.util, sys; sys.path.insert(0, '.'); "
            "spec = importlib.util.spec_from_file_location('probe', "
            f"{os.path.abspath(__file__)!r}); "
            "m = importlib.util.module_from_spec(spec); "
            "spec.loader.exec_module(m); m.long_kernel_times()")
    out = subprocess.run([sys.executable, "-c", code], cwd=tree,
                         capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        fail(f"the band entries' times in {tree}: {out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def phase_bands(base, reps: int = 5) -> None:
    """The band kernel's two rules measured: at each of BAND_SHAPES, on
    pairs of phase 13's long chains (long_pipe; the self-rev's profiles
    for score only at B = 1), each kind by the shared-memory kernel (up to
    MAX_LB columns, at its own R) and by the band kernel at R = 4 and at
    R = 8, forced by replacing ops/sw_align.py's sw_align_uses_bands and
    rows_per_lane, in turns, forward then back.  All must give the same
    best (and cells); the tracebacks of one R the same bytes.  One line a shape and kind: the times and each band plan with
    its blocks in flight and SMs a pair."""
    from reseek_tpu_torch.ops import sw_align as swm
    pipe, _chains, longs, at = long_pipe(base)
    p = pipe.params
    go, ge = float(p.gap_open), float(p.gap_ext)
    idx = [at[c.label] for c in longs]
    combos = [(x, y) for x in idx for y in idx]
    rule = (swm.sw_align_uses_bands, swm.rows_per_lane)
    variants = ("short", "bands R=4", "bands R=8")

    @contextlib.contextmanager
    def forced(kind):
        # the shared-memory kernel keeps rows_per_lane's rule for it
        bands = kind != "short"
        swm.sw_align_uses_bands = lambda la, lb: bands
        if bands:
            swm.rows_per_lane = lambda la, lb, r=int(kind[-1]): r
        try:
            yield
        finally:
            swm.sw_align_uses_bands, swm.rows_per_lane = rule

    def runner(kind, call):
        def run():
            with forced(kind):
                return call(None)
        return run

    for b, la, lb, kinds in BAND_SHAPES:
        pairs = np.asarray([combos[k % len(combos)] for k in range(b)])
        ia, ib = (pipe._sorted_idx(pairs[:, k]) for k in (0, 1))
        for what in kinds:
            if what == "align":
                def call(stats, args=(pipe.prof, ia, ib, pipe.table, la, lb,
                                      go, ge)):
                    return swm.sw_align(*args, stats=stats)
            else:
                side = pipe.prof_rev if b == 1 else pipe.prof
                rib = ia if b == 1 else ib

                def call(stats, args=(pipe.prof, side, ia, rib, pipe.table,
                                      la, lb, go, ge)):
                    return (swm.sw_score_profiles(*args, stats=stats),)
            names = [v for v in variants
                     if v != "short" or lb <= swm.MAX_LB]
            runs = {v: runner(v, call) for v in names}
            got = {v: runs[v]() for v in names}
            if not all(torch.equal(x, y) for v in names
                       for x, y in zip(got[v][:3], got[names[0]][:3])):
                fail(f"--bands {what} at {(b, la, lb)}: the variants' best "
                     "differ")
            tbs = [got[v][3] for v in names if what == "align"]
            if any(x.shape == y.shape and not torch.equal(x, y)
                   for x in tbs for y in tbs):
                fail(f"--bands align at {(b, la, lb)}: two tracebacks of "
                     "one R differ")
            ms = {v: [] for v in names}
            for v in names + names[::-1]:
                ms[v].append(time_ms(runs[v], reps))
            plans = {}
            for v in names[int(names[0] == "short"):]:
                st = torch.empty(swm.band_stats_words(b), dtype=torch.int32,
                                 device=DEVICE)
                with forced(v):
                    call(st)
                    plans[v] = swm.band_stats(st, b, la, lb)
            print(f"[b] {what} {(b, la, lb)}: rule "
                  f"{'bands' if rule[0](la, lb) else 'short'} R="
                  f"{rule[1](la, lb)}; ms " + json.dumps(
                      {v: [round(x, 4) for x in t] for v, t in ms.items()})
                  + "; plans " + json.dumps(plans))


def phase_mu_bands(base, reps: int = 5) -> None:
    """The Mu filter's band kernel measured: at each of MU_BAND_SHAPES, on
    pairs of phase 13's long chains (long_pipe), and at the stage-1 blocks
    of its pipeline whose columns take the band kernel (the first block of
    each group of stage1_block_plan past MU_MAX_LB columns, as the
    --omega self-search launches them), the Mu filter by the
    shared-memory kernel (up to MU_MAX_LB columns, at its own lanes and R)
    and by the band kernel at R = 4 and at R = 8, forced by replacing
    ops/sw_sweep.py's mu_uses_global and mu_band_rows, in turns, forward
    then back.  All must give the same scores.  One line a shape: the
    times and each band plan with its blocks in flight and SMs a pair."""
    from reseek_tpu_torch.ops import sw_sweep as mu
    from reseek_tpu_torch.ops.sw_align import band_stats, band_stats_words
    pipe, _chains, longs, at = long_pipe(base)
    p = pipe.params
    o, e = -float(p.para_mu_gap_open), -float(p.para_mu_gap_ext)
    idx = [at[c.label] for c in longs]
    combos = [(x, y) for x in idx for y in idx]
    rule = (mu.mu_uses_global, mu.mu_band_rows)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    variants = ("short", "bands R=4", "bands R=8")
    cases = []
    for b, la, lb in MU_BAND_SHAPES:
        pairs = np.asarray([combos[k % len(combos)] for k in range(b)])
        ia, ib = (pipe._sorted_idx(pairs[:, k]) for k in (0, 1))
        cases.append((f"pairs {(b, la, lb)}", pipe.mu[ia, :la],
                      pipe.mu[ib, :lb]))
    for (lea, leb, ca, cb), starts in pipe.stage1_block_plan().items():
        if mu.mu_uses_global(leb):
            a, b, _ia, _ib = pipe.stage1_letters(lea, leb, ca, cb,
                                                 *starts[0][:2])
            cases.append((f"stage-1 block {(lea, leb, ca, cb)}", a, b))

    @contextlib.contextmanager
    def forced(kind):
        bands = kind != "short"
        mu.mu_uses_global = lambda lb: bands
        if bands:
            mu.mu_band_rows = lambda b, la, sms, r=int(kind[-1]): r
        try:
            yield
        finally:
            mu.mu_uses_global, mu.mu_band_rows = rule

    for what, a, b in cases:
        (n, la), lb = a.shape, b.shape[1]
        names = [v for v in variants if v != "short" or lb <= mu.MU_MAX_LB]

        def run(v, stats=None, a=a, b=b):
            with forced(v):
                return mu.mu_sw_scores(a, b, pipe.mu_table, o, e,
                                       stats=stats)

        got = {v: run(v) for v in names}
        if not all(torch.equal(got[v], got[names[0]]) for v in names):
            fail(f"--mu-bands at {what}: the variants' scores differ")
        ms = {v: [] for v in names}
        for v in names + names[::-1]:
            ms[v].append(time_ms(functools.partial(run, v), reps))
        plans = {}
        for v in names[int(names[0] == "short"):]:
            st = torch.empty(band_stats_words(n), dtype=torch.int32,
                             device=DEVICE)
            run(v, st)
            plans[v] = band_stats(st, n, la, lb, int(v[-1]))
            sms = plans[v].pop("sms_per_pair")
            plans[v]["sms_per_pair_min_max"] = [min(sms), max(sms)]
        print(f"[mb] Mu filter, {what} -> {(n, la, lb)}: rule "
              f"{'bands' if rule[0](lb) else 'short'} R="
              f"{rule[1](n, la, sms)}; ms " + json.dumps(
                  {v: [round(x, 4) for x in t] for v, t in ms.items()})
              + "; plans " + json.dumps(plans), flush=True)


def once_ms(fn):
    """(fn(), its milliseconds): CUDA events around one call, for the
    plain versions at phase 13's shapes, which run once."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def tie_prone_profiles(table, n: int, la: int, lb: int, seed: int):
    """Profiles [2n, F, max(la, lb)] uint8 on DEVICE for n pairs (A side
    row 2k, B side 2k+1), PAD_BYTE past each chain's end: pair 0's B side
    ~la/2 random letters and its A side two copies of them end to end, so
    that its best score comes twice, ~la/2 rows apart (different bands);
    pair 1's A side all padding (no positive cell); the others two letters
    a feature (cells tie everywhere), ragged lengths."""
    rng = np.random.default_rng(seed)
    nf, length = len(table.sizes), max(la, lb)
    prof = np.full((2 * n, nf, length), 255, np.uint8)
    half = la // 2
    x = rng.integers(0, np.array(table.sizes)[:, None], (nf, half))
    prof[1, :, :half] = x
    prof[0, :, :half] = prof[0, :, half:2 * half] = x
    for k in range(2, n):
        for side, top in ((2 * k, la), (2 * k + 1, lb)):
            m = int(rng.integers(top // 2, top + 1))
            prof[side, :, :m] = rng.integers(0, 2, (nf, m))
    prof[3, :, :lb] = rng.integers(0, np.array(table.sizes)[:, None],
                                   (nf, lb))
    return torch.from_numpy(prof).to(DEVICE)


def phase_long_ties(pipe, gate, same, equal) -> None:
    """Phase 13, the band kernels on tie-prone inputs (tie_prone_profiles
    at TIE_SHAPE): sw_align_long and sw_score_long bit-equal to their
    plain versions, pair 0's best cell in the first of its two copies."""
    from reseek_tpu_torch.ops.sw_align import (sw_align, sw_align_ref,
                                               sw_score_profiles,
                                               sw_score_profiles_ref)
    n, la, lb = TIE_SHAPE
    p = pipe.params
    go, ge = float(p.gap_open), float(p.gap_ext)
    prof = tie_prone_profiles(pipe.table, n, la, lb, REPLICA_SEED)
    ia = torch.arange(0, 2 * n, 2, device=DEVICE)
    ib = ia + 1
    nf, tab = prof.shape[1], 4 * pipe.table.blocks.numel()
    cells = n * la * lb
    args = (prof, ia, ib, pipe.table, la, lb, go, ge)
    best, bi, _bj, _tb = gate(
        "sw_align_long", lambda: sw_align(*args), lambda: sw_align_ref(*args),
        same, TIE_SHAPE, n * nf * (la + lb) + tab + cells // 2 + 12 * n,
        cells * CELL_OPS["sw_align"], key="sw_align_long_ties")
    if not (best[0] > 0 and int(bi[0]) < la // 2 and best[1] == 0):
        fail(f"tie-prone gate: pair 0's best {best[0]} at row {bi[0]}, "
             f"pair 1's {best[1]}")
    sargs = (prof, prof, ia, ib, pipe.table, la, lb, go, ge)
    score = gate("sw_score_long", lambda: sw_score_profiles(*sargs),
                 lambda: sw_score_profiles_ref(*sargs), equal, TIE_SHAPE,
                 n * nf * (la + lb) + tab + 4 * n,
                 cells * CELL_OPS["sw_score"], key="sw_score_long_ties")
    if not torch.equal(score, best):
        fail("tie-prone gate: sw_score_long differs from sw_align_long")


def phase_long_kernels(pipe, opipe, a_orig, b_orig, longs) -> dict:
    """Phase 13, kernel gates: each long-column variant against its plain
    version on the card at a shape the main path gives it; the score
    kernels and the walk bit-equal, LDDT within LDDT_TOL.  sw_align,
    sw_score_profiles and the walk on the pairs (a_orig[k], b_orig[k]) at
    the stage-3 shape of the first (the engine's edge of a_orig[0]'s
    chain by its widest edge: 8,192 x 16,384 for the 8,000 x 12,000
    pair, several passes of row tiles, each handing its bottom row to the
    next through device memory); the Mu filter on the same pairs at the
    legacy engine's bucket of the longest chain (its length rounded up to
    256, square), and on the stage-1 blocks of ``opipe`` (the --omega
    self-search's engine) past the column limit, whole; LDDT on two pairs of M = 12,000 columns (the longest
    chain against its noisy copy, and against a copy with 0.5 A noise
    over 11,000 valid columns).  The bounds count the cells up to the
    chains' ends.  Each kernel timed (CUDA events behind the device spin,
    warm), each plain version once.  Returns {variant: {max_abs_err, ms,
    plain_ms, bound_ms, bound_by, shape}}."""
    from reseek_tpu_torch.ops.postalign import (lddt_batch, lddt_batch_ref,
                                                lddt_cluster,
                                                lddt_long_blocks,
                                                walk_traceback_batch,
                                                walk_traceback_batch_ref)
    from reseek_tpu_torch.ops.sw_align import (band_stats, band_stats_words,
                                               sw_align, sw_align_ref,
                                               sw_score_profiles,
                                               sw_score_profiles_ref)
    from reseek_tpu_torch.ops.sw_sweep import (mu_band_rows, mu_lane_bits,
                                               mu_sw_scores, mu_sw_scores_ref,
                                               mu_uses_global)
    p = pipe.params
    res = {}

    def gate(name, got_fn, plain_fn, equal, shape, nbytes, ops, reps=3,
             key=None, chain=None, plan=band_stats):
        """Run the kernel (its variant counted), then the plain version
        once; fail unless ``equal(got, want)`` (-> max_abs_err or None);
        time the kernel and keep its bound (and, for a band kernel, the
        chain bound from the longest pair's LA + LB cells, and its plan
        and stats from one more call, got_fn(stats), read by ``plan``)
        under ``key``."""
        with Launches() as n:
            got = got_fn()
            torch.cuda.synchronize()
        n.require([name], f"the {name} gate")
        want, plain_ms = once_ms(plain_fn)
        err = equal(got, want)
        if err is None:
            fail(f"{name} != plain at {shape}")
        b, by = bound(nbytes, ops)
        key = key or name
        res[key] = r = {"max_abs_err": float(err),
                        "ms": time_ms(got_fn, reps), "plain_ms": plain_ms,
                        "bound_ms": b, "bound_by": by, "shape": shape}
        extra = ""
        if chain is not None:
            r["chain_bound_ms"] = chain * CELL_CHAIN_CYCLES / sm_clock_hz() \
                * 1e3
            st = torch.empty(band_stats_words(shape[0]), dtype=torch.int32,
                             device=DEVICE)
            got_fn(st)
            r["bands"] = plan(st, *shape)
            sms = r["bands"]["sms_per_pair"]
            if len(sms) > 8:
                r["bands"]["sms_per_pair"] = [min(sms), max(sms)]
            extra = (f", chain bound {r['chain_bound_ms']:.4f} ms; "
                     f"bands {json.dumps(r['bands'])}")
        print(f"[13] {key} at {shape}: equal to the plain version (err "
              f"{r['max_abs_err']:.3g}); kernel {r['ms']:.3f} ms, plain "
              f"{plain_ms:.1f} ms (once), bound {b:.4f} ms ({by}){extra}")
        return got

    def same(got, want):
        return 0.0 if all(torch.equal(x, y) for x, y in zip(got, want)) \
            else None

    go, ge = float(p.gap_open), float(p.gap_ext)
    ia = pipe._sorted_idx(np.asarray(a_orig))
    ib = pipe._sorted_idx(np.asarray(b_orig))
    nb, lb = len(a_orig), int(pipe.prof.shape[2])
    la = int(pipe._edge_of(pipe.lens[a_orig[:1]])[0])
    nf = pipe.prof.shape[1]
    cells = nb * la * lb
    # the cells up to the chains' ends (no other cell can raise the best)
    len_a, len_b = pipe.lens[a_orig], pipe.lens[b_orig]
    real = int((np.minimum(len_a, la) * np.minimum(len_b, lb)).sum())
    chain = int((np.minimum(len_a, la) + np.minimum(len_b, lb)).max())
    tab = 4 * pipe.table.blocks.numel()
    args = (pipe.prof, ia, ib, pipe.table, la, lb, go, ge)
    best, bi, bj, tb = gate(
        "sw_align_long", lambda st=None: sw_align(*args, stats=st),
        lambda: sw_align_ref(*args), same, (nb, la, lb), nb * nf * (la + lb) + tab + cells // 2 + 12 * nb,
        real * CELL_OPS["sw_align"], chain=chain)
    print(f"[13] sw_align_long / sw_score_long: {tb.shape[1]} bands of "
          f"{32 * 2 * tb.shape[4]} rows a pair; cells to the chains' ends "
          f"{real}")

    def walk_fn():
        return walk_traceback_batch(tb, best, bi, bj, la)

    walk = walk_fn()
    rwalk, walk_plain_ms = once_ms(
        lambda: walk_traceback_batch_ref(tb, best, bi, bj, la))
    if same(walk, rwalk) is None:
        fail(f"walk_traceback != plain at {(nb, la, lb)}")
    print(f"[13] walk_traceback at {(nb, la, lb)}: equal to the plain "
          f"version (paths of {walk[2].tolist()} steps); kernel "
          f"{time_ms(walk_fn, 5):.3f} ms, plain {walk_plain_ms:.1f} ms "
          f"(once)")
    sargs = (pipe.prof, pipe.prof, ia, ib, pipe.table, la, lb, go, ge)

    def equal(g, w):
        return 0.0 if torch.equal(g, w) else None

    score = gate(
        "sw_score_long", lambda st=None: sw_score_profiles(*sargs, stats=st),
        lambda: sw_score_profiles_ref(*sargs), equal, (nb, la, lb),
        nb * nf * (la + lb) + tab + 4 * nb, real * CELL_OPS["sw_score"],
        chain=chain)
    if not torch.equal(score, best):
        fail("sw_score_long differs from sw_align_long's best")
    # the self-rev shape, one pair: the 12,000-residue chain against its
    # reversed profile at its edge, square
    one = ib[:1]
    n12 = int(len_b[0])
    rargs = (pipe.prof, pipe.prof_rev, one, one, pipe.table, lb, lb, go, ge)
    gate("sw_score_long", lambda st=None: sw_score_profiles(*rargs, stats=st),
         lambda: sw_score_profiles_ref(*rargs), equal, (1, lb, lb),
         nf * 2 * lb + tab + 4, n12 * n12 * CELL_OPS["sw_score"],
         key="sw_score_long_b1", chain=2 * n12)
    # below the column limit, where the band kernel takes the place of
    # passes on one SM: a stage-3 chunk at edge 8,192 (up to 8 pairs, 2^26
    # cells; R = 4) and a rectangular one of 4,096 x 512 (32 pairs; R = 8),
    # pairs of the long chains
    idx = sorted(set(a_orig) | set(b_orig))
    combos = [(x, y) for x in idx for y in idx]
    for n, ea, eb in ((8, la, la), (32, la // 2, 512)):
        pairs = np.asarray([combos[k % len(combos)] for k in range(n)])
        sa, sb = (pipe._sorted_idx(pairs[:, k]) for k in (0, 1))
        ra = np.minimum(pipe.lens[pairs[:, 0]], ea)
        rb = np.minimum(pipe.lens[pairs[:, 1]], eb)
        margs = (pipe.prof, sa, sb, pipe.table, ea, eb, go, ge)
        mid = gate("sw_align_long",
                   lambda st=None, a=margs: sw_align(*a, stats=st),
                   lambda a=margs: sw_align_ref(*a), same, (n, ea, eb),
                   n * nf * (ea + eb) + tab + n * ea * eb // 2 + 12 * n,
                   int((ra * rb).sum()) * CELL_OPS["sw_align"],
                   key=f"sw_align_long_{n}x{ea}x{eb}",
                   chain=int((ra + rb).max()))
        with Launches() as launched:
            mid_score = sw_score_profiles(pipe.prof, pipe.prof, sa, sb,
                                          pipe.table, ea, eb, go, ge)
            torch.cuda.synchronize()
        launched.require(["sw_score_long"],
                         f"the score-only band gate at {(n, ea, eb)}")
        if not torch.equal(mid_score, mid[0]):
            fail("sw_score_long differs from sw_align_long's best at "
                 f"{(n, ea, eb)}")
    phase_long_ties(pipe, gate, same, equal)

    o, e = -float(p.para_mu_gap_open), -float(p.para_mu_gap_ext)
    mt = pipe.mu_table

    def exact(g, w):
        return 0.0 if torch.equal(g, w) else None

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def mu_plan(st, b, la, lb):
        return band_stats(st, b, la, lb, mu_band_rows(b, la, sms))

    def distinct_ref(a, b):
        """The plain version on the distinct (A, B) rows of a batch, its
        scores spread back over the batch's rows: a stage-1 block's pairs
        clamped to the last chain repeat one pair, which must score alike."""
        rows, inv = torch.unique(torch.cat([a, b], 1), dim=0,
                                 return_inverse=True)
        la = a.shape[1]
        return mu_sw_scores_ref(rows[:, :la].contiguous(),
                                rows[:, la:].contiguous(), mt.mumx, o,
                                e)[inv]

    def mu_gate(key, a, b):
        """The Mu filter's band kernel on letters a [B, LA], b [B, LB]:
        bit-equal to its plain version (on the batch's distinct pairs);
        bound from the cells up to each pair's last letters (the kernel
        sweeps no more), chain bound from the longest pair's rows +
        columns there."""
        ea, eb = (((x < 36) * torch.arange(1, x.shape[1] + 1,
                                           device=DEVICE)).amax(1).cpu()
                  .numpy().astype(np.int64) for x in (a, b))
        ea = np.where(eb > 0, ea, 0)
        bsz, la = a.shape
        lb = b.shape[1]
        gate("mu_sweep_long",
             lambda st=None: mu_sw_scores(a, b, mt, o, e, stats=st),
             lambda: distinct_ref(a, b), exact,
             (bsz, la, lb), a.numel() + b.numel() + 2 * mt.tab16.numel()
             + 4 * bsz, int((ea * eb).sum()) * CELL_OPS["mu_sweep"],
             key=key, chain=int((ea + eb).max()), plan=mu_plan)
        bits = mu_lane_bits(la, lb, mt.smax, mt.smin, int(o), int(e))
        print(f"[13] {key}: int{bits} lanes, R = "
              f"{mu_band_rows(bsz, la, sms)}; rows / columns to the "
              f"letters' ends {ea.tolist()[:8]} / {eb.tolist()[:8]}")

    # the legacy bucket (2 x 12,032 x 12,032), one pair of it, and a
    # ragged batch at that bucket: A sides ending mid-band (the noisy
    # 12,000 chain cut at 5,064 rows, the 8,000 chain, the shortest chain)
    a, b = mu_bucket_letters(pipe, ia, ib)
    mu_gate("mu_sweep_long_bucket", a, b)
    mu_gate("mu_sweep_long_b1", a[1:], b[1:])
    ragged = a[[1, 0, 1]].clone()
    ragged[0, 5064:] = 36
    ragged[2] = pipe.mu[0, :ragged.shape[1]]
    mu_gate("mu_sweep_long_ragged", ragged, b[[0, 0, 1]].contiguous())
    # the --omega self-search's stage-1 blocks past the limit, whole, as
    # it launches them: its short rows against the 16,384 edge (the
    # smallest A edge; 128 blocks, R = 4), and its largest, 16,384 x
    # 16,384 (128 pairs of the 12,000-residue chain, fwd and rev, 8,192
    # blocks that queue, R = 8), mu_sweep_long's shape in the kernels line
    blocks = {k: v for k, v in opipe.stage1_block_plan().items()
              if mu_uses_global(k[1])}
    for key, shape in (("mu_sweep_long_stage1", min(blocks)),
                       ("mu_sweep_long", max(blocks))):
        sa, sb, _, _ = opipe.stage1_letters(*shape, *blocks[shape][0][:2])
        mu_gate(key, sa, sb)

    def lddt_equal(got, want):
        err = float((got[0] - want[0]).abs().max())
        return err if torch.equal(got[1], want[1]) and err <= LDDT_TOL \
            else None


    def lddt_gate(key, cq, ct, valid):
        """LDDT's long variant within LDDT_TOL of its plain version, risky
        equal; bound from the valid column pairs."""
        n_m = valid.sum(1).to(torch.int32)
        nm = n_m.long()
        b, m = valid.shape
        got = gate("lddt_long", lambda: lddt_batch(cq, ct, valid, n_m),
                   lambda: lddt_batch_ref(cq, ct, valid, n_m), lddt_equal,
                   (b, m), 8 * cq.numel() + valid.numel() + 4 * b + 5 * b,
                   int((nm * (nm - 1) // 2).sum()) * LDDT_PAIR_OPS, key=key)
        print(f"[13] {key}: values {got[0].tolist()}, risky "
              f"{got[1].tolist()}, {lddt_long_blocks(b, m, sms)} blocks "
              f"(the parent's cluster: {lddt_cluster(b, m, sms)} a pair)")

    cq, ct, valid, _n = lddt_long_columns(longs)
    lddt_gate("lddt_long", cq, ct, valid)
    lddt_gate("lddt_long_b1", cq[:1], ct[:1], valid[:1])
    # M = 7,681, one past the shared-memory kernel's limit
    lddt_gate("lddt_long_7681", cq[:, :7681].contiguous(),
              ct[:, :7681].contiguous(), valid[:, :7681].contiguous())
    # B = 8 at M = 8,000: the 8,000-residue chain against copies with
    # 0.0625-0.5 A of noise (seed 19), valid over ragged spans with holes
    eight = longs[0]
    m8 = len(eight)
    rng = np.random.default_rng(REPLICA_SEED + 2)
    cq8 = torch.tensor(np.repeat(eight.coords[None], 8, 0), device=DEVICE)
    ct8 = torch.tensor(np.stack([
        eight.coords + rng.normal(0, REPLICA_NOISE * (k + 1) / 4,
                                  eight.coords.shape).astype(np.float32)
        for k in range(8)]), device=DEVICE)
    v8 = rng.random((8, m8)) < 0.97
    for k in range(8):
        v8[k, m8 - 500 * k:] = False
    lddt_gate("lddt_long_b8", cq8, ct8, torch.tensor(v8, device=DEVICE))
    return res


def phase_long(base, parent=None):
    """Phase 13: --verysensitive past the kernels' column limits, on long
    chains made from q100 (long_chains) beside the 8 shortest q100
    chains.  The kernel gates (phase_long_kernels); with ``parent`` (a
    directory holding another tree of the repository) first the band
    entries' times there and here (long_kernel_times, each in a
    subprocess, parent then this tree).  The self-search and a query
    search of the 12,000-residue chain through the port's entry points
    (engine="device", device="cuda"), with a chain of LONG_XL residues
    added (stage-3 edge 32,768), byte-equal to the host engine, every
    long chain with its self hit; the device self-reversal scores equal
    to the host's; the legacy engine (sensitive filters, MKF routing off:
    the Mu filter runs) equal to the host PairAligner pair for pair.
    Each run must launch its long variants (LONG_KERNELS).  Walls and
    peak device memory.  Returns (kernel results, {run: launch
    counts})."""
    import dataclasses
    from reseek_tpu_torch.align.output import parse_columns
    from reseek_tpu_torch.align.pipeline import self_rev_score
    from reseek_tpu_torch.constants import DSSParams
    from reseek_tpu_torch.search import driver as port
    from reseek_tpu_torch.search.batched import (BatchedEngine, DeviceDB,
                                                 batched_self_search)
    from reseek_tpu_torch.search.engine import DeviceSelfSearch
    from reseek_tpu_torch.search.host import SearchOptions, _encode_all
    t_phase = time.perf_counter()
    if parent is not None:
        times = {}
        for tree in (parent, ROOT):
            times[tree] = tree_long_times(tree)
            print(f"[13] long entries' times, {tree}: "
                  f"{json.dumps(times[tree])}", flush=True)
        differ = sorted(k for k in times[parent] if k in times[ROOT] and
                        times[parent][k]["digest"] != times[ROOT][k]["digest"])
        if differ:
            fail(f"the long entries' outputs differ from {parent}'s: "
                 f"{differ}")
    torch.cuda.reset_peak_memory_stats()
    pipe, chains, longs, at = long_pipe(base)
    ecs, params = pipe.ecs, pipe.params
    short = sorted(base, key=len)[:8]
    labels = [c.label for c in longs]
    xl = long_chain(base, LONG_XL, f"long{LONG_XL}")
    print(f"[13] long chains {dict(zip(labels, map(len, longs)))} from "
          f"q100, beside the 8 shortest q100 chains; {xl.label} in the "
          f"searches")
    print(f"[13] engine edges {pipe.edges}")
    # --verysensitive --omega 12, as a user gives it: the Mu filter runs,
    # and its stage-1 blocks of the long chains (columns at edges 8,192
    # and 16,384) take mu_sweep_long
    oparams = dataclasses.replace(params, omega=LONG_OMEGA)
    ochains = short + longs[:2]
    opipe = DeviceSelfSearch(_encode_all(ochains, oparams,
                                         with_self_rev=False), oparams,
                             device=DEVICE)
    res = phase_long_kernels(pipe, opipe, [at[labels[0]], at[labels[2]]],
                             [at[labels[1]]] * 2, longs)
    del opipe
    launches = {}

    t0 = time.perf_counter()
    with Launches() as launched:
        got = pipe.self_rev_scores_device()
    secs = time.perf_counter() - t0
    want = np.float32([self_rev_score(ec, params) for ec in ecs])
    if not np.array_equal(got, want):
        fail(f"long self-rev: {int((got != want).sum())} chains differ "
             "from the host")
    launched.require(["sw_score_long"], "the long chains' device self-rev")
    launches["self_rev"] = launched.counts
    print(f"[13] device self-rev of the {len(ecs)} chains equals the host: "
          f"{secs:.2f} s; launches {launched.counts}")

    opts = SearchOptions(columns=parse_columns(COLUMNS), mode=LONG_MODE,
                         max_evalue=float("inf"))
    dev = {"engine": "device", "device": DEVICE}

    def run(fn, *a, with_params=params, **kw):
        out = io.StringIO()
        t0 = time.perf_counter()
        fn(*a, with_params, opts, out, **kw)
        torch.cuda.synchronize()
        return out.getvalue(), time.perf_counter() - t0

    searched = chains + [xl]
    want, host_s = run(port.self_search, searched, engine="host")
    with Launches() as launched:
        got, dev_s = run(port.self_search, searched, **dev)
    if got != want:
        fail("long --verysensitive self-search differs from the host")
    rows = [line.split("\t") for line in got.splitlines()]
    selfs = {r[0] for r in rows if r[0] == r[1]}
    if not set(labels + [xl.label]) <= selfs:
        fail(f"long self-search: {sorted(set(labels) - selfs)} lack a "
             "self hit")
    launched.require(["sw_align_long", "lddt_long", "walk_traceback"],
                     "the long self-search")
    launches["search"] = launched.counts
    print(f"[13] --verysensitive self-search of {len(searched)} chains: "
          f"{len(rows)} rows byte-equal to the host, every long chain's "
          f"self hit; device {dev_s:.2f} s, host {host_s:.2f} s; launches "
          f"{launched.counts}")
    query = [longs[1]]
    want, host_s = run(port.query_search, query, searched, engine="host")
    with Launches() as launched:
        got, dev_s = run(port.query_search, query, searched, **dev)
    if got != want or not got:
        fail("long --verysensitive query search differs from the host")
    if xl.label not in {line.split("\t")[1] for line in got.splitlines()}:
        fail(f"long query: no row against {xl.label}")
    launched.require(["sw_align_long", "lddt_long"], "the long query")
    print(f"[13] --verysensitive query {labels[1]} x {len(searched)} chains: "
          f"{len(got.splitlines())} rows byte-equal to the host; device "
          f"{dev_s:.2f} s, host {host_s:.2f} s; launches {launched.counts}")

    # the --omega self-search through the entry point
    want, host_s = run(port.self_search, ochains, with_params=oparams,
                       engine="host")
    with Launches() as launched:
        got, dev_s = run(port.self_search, ochains, with_params=oparams,
                         **dev)
    if got != want:
        fail(f"--verysensitive --omega {LONG_OMEGA:g} self-search differs "
             "from the host")
    launched.require(["mu_sweep_long", "sw_align_long", "lddt_long"],
                     f"the --omega {LONG_OMEGA:g} self-search")
    launches["omega"] = launched.counts
    print(f"[13] --verysensitive --omega {LONG_OMEGA:g} self-search of "
          f"{len(ochains)} chains: {len(got.splitlines())} rows byte-equal "
          f"to the host; device {dev_s:.2f} s, host {host_s:.2f} s; "
          f"launches {launched.counts}", flush=True)

    lparams = dataclasses.replace(DSSParams.create("sensitive"),
                                  mkfl=params.mkfl)
    lchains = short[:4] + longs[:2] + short[4:]
    lecs = _encode_all(lchains, lparams, with_self_rev=False)
    t0 = time.perf_counter()
    with Launches() as launched:
        ldb = DeviceDB(lecs, lparams, with_rev_profiles=True, device=DEVICE)
        srs = BatchedEngine(ldb).self_rev_scores()
        host_srs = np.float32([self_rev_score(ec, lparams) for ec in lecs])
        if not np.array_equal(srs, host_srs):
            fail("legacy self_rev_scores of the long chains differ from "
                 "the host")
        for ec, s in zip(lecs, host_srs):
            ec.self_rev_score = float(s)
        t1 = time.perf_counter()
        got = batched_self_search(lecs, lparams, db=ldb)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
    launched.require(["mu_sweep_long", "sw_score_long", "sw_align_long",
                      "lddt_long"], "the legacy engine on the long chains")
    launches["legacy"] = launched.counts
    legacy_vs_host(lecs, lparams, got)
    print(f"[13] legacy engine (sensitive, MKF off) on {len(lchains)} chains"
          f" (buckets {ldb.buckets}): self_rev_scores bit-equal to the "
          f"host, batched_self_search {secs:.2f} s, {len(got)} pairs equal "
          f"to the host PairAligner; DeviceDB + self-rev {t1 - t0:.2f} s; "
          f"stages {json.dumps(ldb.stats)}; launches {launched.counts}")
    print(f"[13] phase 13: {time.perf_counter() - t_phase:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return res, launches


def long_entries(res: dict, launches: dict) -> list:
    """The ``kernels`` line's entries of the long-column variants: phase
    13's gate results, the launches of the run LONG_KERNELS names, of the
    legacy run and of every run of phase 13; the band kernels' chain
    bound and bands."""
    return [{"name": k, "route": "cuda", "source": src, "replaces": rep,
             "launches": launches[run][k],
             "max_abs_err": res[k]["max_abs_err"], "ms": res[k]["ms"],
             "plain_ms": res[k]["plain_ms"], "bound_ms": res[k]["bound_ms"],
             "bound_by": res[k]["bound_by"], "library_ms": None,
             "shape": res[k]["shape"],
             "legacy_launches": launches["legacy"][k],
             "launches_by_run": {r: n[k] for r, n in launches.items()},
             **{x: res[k][x] for x in ("chain_bound_ms", "bands")
                if x in res[k]}}
            for k, (src, rep, run) in LONG_KERNELS.items()]


def phase_fwd_exact() -> None:
    """[14] The host finish displays and gates on stage 3's forward score
    as it is: on every stage-3 pair of one FWD_EXACT_CELL job drawn from
    FWD_EXACT_SEED, the CUDA SW score must equal the host SW's bit for
    bit."""
    from portbench.harness import Bench, kind_module
    from reseek_tpu_torch.chain import Chain
    from reseek_tpu_torch.constants import DSSParams
    from reseek_tpu_torch.search import driver, host
    from reseek_tpu_torch.search.engine import (DeviceSelfSearch,
                                                _exact_fwd_score)
    cell = Bench(ROOT).cell(FWD_EXACT_CELL)
    kind = kind_module(cell["traffic"])
    wl = kind.Workload(cell["config"], cell["traffic"], FWD_EXACT_SEED,
                       DEVICE)
    chains = wl.pool.chains(Chain, wl.next_call())
    params = DSSParams.create(wl.mode)
    seen = []
    finish = DeviceSelfSearch._finish

    def record(self, chunk, r, *args):
        seen.append((self.ecs, chunk, r["best"]))
        return finish(self, chunk, r, *args)

    DeviceSelfSearch._finish = record
    try:
        with Launches() as launched:
            t0 = time.perf_counter()
            drv = driver.self_search(
                chains, params, kind.options_for(wl.mode, wl.columns, host),
                io.StringIO(), engine="device", device=DEVICE)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        DeviceSelfSearch._finish = finish
    launched.require(["sw_align"], f"the {FWD_EXACT_CELL} job")
    pairs = [(ecs[i], ecs[j]) for ecs, chunk, _ in seen for i, j in chunk]
    got = np.concatenate([best for _, _, best in seen]).astype(np.float32)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(os.cpu_count() or 2) as tp:
        exact = np.float32(list(tp.map(lambda p: _exact_fwd_score(
            params, p[0].profile, p[1].profile), pairs)))
    host_s = time.perf_counter() - t0
    differ = int((got != exact).sum())
    st = drv.device_stats
    print(f"[14] {FWD_EXACT_CELL} job of {len(chains)} domains (seed "
          f"{FWD_EXACT_SEED}): {len(pairs)} stage-3 pairs compared with the host SW "
          f"({host_s:.2f} s), {differ} differ; wall {wall:.2f} s, "
          f"finish {st['finish_s']:.3f} s, {st['recomputed_pairs']} of "
          f"{st['finish_pairs']} result pairs recomputed "
          f"({st['finish_recompute_s']:.3f} s); sw_align launches "
          f"{launched.counts['sw_align']}")
    if len(pairs) != st["stage3_pairs"]:
        fail(f"phase 14 saw {len(pairs)} of {st['stage3_pairs']} stage-3 "
             f"pairs")
    if differ:
        fail(f"{differ} stage-3 forward scores differ from the host SW")


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


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
    from reseek_tpu_torch.constants import DSSParams
    from reseek_tpu_torch.device import disable_tf32
    from reseek_tpu_torch.io.reader import read_chains
    from reseek_tpu_torch.search.engine import DeviceSelfSearch
    from reseek_tpu_torch.search.host import _encode_all
    disable_tf32()
    kind = torch.cuda.get_device_name(0)
    print(f"[0] device: {kind} x {torch.cuda.device_count()}")
    t_start = time.perf_counter()

    phase_build()
    if sys.argv[1:2] == ["--sass"]:
        # phases 0-1, then the opcodes of the kernels named (default: the
        # float sweep)
        phase_sass(sys.argv[2] if len(sys.argv) > 2 else "sweep_kernel")
        return 0
    if sys.argv[1:] == ["--bench-cmds"]:
        # phases 0-1, then the benchmark commands alone
        phase_bench_cmds()
        return 0
    if sys.argv[1:] == ["--io-cmds"]:
        # phases 0-1, then the I/O, format and alignment commands alone
        phase_io_cmds()
        return 0
    chains = read_chains(Q100)
    if sys.argv[1:] == ["--msa-cmds"]:
        # phases 0-1, then the MSA, training and diagnostic commands and
        # the legacy engine alone
        phase_msa_cmds()
        phase_legacy(chains, replica(chains, REPLICA_CHAINS))
        return 0
    if sys.argv[1:2] == ["--long"]:
        # phases 0-1, then the long chains alone; --long --parent DIR also
        # times the band entries of the tree at DIR
        parent = (sys.argv[3] if sys.argv[2:3] == ["--parent"]
                  and len(sys.argv) > 3 else None)
        long_res, long_launches = phase_long(chains, parent)
        print(card)
        print(json.dumps({"kernels": long_entries(long_res, long_launches)}))
        return 0
    if sys.argv[1:] == ["--bands"]:
        # phases 0-1, then the band kernel against the shared-memory
        # kernel and R = 4 against R = 8
        phase_bands(chains)
        return 0
    if sys.argv[1:] == ["--mu-bands"]:
        # phases 0-1, then the Mu filter's band kernel against its
        # shared-memory kernel and R = 4 against R = 8
        phase_mu_bands(chains)
        return 0
    if sys.argv[1:] == ["--fwd-exact"]:
        # phases 0-1, then the stage-3 forward scores of a benchmark job
        # against the host SW
        phase_fwd_exact()
        return 0
    if sys.argv[1:] == ["--stage1"]:
        # phases 0-1, then the replica's stage 1 alone (to compare two
        # versions of the Mu filter in one call)
        phase_stage1(replica(chains, REPLICA_CHAINS))
        return 0
    params = DSSParams.create(MODE)
    pipe = DeviceSelfSearch(_encode_all(chains, params, with_self_rev=False),
                            params, device=DEVICE)
    survivors = pipe.stage1_survivors()
    print(f"[2] q100 stage-1 survivors: {len(survivors)}")
    if sys.argv[1:] == ["--walk"]:
        # phases 0-1, then the walk alone (to compare two versions of it)
        phase_walk_alone(pipe, survivors)
        return 0
    if sys.argv[1:] == ["--sweep"]:
        # phases 0-1, then the float sweep alone (to compare two versions)
        phase_sweep_alone(pipe, survivors)
        return 0
    res = phase_kernels(pipe, survivors)
    phase_tie_prone(pipe)
    phase_walk_paths(pipe)
    if sys.argv[1:] == ["--kernels"]:
        # phases 0-2 only: the kernels against their plain versions
        print(json.dumps(res))
        return 0
    del pipe
    big = replica(chains, FAST_DB_CHAINS)
    db = big[:REPLICA_CHAINS]
    launches = {}
    launches["q100"], want_self, self_s = phase_q100(chains)
    phase_replica(db)
    launches["self_rev"], rev = phase_self_rev([("q100", chains),
                                                ("replica", db)])
    launches["query_prepass"], want_query, query_s, want_ten = phase_query(
        chains, db)
    phase_fast(chains, big)
    phase_mesh(chains, db, {"self": (want_self, self_s),
                            "query": (want_query, query_s),
                            "ten": want_ten, "rev": rev})
    phase_multiprocess(big)
    phase_bench_cmds()
    launches["io_cmds"] = phase_io_cmds(want_self)
    t12 = time.perf_counter()
    phase_msa_cmds()
    launches["legacy"] = phase_legacy(chains, db)
    print(f"[12] phase 12: {time.perf_counter() - t12:.1f} s")
    long_res, long_launches = phase_long(chains)
    phase_fwd_exact()
    print(f"[end] all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")

    print(card)
    # library_ms: no single PyTorch call computes SW, the walk or LDDT;
    # the stage-3 kernel's yardstick is the gather-sum it absorbs (smx_ms),
    # LDDT's times per cluster size (cluster<C>_ms) are beside its own
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[run][k], "max_abs_err": res[k]["max_abs_err"],
         "ms": res[k]["ms"], "plain_ms": res[k]["plain_ms"],
         "bound_ms": res[k]["bound_ms"], "bound_by": res[k]["bound_by"],
         "library_ms": None, "shape": res[k]["shape"],
         "io_cmds_launches": launches["io_cmds"][k],
         "legacy_launches": launches["legacy"][k],
         **extra_times(res[k])}
        for k, (src, rep, run) in KERNELS.items()]
        + long_entries(long_res, long_launches)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
