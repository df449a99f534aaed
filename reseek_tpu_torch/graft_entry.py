"""Graft entry points: one kernel's compile-and-run check and a dry
run of the search over a mesh, the port's counterparts of the repository's
``__graft_entry__.py``.

    fn, args = entry("cuda")        # fn(*args): the exact SW score of four
                                    # seeded profile pairs (kernel P3)
    dryrun_multichip(2, "cuda")     # the mesh searches against one device

Both take the torch device explicitly and never fall back to the CPU;
``device="cpu"`` runs the kernels' plain versions.
"""

from __future__ import annotations

import io
import os
import tempfile
from typing import Tuple

import numpy as np
import torch

Q100 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tests", "golden", "q100.cal")
# nine q100 chains of 49-601 residues, in five 128-residue length buckets;
# 1amo_A (601) is at the MKF length of sensitive mode (the host MKF
# route); each of the first three has a hit among the other six
DRYRUN_CHAINS = (43, 10, 64, 67, 74, 69, 94, 22, 30)


def entry(device: str = "cuda") -> Tuple:
    """(fn, example_args): ``fn(prof_a, prof_b, table)`` is the exact best
    local score of the pairs (prof_a[k], prof_b[k]) on the sensitive
    parameters (ops/sw_align.sw_score_profiles: the substitution scores
    gathered inside the kernel), counterpart of __graft_entry__'s
    smx_batch_gather + sw_score_batch.  The example arguments are its
    seeded codes (default_rng(0), 4 pairs of 96 residues), as uint8
    profiles of feature letters, and the FeatureTable, on ``device``."""
    from reseek_tpu_torch.constants import ALPHA_SIZES, DSSParams
    from reseek_tpu_torch.ops.smx import flat_layout
    from reseek_tpu_torch.ops.sw_align import FeatureTable, sw_score_profiles

    params = DSSParams.create("sensitive")
    offsets, _d, w = flat_layout(params.features, params.weights)
    open_, ext = float(params.gap_open), float(params.gap_ext)
    table = FeatureTable.build(torch.from_numpy(w),
                               torch.from_numpy(offsets)).to(device)

    def fn(prof_a: torch.Tensor, prof_b: torch.Tensor,
           table: FeatureTable) -> torch.Tensor:
        pairs = torch.arange(prof_a.shape[0], device=prof_a.device)
        la = lb = int(prof_a.shape[2])
        return sw_score_profiles(prof_a, prof_b, pairs, pairs, table, la,
                                 lb, open_, ext)

    rng = np.random.default_rng(0)
    b, f, l = 4, len(params.features), 96
    sizes = np.array([ALPHA_SIZES[x] for x in params.features])
    prof = rng.integers(0, sizes[None, :, None], (b, f, l))
    prof2 = rng.integers(0, sizes[None, :, None], (b, f, l))
    return fn, tuple(torch.from_numpy(p.astype(np.uint8)).to(device)
                     for p in (prof, prof2)) + (table,)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def mesh_of(n_devices: int, device: str = "cuda") -> Tuple[str, ...]:
    """``n_devices`` mesh positions: cuda:0..n-1 when there are that many
    cards, else n positions of cuda:0; n positions of the CPU for
    ``device="cpu"``."""
    if device == "cpu":
        return ("cpu",) * n_devices
    if torch.cuda.device_count() >= n_devices:
        return tuple(f"cuda:{i}" for i in range(n_devices))
    return ("cuda:0",) * n_devices


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """The search dealt over a mesh of ``n_devices`` positions (mesh_of),
    held against one device as __graft_entry__.dryrun_multichip holds it
    (an AssertionError names the first check that fails):

    1. the sensitive self-search of nine q100 chains (DRYRUN_CHAINS)
       on the mesh, byte-equal to one device;
    2. three of them as queries against the other six, byte-equal;
    3. the prefilter's top-B selection of the nine against q100, the
       targets sharded over the mesh and merged
       (parallel/topk.sharded_prefilter_search), equal to the single-shard
       prefilter_search at top_b=4, with a truncated list;
    4. the multi-process -fast search (parallel/multihost.
       distributed_fast_search, one rank, the device engine over the mesh)
       of the three queries against q100, byte-equal to the host engine's
       fast_search.
    """
    from reseek_tpu_torch.align.output import parse_columns
    from reseek_tpu_torch.constants import DSSParams
    from reseek_tpu_torch.encoder.dss import encode_chain
    from reseek_tpu_torch.io.reader import read_chains
    from reseek_tpu_torch.parallel.multihost import distributed_fast_search
    from reseek_tpu_torch.parallel.topk import sharded_prefilter_search
    from reseek_tpu_torch.search.driver import (fast_search, query_search,
                                                self_search)
    from reseek_tpu_torch.search.host import SearchOptions
    from reseek_tpu_torch.search.prefilter import prefilter_search

    mesh = mesh_of(n_devices, device)
    params = DSSParams.create("sensitive")
    options = SearchOptions(
        columns=parse_columns("query+target+qlo+qhi+evalue+cigar"),
        max_evalue=10.0, mode="sensitive")
    t100 = read_chains(Q100)
    chains = [t100[i] for i in DRYRUN_CHAINS]
    buf_mesh, buf_one = io.StringIO(), io.StringIO()
    self_search(chains, params, options, buf_mesh, engine="device",
                mesh=mesh)
    self_search(chains, params, options, buf_one, engine="device",
                device=device)
    _check(buf_mesh.getvalue() == buf_one.getvalue()
           and buf_mesh.getvalue().count("\n") > 5,
           "the mesh self-search differs from one device's")

    queries, db_chains = chains[:3], chains[3:]
    buf_qm, buf_q1 = io.StringIO(), io.StringIO()
    query_search(queries, db_chains, params, options, buf_qm,
                 engine="device", mesh=mesh)
    query_search(queries, db_chains, params, options, buf_q1,
                 engine="device", device=device)
    _check(buf_qm.getvalue() == buf_q1.getvalue() and buf_qm.getvalue(),
           "the mesh query-vs-DB search differs from one device's")

    q_mu = [encode_chain(c).mu_letters for c in chains]
    t_mu = [encode_chain(c).mu_letters for c in t100]
    single = prefilter_search(q_mu, list(enumerate(t_mu)), top_b=4)
    merged = sharded_prefilter_search(q_mu, t_mu, mesh, top_b=4)
    _check(merged.query_targets == single.query_targets
           and any(len(t) == 4 for t in merged.query_targets),
           "the sharded top-B prefilter differs from one shard's")

    fast_opts = SearchOptions(columns=parse_columns("std"),
                              max_evalue=10.0, mode="fast")
    buf_fast = io.StringIO()
    fast_search(queries, t100, DSSParams.create("fast"), fast_opts,
                buf_fast, engine="host")
    with tempfile.TemporaryDirectory() as scratch:
        buf_dist = io.StringIO()
        distributed_fast_search(queries, t100, fast_opts, buf_dist,
                                scratch_dir=scratch, engine="device",
                                mesh=mesh)
    _check(buf_dist.getvalue() == buf_fast.getvalue()
           and buf_dist.getvalue().count("\n") > 0,
           "the distributed -fast search differs from the host engine's")
