"""The multi-process -fast search, counterpart of
reseek_tpu/parallel/multihost.py, on ``torch.distributed``.

Every rank runs the same program (``python -m reseek_tpu_torch search
--fast --db X.bca --nprocs N --procid I --coord HOST:PORT``):

  1. ``init_distributed`` joins the Gloo process group (the merged lists
     are host data, made by the native prefilter) and pins the rank to
     its share of its host's cores;
  2. each rank scans the contiguous target shards of its mesh positions
     with the native prefilter (global indices);
  3. the per-query top-B lists, padded to [nq, top_b], are all-gathered
     and merged with the stable selection of parallel/topk.py, so every
     rank holds the identical global selection;
  4. each rank aligns the survivors in its own target range, on the
     port's device engine (its mesh devices) or on the host, and writes
     them to scratch/rows.<rank> (a tmp file, renamed when complete);
  5. after a barrier, rank 0 concatenates the row files in rank order.
     Ranks cover ascending target ranges and rows come out per target
     ascending, so the concatenation is the one-process output.

What this port does where reseek_tpu's version falls short:
  - resume: rows.<rank> is reused only when the fingerprint stored beside
    it (rows.<rank>.json: queries, DB path, size and mtime, top-B,
    prefilter mode, columns, E gate, rank range) matches the run; a reused shard opens no devnull
    handle and reports the hit count of its rows;
  - only rank 0 writes the outputs; alignment blocks (--aln) go per rank
    to scratch and rank 0 joins them in row order;
  - the world size is checked against the requested process count;
  - each rank's host pools size to its share of the cores.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import hashlib
import json
import os
import socket
import sys
import time
from typing import List, Optional, TextIO, Tuple

import torch

from reseek_tpu_torch.constants import DSSParams
from reseek_tpu_torch.device import host_cores, resolve
from reseek_tpu_torch.io.bca import BCAReader
from reseek_tpu_torch.io.mufasta import iter_mu_fasta
from reseek_tpu_torch.parallel.mesh import (Mesh, MeshLike, _mesh_shard_ranges,
                                            as_mesh, host_shard_bounds)
from reseek_tpu_torch.search.prefilter import PrefilterResult

__all__ = ["init_distributed", "global_mesh", "host_shard_bounds",
           "distributed_fast_search", "distributed_prefilter",
           "rank_from_env"]


def rank_from_env(nprocs: int, procid: Optional[int], coord: Optional[str],
                  env=os.environ) -> Tuple[str, int]:
    """(coordinator HOST:PORT, rank) of a multi-process run: from
    ``procid``/``coord``, else from torch's ``RANK`` and ``MASTER_ADDR``/
    ``MASTER_PORT``; ``WORLD_SIZE``, when set, must equal ``nprocs``.
    Raises when either is missing: a rank is never guessed."""
    if procid is None:
        if "RANK" not in env:
            raise ValueError("multi-process search: give --procid (or set "
                             "RANK)")
        procid = int(env["RANK"])
    if coord is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise ValueError("multi-process search: give --coord HOST:PORT "
                             "(or set MASTER_ADDR and MASTER_PORT)")
        coord = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if "WORLD_SIZE" in env and int(env["WORLD_SIZE"]) != nprocs:
        raise ValueError(f"WORLD_SIZE={env['WORLD_SIZE']} but --nprocs "
                         f"{nprocs}")
    if not 0 <= procid < nprocs:
        raise ValueError(f"rank {procid} outside 0..{nprocs - 1}")
    return coord, procid


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     timeout_s: float = 1800.0) -> Tuple[int, int]:
    """Join the Gloo process group at tcp://``coordinator`` as rank
    ``process_id`` of ``num_processes`` (an already joined group is
    reused), then pin this rank to its share of the host's cores
    (``pin_host_share``).  Returns (rank, world size).  Raises unless the
    group's world size and rank are the ones asked for."""
    import torch.distributed as dist
    if not dist.is_initialized():
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator}", rank=process_id,
            world_size=num_processes,
            timeout=datetime.timedelta(seconds=timeout_s))
    rank, world = dist.get_rank(), dist.get_world_size()
    if world != num_processes or rank != process_id:
        raise RuntimeError(f"process group has rank {rank} of {world}, "
                           f"but rank {process_id} of {num_processes} was "
                           "asked for")
    pin_host_share(rank, world)
    return rank, world


def pin_host_share(rank: int, world: int) -> List[int]:
    """Pin this rank (its main thread, and so every thread it starts
    later) to its contiguous share of the cores that the ranks on its host
    split, and size torch's thread pool to it.  The ranks sharing a host
    are found by gathering host names over the group.  Returns the
    cores."""
    import torch.distributed as dist
    names = [None] * world
    dist.all_gather_object(names, socket.gethostname())
    local = [r for r in range(world) if names[r] == names[rank]]
    k, n = local.index(rank), len(local)
    try:
        cores = sorted(os.sched_getaffinity(0))
    except AttributeError:          # no affinity call on this platform
        return []
    share = (cores[k * len(cores) // n: (k + 1) * len(cores) // n]
             if len(cores) >= n else [cores[k % len(cores)]])
    os.sched_setaffinity(0, share)
    torch.set_num_threads(len(share))
    print(f"reseek_tpu_torch: rank {rank} ({k + 1} of {n} on "
          f"{names[rank]}): cores {share}", file=sys.stderr, flush=True)
    return share


def global_mesh(device_type: str = "cuda") -> Mesh:
    """1-axis mesh of one device per rank, in rank order: rank r's is
    ``cuda:{r % device_count}`` (so on a one-card machine every rank
    shares cuda:0), or ``cpu`` when ``device_type`` asks for it.  The
    devices are resolved here, so cuda without a card raises: the CPU is
    never a silent substitute."""
    world = _rank_world()[1]
    n_cuda = torch.cuda.device_count() if device_type == "cuda" else 0
    return Mesh(tuple(resolve(torch.device("cuda", r % n_cuda) if n_cuda
                              else device_type) for r in range(world)),
                tuple(range(world)))


def _rank_world() -> Tuple[int, int]:
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def distributed_prefilter(query_mu, target_mu_shard, shard_lo: int,
                          mesh: MeshLike, axis: str = "db",
                          top_b: int = 1500, mode=None,
                          ascii_roundtrip: bool = True):
    """This rank's prefilter scan over its shard, targets [shard_lo,
    shard_lo + len(target_mu_shard)), subdivided over its mesh positions,
    then the merge over the group: the GLOBAL per-query top-B, identical
    on every rank (with no process group, the merge of this shard
    alone)."""
    from reseek_tpu_torch.parallel.topk import (merge_topk_distributed,
                                                shard_lists)
    mesh = as_mesh(mesh)
    if axis != mesh.axis:
        raise ValueError(f"mesh has axis {mesh.axis!r}, not {axis!r}")
    n_local = mesh.ranks.count(_rank_world()[0])
    return PrefilterResult(query_targets=merge_topk_distributed(
        *shard_lists(query_mu, target_mu_shard, shard_lo, n_local, top_b,
                     mode, ascii_roundtrip), top_b))


def _db_fingerprint(db) -> dict:
    if isinstance(db, str):
        st = os.stat(db)
        return {"path": os.path.abspath(db), "bytes": st.st_size,
                "mtime_ns": st.st_mtime_ns}
    h = hashlib.sha256()
    for c in db:
        h.update(f"{c.label}\t{len(c)}\n".encode())
    return {"chains_sha256": h.hexdigest()}


def _read_json(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def distributed_fast_search(queries, db, options, out: Optional[TextIO],
                            scratch_dir: str, dbmu: Optional[str] = None,
                            top_b: int = 1500, prefilter_mode=None,
                            engine: str = "host", mesh: MeshLike = None,
                            resume: bool = False,
                            aln_out: Optional[TextIO] = None,
                            with_aln: bool = False):
    """The multi-process -fast search (steps 2-5 of the module notes; no
    reference counterpart: the reference is single-node).  Every rank
    calls it after ``init_distributed``; with no process group it runs as
    one rank.

    db: a .bca path (random-access re-reads, like the reference's
    BCAData::ReadChain) or an in-memory chain list; dbmu: a Mu-letter
    FASTA of the DB for the prefilter.  engine: "device" (the port's
    engine on this rank's mesh devices), "host", or "auto" (the device
    engine).  mesh: default ``global_mesh()``.  out, aln_out:
    rank 0's merged outputs (None elsewhere); with_aln: every rank writes
    alignment blocks to scratch for rank 0 to join.  resume: reuse
    rows.<rank> when its stored fingerprint matches this run.  Returns
    this rank's SearchDriver (counts cover its range) with ``fast_stats``.
    """
    from reseek_tpu_torch.search import driver as port_driver
    from reseek_tpu_torch.search import host

    t0 = time.perf_counter()
    rank, world = _rank_world()
    mesh = as_mesh(mesh if mesh is not None else global_mesh())
    per_rank = {mesh.ranks.count(r) for r in range(world)}
    if len(mesh.ranks) != world * max(per_rank) or len(per_rank) != 1:
        raise ValueError(f"mesh ranks {mesh.ranks}: every one of the "
                         f"{world} ranks needs the same number of positions")
    if engine == "auto":
        engine = "device"
    if engine not in ("device", "host"):
        raise ValueError(f"unknown engine {engine!r}")
    sens = DSSParams.create("sensitive")
    q_ecs = host._encode_all(list(queries), sens, with_self_rev=False)
    q_mu = [ec.mu_letters for ec in q_ecs]
    nq = len(q_ecs)
    db_is_path = isinstance(db, str)
    if db_is_path and not db.lower().endswith(".bca"):
        raise ValueError("multi-process -fast reads the DB by index: give "
                         "a .bca file")
    if db_is_path:
        with BCAReader(db) as r:
            n_targets = len(r)
    else:
        n_targets = len(db)

    _allr, local = _mesh_shard_ranges(mesh, n_targets, rank)
    proc_lo, proc_hi = local[0][1], local[-1][2]
    fingerprint = {
        "queries": [[ec.label, len(ec)] for ec in q_ecs],
        "db": _db_fingerprint(db), "targets": n_targets, "dbmu": dbmu,
        "top_b": top_b, "prefilter": prefilter_mode,
        "columns": list(options.columns), "mode": options.mode,
        "max_evalue": options.max_evalue,
        "scores_are_not_evalues": options.scores_are_not_evalues,
        "no_self": options.no_self, "aln": with_aln, "nprocs": world,
        "pid": rank, "range": [proc_lo, proc_hi]}
    # json normalises tuples and floats as the stored copy does
    fingerprint = json.loads(json.dumps(fingerprint))
    rows_fn = os.path.join(scratch_dir, f"rows.{rank}")
    aln_fn = os.path.join(scratch_dir, f"aln.{rank}")
    fp_fn = rows_fn + ".json"
    stored = _read_json(fp_fn) if resume else None
    reuse = (stored is not None and stored.get("fingerprint") == fingerprint
             and os.path.exists(rows_fn)
             and (not with_aln or os.path.exists(aln_fn)))
    stats = {"engine": engine, "rank": rank, "nprocs": world,
             "range": [proc_lo, proc_hi], "reused": reuse,
             "cores": host_cores()}

    # 2-3: prefilter of this rank's shards, merged over the group
    def shard_mu(lo, hi):
        if dbmu is not None:
            return [m for _l, m in iter_mu_fasta(dbmu)][lo:hi]
        if db_is_path:
            with BCAReader(db) as r:
                chains = [r.read_chain(t) for t in range(lo, hi)]
        else:
            chains = db[lo:hi]
        enc = iter(list(port_driver._mu_letters(
            c for c in chains if not hasattr(c, "mu_letters"))))
        return [c.mu_letters if hasattr(c, "mu_letters") else next(enc)
                for c in chains]

    merged = distributed_prefilter(q_mu, shard_mu(proc_lo, proc_hi), proc_lo,
                                   mesh, top_b=top_b, mode=prefilter_mode)
    t_pf = time.perf_counter()
    t2q = {t: qs for t, qs in merged.target_to_queries().items()
           if proc_lo <= t < proc_hi}
    tidxs = sorted(t2q)
    stats.update(candidates=sum(len(v) for v in t2q.values()),
                 targets_read=len(tidxs))

    def survivor_chains():
        if db_is_path:
            with BCAReader(db) as r:
                for t in tidxs:
                    yield t, r.read_chain(t)
        else:
            for t in tidxs:
                yield t, db[t]

    # 4: stage 2 of this rank's survivors, or its finished rows reused;
    # the kernel launches it made go into the stats
    from reseek_tpu_torch.ops import kernel_wrappers
    wrappers = kernel_wrappers()
    before = {k: w.launches for k, w in wrappers.items()}
    if reuse:
        drv = host.SearchDriver(sens, options, None)
        drv.hit_count = int(stored["hits"])
    else:
        for fn in (fp_fn, rows_fn, aln_fn):   # a stale set never survives
            if os.path.exists(fn):
                os.unlink(fn)
        with contextlib.ExitStack() as files:
            rows_out = files.enter_context(open(rows_fn + ".tmp", "w"))
            opts = dataclasses.replace(options, aln_out=(
                files.enter_context(open(aln_fn + ".tmp", "w"))
                if with_aln else None))
            drv = host.SearchDriver(sens, opts, rows_out)
            if engine == "device":
                port_driver._fast_align_device(
                    drv, q_ecs, survivor_chains(), t2q, sens, opts, None,
                    stats, mesh.local(rank))
            else:
                host._fast_align_host(drv, q_ecs, survivor_chains(), t2q,
                                      sens)
        if with_aln:
            os.replace(aln_fn + ".tmp", aln_fn)
        os.replace(rows_fn + ".tmp", rows_fn)
        with open(fp_fn + ".tmp", "w") as f:
            json.dump({"fingerprint": fingerprint,
                       "hits": drv.hit_count}, f)
        os.replace(fp_fn + ".tmp", fp_fn)
    drv.query_count = nq
    drv.processed_pairs = nq * (proc_hi - proc_lo)
    stats["launches"] = {k: w.launches - before[k]
                         for k, w in wrappers.items()}
    t_align = time.perf_counter()

    # 5: barrier, then rank 0 joins the files in rank order
    if world > 1:
        import torch.distributed as dist
        dist.barrier()
    if rank == 0:
        for p in range(world):
            if out is not None:
                with open(os.path.join(scratch_dir, f"rows.{p}")) as f:
                    out.write(f.read())
            if aln_out is not None:
                with open(os.path.join(scratch_dir, f"aln.{p}")) as f:
                    aln_out.write(f.read())
    stats.update(prefilter_s=t_pf - t0, align_s=t_align - t_pf,
                 wall_s=time.perf_counter() - t0)
    drv.fast_stats = stats
    return drv
