"""Per-query top-B candidate merge over a DB-sharded mesh, counterpart of
reseek_tpu/parallel/topk.py.

Each shard (a mesh position here; a rank in a multi-process run) scans its
contiguous slice of the target DB with the native prefilter and keeps its
per-query top-B (target, score) list, score descending, ties by ascending
target index (the host RankedScoresBag order).  The merge concatenates the
lists shard-ascending and selects the global top-B per query.

Tie rule: score descending, then ascending global target index, the order
of reseek_tpu's host RankedScoresBag, so sharded and single-shard
selections are identical.  reseek_tpu gets it from XLA's ``top_k``, which
breaks ties by the lower position; ``torch.topk`` fixes no order among
ties, so the merge uses a stable descending ``torch.sort``: within equal
scores the concatenation order survives, and with contiguous ascending
shards, each sorted, that order is ascending target index.

The lists are host data (the native prefilter made them), so the merge runs
on CPU tensors and the multi-process gather uses Gloo.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from reseek_tpu_torch.device import host_cores
from reseek_tpu_torch.parallel.mesh import MeshLike, as_mesh, shard_bounds
from reseek_tpu_torch.search.prefilter import MuPrefilter, PrefilterResult

PAD_SCORE = np.int32(-(1 << 30))
PAD_INDEX = np.int32(2**31 - 1)

TopLists = List[List[Tuple[int, int]]]


def _select(sv: torch.Tensor, ti: torch.Tensor, top_b: int) -> TopLists:
    """Global top-B of the stacked shard lists sv, ti [n_shard, nq, b]
    (shard-ascending): per query [(target, score)], pads dropped."""
    n_shard, nq, b = sv.shape
    k_out = min(top_b, b * n_shard)
    allv = sv.permute(1, 0, 2).reshape(nq, -1)
    alli = ti.permute(1, 0, 2).reshape(nq, -1)
    tv, pos = torch.sort(allv, dim=1, descending=True, stable=True)
    tv = tv[:, :k_out].numpy()
    tidx = torch.gather(alli, 1, pos[:, :k_out]).numpy()
    out: TopLists = []
    for qi in range(nq):
        keep = tv[qi] > PAD_SCORE
        out.append([(int(t), int(s))
                    for t, s in zip(tidx[qi][keep], tv[qi][keep])])
    return out


def _stack(shard_scores: List[np.ndarray], shard_tidx: List[np.ndarray],
           b_local: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[n_shard, nq, b_local] int32 scores and indices, pad-filled."""
    n, nq = len(shard_scores), shard_scores[0].shape[0]
    sv = np.full((n, nq, b_local), PAD_SCORE, np.int32)
    ti = np.full((n, nq, b_local), PAD_INDEX, np.int32)
    for d in range(n):
        b = shard_scores[d].shape[1]
        sv[d, :, :b] = shard_scores[d]
        ti[d, :, :b] = shard_tidx[d]
    return torch.from_numpy(sv), torch.from_numpy(ti)


def merge_topk_sharded(mesh: MeshLike, axis: str,
                       shard_scores: List[np.ndarray],
                       shard_tidx: List[np.ndarray],
                       top_b: int) -> TopLists:
    """Merge per-shard top-B lists into the global per-query top-B.

    shard_scores[d]: int32 [nq, <=B] list of mesh position d (score
    descending, ties by ascending target index); shard_tidx[d] holds
    GLOBAL target indices.  Shards cover contiguous ascending target
    ranges.  Returns per query [(target, score)], like
    PrefilterResult.query_targets."""
    mesh = as_mesh(mesh)
    if axis != mesh.axis:
        raise ValueError(f"mesh has axis {mesh.axis!r}, not {axis!r}")
    if len(shard_scores) != mesh.size or len(shard_tidx) != mesh.size:
        raise ValueError(f"{len(shard_scores)} shard lists for a mesh of "
                         f"{mesh.size}")
    b_local = max(max(s.shape[1] for s in shard_scores), 1)
    return _select(*_stack(shard_scores, shard_tidx, b_local), top_b)


def merge_topk_distributed(local_scores: List[np.ndarray],
                           local_tidx: List[np.ndarray], top_b: int,
                           group=None) -> TopLists:
    """Multi-process merge: each rank passes the lists of its own mesh
    positions (mesh order), each padded to exactly [nq, top_b]; one
    ``all_gather`` over the process group (rank order = mesh order) and
    the same stable selection give every rank the identical global
    top-B.  With no process group up, the local lists are merged alone."""
    import torch.distributed as dist
    if not local_scores:
        raise ValueError("merge_topk_distributed: no local shard lists")
    for s in local_scores:
        if s.shape[1] != top_b:
            raise ValueError(f"shard lists must be padded to top_b "
                             f"({s.shape[1]} != {top_b})")
    sv, ti = _stack(local_scores, local_tidx, top_b)
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size(group)
        g_sv = [torch.empty_like(sv) for _ in range(world)]
        g_ti = [torch.empty_like(ti) for _ in range(world)]
        dist.all_gather(g_sv, sv, group=group)
        dist.all_gather(g_ti, ti, group=group)
        sv, ti = torch.cat(g_sv), torch.cat(g_ti)
    return _select(sv, ti, top_b)


def pad_topk_lists(query_targets: TopLists, nq: int, top_b: int):
    """PrefilterResult.query_targets -> padded ([nq, top_b] scores,
    [nq, top_b] global target indices), int32."""
    sv = np.full((nq, top_b), PAD_SCORE, np.int32)
    ti = np.full((nq, top_b), PAD_INDEX, np.int32)
    for qi, lst in enumerate(query_targets):
        for k, (t, s) in enumerate(lst[:top_b]):
            sv[qi, k] = s
            ti[qi, k] = t
    return sv, ti


def shard_lists(query_mu, target_mu, lo: int, parts: int, top_b: int,
                mode: Optional[str], ascii_roundtrip: bool):
    """The native prefilter over the Mu letters of targets lo, lo + 1, ...
    (global indices), cut into ``parts`` contiguous shards, each scanned
    alone: (per shard its [nq, top_b] scores, per shard its target
    indices), padded.  The scans run on the cores this process may use (a
    rank's share)."""
    b = shard_bounds(len(target_mu), parts)
    sv, ti = [], []
    for d in range(parts):
        pf = MuPrefilter(query_mu, top_b=top_b, mode=mode,
                         threads=host_cores(),
                         ascii_roundtrip=ascii_roundtrip)
        mus = [np.asarray(m, np.uint8) for m in target_mu[b[d]:b[d + 1]]]
        if mus:
            first = lo + int(b[d])
            pf.add_targets(mus, list(range(first, first + len(mus))))
        s, t = pad_topk_lists(pf.finish().query_targets, len(query_mu),
                              top_b)
        sv.append(s)
        ti.append(t)
    return sv, ti


def sharded_prefilter_search(query_mu, target_mu_list, mesh: MeshLike,
                             axis: str = "db", top_b: int = 1500,
                             mode: Optional[str] = None,
                             ascii_roundtrip: bool = True):
    """DB-sharded prefilter in one process: contiguous target shards, one
    per mesh position, each scanned with the native prefilter, then
    merged.  The selection equals the single-shard prefilter_search's."""
    mesh = as_mesh(mesh)
    return PrefilterResult(query_targets=merge_topk_sharded(
        mesh, axis, *shard_lists(query_mu, target_mu_list, 0, mesh.size,
                                 top_b, mode, ascii_roundtrip), top_b))
