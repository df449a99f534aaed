"""The legacy square-bucket engine of reseek_tpu
(reseek_tpu/search/engine.py: DeviceDB, BatchedEngine,
batched_self_search) on the port's kernels.  No driver or command calls
it; the sorted-DB engine (engine.DeviceSelfSearch) is the search path.

Each chain pair is padded to the square of its bucket (DEFAULT_BUCKETS;
a longest chain past the last bucket gets a bucket of its length rounded
up to 256), and a bucket's pairs go in batches of CELL_BUDGET / bucket^2
pairs (at most MAX_BATCH), the last batch filled up with copies of its
last pair.  reseek_tpu's four jitted stages map onto the port's kernels:

  stage 1, Mu filter    ops/sw_sweep.mu_sw_scores (csrc/mu_wavefront.cu),
                        fwd and rev pairs in one launch, then the parasail
                        saturation and the OmegaFwd gate
  stage 2, full score   ops/sw_align.sw_score_profiles (score only, from
                        the profiles), against the reversed chains'
                        profiles for the self-reversal scores
  stage 3, alignment    ops/sw_align.sw_align, then
                        ops/postalign.walk_traceback_batch
  stage 4, LDDT         engine.aligned_coords (the aligned columns'
                        coordinates gathered on the device), then
                        ops/postalign.lddt_batch

Every stage launches all its batches before it fetches any result
(stages 1 and 2 in one transfer); TS/P/E are finished on the host
(engine._finish_from_lddt).  On ``device="cpu"``
every kernel runs its plain version.  The kernels take at most MAX_LB
(8,192) columns, so DeviceDB refuses a longer chain, where reseek_tpu's
takes any length.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from reseek_tpu_torch.align.pipeline import (MU_SAT_LIMIT, MU_SAT_REV_SCORE,
                                             MU_SAT_SCORE, AlignResult,
                                             EncodedChain)
from reseek_tpu_torch.constants import DSSParams
from reseek_tpu_torch.device import DeviceLike, host_cores, resolve
from reseek_tpu_torch.encoder.dss import encode_chain
from reseek_tpu_torch.ops.postalign import lddt_batch, walk_traceback_batch
from reseek_tpu_torch.ops.smx import PAD_BYTE, flat_layout, mu_table
from reseek_tpu_torch.ops.sw_align import (MAX_LB, FeatureTable, sw_align,
                                           sw_score_profiles)
from reseek_tpu_torch.ops.sw_sweep import MuTable, mu_sw_scores
from reseek_tpu_torch.search.engine import (_PATH_CHARS, _f32,
                                            _finish_from_lddt, aligned_coords)

DEFAULT_BUCKETS = (96, 192, 384, 768, 1536, 3072)
CELL_BUDGET = 1 << 26  # B * L * L cells per device batch
MAX_BATCH = 2048       # reseek_tpu's cap (its compiles grew with the batch)


def bucket_for(length: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


def batch_size_for(bucket: int) -> int:
    return max(1, min(MAX_BATCH, CELL_BUDGET // (bucket * bucket)))


class DeviceDB:
    """Encoded chains resident on ``device``.

    The host keeps the EncodedChain list (coords, labels, profiles); the
    device holds the uint8 profiles (PAD_BYTE past a chain's end), the Mu
    letters and the reversed Mu letters (letter 36 past the end, the
    reversed ones left-aligned), the coordinates, all padded to one Lmax
    and gathered and sliced per batch on the device; with
    with_rev_profiles also the reversed chains' profiles.  Raises
    ValueError when the longest chain needs a bucket above MAX_LB."""

    def __init__(self, ecs: List[EncodedChain], params: DSSParams,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 with_rev_profiles: bool = True,
                 device: DeviceLike = "cuda"):
        self.ecs = ecs
        self.params = params
        lens = np.array([len(ec) for ec in ecs])
        lmax = int(lens.max()) if len(lens) else 1
        if lmax > buckets[-1]:
            # chains longer than the largest preset bucket (possible in
            # verysensitive mode, where MKF routing is off) get a final
            # bucket rounded up to 256 — never silently truncated
            self.lmax = -(-lmax // 256) * 256
        else:
            self.lmax = bucket_for(lmax, buckets)
        if self.lmax > MAX_LB:
            raise ValueError(
                f"DeviceDB: a chain of {lmax} residues needs a "
                f"{self.lmax}-column bucket; the port's kernels take at most "
                f"{MAX_LB} columns")
        self.buckets = tuple(b for b in buckets if b <= self.lmax)
        if not self.buckets or self.buckets[-1] < self.lmax:
            self.buckets = tuple(self.buckets) + (self.lmax,)
        self.device = dev = resolve(device)

        offsets, d, w = flat_layout(params.features, params.weights)
        self.offsets = torch.tensor(offsets, dtype=torch.int64, device=dev)
        self.pad_code = int(d)
        self.w = torch.tensor(w, device=dev)
        self.table = FeatureTable.build(self.w, self.offsets)
        self.mu_table = MuTable.build(torch.tensor(mu_table(), device=dev))

        n, nf = len(ecs), len(params.features)
        prof = np.full((n, nf, self.lmax), PAD_BYTE, np.uint8)
        mu = np.full((n, self.lmax), 36, np.uint8)
        mu_rev = np.full((n, self.lmax), 36, np.uint8)
        coords = np.zeros((n, self.lmax, 3), np.float32)
        for i, ec in enumerate(ecs):
            L = len(ec)
            prof[i, :, :L] = ec.profile
            mu[i, :L] = ec.mu_letters
            mu_rev[i, :L] = ec.mu_letters[::-1]
            coords[i, :L] = ec.chain.coords
        self.prof = torch.tensor(prof, device=dev)
        self.mu = torch.tensor(mu, device=dev)
        self.mu_rev = torch.tensor(mu_rev, device=dev)
        self.coords = torch.tensor(coords, device=dev)

        self.stats: Dict[str, float] = {}
        self.prof_rev: Optional[torch.Tensor] = None
        if with_rev_profiles:
            prof_rev = np.full((n, nf, self.lmax), PAD_BYTE, np.uint8)

            def rev_one(i):
                ec = ecs[i]
                prof_rev[i, :, :len(ec)] = encode_chain(
                    ec.chain.reversed()).profile(params)

            # the native encoder releases the GIL
            with ThreadPoolExecutor(max_workers=host_cores()) as tp:
                list(tp.map(rev_one, range(n)))
            self.prof_rev = torch.tensor(prof_rev, device=dev)


class BatchedEngine:
    """The four stages over explicit (i, j) pairs of ``db``'s chains.
    ``stats`` (the DB's, shared by its engines) holds, for the last call
    of each stage, its pairs (``stage1_pairs`` .. ``stage3_pairs``; stage
    4 takes stage 3's) and its host-clock wall read after the device has
    finished (``stage1_s`` .. ``stage4_s``, and ``finish_s``,
    full_alignments' host finish)."""

    def __init__(self, db: DeviceDB):
        self.db = db
        self.params = db.params
        self.stats = db.stats

    # -- batching ------------------------------------------------------
    def _bucketed(self, pairs: np.ndarray
                  ) -> Iterator[Tuple[int, np.ndarray, int, np.ndarray]]:
        if len(pairs) == 0:
            return
        lens = np.array([len(ec) for ec in self.db.ecs])
        maxlen = np.minimum(np.maximum(lens[pairs[:, 0]], lens[pairs[:, 1]]),
                            self.db.lmax)
        edges = np.asarray(self.db.buckets)
        pb = edges[np.minimum(np.searchsorted(edges, maxlen),
                              len(edges) - 1)]
        for b in sorted(set(pb.tolist())):
            rows_all = np.flatnonzero(pb == b)
            bs = batch_size_for(b)
            for kk in range(0, len(rows_all), bs):
                rows = rows_all[kk: kk + bs]
                chunk = pairs[rows]
                n = len(chunk)
                if n < bs:
                    chunk = np.concatenate(
                        [chunk, np.repeat(chunk[-1:], bs - n, axis=0)])
                yield b, chunk, n, rows

    def _sides(self, chunk: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """The chunk's A and B chain indices as int64 tensors."""
        dev = self.db.device
        return (torch.tensor(chunk[:, 0], dtype=torch.int64, device=dev),
                torch.tensor(chunk[:, 1], dtype=torch.int64, device=dev))

    def _clock(self) -> float:
        if self.db.device.type == "cuda":
            torch.cuda.synchronize(self.db.device)
        return time.perf_counter()

    @staticmethod
    def _scatter(n_pairs: int, jobs) -> np.ndarray:
        """[n_pairs] float32 from the batches' (rows, values [n]), in one
        fetch after the last launch."""
        out = np.zeros(n_pairs, np.float32)
        if jobs:
            out[np.concatenate([r for r, _ in jobs])] = torch.cat(
                [v for _, v in jobs]).cpu().numpy()
        return out

    # -- stages --------------------------------------------------------
    def mu_filter_scores(self, pairs: np.ndarray) -> np.ndarray:
        """Filter value per pair: 0 if fwd < OmegaFwd else fwd - rev
        (src/parasail_mu.cpp:120-161), with parasail's 8-bit saturation
        (align/pipeline.py MU_SAT_* notes)."""
        t0 = self._clock()
        p, db = self.params, self.db
        o, e = -float(p.para_mu_gap_open), -float(p.para_mu_gap_ext)
        jobs = []
        for bucket, chunk, n, rows in self._bucketed(pairs):
            ia, ib = self._sides(chunk)
            b = db.mu[ib, :bucket]
            # fwd and rev in one kernel launch ([2B] batch)
            both = mu_sw_scores(
                torch.cat([db.mu[ia, :bucket], db.mu_rev[ia, :bucket]]),
                torch.cat([b, b]), db.mu_table, o, e)
            fwd, rev = both[:len(chunk)], both[len(chunk):]
            fwd = torch.where(fwd > MU_SAT_LIMIT, MU_SAT_SCORE, fwd)
            rev = torch.where(rev > MU_SAT_LIMIT, MU_SAT_REV_SCORE, rev)
            val = torch.where(fwd < _f32(p.omega_fwd), 0.0, fwd - rev)
            jobs.append((rows, val[:n]))
        out = self._scatter(len(pairs), jobs)
        self.stats.update(stage1_pairs=len(pairs),
                          stage1_s=self._clock() - t0)
        return out

    def full_scores(self, pairs: np.ndarray,
                    b_side_rev: bool = False) -> np.ndarray:
        """Stage-2 SW scores; with b_side_rev the target profile array is
        the reversed-chain encodes (used for self-reversal scores)."""
        t0 = self._clock()
        p, db = self.params, self.db
        prof_b = db.prof_rev if b_side_rev else db.prof
        if prof_b is None:
            raise ValueError("full_scores: b_side_rev needs a DeviceDB "
                             "built with_rev_profiles")
        jobs = []
        for bucket, chunk, n, rows in self._bucketed(pairs):
            ia, ib = self._sides(chunk)
            sc = sw_score_profiles(db.prof, prof_b, ia, ib, db.table, bucket,
                                   bucket, float(p.gap_open),
                                   float(p.gap_ext))
            jobs.append((rows, sc[:n]))
        out = self._scatter(len(pairs), jobs)
        self.stats.update(stage2_pairs=len(pairs),
                          stage2_s=self._clock() - t0)
        return out

    def self_rev_scores(self) -> np.ndarray:
        """GetSelfRevScore per chain (src/alignpair.cpp:7-25), batched."""
        n = len(self.db.ecs)
        pairs = np.stack([np.arange(n), np.arange(n)], axis=1)
        return self.full_scores(pairs, b_side_rev=True)

    def full_alignments(self, pairs: np.ndarray) -> List[AlignResult]:
        """Stage 3+4: paths on the device, LDDT on the device, TS/P/E on
        the host; a result per pair, in pair order."""
        t0 = self._clock()
        p, db = self.params, self.db
        lens = np.array([len(ec) for ec in db.ecs])
        batches = []
        for bucket, chunk, n, rows in self._bucketed(pairs):
            ia, ib = self._sides(chunk)
            best, bi, bj, tb = sw_align(db.prof, ia, ib, db.table, bucket,
                                        bucket, float(p.gap_open),
                                        float(p.gap_ext))
            lo_a, lo_b, plen, path_rev = walk_traceback_batch(tb, best, bi,
                                                              bj, bucket)
            del tb
            batches.append((chunk, n, rows, ia, ib, bi, bj, path_rev,
                            (best, lo_a, lo_b, plen)))
        fetched = [(tuple(x[:n].cpu().numpy() for x in outs),
                    path_rev[:n].cpu().numpy())
                   for _c, n, _r, _a, _b, _i, _j, path_rev, outs in batches]
        t1 = self._clock()
        # stage 4: LDDT over the aligned columns, at most min(LA, LB) of
        # them (padding columns past the valid ones add exact zeros)
        lddts = []
        for chunk, n, _rows, ia, ib, bi, bj, path_rev, _ in batches:
            m_cap = int(np.minimum(lens[chunk[:, 0]], lens[chunk[:, 1]]).max())
            cq, ct, valid, n_m = aligned_coords(path_rev, bi, bj, ia, ib,
                                                db.coords, m_cap)
            lddts.append(lddt_batch(cq, ct, valid, n_m,
                                    with_risky=False)[:n])
        lddts = [x.cpu().numpy() for x in lddts]
        t2 = self._clock()

        results: List[Optional[AlignResult]] = [None] * len(pairs)
        for (chunk, n, rows, *_), ((best, lo_a, lo_b, plen), path_rev), \
                lddt in zip(batches, fetched, lddts):
            for kk in range(n):
                q, t = db.ecs[int(chunk[kk, 0])], db.ecs[int(chunk[kk, 1])]
                res = AlignResult(query=q.label, target=t.label,
                                  fwd_score=float(best[kk]))
                if best[kk] > 0:
                    codes = path_rev[kk, :plen[kk]][::-1]
                    res.path = _PATH_CHARS[codes].tobytes().decode()
                    res.lo_a = int(lo_a[kk])
                    res.lo_b = int(lo_b[kk])
                    if res.fwd_score >= p.min_fwd_score:
                        _finish_from_lddt(res, q, t, p, float(lddt[kk]))
                results[rows[kk]] = res
        self.stats.update(stage3_pairs=len(pairs), stage3_s=t1 - t0,
                          stage4_s=t2 - t1,
                          finish_s=time.perf_counter() - t2)
        return results


def batched_self_search(ecs: List[EncodedChain], params: DSSParams,
                        max_evalue: float = 10.0,
                        db: Optional[DeviceDB] = None,
                        skip_pair=None,
                        skipped: Optional[list] = None,
                        kept_pairs: Optional[list] = None,
                        device: DeviceLike = "cuda"
                        ) -> List[AlignResult]:
    """All-vs-all via the staged device pipeline (pair emitted once).

    skip_pair(i, j) -> True routes a pair away from the device engine
    (collected into `skipped`, e.g. for the host MKF long-chain path).
    When kept_pairs is given it receives the (i, j) tuple of each
    returned result, in result order.  ``device`` places the DeviceDB
    built when ``db`` is None."""
    if db is None:
        db = DeviceDB(ecs, params, with_rev_profiles=False, device=device)
    eng = BatchedEngine(db)
    n = len(ecs)
    iu = np.triu_indices(n)
    pairs = np.stack(iu, axis=1).astype(np.int64)
    if skip_pair is not None:
        mask = np.array([skip_pair(int(i), int(j)) for i, j in pairs])
        if skipped is not None:
            skipped.extend((int(i), int(j)) for i, j in pairs[mask])
        pairs = pairs[~mask]
    if params.omega > 0:
        mu = eng.mu_filter_scores(pairs)
        pairs = pairs[mu >= params.omega]
    if len(pairs) == 0:
        return []
    fwd = eng.full_scores(pairs)
    pairs = pairs[fwd >= params.min_fwd_score]
    if len(pairs) == 0:
        return []
    results = eng.full_alignments(pairs)
    out = []
    for pr, r in zip(pairs, results):
        if r is not None and r.path and r.evalue <= max_evalue:
            out.append(r)
            if kept_pairs is not None:
                kept_pairs.append((int(pr[0]), int(pr[1])))
    return out
