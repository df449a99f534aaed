"""Device search engine, counterpart of
``reseek_tpu.search.engine.DeviceSelfSearch`` (the sorted-DB rectangular
pipeline), for the all-vs-all self-search and, on explicit pair lists,
query-vs-DB and the -fast pipeline's stage 2.

  - chains are sorted by length once, so each length bucket is a
    contiguous index range and stage-1 pair blocks are generated on the
    device from range scalars;
  - stage 1 (Mu filter, src/dssaligner.cpp:619-630 with the parasail
    saturation of src/parasail_mu.cpp:135-139): fwd and rev Mu SW in one
    kernel launch per block (ops/sw_sweep.py), then Omega gating; the pass
    mask comes back as bools.  ``stage1_scores`` gives the filter value of
    explicit pairs instead;
  - stage 2, score only (``stage2_scores``): the float row sweep, or the
    bit-exact score-only wavefront (``exact``, e.g. the self-reversal
    scores against reversed profiles), both on the pairs' profiles with
    the substitution scores built in the kernel; it serves the optional
    prepasses of ``align_survivors``;
  - stage 3 on the survivors: SW with traceback on the pairs' profiles,
    substitution scores built in the kernel (ops/sw_align.py), the
    backward walk, the aligned-column coordinate gather and LDDT
    (ops/postalign.py); the per-pair results and uint8 path codes come
    back;
  - TS/P/E on the host in reference float32 order from the exact forward
    scores, with the LDDT band checks that send boundary pairs to the
    exact host LDDT.

With a ``mesh`` (parallel/mesh.py) the engine keeps one replica of its
device state on each mesh device and deals every work list round-robin
over the mesh positions: stage-1 pair blocks (reseek_tpu launches one per
mesh device per launch), and the chunks of stage1_scores, stage2_scores
(so the self-reversal scores) and align_survivors.  Every chunk is
launched before any is fetched, and the host finish runs in the
single-device chunk order.  Each pair's computation is the single-device
one, so results are identical.  reseek_tpu's mesh path forces max-edge
squares to keep one compiled shape per edge; nothing is compiled here, so
the single-device plan, rectangular edges and all, is kept.

Pairs with a chain at or above the MKF length routing threshold are not
handled here; the driver aligns them on the host path and merges.  Bucket
edges are the JAX engine's 128-multiples: they change padding, never
results.
"""

from __future__ import annotations

import copy
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from reseek_tpu_torch.align.pipeline import (FLT_MAX, MU_SAT_LIMIT,
                                             MU_SAT_REV_SCORE, MU_SAT_SCORE,
                                             AlignResult, EncodedChain,
                                             _path_positions, _ts_value)
from reseek_tpu_torch.constants import SCOP40C_DBSIZE, DSSParams, StatSig
from reseek_tpu_torch.device import DeviceLike, host_cores, resolve
from reseek_tpu_torch.encoder.dss import encode_chain
from reseek_tpu_torch.ops.lddt import lddt_mu_fast
from reseek_tpu_torch.ops.postalign import (PD, PI, PM, lddt_batch,
                                            walk_traceback_batch)
from reseek_tpu_torch.ops.smx import PAD_BYTE, flat_layout, mu_table
from reseek_tpu_torch.ops.sw_align import (FeatureTable, sw_align,
                                           sw_score_profiles, tb_shape)
from reseek_tpu_torch.ops.sw_sweep import (MuTable, mu_sw_scores,
                                           sw_score_sweep, sweep_takes)
from reseek_tpu_torch.parallel.mesh import MeshLike, as_mesh
from reseek_tpu_torch.utils.spans import Spans

# Cell budgets of the per-launch device batches (DP cells per launch);
# environment-overridable to shrink peak device memory.
STAGE1_CELLS = int(os.environ.get("RESEEK_STAGE1_CELLS", str(1 << 28)))
STAGE2_CELLS = int(os.environ.get("RESEEK_STAGE2_CELLS", str(1 << 27)))
STAGE3_CELLS = int(os.environ.get("RESEEK_STAGE3_CELLS", str(1 << 26)))
# Traceback bytes of a stage-3 chunk (sw_align's 4-bit cells): at most
# this share of the memory of the smallest device the engine runs on
# (stage3_tb_bytes).  From edge 4,096 up the cell budget leaves 8 pairs a
# chunk, and a pair at edge 131,072 (a chain of 99,998 residues) holds
# 8 GiB of traceback, so on an 80 GB card this cuts such chunks down to
# one pair.
STAGE3_TB_SHARE = 5
# Stage 2 (score-only prepass) uses the row-sweep kernel, whose float
# summation order differs from the reference wavefront by at most ~1e-3
# on real profiles; the guard band keeps every pair that could exactly
# pass MinFwdScore in stage 3, where the bit-exact kernel re-gates.
STAGE2_GUARD = np.float32(0.5)
EDGE_SET = (128, 256, 512, 1024, 2048, 4096, 8192)
_PATH_CHARS = np.zeros(4, np.uint8)
_PATH_CHARS[1:4] = [ord("M"), ord("D"), ord("I")]


def _E_PREPASS_MIN() -> int:
    """Survivor count above which align_survivors runs the E-bound
    score-only prepass; 0 (the default) disables it.  Its LDDT <= 1 bound
    is loose when forward scores are high (homolog-dense sets), so it is
    opt-in (RESEEK_E_PREPASS_MIN=N) for sparse-hit workloads where most
    survivors fail the E-gate on fwd alone."""
    return int(os.environ.get("RESEEK_E_PREPASS_MIN", "0"))


def _edges_for(params: DSSParams, lmax: int) -> Tuple[int, ...]:
    """Bucket edges: EDGE_SET trimmed to lmax.  The device/host (full-SW
    vs MKF) routing boundary is not an edge: the sorted-by-length layout
    makes the device-eligible chains a contiguous prefix (clamped per
    bucket via dev_end)."""
    edges = sorted(e for e in EDGE_SET if e < lmax * 2)
    while edges and edges[-1] < lmax:
        edges.append(edges[-1] * 2)
    if not edges:
        edges = [-(-max(lmax, 8) // 128) * 128]
    out = []
    for e in edges:
        out.append(e)
        if e >= lmax:
            break
    return tuple(out)


def _batch_shape(n: int, le: int, cells: int, multiple: int = 1,
                 le_b: Optional[int] = None) -> int:
    """Per-launch batch size: the cell budget capped, but no larger than
    the next power of two >= n.  le_b gives the second edge of a
    rectangular shape (default: square)."""
    cap = max(8, cells // (le * (le_b if le_b is not None else le)))
    p = 8
    while p < n:
        p *= 2
    bs = min(cap, p)
    return -(-bs // multiple) * multiple


def stage3_tb_bytes(device: torch.device) -> int:
    """The traceback bytes a stage-3 chunk may hold on ``device``: its
    total memory (the host's physical memory for the CPU) over
    STAGE3_TB_SHARE."""
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
    else:
        total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return total // STAGE3_TB_SHARE


def _stage3_batch(n: int, lea: int, leb: int, tb_bytes: int) -> int:
    """Pairs a stage-3 chunk of shape [lea, leb]: ``_batch_shape`` under
    STAGE3_CELLS, cut to what tb_bytes of traceback hold (at least one
    pair)."""
    bs = _batch_shape(n, lea, STAGE3_CELLS, le_b=leb)
    return max(1, min(bs, tb_bytes // int(np.prod(tb_shape(1, lea, leb)))))


def _rect_edges(ea: np.ndarray, eb: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-pair DP shape: rectangular (A edge x B edge) when the sides
    differ by >= 2x, else the larger edge's square.  RESEEK_RECT=0 forces
    all-square."""
    emax = np.maximum(ea, eb)
    if os.environ.get("RESEEK_RECT", "1") == "0":
        return emax, emax
    rect = emax >= 2 * np.minimum(ea, eb)
    return (np.where(rect, ea, emax).astype(ea.dtype),
            np.where(rect, eb, emax).astype(eb.dtype))


def _exact_fwd_score(params: DSSParams, prof_a: np.ndarray,
                     prof_b: np.ndarray) -> float:
    """Bit-exact full-profile SW score on the host (native kernel,
    numpy replica fallback): the score the device SW kernels are held
    to."""
    from reseek_tpu_torch.ops.sw_native import sw_score_profile_native
    v = sw_score_profile_native(params, prof_a, prof_b)
    if v is not None:
        return v
    from reseek_tpu_torch.ops.substmx import build_smx
    from reseek_tpu_torch.ops.sw_np import sw_score as sw_score_np
    return sw_score_np(build_smx(params, prof_a, prof_b),
                       params.gap_open, params.gap_ext)


def _vector_stats(fwd: np.ndarray, lddt: np.ndarray, sa: np.ndarray,
                  sb: np.ndarray, la: np.ndarray, lb: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized TS/P/E in the reference's float32 order
    (src/dssaligner.cpp:883-902 + src/statsig.cpp:27-50)."""
    f32 = np.float32
    have = (sa != FLT_MAX) & (sb != FLT_MAX)
    rev_dp = np.where(have, (sa.astype(f32) + sb.astype(f32)) / f32(2),
                      f32(0.0)).astype(f32)
    ts = _ts_value(lddt.astype(f32), fwd.astype(f32), rev_dp, la, lb)
    tsd = ts.astype(np.float64)
    log10p = np.where(tsd < StatSig.X1, StatSig.M0 * tsd + StatSig.C0,
                      StatSig.M * tsd + StatSig.C)
    p = np.minimum(np.power(10.0, log10p), 1.0)
    return ts, p, p * SCOP40C_DBSIZE


def _finish_from_lddt(res: AlignResult, q: EncodedChain, t: EncodedChain,
                      p: DSSParams, lddt: float) -> None:
    """TS/P/E from a precomputed LDDT, float32 order of
    src/dssaligner.cpp:852-904."""
    n_m = res.path.count("M")
    n_d = res.path.count("D")
    n_i = res.path.count("I")
    res.hi_a = res.lo_a + n_m + n_d - 1
    res.hi_b = res.lo_b + n_m + n_i - 1
    res.ids = n_m
    res.gaps = n_d + n_i
    res.lddt = lddt
    sa, sb = q.self_rev_score, t.self_rev_score
    if sa != FLT_MAX and sb != FLT_MAX:
        rev_dp = np.float32(np.float32(sa) + np.float32(sb)) / np.float32(2)
    else:
        rev_dp = np.float32(0.0)
    res.ts = float(_ts_value(np.float32(res.lddt),
                             np.float32(res.fwd_score), rev_dp,
                             len(q), len(t)))
    res.pvalue = StatSig.pvalue(res.ts)
    res.evalue = StatSig.evalue(res.ts)
    res.qual = StatSig.qual(res.ts)


def finish_result(res: AlignResult, q: EncodedChain, t: EncodedChain,
                  p: DSSParams) -> None:
    """LDDT and TS/P/E of a host alignment with a path (the MKF route's
    finish)."""
    if res.fwd_score < p.min_fwd_score:
        return
    pos_q, pos_t = _path_positions(res.lo_a, res.lo_b, res.path)
    lddt = lddt_mu_fast(q.chain.coords, t.chain.coords, pos_q, pos_t)
    _finish_from_lddt(res, q, t, p, lddt)


def _f32(x: float) -> float:
    """x rounded to float32, as a Python float (compares identically
    against a float32 tensor in float32 or float64)."""
    return float(np.float32(x))


def aligned_coords(path_rev: torch.Tensor, bi: torch.Tensor,
                   bj: torch.Tensor, ia: torch.Tensor, ib: torch.Tensor,
                   coords: torch.Tensor, m_cap: int):
    """Coordinates of the aligned (M) columns in forward order.

    path_rev [B, S] uint8 codes backward from the alignment end (bi, bj);
    ia, ib [B] rows of ``coords`` [N, L, 3].  Returns (cq, ct [B, m_cap, 3],
    valid [B, m_cap] bool, n_m [B] int32)."""
    b = path_rev.shape[0]
    is_m = path_rev == PM
    adv_a = (is_m | (path_rev == PD)).long()
    adv_b = (is_m | (path_rev == PI)).long()
    pos_a = bi.long()[:, None] - (adv_a.cumsum(1) - adv_a)
    pos_b = bj.long()[:, None] - (adv_b.cumsum(1) - adv_b)
    m_cum = is_m.long().cumsum(1)
    n_m = m_cum[:, -1]
    # forward rank of each M column; other codes go to the dropped slot
    rank = torch.where(is_m, n_m[:, None] - m_cum, m_cap)
    zeros = torch.zeros((b, m_cap + 1), dtype=torch.long,
                        device=path_rev.device)
    cq_pos = zeros.scatter(1, rank, pos_a)[:, :m_cap]
    ct_pos = zeros.scatter(1, rank, pos_b)[:, :m_cap]
    cq = coords[ia[:, None], cq_pos]
    ct = coords[ib[:, None], ct_pos]
    valid = (torch.arange(m_cap, device=path_rev.device)[None, :]
             < n_m[:, None])
    return cq, ct, valid, n_m.to(torch.int32)


class DeviceSelfSearch:
    """Search of the pairs below the MKF routing threshold (src/runself.cpp
    + src/dssaligner.cpp), on ``device``: all-vs-all, or given pairs.

    with_rev_profiles: encode and upload the reversed chains' profiles
    (``build_rev_profiles``), which the self-reversal scores need.
    mesh: a one-process mesh (or a sequence of devices); the work is dealt
    over its positions, and ``device`` is its first device.
    spans: the calling driver's recorder (utils/spans.py), which the
    stages' spans and counters add into; by default one of its own."""

    def __init__(self, ecs: List[EncodedChain], params: DSSParams,
                 device: DeviceLike = "cuda",
                 with_rev_profiles: bool = True, mesh: MeshLike = None,
                 spans: Optional[Spans] = None):
        lens = np.array([len(ec) for ec in ecs], np.int64)
        order = np.argsort(lens, kind="stable")
        edges = _edges_for(params, int(lens.max()) if len(lens) else 1)
        offsets, _d, w = flat_layout(params.features, params.weights)
        n, nf, L = len(ecs), len(params.features), edges[-1]
        prof = np.full((n, nf, L), PAD_BYTE, np.uint8)
        mu = np.full((n, L), 36, np.uint8)
        mu_rev = np.full((n, L), 36, np.uint8)
        coords = np.zeros((n, L, 3), np.float32)
        for s, oi in enumerate(order):
            ec = ecs[oi]
            ln = min(len(ec), L)
            prof[s, :, :ln] = ec.profile[:, :ln]
            mu[s, :ln] = ec.mu_letters[:ln]
            mu_rev[s, :ln] = ec.mu_letters[:ln][::-1]
            coords[s, :ln] = ec.chain.coords[:ln]
        self._setup(ecs, params, device, order, edges, prof, mu, mu_rev,
                    coords, w, offsets, mu_table(), mesh, spans)
        if with_rev_profiles:
            self.build_rev_profiles()

    @classmethod
    def from_arrays(cls, ecs: List[EncodedChain], params: DSSParams,
                    device: DeviceLike = "cuda", *, order, edges, prof, mu,
                    mu_rev, coords, w, offsets, mumx,
                    mesh: MeshLike = None,
                    spans: Optional[Spans] = None) -> "DeviceSelfSearch":
        """An engine over given device state (numpy arrays, e.g. fetched
        from reseek_tpu's DeviceSelfSearch): sorted order, bucket edges,
        sorted uint8 profiles [N, F, L], Mu letters and reversed letters
        [N, L], coordinates [N, L, 3], flat table W, feature offsets and
        the padded Mu table."""
        self = cls.__new__(cls)
        self._setup(ecs, params, device, order, edges, prof, mu, mu_rev,
                    coords, w, offsets, mumx, mesh, spans)
        return self

    def _setup(self, ecs, params, device, order, edges, prof, mu, mu_rev,
               coords, w, offsets, mumx, mesh, spans) -> None:
        self.mesh = as_mesh(mesh)
        dev = (self.mesh.devices[0] if self.mesh is not None
               else resolve(device))
        self.device = dev
        self.ecs = ecs
        self.params = params
        self.lens = np.array([len(ec) for ec in ecs], np.int64)
        self.order = np.asarray(order, np.int64)
        self.sorted_lens = self.lens[self.order]
        self.edges = tuple(int(e) for e in edges)
        # bucket index per sorted position; contiguous ranges per bucket
        bucket_of = np.searchsorted(np.asarray(self.edges), self.sorted_lens)
        self.range_of = {}
        for bi in range(len(self.edges)):
            sel = np.flatnonzero(bucket_of == bi)
            if len(sel):
                self.range_of[bi] = (int(sel[0]), int(sel[-1]) + 1)
        # chains with length < mkfl take the device path: a prefix of the
        # sorted index space (longer ones route to the host MKF path)
        self.dev_end = int(np.searchsorted(self.sorted_lens, params.mkfl))
        self.sorted_of = np.empty(len(ecs), np.int64)
        self.sorted_of[self.order] = np.arange(len(ecs))

        def put(x, dtype):     # a copy: callers may pass read-only arrays
            return torch.tensor(np.asarray(x), dtype=dtype, device=dev)

        self.prof = put(prof, torch.uint8)
        self.mu = put(mu, torch.uint8)
        self.mu_rev = put(mu_rev, torch.uint8)
        self.coords = put(coords, torch.float32)
        self.w = put(w, torch.float32)
        self.offsets = put(offsets, torch.int64)
        # the padded Mu table, checked once (stage 1's kernel table)
        self.mu_table = MuTable.build(put(mumx, torch.float32))
        self.pad_code = int(self.w.shape[0]) - 1
        # W's per-feature blocks, the stage-3 kernel's tables
        self.table = FeatureTable.build(self.w, self.offsets)
        self.prof_rev: Optional[torch.Tensor] = None
        # a stage-3 chunk's traceback budget, for any device of the mesh
        self.tb_bytes = min(stage3_tb_bytes(d) for d in (
            self.mesh.devices if self.mesh is not None else (dev,)))
        self.spans = spans if spans is not None else Spans()
        # one view of the engine per mesh position; positions on one
        # device share its view, whose device state is that device's
        # replica (the first device's is this engine's own)
        views = {dev: self}
        for d in (self.mesh.devices if self.mesh is not None else ()):
            if d not in views:
                views[d] = v = copy.copy(self)
                v.device = d
                for name in ("prof", "mu", "mu_rev", "coords", "w",
                             "offsets"):
                    setattr(v, name, getattr(self, name).to(d))
                v.table = self.table.to(d)
                v.mu_table = self.mu_table.to(d)
        self._views = ([views[d] for d in self.mesh.devices]
                       if self.mesh is not None else [self])
        for v in views.values():
            v._views = self._views

    @property
    def seconds(self) -> Dict[str, float]:
        """Host-clock walls from ``spans``: ``stage1``, ``stage2`` (the
        prepasses), ``stage3`` (launch and fetch) and ``finish`` (the host
        finish), each summed over the recorder's calls of its stage (one
        call's wall where the stage ran once); the stage spans start and
        end after every device has finished."""
        return {k: self.spans.seconds[k]
                for k in ("stage1", "stage2", "stage3", "finish")
                if k in self.spans.seconds}

    @property
    def mumx(self) -> torch.Tensor:
        """The padded float32 Mu table (the plain version's)."""
        return self.mu_table.mumx

    def build_rev_profiles(self) -> None:
        """Encode the reversed chains below mkfl on a host thread pool and
        upload their profiles, in the sorted layout (for the self-reversal
        scores; longer chains take the host MKF path)."""
        if self.prof_rev is not None:
            return
        p = self.params
        n, nf, L = len(self.ecs), len(p.features), self.edges[-1]
        prof_rev = np.full((n, nf, L), PAD_BYTE, np.uint8)

        def rev_one(s_oi):
            s, oi = s_oi
            ec = self.ecs[oi]
            if len(ec) >= p.mkfl:
                return
            ln = min(len(ec), L)
            prof_rev[s, :, :ln] = encode_chain(
                ec.chain.reversed()).profile(p)[:, :ln]

        # the native encoder releases the GIL
        with ThreadPoolExecutor(max_workers=host_cores()) as tp:
            list(tp.map(rev_one, enumerate(self.order)))
        self.prof_rev = torch.tensor(prof_rev, device=self.device)
        for v in self._views:
            if v.prof_rev is None:
                v.prof_rev = self.prof_rev.to(v.device)

    def _view(self, k: int) -> "DeviceSelfSearch":
        """The view that runs chunk ``k``: mesh position k mod size."""
        return self._views[k % len(self._views)]

    def _fetch(self, outs: List[torch.Tensor]) -> List[np.ndarray]:
        """Host copies of chunk outputs, chunk k made on ``_view(k)``:
        one transfer per mesh position, chunk order kept."""
        n = len(self._views)
        got: List[np.ndarray] = [None] * len(outs)
        for v in range(min(n, len(outs))):
            part = outs[v::n]
            flat = torch.cat(part).cpu().numpy()
            ends = np.cumsum([len(x) for x in part])
            for k, x in zip(range(v, len(outs), n),
                            np.split(flat, ends[:-1])):
                got[k] = x
        return got

    def _stage(self, name: str):
        """The span of a device stage: it starts and ends after every
        device's queued work has finished."""
        return self.spans.span(name, sync={v.device for v in self._views})

    def _device_ranges(self):
        """(bucket_index, s0, s1) for each bucket's device-eligible
        (length < mkfl) sorted-index range, clamped at dev_end."""
        out = []
        for bi in range(len(self.edges)):
            if bi not in self.range_of:
                continue
            s0, s1 = self.range_of[bi]
            s1 = min(s1, self.dev_end)
            if s0 < s1:
                out.append((bi, s0, s1))
        return out

    # -- stage 1: Mu filter over all device pairs ------------------------
    def stage1_block_plan(self) -> Dict[Tuple[int, int, int, int], list]:
        """Stage-1 launch plan {(lea, leb, ca, cb): [(ba, bb, a1, b1), ...]}:
        every (ca x cb) pair block over the device-eligible bucket ranges,
        blocks wholly below the diagonal skipped.  The DP shape is
        rectangular (A edge x B edge) when the buckets differ >= 2x, else
        the larger edge's square; block dims are powers of two clamped to
        the range sizes and the STAGE1_CELLS budget."""
        groups: Dict[Tuple[int, int, int, int], list] = {}
        dev = self._device_ranges()
        for ai, a0, a1 in dev:
            for bi_, b0, b1 in dev:
                if bi_ < ai:
                    continue
                lea_a, leb_a = _rect_edges(np.array([self.edges[ai]]),
                                           np.array([self.edges[bi_]]))
                lea, leb = int(lea_a[0]), int(leb_a[0])
                budget = max(256, STAGE1_CELLS // (lea * leb))
                ca = 8
                while ca < min(64, a1 - a0, budget):
                    ca *= 2
                cb = 8
                while cb < min(512, b1 - b0, max(8, budget // ca)):
                    cb *= 2
                for ba in range(a0, a1, ca):
                    for bb in range(b0, b1, cb):
                        if bb + cb > ba:  # skip below-diagonal blocks
                            groups.setdefault((lea, leb, ca, cb), []).append(
                                (ba, bb, a1, b1))
        return groups

    def stage1_letters(self, lea: int, leb: int, ca: int, cb: int, ba: int,
                       bb: int):
        """Kernel inputs of one pair block, generated on the device: A rows
        ba..ba+ca, B rows bb..bb+cb (sorted indices, clamped).  Returns
        (a [2*ca*cb, lea], b [2*ca*cb, leb]) uint8 letters, fwd pairs then
        rev pairs, and the unclamped row indices (ia [ca], ib [cb])."""
        dev = self.device
        n = self.mu.shape[0]
        ia = ba + torch.arange(ca, device=dev)
        ib = bb + torch.arange(cb, device=dev)
        idx_a = ia.clamp(0, n - 1).repeat_interleave(cb)
        idx_b = ib.clamp(0, n - 1).repeat(ca)
        b = self.mu[idx_b, :leb]
        return (torch.cat([self.mu[idx_a, :lea], self.mu_rev[idx_a, :lea]]),
                torch.cat([b, b]), ia, ib)

    def _stage1_block(self, lea: int, leb: int, ca: int, cb: int, ba: int,
                      bb: int, a1: int, b1: int) -> torch.Tensor:
        """Pass mask [ca*cb] bool of one pair block; valid when in range
        and ia <= ib (unordered pair once)."""
        p = self.params
        a, b, ia, ib = self.stage1_letters(lea, leb, ca, cb, ba, bb)
        # fwd and rev in one kernel launch ([2B] batch)
        both = mu_sw_scores(a, b, self.mu_table, -float(p.para_mu_gap_open),
                            -float(p.para_mu_gap_ext))
        fwd, rev = both[: ca * cb], both[ca * cb:]
        # parasail 8-bit saturation (align/pipeline.py MU_SAT_* notes)
        fwd = torch.where(fwd > MU_SAT_LIMIT, MU_SAT_SCORE, fwd)
        rev = torch.where(rev > MU_SAT_LIMIT, MU_SAT_REV_SCORE, rev)
        ok = (fwd >= _f32(p.omega_fwd)) & (fwd - rev >= _f32(p.omega))
        valid = ((ia < a1).repeat_interleave(cb) & (ib < b1).repeat(ca)
                 & (ia.repeat_interleave(cb) <= ib.repeat(ca)))
        return ok & valid

    def stage1_survivors(self) -> np.ndarray:
        """(i, j) ORIGINAL-index pairs (i <= j) passing the Mu filter, for
        all pairs with both chains below mkfl.  With omega == 0 the filter
        is off and all such pairs survive (src/dssaligner.cpp:819-828)."""
        dev = self._device_ranges()
        pair_chunks = []
        with self._stage("stage1"):
            if self.params.omega <= 0:
                for ai, a0, a1 in dev:
                    for bi_, b0, b1 in dev:
                        if bi_ < ai:
                            continue
                        ia, ib = np.meshgrid(np.arange(a0, a1),
                                             np.arange(b0, b1), indexing="ij")
                        keep = ib >= ia
                        pair_chunks.append(np.stack([ia[keep], ib[keep]],
                                                    axis=1))
            else:
                # block k on mesh position k mod size; all launched, then
                # fetched
                blocks, masks = [], []
                for (lea, leb, ca, cb), starts in (
                        self.stage1_block_plan().items()):
                    for ba, bb, a1, b1 in starts:
                        masks.append(self._view(len(masks))._stage1_block(
                            lea, leb, ca, cb, ba, bb, a1, b1))
                        blocks.append((ba, bb, ca, cb))
                for (ba, bb, ca, cb), mask in zip(blocks, self._fetch(masks)):
                    ia_r, ib_r = np.nonzero(mask.reshape(ca, cb))
                    if len(ia_r):
                        pair_chunks.append(np.stack([ba + ia_r, bb + ib_r],
                                                    axis=1))
        if not pair_chunks:
            return np.zeros((0, 2), np.int64)
        sp = np.concatenate(pair_chunks)
        # sorted -> original, oriented (min, max) by ORIGINAL index (the
        # reference aligns query=i, target=j with i <= j, src/runself.cpp)
        oi = self.order[sp[:, 0]]
        oj = self.order[sp[:, 1]]
        out = np.stack([np.minimum(oi, oj), np.maximum(oi, oj)], axis=1)
        return out[np.lexsort((out[:, 1], out[:, 0]))]

    def _edge_of(self, lv: np.ndarray) -> np.ndarray:
        """Bucket edge of each length (the last edge caps it)."""
        edges = np.asarray(self.edges)
        return edges[np.minimum(np.searchsorted(edges, lv), len(edges) - 1)]

    def _sorted_idx(self, orig: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(self.sorted_of[orig], device=self.device)

    # -- stage 1 on explicit pairs: Mu filter values ---------------------
    def stage1_pair_letters(self, pairs_orig: np.ndarray):
        """Kernel inputs of stage 1 on explicit (i, j) original-index
        pairs, yielded one batch at a time: (rows of pairs_orig, the view
        that runs them, a [2n, LA], b [2n, LB] uint8 letters, fwd pairs
        then rev pairs), pairs grouped
        by their rectangular edges as in stage 3, at most STAGE1_CELLS / 2
        cells a batch, batch k on mesh position k mod size."""
        ra, rb = _rect_edges(self._edge_of(self.lens[pairs_orig[:, 0]]),
                             self._edge_of(self.lens[pairs_orig[:, 1]]))
        keys = ra.astype(np.int64) * (1 << 20) + rb
        k = 0
        for key in sorted({int(x) for x in keys}):
            lea, leb = key >> 20, key & ((1 << 20) - 1)
            rows = np.flatnonzero(keys == key)
            bs = _batch_shape(len(rows), lea, STAGE1_CELLS // 2, le_b=leb)
            for kk in range(0, len(rows), bs):
                rr = rows[kk: kk + bs]
                v = self._view(k)
                k += 1
                ia = v._sorted_idx(pairs_orig[rr, 0])
                b = v.mu[v._sorted_idx(pairs_orig[rr, 1]), :leb]
                yield (rr, v, torch.cat([v.mu[ia, :lea], v.mu_rev[ia, :lea]]),
                       torch.cat([b, b]))

    def stage1_scores(self, pairs_orig: np.ndarray) -> np.ndarray:
        """Mu filter value per (i, j) original-index pair: 0 if fwd <
        OmegaFwd else fwd - rev, with parasail saturation semantics
        (src/parasail_mu.cpp:120-161); rev reverses the A side.
        Integer-exact: equals the host mu_filter_score bit for bit.  For
        drivers that bring their own pair lists (query-vs-DB, the -fast
        stage 2).  Rectangular edges as in stage 3; fwd and rev pairs run
        as one [2B] kernel batch."""
        p = self.params
        out = np.zeros(len(pairs_orig), np.float32)
        if len(pairs_orig) == 0:
            return out
        o, e = -float(p.para_mu_gap_open), -float(p.para_mu_gap_ext)
        with self._stage("stage1"):
            jobs = []
            for rr, v, a, b in self.stage1_pair_letters(pairs_orig):
                jobs.append((rr, mu_sw_scores(a, b, v.mu_table, o, e)))
            for (rr, _), both in zip(jobs,
                                     self._fetch([x for _, x in jobs])):
                n = len(rr)
                fwd = both[:n].copy()
                rev = both[n:].copy()
                # parasail 8-bit saturation (align/pipeline.py MU_SAT_*
                # notes)
                fwd[fwd > MU_SAT_LIMIT] = MU_SAT_SCORE
                rev[rev > MU_SAT_LIMIT] = MU_SAT_REV_SCORE
                val = fwd - rev
                val[fwd < np.float32(p.omega_fwd)] = 0.0
                out[rr] = val
        return out

    # -- stage 2: score-only full-profile SW -----------------------------
    def _stage2_chunks(self, pairs_orig: np.ndarray):
        """[(le, rows of pairs_orig)]: pairs grouped by the square of
        their larger edge, at most STAGE2_CELLS DP cells per chunk."""
        be = self._edge_of(np.maximum(self.lens[pairs_orig[:, 0]],
                                      self.lens[pairs_orig[:, 1]]))
        plan = []
        for le in sorted({int(x) for x in be}):
            rows = np.flatnonzero(be == le)
            bs = _batch_shape(len(rows), le, STAGE2_CELLS)
            plan.extend((le, rows[kk: kk + bs])
                        for kk in range(0, len(rows), bs))
        return plan

    def stage2_plan(self, pairs_orig: np.ndarray):
        """Stage-2 chunks of (i, j) original-index pairs: [(le, rows of
        pairs_orig [n], ia [n], ib [n] sorted-index tensors)]
        (``_stage2_chunks``, indices on the first device)."""
        return [(le, rr, self._sorted_idx(pairs_orig[rr, 0]),
                 self._sorted_idx(pairs_orig[rr, 1]))
                for le, rr in self._stage2_chunks(pairs_orig)]

    def stage2_scores(self, pairs_orig: np.ndarray, b_side_rev: bool = False,
                      exact: bool = False) -> np.ndarray:
        """Full-profile SW scores of (i, j) original-index pairs.

        By default the float row sweep (ops/sw_sweep.sw_score_sweep),
        whose rounding differs from the reference by up to ~1e-3: gate
        with STAGE2_GUARD.  exact=True runs the bit-exact score-only
        kernel (ops/sw_align.sw_score_profiles), for scores that are
        reported, such as the self-reversal scores.  Both read the pairs'
        profiles: no substitution tensor is built.  b_side_rev scores
        against the reversed chains' profiles.  The float sweep takes at
        most SWEEP_MAX_LB columns (ops/sw_sweep.sweep_takes): a longer
        chunk gets the exact score, the value STAGE2_GUARD's band holds
        the sweep's to."""
        p = self.params
        out = np.zeros(len(pairs_orig), np.float32)
        if len(pairs_orig) == 0:
            return out
        with self._stage("stage2"):
            if b_side_rev:
                self.build_rev_profiles()
            go, ge = float(p.gap_open), float(p.gap_ext)
            jobs = []
            for le, rr in self._stage2_chunks(pairs_orig):
                v = self._view(len(jobs))
                ia = v._sorted_idx(pairs_orig[rr, 0])
                ib = v._sorted_idx(pairs_orig[rr, 1])
                prof_b = v.prof_rev if b_side_rev else v.prof
                score = (sw_score_sweep if not exact and sweep_takes(le)
                         else sw_score_profiles)
                jobs.append((rr, score(v.prof, prof_b, ia, ib, v.table, le,
                                       le, go, ge)))
            for (rr, _), sc in zip(jobs, self._fetch([x for _, x in jobs])):
                out[rr] = sc
        return out

    # -- self-reversal scores (src/alignpair.cpp:7-25), device part ------
    def self_rev_scores_device(self) -> np.ndarray:
        """Self-reversal scores of the chains below mkfl (others take the
        host MKF quirk path), indexed by ORIGINAL chain index, NaN where
        not computed here: each chain against its reversed profile on the
        bit-exact stage-2 score."""
        out = np.full(len(self.ecs), np.nan, np.float32)
        idx = []
        for _bi, s0, s1 in self._device_ranges():
            idx.extend(self.order[s0:s1].tolist())
        if not idx:
            return out
        pairs = np.stack([np.asarray(idx)] * 2, axis=1)
        out[np.asarray(idx)] = self.stage2_scores(pairs, b_side_rev=True,
                                                  exact=True)
        return out

    # -- stage 3: align + LDDT on survivors ------------------------------
    def _stage3_chunks(self, pairs_orig: np.ndarray):
        """[(lea, leb, chunk pairs [n, 2])].  The DP shape is
        rectangular (A edge x B edge) when the edges differ >= 2x, else the
        larger edge's square; chunks hold at most STAGE3_CELLS DP
        cells and ``tb_bytes`` of traceback (``_stage3_batch``)."""
        ra, rb = _rect_edges(self._edge_of(self.lens[pairs_orig[:, 0]]),
                             self._edge_of(self.lens[pairs_orig[:, 1]]))
        keys = ra.astype(np.int64) * (1 << 20) + rb
        plan = []
        for key in sorted({int(x) for x in keys}):
            lea, leb = key >> 20, key & ((1 << 20) - 1)
            rows = np.flatnonzero(keys == key)
            bs = _stage3_batch(len(rows), lea, leb, self.tb_bytes)
            plan.extend((lea, leb, pairs_orig[rows[kk: kk + bs]])
                        for kk in range(0, len(rows), bs))
        return plan

    def stage3_plan(self, pairs_orig: np.ndarray):
        """Stage-3 chunks of (i, j) original-index pairs: [(lea, leb,
        chunk pairs [n, 2], ia [n], ib [n] sorted-index tensors)]
        (``_stage3_chunks``, indices on the first device)."""
        return [(lea, leb, chunk, self._sorted_idx(chunk[:, 0]),
                 self._sorted_idx(chunk[:, 1]))
                for lea, leb, chunk in self._stage3_chunks(pairs_orig)]

    def m_cap(self, chunk: np.ndarray) -> int:
        """LDDT's columns for a chunk of (i, j) original-index pairs: its
        largest shorter-chain length, which bounds every pair's aligned
        columns (columns past a pair's own add exact zeros).  Host lengths:
        no device sync."""
        return int(np.minimum(self.lens[chunk[:, 0]],
                              self.lens[chunk[:, 1]]).max())

    def _stage3_chunk(self, lea: int, leb: int, ia: torch.Tensor,
                      ib: torch.Tensor, m_cap: int) -> Dict[str, torch.Tensor]:
        """Full-profile SW with traceback (scores built from the profiles
        in the kernel: no [n, lea, leb] tensor), backward walk,
        aligned-column coordinate gather and LDDT over m_cap columns
        (``m_cap``) for sorted-index pairs (ia, ib) with DP shape [lea,
        leb]."""
        p = self.params
        best, bi, bj, tb = sw_align(self.prof, ia, ib, self.table, lea, leb,
                                    float(p.gap_open), float(p.gap_ext))
        lo_a, lo_b, plen, path_rev = walk_traceback_batch(tb, best, bi, bj,
                                                          lea)
        del tb
        cq, ct, valid, n_m = aligned_coords(path_rev, bi, bj, ia, ib,
                                            self.coords, m_cap)
        lddt, risky = lddt_batch(cq, ct, valid, n_m, with_risky=True)
        return {"best": best, "lo_a": lo_a, "lo_b": lo_b, "hi_a": bi,
                "hi_b": bj, "plen": plen, "lddt": lddt, "n_m": n_m,
                "risky": risky, "path_rev": path_rev}

    def _prepass(self, pairs_orig: np.ndarray, need_all_paths: bool,
                 fwd_prefilter: bool,
                 evalue_gate: Optional[float]) -> np.ndarray:
        """The pairs that the score-only stage-2 prepasses keep.

        fwd_prefilter: drop pairs whose sweep score + STAGE2_GUARD cannot
        reach MinFwdScore (src/dssaligner.cpp:852-860: such pairs get no
        E-value, so the E-gate rejects their rows).  The E-bound prepass
        (on at RESEEK_E_PREPASS_MIN survivors, off by default): TS rises
        with both fwd and LDDT, so stats at (sweep score + STAGE2_GUARD,
        LDDT = 1) bound each pair's E-value from below; pairs whose bound
        exceeds the emit gate cannot emit a row.  Both are off when every
        path is needed (E-gate off)."""
        p = self.params
        if need_all_paths:
            return pairs_orig
        if fwd_prefilter and p.min_fwd_score > 0 and len(pairs_orig):
            pre = self.stage2_scores(pairs_orig)
            pairs_orig = pairs_orig[
                pre >= np.float32(p.min_fwd_score) - STAGE2_GUARD]
        epm = _E_PREPASS_MIN()
        if (evalue_gate is not None and epm > 0
                and len(pairs_orig) >= epm):
            pre = self.stage2_scores(pairs_orig)
            sa = np.array([self.ecs[i].self_rev_score
                           for i in pairs_orig[:, 0]], np.float32)
            sb = np.array([self.ecs[j].self_rev_score
                           for j in pairs_orig[:, 1]], np.float32)
            _, _, ev_min = _vector_stats(
                pre + STAGE2_GUARD, np.ones(len(pre), np.float32), sa, sb,
                self.lens[pairs_orig[:, 0]], self.lens[pairs_orig[:, 1]])
            # the relative margin covers float32 wobble in the stats
            pairs_orig = pairs_orig[
                ev_min <= np.float32(evalue_gate) * np.float32(1.0001)]
        return pairs_orig

    def align_survivors(self, pairs_orig: np.ndarray,
                        need_all_paths: bool = False,
                        fwd_prefilter: bool = False,
                        evalue_gate: Optional[float] = None
                        ) -> Dict[Tuple[int, int], AlignResult]:
        """Full alignment of (i, j) original-index pairs.  Returns
        {(i, j): AlignResult} for the alignments with a path.

        need_all_paths: the E-gate is off, so every path is needed and the
        prepasses are skipped.  fwd_prefilter: drop pairs that cannot
        reach MinFwdScore first (see ``_prepass``, which also runs the
        opt-in E-bound prepass).  evalue_gate: the caller's emit gate;
        pairs whose best-case E-value exceeds it skip the host finish.
        The SW kernels give the exact forward scores, bit-equal to the
        host SW, so the finish (``_finish``) displays and gates on them as
        they are; only pairs whose device LDDT lies near a boundary are
        recomputed on the host."""
        results: Dict[Tuple[int, int], AlignResult] = {}
        if len(pairs_orig) == 0:
            return results
        pairs_orig = self._prepass(pairs_orig, need_all_paths, fwd_prefilter,
                                   evalue_gate)
        if len(pairs_orig) == 0:
            return results
        self.spans.count("stage3_pairs", len(pairs_orig))
        with self._stage("stage3"):
            # launch every chunk (chunk k on mesh position k mod size),
            # then fetch: the devices run ahead of the host
            jobs = []
            for lea, leb, chunk in self._stage3_chunks(pairs_orig):
                v = self._view(len(jobs))
                jobs.append((chunk, v._stage3_chunk(
                    lea, leb, v._sorted_idx(chunk[:, 0]),
                    v._sorted_idx(chunk[:, 1]), self.m_cap(chunk))))
            fetched = [(chunk, {k: v.cpu().numpy() for k, v in out.items()})
                       for chunk, out in jobs]
        with self.spans.span("finish"):
            for chunk, host in fetched:
                self._finish(chunk, host, results, evalue_gate)
        return results

    def _finish(self, chunk: np.ndarray, r: Dict[str, np.ndarray],
                results: Dict[Tuple[int, int], AlignResult],
                evalue_gate: Optional[float]) -> None:
        """TS/P/E of one chunk in reference float32 order.

        The forward score ``best`` is the exact one: every SW kernel adds
        the feature tables in ``profile_smx``'s order, bit for bit
        (csrc/sw_align.cu), which chip_smoke.py holds on the card and
        tests/test_torch_finish.py against the host SW on every stage-3
        pair.  So it is displayed and gated on as it is, with no band.
        The device LDDT carries tiny non-boundary rounding (d^2 without
        the reference's FMAs): a pair the kernel flags ``risky``, or whose
        displayed or gated value could change within the LDDT band, is
        recomputed with the exact host LDDT."""
        p = self.params
        best, lddt = r["best"], r["lddt"]
        lo_a, lo_b = r["lo_a"], r["lo_b"]
        hi_a, hi_b = r["hi_a"], r["hi_b"]
        plen, n_m, path_rev = r["plen"], r["n_m"], r["path_rev"]
        n = len(chunk)
        sa = np.array([self.ecs[i].self_rev_score for i in chunk[:, 0]],
                      np.float32)
        sb = np.array([self.ecs[j].self_rev_score for j in chunk[:, 1]],
                      np.float32)
        la_v = self.lens[chunk[:, 0]]
        lb_v = self.lens[chunk[:, 1]]
        # lddt_rec: device LDDT near a threshold/display boundary -> exact
        # native LDDT
        lddt_rec = r["risky"].astype(bool).copy()
        band = np.float32(1e-6)
        tsl_lo, pvl_lo, evl_lo = _vector_stats(
            best, np.maximum(lddt - band, 0), sa, sb, la_v, lb_v)
        # a risky LDDT may be off by a flipped comparison, far past the
        # band: its upper bound is LDDT 1 (the band checks below pass over
        # risky pairs, so only the E-gate reads these)
        tsl_hi, pvl_hi, evl_hi = _vector_stats(
            best, np.where(lddt_rec, np.float32(1), lddt + band), sa, sb,
            la_v, lb_v)
        # E-gate fast reject: ts increases with lddt, so the stats at the
        # upper bound give the smallest E-value the exact LDDT could give;
        # such pairs can never produce a row.  A pair whose E-value could
        # cross the gate within the band is recomputed.
        skip = np.zeros(n, bool)
        if evalue_gate is not None:
            skip = evl_hi > evalue_gate
            lddt_rec |= evl_lo > evalue_gate
        with self.spans.span("finish.bands"):
            for kk in range(n):
                if skip[kk] or lddt_rec[kk]:
                    continue
                if ("%.3g" % pvl_lo[kk] != "%.3g" % pvl_hi[kk]
                        or "%.3g" % evl_lo[kk] != "%.3g" % evl_hi[kk]
                        or "%.3g" % tsl_lo[kk] != "%.3g" % tsl_hi[kk]
                        or "%.4g" % np.float32(lddt[kk] - band)
                        != "%.4g" % np.float32(lddt[kk] + band)):
                    lddt_rec[kk] = True
        ts, pv, ev = _vector_stats(best, lddt, sa, sb, la_v, lb_v)
        # the pairs that get a result; the exact host recomputes among them
        # are timed one by one (a minority of pairs)
        self.spans.count("finish_pairs", int(((best > 0) & ~skip).sum()))
        rec_n, rec_s = 0, 0.0
        for kk in range(n):
            if best[kk] <= 0 or skip[kk]:
                # no alignment, or best-case E above the emit gate
                continue
            i, j = int(chunk[kk, 0]), int(chunk[kk, 1])
            codes = path_rev[kk, :plen[kk]][::-1]
            path = _PATH_CHARS[codes].tobytes().decode()
            res = AlignResult(
                query=self.ecs[i].label, target=self.ecs[j].label,
                fwd_score=float(best[kk]), lo_a=int(lo_a[kk]),
                lo_b=int(lo_b[kk]), path=path)
            # MinFwdScore gate (src/dssaligner.cpp:852-860)
            if best[kk] >= p.min_fwd_score:
                res.hi_a = int(hi_a[kk])
                res.hi_b = int(hi_b[kk])
                res.ids = int(n_m[kk])
                res.gaps = int(plen[kk]) - int(n_m[kk])
                if lddt_rec[kk]:
                    t0 = time.perf_counter()
                    pos_q, pos_t = _path_positions(res.lo_a, res.lo_b, path)
                    lddt_val = np.float32(lddt_mu_fast(
                        self.ecs[i].chain.coords, self.ecs[j].chain.coords,
                        pos_q, pos_t))
                    rec_n += 1
                    rec_s += time.perf_counter() - t0
                    tse, pve, eve = _vector_stats(
                        best[kk:kk + 1], np.float32([lddt_val]),
                        sa[kk:kk + 1], sb[kk:kk + 1],
                        la_v[kk:kk + 1], lb_v[kk:kk + 1])
                    res.lddt = float(lddt_val)
                    res.ts = float(tse[0])
                    res.pvalue = float(pve[0])
                    res.evalue = float(eve[0])
                else:
                    res.lddt = float(lddt[kk])
                    res.ts = float(ts[kk])
                    res.pvalue = float(pv[kk])
                    res.evalue = float(ev[kk])
                res.qual = StatSig.qual(res.ts)
            results[(i, j)] = res
        self.spans.count("recomputed_pairs", rec_n)
        self.spans.add("finish.recompute", rec_s)
