"""The host finish of the port's engine (reseek_tpu_torch/search/engine.py
``DeviceSelfSearch._finish``) on the CPU (plain versions of the kernels),
on an all-vs-all of 40 sepq_set.cal chains below 500 residues, in fast and
sensitive mode.

Stage 3's forward score is the exact host SW score on every pair, so the
finish takes it as it is: its results equal, field for field, those of a
finish that recomputes both the forward score and LDDT exactly on every
pair (reseek_tpu's host kernels); every pair whose device LDDT would show
or gate otherwise than the exact one, and every pair the kernel flags
``risky``, goes to the host recompute, and no pair without an LDDT flag;
and a ``risky`` pair whose exact E-value lies just inside the E-gate is
not dropped."""

import os

import numpy as np
import pytest
import torch

from reseek_tpu.align.pipeline import AlignResult, _path_positions
from reseek_tpu.constants import DSSParams, StatSig
from reseek_tpu.io.reader import read_chains
from reseek_tpu.ops.lddt import lddt_mu_fast
from reseek_tpu.search.driver import _encode_all
from reseek_tpu.search.engine import _exact_fwd_score, _vector_stats
from reseek_tpu_torch.search import engine as engine_mod
from reseek_tpu_torch.search.engine import DeviceSelfSearch
from reseek_tpu_torch.utils.spans import Spans

SEPQ = os.path.join(os.path.dirname(__file__), "golden", "sepq_set.cal")
N_CHAINS = 40
GATE = 10.0
BAND = np.float32(1e-6)
FIELDS = ("query", "target", "fwd_score", "lo_a", "lo_b", "hi_a", "hi_b",
          "path", "ids", "gaps", "lddt", "ts", "pvalue", "evalue", "qual")
PATH_CHARS = np.frombuffer(b"\0MDI", np.uint8)
# the test workers share the host's cores: one torch thread each keeps the
# plain versions' many small ops from contending for them
torch.set_num_threads(1)


def _chains():
    return [c for c in read_chains(SEPQ) if len(c) < 500][:N_CHAINS]


@pytest.fixture(scope="module", params=["fast", "sensitive"])
def run(request):
    """The engine's stage 3 and finish on every stage-1 survivor, with the
    device outputs of each finished chunk and the pairs whose LDDT went to
    the host recompute recorded; the exact host SW may not be called."""
    params = DSSParams.create(request.param)
    ecs = _encode_all(_chains(), params, with_self_rev=True)
    spans = Spans()
    port = DeviceSelfSearch(ecs, params, device="cpu", spans=spans)
    chunks, recomputed = [], []
    of_coords = {id(ec.chain.coords): k for k, ec in enumerate(ecs)}
    finish, host_lddt = DeviceSelfSearch._finish, engine_mod.lddt_mu_fast

    def record_chunk(self, chunk, r, *args):
        chunks.append((chunk.copy(), {k: v.copy() for k, v in r.items()}))
        return finish(self, chunk, r, *args)

    def record_lddt(cq, ct, pos_q, pos_t):
        recomputed.append((of_coords[id(cq)], of_coords[id(ct)]))
        return host_lddt(cq, ct, pos_q, pos_t)

    def no_exact_fwd(*args):
        raise AssertionError("the finish recomputed a forward score")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DeviceSelfSearch, "_finish", record_chunk)
        mp.setattr(engine_mod, "lddt_mu_fast", record_lddt)
        mp.setattr(engine_mod, "_exact_fwd_score", no_exact_fwd)
        got = port.align_survivors(port.stage1_survivors(),
                                   evalue_gate=GATE)
    return params, ecs, port, chunks, got, recomputed, spans.stats()


@pytest.fixture(scope="module")
def want(run):
    """The all-exact finish's results (``_exact_results``)."""
    params, ecs, _, chunks, _, _, _ = run
    return _exact_results(params, ecs, chunks)


def _pairs(chunks):
    for chunk, r in chunks:
        for kk, (i, j) in enumerate(chunk):
            yield int(i), int(j), kk, r


def _stats(ecs, i, j, fwd, lddt):
    f32 = np.float32
    return _vector_stats(f32([fwd]), f32([lddt]),
                         f32([ecs[i].self_rev_score]),
                         f32([ecs[j].self_rev_score]),
                         np.array([len(ecs[i])]), np.array([len(ecs[j])]))


def _exact_results(params, ecs, chunks):
    """Every stage-3 pair's result as a finish that recomputes both the
    forward score (host SW) and LDDT (host LDDT on the device path) on
    every pair would build it."""
    out = {}
    for i, j, kk, r in _pairs(chunks):
        fwd = np.float32(_exact_fwd_score(params, ecs[i].profile,
                                          ecs[j].profile))
        if fwd <= 0:
            continue
        codes = r["path_rev"][kk, :r["plen"][kk]][::-1]
        res = AlignResult(query=ecs[i].label, target=ecs[j].label,
                          fwd_score=float(fwd), lo_a=int(r["lo_a"][kk]),
                          lo_b=int(r["lo_b"][kk]),
                          path=PATH_CHARS[codes].tobytes().decode())
        if fwd >= params.min_fwd_score:
            res.hi_a, res.hi_b = int(r["hi_a"][kk]), int(r["hi_b"][kk])
            res.ids = int(r["n_m"][kk])
            res.gaps = int(r["plen"][kk]) - res.ids
            pos_q, pos_t = _path_positions(res.lo_a, res.lo_b, res.path)
            lddt = np.float32(lddt_mu_fast(ecs[i].chain.coords,
                                           ecs[j].chain.coords, pos_q, pos_t))
            ts, pv, ev = _stats(ecs, i, j, fwd, lddt)
            res.lddt, res.ts = float(lddt), float(ts[0])
            res.pvalue, res.evalue = float(pv[0]), float(ev[0])
            res.qual = StatSig.qual(res.ts)
        out[(i, j)] = res
    return out


def _shown(ecs, i, j, fwd, lddt, gate=GATE):
    """What a row shows of LDDT, TS, P and E, and whether it passes the
    E-gate."""
    ts, pv, ev = _stats(ecs, i, j, fwd, lddt)
    return ("%.4g" % np.float32(lddt), "%.3g" % ts[0], "%.3g" % pv[0],
            "%.3g" % ev[0], bool(ev[0] <= gate))


def test_best_is_the_exact_forward_score(run):
    """Every stage-3 pair, those the E-gate skips included: the device
    forward score equals the host SW's bit for bit."""
    params, ecs, _, chunks, _, _, stats = run
    n = 0
    for i, j, kk, r in _pairs(chunks):
        exact = _exact_fwd_score(params, ecs[i].profile, ecs[j].profile)
        assert r["best"][kk] == np.float32(exact), (i, j)
        n += 1
    assert n == stats["stage3_pairs"] > 50


def test_results_equal_the_exact_finish(run, want):
    """Field for field, every result equals the all-exact finish's; every
    pair that finish would emit under the gate has a result."""
    _, _, _, _, got, _, _ = run
    assert got.keys() <= want.keys() and len(got) > 40
    assert {k for k, w in want.items() if w.evalue <= GATE} <= got.keys()
    for key, res in got.items():
        assert ({f: getattr(res, f) for f in FIELDS}
                == {f: getattr(want[key], f) for f in FIELDS}), key


def test_only_lddt_flags_are_recomputed(run, want):
    """Every result pair at or above MinFwdScore whose device LDDT would
    show or gate otherwise than the exact LDDT of the all-exact finish,
    and every ``risky`` one, is recomputed, each once; a recomputed pair
    is ``risky`` or has a shown value that changes within the LDDT
    band."""
    params, ecs, _, chunks, got, recomputed, stats = run
    needed, risky, flagged = set(), set(), set()
    for i, j, kk, r in _pairs(chunks):
        fwd, lddt = r["best"][kk], r["lddt"][kk]
        if (i, j) not in got or fwd < params.min_fwd_score:
            continue
        if _shown(ecs, i, j, fwd, lddt) != _shown(ecs, i, j, fwd,
                                                  want[(i, j)].lddt):
            needed.add((i, j))
        if r["risky"][kk]:
            risky.add((i, j))
        if r["risky"][kk] or (
                _shown(ecs, i, j, fwd, np.maximum(lddt - BAND, 0))
                != _shown(ecs, i, j, fwd, lddt + BAND)):
            flagged.add((i, j))
    assert len(recomputed) == len(set(recomputed)) and risky
    assert needed | risky <= set(recomputed) <= flagged
    assert stats["recomputed_pairs"] == len(recomputed)
    assert stats["recomputed_pairs"] < stats["finish_pairs"] == len(got)


def test_risky_pair_inside_the_gate_is_kept(run, want):
    """A ``risky`` pair whose device LDDT lies 1e-4 below the exact one
    (a flipped distance comparison moves it by ~3e-5) and whose exact
    E-value is the E-gate itself: the E-value at the device LDDT plus the
    band lies past the gate, yet the pair keeps its exact result."""
    params, ecs, port, chunks, _, _, _ = run
    n = 0
    for i, j, kk, r in _pairs(chunks):
        fwd = r["best"][kk]
        if fwd < params.min_fwd_score or want[(i, j)].lddt < 0.01:
            continue
        exact = np.float32(want[(i, j)].lddt)
        gate = float(_stats(ecs, i, j, fwd, exact)[2][0])
        one = {k: v[kk:kk + 1].copy() for k, v in r.items()}
        one["lddt"][0] = exact - np.float32(1e-4)
        one["risky"][0] = True
        if _stats(ecs, i, j, fwd, one["lddt"][0] + BAND)[2][0] <= gate:
            continue  # E-value at its floor, the same on both sides
        results = {}
        port._finish(np.array([[i, j]]), one, results, gate)
        assert ({f: getattr(results.get((i, j)), f, None) for f in FIELDS}
                == {f: getattr(want[(i, j)], f) for f in FIELDS}), (i, j)
        n += 1
        if n == 8:
            break
    assert n == 8
