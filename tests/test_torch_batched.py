"""The port's legacy square-bucket engine (reseek_tpu_torch/search/
batched.py: DeviceDB, BatchedEngine, batched_self_search) on the CPU
(the kernels' plain versions) against reseek_tpu's legacy engine on the
CPU (its lax.scan kernels) and against the host pipeline, on 8 chains of
tests/golden/q100.cal below 96 residues (one bucket: each stage runs a
batch of 2,048 pairs, 36 of them real).

reseek_tpu's engine builds its substitution scores with one-hot matrix
products, which on the CPU sum the eight feature scores of a cell in
another order than the host's gather-sum; its full-profile scores then
differ from the host's in the last bits (up to ~1e-6 relative).  The
port's kernels sum in the host's order.  So the integer Mu filter values,
the paths, positions and LDDT are held equal to reseek_tpu's engine, the
float scores, TS and E-values equal to the host (reseek_tpu's
self_rev_score, its exact host SW, its PairAligner), and reseek_tpu's
own stage kernels, fed the host-ordered scores, give the port's bit for
bit."""

import os

import numpy as np
import pytest
import torch

from reseek_tpu.align.pipeline import encode_for_search as tpu_encode
from reseek_tpu.align.pipeline import self_rev_score as tpu_self_rev_score
from reseek_tpu.constants import DSSParams as TpuParams
from reseek_tpu.io.reader import read_chains as tpu_read_chains
from reseek_tpu.search import engine as tpu_engine
from reseek_tpu_torch.align.pipeline import PairAligner, encode_for_search
from reseek_tpu_torch.chain import Chain
from reseek_tpu_torch.constants import DSSParams
from reseek_tpu_torch.io.reader import read_chains
from reseek_tpu_torch.ops.smx import mu_table
from reseek_tpu_torch.ops.sw_sweep import (MuTable, mu_lane_bits,
                                           mu_sw_scores)
from reseek_tpu_torch.search import batched

Q100 = os.path.join(os.path.dirname(__file__), "golden", "q100.cal")
# q100 chains of 49-94 residues: (27, 49) and (14, 91) are homologous
CHAINS = [27, 49, 14, 91, 43, 45, 76, 74]
SKIP = 4       # a chain with no homolog among them
REL = 1e-6     # one-hot-product scores against the host's gather-sum
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def run():
    """Both engines over every pair i <= j of the 8 chains: stage by stage
    and through batched_self_search."""
    tp, pp = TpuParams.create("sensitive"), DSSParams.create("sensitive")
    tq, pq = tpu_read_chains(Q100), read_chains(Q100)
    tecs = [tpu_encode(tq[i], tp, with_self_rev=False) for i in CHAINS]
    pecs = [encode_for_search(pq[i], pp, with_self_rev=False)
            for i in CHAINS]
    tdb = tpu_engine.DeviceDB(tecs, tp, with_rev_profiles=True)
    pdb = batched.DeviceDB(pecs, pp, with_rev_profiles=True, device="cpu")
    teng, peng = tpu_engine.BatchedEngine(tdb), batched.BatchedEngine(pdb)
    n = len(CHAINS)
    pairs = np.stack(np.triu_indices(n), axis=1).astype(np.int64)
    r = {"tp": tp, "pp": pp, "tecs": tecs, "pecs": pecs, "pdb": pdb,
         "pairs": pairs, "tdb": tdb}
    for key, fn in (("mu", "mu_filter_scores"), ("full", "full_scores")):
        r[key] = getattr(teng, fn)(pairs), getattr(peng, fn)(pairs)
    r["srs"] = teng.self_rev_scores(), peng.self_rev_scores()
    for ecs, srs in zip((tecs, pecs), r["srs"]):
        for ec, s in zip(ecs, srs):
            ec.self_rev_score = float(s)
    r["aln"] = teng.full_alignments(pairs), peng.full_alignments(pairs)
    # the pairs of chain SKIP routed away, as the MKF route would be
    r["bss"] = []
    for fn, ecs, p, db in ((tpu_engine.batched_self_search, tecs, tp, tdb),
                           (batched.batched_self_search, pecs, pp, pdb)):
        skipped, kept = [], []
        res = fn(ecs, p, db=db, skip_pair=lambda i, j: SKIP in (i, j),
                 skipped=skipped, kept_pairs=kept)
        r["bss"].append((res, skipped, kept))
    return r


def _rel_close(a, b) -> bool:
    a, b = np.float32(a), np.float32(b)
    return bool(abs(a - b) <= REL * max(abs(a), abs(b), 1.0))


def test_geometry_is_reseek_tpus():
    assert batched.DEFAULT_BUCKETS == tpu_engine.DEFAULT_BUCKETS
    assert batched.CELL_BUDGET == tpu_engine.CELL_BUDGET
    for length in (1, 49, 96, 97, 700, 3072, 3073, 5000):
        for b in (batched.DEFAULT_BUCKETS, (64, 128)):
            assert batched.bucket_for(length, b) == tpu_engine.bucket_for(
                length, b)
    for b in (96, 192, 384, 768, 1536, 3072, 3328, 8192):
        assert batched.batch_size_for(b) == tpu_engine.batch_size_for(b)


def test_device_db_layout(run):
    """The DeviceDB arrays are reseek_tpu's, byte for byte."""
    tdb, pdb = run["tdb"], run["pdb"]
    assert pdb.lmax == tdb.lmax == 96 and pdb.buckets == tdb.buckets
    for name in ("prof", "mu", "mu_rev", "prof_rev"):
        assert np.array_equal(getattr(pdb, name).numpy(),
                              np.asarray(getattr(tdb, name))), name
    assert np.array_equal(pdb.mu_table.mumx.numpy(), np.asarray(tdb.mumx))
    assert np.array_equal(pdb.w.numpy(), np.asarray(tdb.w))


def test_mu_filter_scores_bit_equal(run):
    tpu, port = run["mu"]
    assert np.array_equal(tpu, port) and port.dtype == np.float32
    assert (port > 0).sum() >= len(CHAINS)


def test_full_scores_equal_the_host(run):
    from reseek_tpu.search.engine import _exact_fwd_score
    tpu, port = run["full"]
    host = np.float32([_exact_fwd_score(run["tp"], run["tecs"][i].profile,
                                        run["tecs"][j].profile)
                       for i, j in run["pairs"]])
    assert np.array_equal(port, host)
    assert all(_rel_close(a, b) for a, b in zip(tpu, port))


def test_self_rev_scores_equal_the_host(run):
    tpu, port = run["srs"]
    host = np.float32([tpu_self_rev_score(ec, run["tp"])
                       for ec in run["tecs"]])
    assert np.array_equal(port, host)
    assert all(_rel_close(a, b) for a, b in zip(tpu, port))


def test_stage_kernels_on_host_ordered_scores(run):
    """reseek_tpu's stage-2 and stage-3 kernels (sw_jax) over the
    gather-sum substitution tensor at the bucket's square, then its walk,
    give the port's scores, paths and positions."""
    import jax.numpy as jnp
    from reseek_tpu.ops.postalign_jax import walk_traceback_batch
    from reseek_tpu.ops.sw_jax import sw_score_batch, sw_traceback_batch
    from reseek_tpu_torch.ops.smx import profile_codes, profile_smx
    pdb, p, pairs = run["pdb"], run["pp"], run["pairs"]
    ia, ib = (torch.from_numpy(np.ascontiguousarray(pairs[:, k]))
              for k in (0, 1))
    s = profile_smx(profile_codes(pdb.prof[ia], pdb.offsets, pdb.pad_code),
                    profile_codes(pdb.prof[ib], pdb.offsets, pdb.pad_code),
                    pdb.w).numpy()
    go, ge = float(p.gap_open), float(p.gap_ext)
    assert np.array_equal(np.asarray(sw_score_batch(jnp.asarray(s), go, ge)),
                          run["full"][1])
    best, bi, bj, tbs = sw_traceback_batch(jnp.asarray(s), go, ge)
    lo_a, lo_b, plen, path_rev = (np.asarray(x) for x in
                                  walk_traceback_batch(tbs, best, bi, bj))
    chars = {1: "M", 2: "D", 3: "I"}
    for k, res in enumerate(run["aln"][1]):
        assert np.float32(res.fwd_score) == np.asarray(best)[k]
        path = "".join(chars[c] for c in path_rev[k, :plen[k]][::-1])
        assert (res.path or "") == path
        if res.path:
            assert (res.lo_a, res.lo_b) == (lo_a[k], lo_b[k])


def test_full_alignments(run):
    """Paths, positions and LDDT equal to reseek_tpu's engine; float
    fields equal to the host's within the one-hot products' rounding."""
    tpu, port = run["aln"]
    assert len(tpu) == len(port) == len(run["pairs"])
    n_path = 0
    for a, b in zip(tpu, port):
        for f in ("query", "target", "path", "lo_a", "lo_b", "hi_a", "hi_b",
                  "ids", "gaps"):
            assert getattr(a, f) == getattr(b, f), f
        assert np.float32(a.lddt) == np.float32(b.lddt)
        for f in ("fwd_score", "ts"):
            assert _rel_close(getattr(a, f), getattr(b, f)), f
        n_path += bool(b.path)
    assert n_path >= len(CHAINS)


def test_batched_self_search_matches_host(run):
    """tests/test_engine.py's assertion, on the port: every pair the host
    PairAligner reports within E 10 is returned with its path, positions,
    forward score, LDDT and TS, except the pairs that skip_pair routes
    away; no other pair is; the order is reseek_tpu's."""
    (tpu, _, _), (port, _, _) = run["bss"]
    pecs = run["pecs"]
    results = {(r.query, r.target): r for r in port}
    pa = PairAligner(run["pp"])
    n_checked = 0
    for i in range(len(pecs)):
        for j in range(i, len(pecs)):
            res = pa.align(pecs[i], pecs[j])
            key = (pecs[i].label, pecs[j].label)
            if (res is None or not res.path or res.evalue > 10.0
                    or SKIP in (i, j)):
                assert key not in results
                continue
            got = results[key]
            assert got.path == res.path
            assert got.lo_a == res.lo_a and got.lo_b == res.lo_b
            assert np.float32(got.fwd_score) == np.float32(res.fwd_score)
            assert np.float32(got.lddt) == np.float32(res.lddt)
            assert np.float32(got.ts) == np.float32(res.ts)
            n_checked += 1
    assert n_checked == len(port) >= len(CHAINS) + 1
    assert [(r.query, r.target) for r in tpu] == list(results)


def test_skip_pair_routing(run):
    """skip_pair sends the pairs away as reseek_tpu's does: the same
    skipped list, and kept_pairs naming each result's (i, j)."""
    (tpu, tskipped, tkept), (port, pskipped, pkept) = run["bss"]
    n = len(CHAINS)
    assert pskipped == tskipped == [(i, j) for i in range(n)
                                    for j in range(i, n) if SKIP in (i, j)]
    assert pkept == tkept
    assert [(run["pecs"][i].label, run["pecs"][j].label)
            for i, j in pkept] == [(r.query, r.target) for r in port]


def _long_chain(n: int) -> Chain:
    """A chain of n residues on a seeded random walk of 3.8 A steps."""
    rng = np.random.default_rng(5)
    step = rng.normal(size=(n, 3))
    step *= 3.8 / np.linalg.norm(step, axis=1, keepdims=True)
    return Chain(f"walk{n}", "A" * n, np.cumsum(step, axis=0))


@pytest.mark.parametrize("n", [8192, 8193])
def test_device_db_limit(n):
    """A chain past the largest preset bucket takes a bucket of its length
    rounded up to 256, on either side of the kernels' 8,192 shared-memory
    columns (past them they launch their long variants): DeviceDB has no
    length limit, as reseek_tpu's has none."""
    p = DSSParams.create("verysensitive")
    ecs = [encode_for_search(_long_chain(n), p, with_self_rev=False)]
    db = batched.DeviceDB(ecs, p, with_rev_profiles=False, device="cpu")
    want = -(-n // 256) * 256
    assert want == (8192 if n == 8192 else 8448)
    assert db.lmax == want and db.buckets[-1] == want
    assert db.prof.shape[2] == want and db.coords.shape[1] == want


def test_mu_lanes_at_the_largest_bucket():
    """The Mu filter's int16x2 lanes are exact at a 3,072 square bucket:
    mu_lane_bits picks 16 there, and the highest score a 3,072 x 3,072
    pair can reach (the best self-scoring letter throughout, 4 x 3,072 =
    12,288) comes out exactly."""
    p = DSSParams.create("sensitive")
    mt = MuTable.build(torch.from_numpy(mu_table()))
    o, e = -int(p.para_mu_gap_open), -int(p.para_mu_gap_ext)
    assert mu_lane_bits(3072, 3072, mt.smax, mt.smin, o, e) == 16
    assert mu_lane_bits(8192, 8192, mt.smax, mt.smin, o, e) == 32
    diag = np.diag(mu_table()[:36, :36])
    letter = int(np.argmax(diag))
    assert diag[letter] == mt.smax
    a = torch.full((1, 3072), letter, dtype=torch.uint8)
    got = mu_sw_scores(a, a.clone(), mt, o, e)
    assert got.tolist() == [float(mt.smax * 3072)]
