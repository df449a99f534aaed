"""The port's top-B merge (reseek_tpu_torch/parallel/topk.py) against
reseek_tpu's collective merge on the 8-virtual-device CPU mesh, on seeded
tie-heavy lists, and its sharded prefilter against the single-shard
prefilter on the q100 Mu letters."""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh

from reseek_tpu.encoder.dss import encode_chain
from reseek_tpu.io.reader import read_chains
from reseek_tpu.parallel import topk as jax_topk
from reseek_tpu.search.prefilter import prefilter_search
from reseek_tpu_torch.parallel import topk

from test_torch_search import Q100


def _jax_mesh(n):
    return JaxMesh(np.array(jax.devices()[:n]), ("db",))


def _shard_lists(scores, n_dev, top_b):
    """Each contiguous shard's top-B of scores [nq, nt] (score descending,
    ties by ascending target), padded to [nq, top_b]."""
    nq, nt = scores.shape
    bounds = np.linspace(0, nt, n_dev + 1).astype(int)
    sv, ti = [], []
    for d in range(n_dev):
        lo, hi = bounds[d], bounds[d + 1]
        lists = []
        for qi in range(nq):
            order = np.lexsort((np.arange(lo, hi), -scores[qi, lo:hi]))
            lists.append([(int(lo + t), int(scores[qi, lo + t]))
                          for t in order[:top_b]])
        s, t = topk.pad_topk_lists(lists, nq, top_b)
        js, jt = jax_topk.pad_topk_lists(lists, nq, top_b)
        assert np.array_equal(s, js) and np.array_equal(t, jt)
        sv.append(s)
        ti.append(t)
    return sv, ti


@pytest.mark.parametrize("top_b", [1, 4, 8])
@pytest.mark.parametrize("n_dev", [2, 3, 4, 8])
def test_merge_matches_jax_on_ties(n_dev, top_b):
    """Dense ties across shards (4 distinct scores over 37 targets, shards
    shorter than top_b included): the same selection as reseek_tpu's
    all-gather + top_k, which is score descending, then ascending target
    index."""
    rng = np.random.default_rng(7 + n_dev * 10 + top_b)
    nq, nt = 5, 37
    scores = rng.integers(0, 4, (nq, nt)).astype(np.int32)
    sv, ti = _shard_lists(scores, n_dev, top_b)
    got = topk.merge_topk_sharded(["cpu"] * n_dev, "db", sv, ti, top_b)
    want = jax_topk.merge_topk_sharded(_jax_mesh(n_dev), "db", sv, ti,
                                       top_b)
    assert got == want
    for qi in range(nq):
        order = np.lexsort((np.arange(nt), -scores[qi]))[:top_b]
        assert got[qi] == [(int(t), int(scores[qi, t])) for t in order]


@pytest.fixture(scope="module")
def q100_mu():
    return [encode_chain(c).mu_letters for c in read_chains(Q100)]


@pytest.mark.parametrize("top_b,n_dev", [(1500, 8), (5, 8), (5, 3)])
def test_sharded_prefilter_matches_single(q100_mu, top_b, n_dev):
    """Ten q100 queries against the 100 q100 chains: the sharded selection
    equals the one-shard prefilter_search's, untruncated (B 1500) and
    with the cut crossing shard boundaries (B 5)."""
    q_mu = q100_mu[:10]
    single = prefilter_search(q_mu, list(enumerate(q100_mu)), top_b=top_b)
    got = topk.sharded_prefilter_search(q_mu, q100_mu, ["cpu"] * n_dev,
                                        top_b=top_b)
    assert got.query_targets == single.query_targets
    assert sum(map(len, got.query_targets)) > 10


@pytest.mark.parametrize("top_b", [1500, 5])
def test_distributed_prefilter_one_process_matches_single(q100_mu, top_b):
    """With no process group, distributed_prefilter subdivides its shard
    (targets 40..99, global indices) over the mesh positions and merges
    locally: the selection of the one-shard prefilter over that shard."""
    from reseek_tpu_torch.parallel.multihost import distributed_prefilter
    q_mu = q100_mu[:10]
    single = prefilter_search(q_mu, [(40 + i, m) for i, m in
                                     enumerate(q100_mu[40:])], top_b=top_b)
    got = distributed_prefilter(q_mu, q100_mu[40:], 40, ["cpu"] * 3,
                                top_b=top_b)
    assert got.query_targets == single.query_targets
    assert min(t for lst in got.query_targets for t, _ in lst) >= 40


def test_merge_checks_its_inputs():
    sv, ti = _shard_lists(np.zeros((2, 6), np.int32), 2, 3)
    with pytest.raises(ValueError):
        topk.merge_topk_sharded(["cpu"] * 3, "db", sv, ti, 3)
    with pytest.raises(ValueError):
        topk.merge_topk_sharded(["cpu"] * 2, "x", sv, ti, 3)
