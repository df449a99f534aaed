"""Port's device engine (reseek_tpu_torch/search/engine.py) against
reseek_tpu's DeviceSelfSearch on the CPU, on 16 q100.cal chains (lengths
245-509 plus 601 and 1231, so two chains route to the host MKF path)."""

import os

import numpy as np
import pytest
import torch

from reseek_tpu.align.pipeline import _path_positions
from reseek_tpu.constants import DSSParams
from reseek_tpu.io.reader import read_chains
from reseek_tpu.ops import smx_jax
from reseek_tpu.ops.substmx import build_smx
from reseek_tpu.search.driver import _encode_all
from reseek_tpu.search.engine import DeviceSelfSearch as JaxSelfSearch
from reseek_tpu.search.engine import _exact_fwd_score, _mu_matrix_padded
from reseek_tpu_torch.ops.postalign import walk_traceback_batch
from reseek_tpu_torch.ops.smx import (flat_layout, mu_table, profile_codes,
                                      profile_smx)
from reseek_tpu_torch.ops.sw_align import sw_align
from reseek_tpu_torch.search.engine import DeviceSelfSearch, aligned_coords

Q100 = os.path.join(os.path.dirname(__file__), "golden", "q100.cal")
SUBSET = [18, 21, 22, 26, 40, 46, 50, 64, 69, 72, 94, 95, 96, 97, 98, 99]
ARRAYS = ("prof", "mu", "mu_rev", "coords", "w", "offsets", "mumx")
# the test workers share the host's cores: one torch thread each keeps the
# plain versions' many small ops from contending for them
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    params = DSSParams.create("sensitive")
    chains = read_chains(Q100)
    ecs = _encode_all([chains[i] for i in SUBSET], params,
                      with_self_rev=True)
    jax_eng = JaxSelfSearch(ecs, params, with_rev_profiles=False)
    port = DeviceSelfSearch.from_arrays(
        ecs, params, "cpu", order=jax_eng.order, edges=jax_eng.edges,
        **{k: np.asarray(getattr(jax_eng, k)) for k in ARRAYS})
    return params, ecs, jax_eng, port


def test_tables_match_jax():
    p = DSSParams.create("sensitive")
    off, d, w = flat_layout(p.features, p.weights)
    joff, jd, jw = smx_jax.flat_layout(p.features, p.weights)
    assert d == jd
    assert np.array_equal(off, joff) and off.dtype == joff.dtype
    assert np.array_equal(w, jw) and w.dtype == jw.dtype
    mu = mu_table()
    assert mu.shape == (37, 37) and np.isfinite(mu).all()
    assert (mu[36] == np.float32(-9e9) / 2).all()
    assert (mu[:, 36] == np.float32(-9e9) / 2).all()
    assert np.array_equal(mu, _mu_matrix_padded())


def test_gather_sum_smx_equals_build_smx(setup):
    """The profile substitution tensor is bit-identical to build_smx on
    every real cell, and ~NEG on padding."""
    params, ecs, _, port = setup
    order = port.order
    lea = leb = 512
    ia = torch.tensor([0, 3, 7, 11])
    ib = torch.tensor([1, 3, 12, 13])
    ca = profile_codes(port.prof[ia, :, :lea], port.offsets, port.pad_code)
    cb = profile_codes(port.prof[ib, :, :leb], port.offsets, port.pad_code)
    s = profile_smx(ca, cb, port.w).numpy()
    for k in range(len(ia)):
        qa, qb = ecs[order[ia[k]]], ecs[order[ib[k]]]
        want = build_smx(params, qa.profile, qb.profile)
        la, lb = want.shape
        assert np.array_equal(s[k, :la, :lb], want)
        assert (s[k, la:, :] < -1e9).all() and (s[k, :, lb:] < -1e9).all()


def test_from_arrays_equals_own_layout(setup):
    params, ecs, jax_eng, port = setup
    own = DeviceSelfSearch(ecs, params, device="cpu")
    assert np.array_equal(own.order, port.order)
    assert own.edges == tuple(jax_eng.edges) == port.edges
    assert own.dev_end == port.dev_end == jax_eng.dev_end
    assert own.range_of == port.range_of == jax_eng.range_of
    assert own.pad_code == port.pad_code == jax_eng.pad_code
    for k in ARRAYS:
        assert torch.equal(getattr(own, k), getattr(port, k)), k
    assert own.stage1_block_plan() == jax_eng.stage1_block_plan()


def test_stage1_survivors_match(setup):
    _, _, jax_eng, port = setup
    got = port.stage1_survivors()
    want = jax_eng.stage1_survivors()
    assert got.dtype == np.int64 and got.shape[1] == 2
    assert {tuple(p) for p in got} == {tuple(p) for p in want}
    assert np.array_equal(got, want)     # same (i, j) sort order


def test_align_survivors_match(setup):
    """Same hits, paths and coordinates as the JAX engine; forward scores
    equal the exact host SW bit for bit (gather-sum smx) and the JAX
    engine's one-hot-matmul scores within its 2e-5 relative band; LDDT
    and E-values agree within the engine's bands.  The port's E-gate
    skip bounds a ``risky`` LDDT at 1, the JAX engine's at its band, so
    the port may keep more pairs: each past the gate."""
    params, ecs, jax_eng, port = setup
    surv = port.stage1_survivors()
    got = port.align_survivors(surv, evalue_gate=10.0)
    want = jax_eng.align_survivors(surv, evalue_gate=10.0)
    assert got.keys() >= want.keys() and len(want) > 20
    assert all(got[k].evalue > 10.0 for k in got.keys() - want.keys())
    for key, w in want.items():
        r = got[key]
        assert (r.query, r.target, r.path, r.lo_a, r.lo_b, r.hi_a, r.hi_b,
                r.ids, r.gaps) == (w.query, w.target, w.path, w.lo_a,
                                   w.lo_b, w.hi_a, w.hi_b, w.ids, w.gaps)
        exact = _exact_fwd_score(params, ecs[key[0]].profile,
                                 ecs[key[1]].profile)
        assert np.float32(r.fwd_score) == np.float32(exact)
        assert abs(r.fwd_score - w.fwd_score) <= 2e-5 * max(
            abs(w.fwd_score), 1.0)
        assert abs(r.lddt - w.lddt) <= 1e-6
        assert r.evalue == pytest.approx(w.evalue, rel=1e-4)


def test_aligned_coords_follow_the_path(setup):
    """The on-device coordinate gather picks the columns of the walked
    path, in forward order."""
    params, ecs, _, port = setup
    ia = torch.tensor([2, 5, 9])
    ib = torch.tensor([4, 5, 10])
    best, bi, bj, tb = sw_align(port.prof, ia, ib, port.table, 512, 512,
                                params.gap_open, params.gap_ext)
    lo_a, lo_b, plen, path_rev = walk_traceback_batch(tb, best, bi, bj, 512)
    cq, ct, valid, n_m = aligned_coords(path_rev, bi, bj, ia, ib,
                                        port.coords, 512)
    chars = np.array([0, ord("M"), ord("D"), ord("I")], np.uint8)
    for k in range(len(ia)):
        codes = path_rev[k, :plen[k]].numpy()[::-1]
        path = chars[codes].tobytes().decode()
        pq, pt = _path_positions(int(lo_a[k]), int(lo_b[k]), path)
        qa, qb = ecs[port.order[ia[k]]], ecs[port.order[ib[k]]]
        n = int(n_m[k])
        assert n == len(pq) == int(valid[k].sum())
        assert np.array_equal(cq[k, :n].numpy(), qa.chain.coords[pq])
        assert np.array_equal(ct[k, :n].numpy(), qb.chain.coords[pt])


def test_profile_codes_padding():
    prof = torch.tensor([[[0, 3, 255], [1, 255, 255]]], dtype=torch.uint8)
    codes = profile_codes(prof, torch.tensor([0, 10]), 99)
    assert codes.tolist() == [[[0, 3, 99], [11, 99, 99]]]
    w = torch.arange(100 * 100, dtype=torch.float32).reshape(100, 100)
    s = profile_smx(codes, codes, w)
    assert s[0, 0, 1].item() == w[0, 3] + w[11, 99]
