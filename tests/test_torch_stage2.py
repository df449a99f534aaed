"""The port's engine on explicit pair lists (reseek_tpu_torch/search/
engine.py: stage1_scores, stage2_scores, self_rev_scores_device and the
stage-2 prepasses of align_survivors) against the exact host kernels and
reseek_tpu's DeviceSelfSearch, on the CPU (plain versions of the kernels),
on 12 q100.cal chains (lengths 245-509 plus 601 and 1231, which route to
the host MKF path)."""

import numpy as np
import pytest
import torch

from reseek_tpu.align.pipeline import PairAligner, self_rev_score
from reseek_tpu.constants import DSSParams
from reseek_tpu.io.reader import read_chains
from reseek_tpu.search.driver import _encode_all
from reseek_tpu.search.engine import DeviceSelfSearch as JaxSelfSearch
from reseek_tpu.search.engine import STAGE2_GUARD, _exact_fwd_score
from reseek_tpu_torch.ops import sw_sweep as sweep_mod
from reseek_tpu_torch.search import engine as engine_mod
from reseek_tpu_torch.search.engine import DeviceSelfSearch
from reseek_tpu_torch.utils.spans import Spans

from test_torch_engine import Q100

plain_sweep = sweep_mod.sw_score_sweep_profiles_ref
SUBSET = [18, 21, 22, 26, 40, 46, 50, 64, 95, 96, 98, 99]
# the test workers share the host's cores: one torch thread each keeps the
# plain versions' many small ops from contending for them
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    params = DSSParams.create("sensitive")
    chains = read_chains(Q100)
    ecs = _encode_all([chains[i] for i in SUBSET], params,
                      with_self_rev=True)
    jax_eng = JaxSelfSearch(ecs, params)
    port = DeviceSelfSearch(ecs, params, device="cpu")
    short = np.array([len(ec) < params.mkfl for ec in ecs])
    dev = np.flatnonzero(short)
    pairs = np.array([(i, j) for i in dev for j in dev if i <= j])
    return params, ecs, jax_eng, port, short, pairs


def test_rev_profiles_match_jax(setup):
    """build_rev_profiles gives reseek_tpu's reversed-chain profiles, in
    the same sorted layout; without with_rev_profiles they wait for the
    first self-reversal score."""
    params, ecs, jax_eng, port, _, _ = setup
    assert np.array_equal(port.prof_rev.numpy(),
                          np.asarray(jax_eng.prof_rev))
    lazy = DeviceSelfSearch(ecs, params, device="cpu",
                            with_rev_profiles=False)
    assert lazy.prof_rev is None
    lazy.build_rev_profiles()
    assert torch.equal(lazy.prof_rev, port.prof_rev)


def test_stage2_exact_equals_host_score(setup):
    """The exact score-only stage 2 on the gather-sum substitution tensor
    is the host native SW score bit for bit."""
    params, ecs, _, port, _, pairs = setup
    got = port.stage2_scores(pairs, exact=True)
    want = np.array([_exact_fwd_score(params, ecs[i].profile,
                                      ecs[j].profile) for i, j in pairs],
                    np.float32)
    assert got.dtype == np.float32
    assert np.array_equal(got, want)


def test_stage2_exact_builds_no_substitution_tensor(setup, monkeypatch):
    """Neither stage-2 path builds a substitution tensor in the engine: the
    exact path scores the profiles (sw_score_profiles), in both
    orientations of the B side, and the default path calls the
    profile-fed float sweep (sw_score_sweep) once a chunk; the engine has
    no gather-sum of its own (stage3_smx is gone).  On the CPU the sweep
    runs its plain version and launches nothing."""
    params, ecs, _, port, short, pairs = setup
    assert not hasattr(DeviceSelfSearch, "stage3_smx")
    assert not hasattr(engine_mod, "profile_smx")
    calls = []

    def counting(*args):
        calls.append(args[5:7])
        return plain_sweep(*args)

    monkeypatch.setattr(sweep_mod, "sw_score_sweep_profiles_ref", counting)
    launches = sweep_mod.sw_score_sweep.launches
    got = port.stage2_scores(pairs[:10], exact=True)
    want = np.array([_exact_fwd_score(params, ecs[i].profile,
                                      ecs[j].profile) for i, j in pairs[:10]],
                    np.float32)
    assert np.array_equal(got, want)
    rev = port.self_rev_scores_device()
    host = np.array([self_rev_score(ec, params) for ec in ecs], np.float32)
    assert np.array_equal(rev[short], host[short])
    assert calls == []
    sweep = port.stage2_scores(pairs)
    chunks = port.stage2_plan(pairs)
    assert calls == [(le, le) for le, _, _, _ in chunks]
    assert sweep_mod.sw_score_sweep.launches == launches
    np.testing.assert_allclose(sweep, port.stage2_scores(pairs, exact=True),
                               rtol=0, atol=1e-3)


def test_stage2_sweep_within_guard(setup):
    """The float row sweep differs from the exact score by rounding only,
    far inside the engine's STAGE2_GUARD; and from the JAX engine's sweep
    (one-hot matmul substitution tensor, ~1e-6 relative) by as little."""
    _, _, jax_eng, port, _, pairs = setup
    exact = port.stage2_scores(pairs, exact=True)
    got = port.stage2_scores(pairs)
    assert np.abs(got - exact).max() <= 1e-3 < STAGE2_GUARD
    want = np.asarray(jax_eng.stage2_scores(pairs))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_self_rev_scores_device(setup):
    """Device self-rev equals the host self_rev_score for every chain
    below mkfl (NaN for the host-routed rest), and JAX's device self-rev
    within 1e-5 relative (its one-hot matmul substitution tensor)."""
    params, ecs, jax_eng, port, short, _ = setup
    got = port.self_rev_scores_device()
    host = np.array([self_rev_score(ec, params) for ec in ecs], np.float32)
    assert np.array_equal(got[short], host[short])
    assert np.isnan(got[~short]).all()
    want = np.asarray(jax_eng.self_rev_scores_device())
    np.testing.assert_allclose(got[short], want[short], rtol=1e-5)


def test_stage1_scores_equal_host_filter(setup):
    """The Mu filter value of explicit pairs, in both orientations: the
    host mu_filter_score and the JAX engine's stage1_scores, bit for
    bit."""
    params, ecs, jax_eng, port, _, pairs = setup
    both = np.concatenate([pairs, pairs[:, ::-1]])
    got = port.stage1_scores(both)
    aligner = PairAligner(params)
    want = np.array([aligner.mu_filter_score(ecs[i], ecs[j])
                     for i, j in both], np.float32)
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.asarray(jax_eng.stage1_scores(both)))
    assert (got >= params.omega).sum() > 10


def test_prepasses_keep_every_emitted_row(setup, monkeypatch):
    """fwd_prefilter and the E-bound prepass (RESEEK_E_PREPASS_MIN) drop
    only pairs that would emit no row; with every path needed they are
    off."""
    _, _, _, port, _, pairs = setup
    pairs = pairs[:28]     # the first chains' pairs, self pairs included
    gate = 10.0
    plain = port.align_survivors(pairs, evalue_gate=gate)
    emitted = {k for k, r in plain.items() if r.evalue <= gate}
    port.spans = Spans()     # the next call's stages alone
    pre = port.align_survivors(pairs, fwd_prefilter=True,
                               evalue_gate=gate)
    assert "stage2" in port.seconds
    port.spans = Spans()     # the next call's stages alone
    monkeypatch.setenv("RESEEK_E_PREPASS_MIN", "1")
    epre = port.align_survivors(pairs, evalue_gate=gate)
    assert "stage2" in port.seconds
    for got in (pre, epre):
        assert {k for k, r in got.items() if r.evalue <= gate} == emitted
        for k in emitted:
            assert got[k].evalue == plain[k].evalue
            assert got[k].path == plain[k].path
    allp = port.align_survivors(pairs, need_all_paths=True,
                                fwd_prefilter=True)
    assert allp.keys() == port.align_survivors(pairs).keys()
