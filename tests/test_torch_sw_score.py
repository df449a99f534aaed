"""The port's score-only kernels' plain versions against the JAX package:
``sw_score_ref`` (the exact wavefront, reseek_tpu_torch/ops/sw_wavefront.py)
against sw_jax.sw_score_batch and the Pallas sw_score_pallas (interpret
mode on the CPU), bit for bit; ``sw_score_profiles_ref`` (the exact score
of profile pairs, ops/sw_align.py: profile_smx, then sw_score_ref) against
sw_score_pallas on the S of the same profiles (reseek_tpu's build_smx), bit
for bit, and with the reversed profiles against the host self_rev_score;
``sw_score_sweep_ref`` (the float row sweep, ops/sw_sweep.py) against the
JAX sw_score_sweep on the same S within 1e-4 absolute (XLA may fuse the
sweep's adds differently from PyTorch's op-by-op rounding)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reseek_tpu.ops import sw_sweep as jsweep
from reseek_tpu.ops.sw_jax import sw_score_batch
from reseek_tpu.ops.sw_np import NEG, sw_score as np_sw_score
from reseek_tpu.ops.sw_pallas import sw_score_pallas
from reseek_tpu.align.pipeline import self_rev_score
from reseek_tpu.constants import ALPHA_SIZES, DSSParams
from reseek_tpu.encoder.dss import encode_chain
from reseek_tpu.io.reader import read_chains
from reseek_tpu.ops.substmx import build_smx
from reseek_tpu.search.driver import _encode_all
from reseek_tpu_torch.ops.smx import PAD_BYTE, flat_layout
from reseek_tpu_torch.ops.sw_align import (FeatureTable, sw_score_profiles,
                                           sw_score_profiles_ref)
from reseek_tpu_torch.ops.sw_sweep import (sw_score_sweep,
                                           sw_score_sweep_profiles_ref,
                                           sw_score_sweep_ref)
from reseek_tpu_torch.ops.sw_wavefront import sw_score_ref, sw_traceback_ref

from test_torch_engine import Q100

# the test workers share the host's cores: one torch thread each keeps the
# plain versions' many small ops from contending for them
torch.set_num_threads(1)
SWEEP_ATOL = 1e-4
PARAMS = DSSParams.create("sensitive")


def _random_batch(rng, b, la, lb, integer):
    """NEG-padded batch with ragged valid regions; float scores are
    rounded to float32 profile-like values."""
    s = np.full((b, la, lb), NEG, np.float32)
    las = rng.integers(3, la + 1, b)
    lbs = rng.integers(3, lb + 1, b)
    for k in range(b):
        if integer:
            v = rng.integers(-3, 4, (las[k], lbs[k])).astype(np.float32)
        else:
            v = rng.normal(0, 2, (las[k], lbs[k])).astype(np.float32)
        s[k, :las[k], :lbs[k]] = v
    return s, las, lbs


CASES = [(True, 33, 41, -1.5, -0.25),
         (False, 29, 37, -0.685533, -0.051881),
         (False, 48, 20, -2.0, -0.5)]


@pytest.mark.parametrize("integer,la,lb,open_,ext", CASES)
def test_score_ref_matches_jax(integer, la, lb, open_, ext):
    """sw_score_ref == lax.scan wavefront == Pallas score kernel ==
    sw_traceback_ref's best, bit for bit."""
    rng = np.random.default_rng(la * 100 + lb)
    s, _, _ = _random_batch(rng, 8, la, lb, integer)
    got = sw_score_ref(torch.from_numpy(s), open_, ext).numpy()
    assert got.dtype == np.float32 and got.shape == (8,)
    for fn in (sw_score_batch, sw_score_pallas):
        assert np.array_equal(got, np.asarray(fn(jnp.asarray(s), open_,
                                                 ext)))
    best = sw_traceback_ref(torch.from_numpy(s), open_, ext)[0].numpy()
    assert np.array_equal(got, best)


def test_score_ref_matches_exact_kernel():
    """Each pair's score equals ops/sw_np.sw_score on its unpadded
    matrix."""
    rng = np.random.default_rng(5)
    s, las, lbs = _random_batch(rng, 10, 31, 26, integer=False)
    got = sw_score_ref(torch.from_numpy(s), -0.9, -0.1).numpy()
    for k in range(len(s)):
        want = np_sw_score(s[k, :las[k], :lbs[k]], -0.9, -0.1)
        assert got[k] == np.float32(want), k


@pytest.mark.parametrize("integer,la,lb,open_,ext", CASES)
def test_sweep_ref_matches_jax(integer, la, lb, open_, ext):
    """The float row sweep against the JAX sweep on the same S; exact on
    integer scores, where every order is exact."""
    rng = np.random.default_rng(la * 7 + lb)
    s, _, _ = _random_batch(rng, 8, la, lb, integer)
    got = sw_score_sweep_ref(torch.from_numpy(s), open_, ext).numpy()
    want = np.asarray(jsweep.sw_score_sweep(jnp.asarray(s), open_, ext))
    if integer:
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=SWEEP_ATOL)
    # the sweep's closed form of F rounds differently from the
    # wavefront's cell order: the engine's STAGE2_GUARD covers ~1e-3
    exact = sw_score_ref(torch.from_numpy(s), open_, ext).numpy()
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-3)


def test_sweep_ref_matches_pallas_sweep():
    """The Pallas row sweep (interpret mode, lane-aligned LB) on the same
    S."""
    rng = np.random.default_rng(11)
    s, _, _ = _random_batch(rng, 4, 20, 128, integer=False)
    got = sw_score_sweep_ref(torch.from_numpy(s), -0.685533,
                             -0.051881).numpy()
    want = np.asarray(jsweep.sw_score_sweep_pallas(
        jnp.asarray(s), -0.685533, -0.051881))
    np.testing.assert_allclose(got, want, rtol=0, atol=SWEEP_ATOL)


def test_no_positive_cell_and_empty():
    s = torch.full((2, 5, 7), -1.0)
    assert sw_score_ref(s, -1.0, -0.5).tolist() == [0.0, 0.0]
    assert sw_score_sweep_ref(s, -1.0, -0.5).tolist() == [0.0, 0.0]
    empty = torch.zeros((0, 5, 7))
    assert sw_score_ref(empty, -1.0, -0.5).shape == (0,)
    assert sw_score_sweep_ref(empty, -1.0, -0.5).shape == (0,)


def _table() -> FeatureTable:
    off, _, w = flat_layout(PARAMS.features, PARAMS.weights)
    return FeatureTable.build(torch.from_numpy(w), torch.from_numpy(off))


def _profiles(rng, n, length, few=False):
    """[n, F, length] uint8 profiles, PAD_BYTE past each chain's random
    end (row 0 all padding), and the lengths; few: two letters a feature,
    so that scores tie everywhere."""
    sizes = [ALPHA_SIZES[f] for f in PARAMS.features]
    prof = np.full((n, len(sizes), length), PAD_BYTE, np.uint8)
    lens = np.zeros(n, np.int64)
    for k in range(1, n):
        lens[k] = rng.integers(length // 3, length + 1)
        for f, size in enumerate(sizes):
            prof[k, f, :lens[k]] = rng.integers(0, 2 if few else size,
                                                lens[k])
    return prof, lens


@pytest.mark.parametrize("la,lb,few", [(40, 40, False), (36, 60, False),
                                       (50, 24, True)])
def test_score_profiles_ref_matches_pallas(la, lb, few):
    """The exact score of profile pairs, bit for bit: the port's plain
    version against sw_score_pallas on reseek_tpu's build_smx of the same
    profiles (NEG past each chain's end), with both penalty pairs."""
    rng = np.random.default_rng(la * 31 + lb + few)
    n = 7
    prof, lens = _profiles(rng, n, max(la, lb), few)
    prof_b, lens_b = _profiles(rng, n, max(la, lb), few)
    ia = rng.integers(0, n, n)
    ib = rng.integers(1, n, n)
    ia[1] = 0                    # a pair with no positive cell
    s = np.full((n, la, lb), NEG, np.float32)
    for k in range(n):
        na, nb = min(lens[ia[k]], la), min(lens_b[ib[k]], lb)
        if na and nb:
            s[k, :na, :nb] = build_smx(PARAMS, prof[ia[k], :, :na],
                                       prof_b[ib[k], :, :nb])
    for open_, ext in ((PARAMS.gap_open, PARAMS.gap_ext), (-1.5, -0.25)):
        got = sw_score_profiles_ref(
            torch.from_numpy(prof), torch.from_numpy(prof_b),
            torch.from_numpy(ia), torch.from_numpy(ib), _table(), la, lb,
            open_, ext).numpy()
        want = np.asarray(sw_score_pallas(jnp.asarray(s), open_, ext))
        assert np.array_equal(got, want)
        assert got[1] == 0.0 and got.max() > 0


def test_score_profiles_on_reversed_profiles_is_self_rev():
    """With the reversed chains' profiles on the B side the plain version
    is the host self_rev_score of each chain, bit for bit."""
    chains = [c for c in read_chains(Q100) if 100 <= len(c) < 200][:4]
    ecs = _encode_all(chains, PARAMS, with_self_rev=False)
    le = 256
    prof = np.full((len(ecs), len(PARAMS.features), le), PAD_BYTE, np.uint8)
    prof_rev = prof.copy()
    for k, c in enumerate(chains):
        prof[k, :, :len(c)] = ecs[k].profile
        prof_rev[k, :, :len(c)] = encode_chain(c.reversed()).profile(PARAMS)
    idx = torch.arange(len(ecs))
    got = sw_score_profiles_ref(torch.from_numpy(prof),
                                torch.from_numpy(prof_rev), idx, idx,
                                _table(), le, le, PARAMS.gap_open,
                                PARAMS.gap_ext).numpy()
    want = np.float32([self_rev_score(ec, PARAMS) for ec in ecs])
    assert np.array_equal(got, want)


@pytest.mark.parametrize("wrapper,ref", [(sw_score_profiles,
                                          sw_score_profiles_ref),
                                         (sw_score_sweep,
                                          sw_score_sweep_profiles_ref)])
def test_wrapper_on_cpu_runs_plain_version(wrapper, ref):
    """A CPU tensor takes the plain version and launches no kernel."""
    rng = np.random.default_rng(4)
    prof = torch.from_numpy(_profiles(rng, 4, 20)[0])
    idx = torch.from_numpy(rng.integers(0, 4, 3))
    args = (prof, prof.flip(2).contiguous(), idx, idx.flip(0), _table(), 12,
            20)
    before = wrapper.launches
    got = wrapper(*args, -1.5, -0.25)
    assert wrapper.launches == before
    assert torch.equal(got, ref(*args, -1.5, -0.25))
