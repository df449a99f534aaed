"""The port's stage-3 entry (reseek_tpu_torch/ops/sw_align.py): its plain
version, the gather-sum profile_smx followed by sw_traceback_ref with the
traceback packed, against reseek_tpu's build_smx followed by the Pallas
sw_traceback_pallas (interpret mode on the CPU); the walk over the packed
layout against postalign_jax.walk_traceback_batch.

best, bi and bj are exact; tb is exact over every pair's cells, read back
through unpack_tb.  Past a chain's end reseek_tpu's tensor here holds NEG
and the gather-sum the pad entries' sum (~NEG); no cell of a chain
depends on those, so only the pair's own cells are compared."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reseek_tpu.constants import ALPHA_SIZES, DSSParams
from reseek_tpu.ops import postalign_jax
from reseek_tpu.ops.substmx import build_smx
from reseek_tpu.ops.sw_np import NEG
from reseek_tpu.ops.sw_pallas import sw_traceback_pallas
from reseek_tpu_torch.ops.postalign import walk_traceback_batch
from reseek_tpu_torch.ops.smx import PAD_BYTE, flat_layout
from reseek_tpu_torch.ops.sw_align import (FeatureTable, pack_tb,
                                           sw_align_ref, tb_shape, unpack_tb)
from reseek_tpu_torch.ops.sw_wavefront import diag_count

PARAMS = DSSParams.create("sensitive")
SIZES = [ALPHA_SIZES[f] for f in PARAMS.features]
# the test workers share the host's cores: one torch thread each keeps the
# plain versions' many small ops from contending for them
torch.set_num_threads(1)


def _table() -> FeatureTable:
    off, _, w = flat_layout(PARAMS.features, PARAMS.weights)
    return FeatureTable.build(torch.from_numpy(w), torch.from_numpy(off))


def _profiles(rng, n, length, few):
    """[n, F, length] uint8 profiles, PAD_BYTE past each chain's end (row
    0 all padding), and the lengths.  Each chain is the one before with a
    third of its letters redrawn, so pairs align over long paths; few: two
    letters a feature, so that scores tie everywhere."""
    prof = np.full((n, len(SIZES), length), PAD_BYTE, np.uint8)
    lens = np.zeros(n, np.int64)
    top = np.array([2 if few else size for size in SIZES])[:, None]
    letters = rng.integers(0, top, (len(SIZES), length))
    for k in range(1, n):
        redraw = rng.random(letters.shape) < 0.33
        letters = np.where(redraw, rng.integers(0, top, letters.shape),
                           letters)
        lens[k] = rng.integers(length // 3, length + 1)
        prof[k, :, :lens[k]] = letters[:, :lens[k]]
    return prof, lens


def _case(la, lb, few):
    """The port's plain outputs and reseek_tpu's Pallas outputs on one
    seeded batch, with each pair's true lengths (na, nb)."""
    rng = np.random.default_rng(la * 1000 + lb + few)
    n = 7
    prof, lens = _profiles(rng, n, max(la, lb), few)
    ia = rng.integers(1, n, n)
    ib = rng.integers(1, n, n)
    ia[1] = 0                      # a pair with no positive cell
    got = sw_align_ref(torch.from_numpy(prof), torch.from_numpy(ia),
                       torch.from_numpy(ib), _table(), la, lb,
                       PARAMS.gap_open, PARAMS.gap_ext)
    s = np.full((n, la, lb), NEG, np.float32)
    na = np.minimum(lens[ia], la)
    nb = np.minimum(lens[ib], lb)
    for k in range(n):
        if na[k] and nb[k]:
            s[k, :na[k], :nb[k]] = build_smx(PARAMS, prof[ia[k], :, :na[k]],
                                             prof[ib[k], :, :nb[k]])
    want = sw_traceback_pallas(jnp.asarray(s), PARAMS.gap_open,
                               PARAMS.gap_ext)
    return got, [np.asarray(x) for x in want], na, nb


@pytest.mark.parametrize("la,lb,few", [
    (48, 48, False),      # square
    (40, 100, False),     # rectangular, wide
    (110, 36, False),     # rectangular, tall
    (64, 80, True),       # tie-prone
])
def test_plain_matches_build_smx_and_pallas(la, lb, few):
    (best, bi, bj, tb), (jbest, jbi, jbj, jtb), na, nb = _case(la, lb, few)
    assert tb.shape == tb_shape(len(best), la, lb)
    assert np.array_equal(best.numpy(), jbest)
    assert np.array_equal(bi.numpy(), jbi)
    assert np.array_equal(bj.numpy(), jbj)
    assert best[1] == 0 and (jbest > 0).sum() == len(best) - 1
    skew = unpack_tb(tb, la, lb).numpy()
    d = np.arange(skew.shape[0])[:, None]
    i = np.arange(la)[None, :]
    for k in range(len(best)):
        own = (i < na[k]) & (d - i >= 0) & (d - i < nb[k])
        jfull = np.zeros_like(skew[:, k])
        rows = min(len(jtb), len(skew))
        jfull[:rows] = jtb[:rows, k]
        assert np.array_equal(skew[:, k][own], jfull[own]), k


@pytest.mark.parametrize("few", [False, True])
def test_walk_on_packed_layout_matches_jax(few):
    la, lb = 56, 72
    (best, bi, bj, tb), (jbest, jbi, jbj, jtb), _, _ = _case(la, lb, few)
    got = walk_traceback_batch(tb, best, bi, bj, la)
    want = postalign_jax.walk_traceback_batch(
        *(jnp.asarray(x) for x in (jtb, jbest, jbi, jbj)))
    assert got[3].shape == (len(best), diag_count(la, lb) + 1)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert int(got[2][1]) == 0 and int(got[2].max()) > 10


@pytest.mark.parametrize("la,lb", [(33, 20), (600, 45), (1100, 9)])
def test_pack_unpack_round_trip(la, lb):
    """Every in-band cell survives the packed layout, for one tile, several
    tiles of 4 rows a lane (LA <= 1024) and of 8 (LA > 1024)."""
    rng = np.random.default_rng(la)
    skew = torch.from_numpy(rng.integers(0, 16, (diag_count(la, lb), 3, la))
                            .astype(np.uint8))
    d = torch.arange(skew.shape[0])[:, None, None]
    i = torch.arange(la)[None, None, :]
    band = ((d - i >= 0) & (d - i < lb)).expand_as(skew)
    packed = pack_tb(skew, la, lb)
    assert packed.shape == tb_shape(3, la, lb)
    back = unpack_tb(packed, la, lb)
    assert torch.equal(back[band], skew[band])
    assert not back[~band].any()


def test_feature_blocks_are_the_table():
    """T_f[b][a] = W[code_f(a), code_f(b)], letter index n_f = padding."""
    table = _table()
    w = table.w.numpy()
    d = w.shape[0] - 1
    start = 0
    for off, n in zip(table.offsets.tolist(), table.sizes):
        blk = table.blocks[start: start + (n + 1) ** 2].numpy().reshape(
            n + 1, n + 1)
        code = np.append(np.arange(off, off + n), d)
        assert np.array_equal(blk, w[np.ix_(code, code)].T)
        start += (n + 1) ** 2
    assert start == table.blocks.numel() and table.sizes == SIZES
