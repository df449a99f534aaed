"""Port's traceback wavefront (reseek_tpu_torch/ops/sw_wavefront.py)
against the JAX package's Pallas kernel (interpret mode on the CPU) and
its lax.scan wavefront, on tie-prone inputs.  best/bi/bj are exact; tb
bytes are exact over the valid band 0 <= d-i < LB."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reseek_tpu.ops.sw_jax import sw_traceback_batch, walk_traceback
from reseek_tpu.ops.sw_np import NEG, sw_align
from reseek_tpu.ops.sw_pallas import sw_traceback_pallas
from reseek_tpu_torch.ops.sw_wavefront import (diag_count, sw_traceback,
                                               sw_traceback_ref)

# the test workers share the host's cores: one torch thread each keeps the
# plain versions' many small ops from contending for them
torch.set_num_threads(1)


def _random_batch(rng, b, la, lb, integer):
    """NEG-padded batch with ragged valid regions (test_sw_pallas.py)."""
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


def _band(dp, la, lb):
    d = np.arange(dp)[:, None, None]
    i = np.arange(la)[None, None, :]
    return (d - i >= 0) & (d - i < lb)


@pytest.mark.parametrize("integer,la,lb,open_,ext", [
    (True, 33, 41, -1.5, -0.25),
    (True, 40, 24, -2.0, -0.5),
    (False, 29, 37, -0.685533, -0.051881),
])
def test_ref_matches_jax(integer, la, lb, open_, ext):
    rng = np.random.default_rng(la * 100 + lb)
    s, _, _ = _random_batch(rng, 8, la, lb, integer)
    best, bi, bj, tb = (x.numpy() for x in sw_traceback_ref(
        torch.from_numpy(s), open_, ext))
    assert tb.shape == (diag_count(la, lb), 8, la)
    band = np.broadcast_to(_band(tb.shape[0], la, lb), tb.shape)
    for fn in (sw_traceback_pallas, sw_traceback_batch):
        jbest, jbi, jbj, jtb = (np.asarray(x) for x in fn(
            jnp.asarray(s), open_, ext))
        assert np.array_equal(best, jbest)
        assert np.array_equal(bi, jbi)
        assert np.array_equal(bj, jbj)
        jtb_full = np.zeros_like(tb)
        jtb_full[: jtb.shape[0]] = jtb
        assert np.array_equal(tb[band], jtb_full[band])


def test_paths_match_exact_kernel():
    """Walking the port's traceback gives sw_np.sw_align's alignment."""
    rng = np.random.default_rng(2)
    s, las, lbs = _random_batch(rng, 8, 33, 41, integer=True)
    best, bi, bj, tb = (x.numpy() for x in sw_traceback_ref(
        torch.from_numpy(s), -1.5, -0.25))
    for k in range(8):
        score, lo_a, lo_b, path = sw_align(s[k, :las[k], :lbs[k]],
                                           -1.5, -0.25)
        if score <= 0:
            assert best[k] == 0 and bi[k] == 0 and bj[k] == 0
            continue
        assert best[k] == np.float32(score)
        assert walk_traceback(tb[:, k, :], int(bi[k]), int(bj[k])) == (
            lo_a, lo_b, path)


def test_no_positive_cell():
    s = np.full((2, 5, 7), -1.0, np.float32)
    best, bi, bj, _ = sw_traceback_ref(torch.from_numpy(s), -1.0, -0.5)
    assert best.tolist() == [0.0, 0.0]
    assert bi.tolist() == [0, 0] and bj.tolist() == [0, 0]


def test_wrapper_on_cpu_runs_plain_version():
    rng = np.random.default_rng(4)
    s, _, _ = _random_batch(rng, 3, 12, 20, integer=True)
    before = sw_traceback.launches
    got = sw_traceback(torch.from_numpy(s), -1.5, -0.25)
    want = sw_traceback_ref(torch.from_numpy(s), -1.5, -0.25)
    assert sw_traceback.launches == before
    assert all(torch.equal(x, y) for x, y in zip(got, want))
