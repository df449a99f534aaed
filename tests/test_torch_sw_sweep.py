"""Port's Mu row-sweep (reseek_tpu_torch/ops/sw_sweep.py) against the JAX
package's sweep, its two Pallas kernels (interpret mode on the CPU) and
the exact numpy kernel.  Integer scores: every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reseek_tpu.ops import sw_sweep as jsweep
from reseek_tpu.ops.sw_np import sw_score
from reseek_tpu.search.engine import _mu_matrix_padded
from reseek_tpu_torch.ops.sw_sweep import mu_sw_scores, mu_sw_scores_ref

MUMX = _mu_matrix_padded()
# the test workers share the host's cores: one torch thread each keeps the
# plain versions' many small ops from contending for them
torch.set_num_threads(1)


def _letters(rng, b, la, lb):
    """Ragged Mu letter rows, padded with letter 36 after each length."""
    a = np.full((b, la), 36, np.uint8)
    bb = np.full((b, lb), 36, np.uint8)
    la_k = rng.integers(3, la + 1, b)
    lb_k = rng.integers(3, lb + 1, b)
    for k in range(b):
        a[k, :la_k[k]] = rng.integers(0, 36, la_k[k])
        bb[k, :lb_k[k]] = rng.integers(0, 36, lb_k[k])
    return a, bb, la_k, lb_k


def _port(a, b, open_, ext):
    return mu_sw_scores_ref(torch.from_numpy(a), torch.from_numpy(b),
                            torch.from_numpy(MUMX), open_, ext).numpy()


@pytest.mark.parametrize("la,lb,seed", [(45, 128, 0), (70, 256, 1)])
def test_ref_matches_jax_sweeps(la, lb, seed):
    """Plain version == lax.scan sweep on the f32 one-hot tensor == Pallas
    row sweep on the bf16 tensor (the stage-1 main path) == fused Pallas
    kernel, on ragged rectangular batches."""
    rng = np.random.default_rng(seed)
    a, b, _, _ = _letters(rng, 9, la, lb)
    open_, ext = -2.0, -1.0
    got = _port(a, b, open_, ext)
    ja = jnp.asarray(a.astype(np.int32))
    jb = jnp.asarray(b.astype(np.int32))
    s = jsweep.mu_smx_onehot(ja, jb, jnp.asarray(MUMX))
    want_scan = np.asarray(jsweep.sw_score_sweep(s, open_, ext))
    want_pallas = np.asarray(jsweep.sw_score_sweep_pallas(
        s.astype(jnp.bfloat16), open_, ext))
    want_fused = np.asarray(jsweep.mu_sw_score_fused_pallas(
        ja, jb, jnp.asarray(MUMX), open_, ext))
    assert np.array_equal(got, want_scan)
    assert np.array_equal(got, want_pallas)
    assert np.array_equal(got, want_fused)


@pytest.mark.parametrize("open_,ext", [(-2.0, -1.0), (-11.0, -1.0),
                                       (-3.0, -2.0)])
def test_ref_matches_exact_kernel(open_, ext):
    """Each pair's score equals ops/sw_np.sw_score on its unpadded matrix."""
    rng = np.random.default_rng(7)
    a, b, la_k, lb_k = _letters(rng, 12, 60, 70)
    got = _port(a, b, open_, ext)
    mu = MUMX[:36, :36]
    for k in range(len(a)):
        m = mu[a[k, :la_k[k]][:, None], b[k, :lb_k[k]][None, :]]
        assert got[k] == np.float32(sw_score(m, open_, ext)), k


def test_all_padding_and_empty_batch():
    a = np.full((2, 16), 36, np.uint8)
    b = np.full((2, 32), 36, np.uint8)
    assert np.array_equal(_port(a, b, -2.0, -1.0), np.zeros(2, np.float32))
    empty = _port(a[:0], b[:0], -2.0, -1.0)
    assert empty.shape == (0,)


def test_wrapper_on_cpu_runs_plain_version():
    """A CPU tensor takes the plain version and launches no kernel."""
    rng = np.random.default_rng(3)
    a, b, _, _ = _letters(rng, 4, 20, 30)
    before = mu_sw_scores.launches
    got = mu_sw_scores(torch.from_numpy(a), torch.from_numpy(b),
                       torch.from_numpy(MUMX), -2.0, -1.0)
    assert mu_sw_scores.launches == before
    assert np.array_equal(got.numpy(), _port(a, b, -2.0, -1.0))
