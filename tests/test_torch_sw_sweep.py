"""Port's Mu filter (reseek_tpu_torch/ops/sw_sweep.py) against the JAX
package's sweep, its two Pallas kernels (interpret mode on the CPU) and
the exact numpy kernel; its table (MuTable) and the rule that picks the
kernel's int16 or int32 lanes.  Integer scores: every comparison is
exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reseek_tpu.ops import sw_sweep as jsweep
from reseek_tpu.ops.sw_np import sw_score
from reseek_tpu.search.engine import _mu_matrix_padded
from reseek_tpu_torch.ops.smx import mu_table
from reseek_tpu_torch.ops.sw_sweep import (LANES, MuTable, mu_lane_bits,
                                           mu_lane_fits, mu_sw_scores,
                                           mu_sw_scores_ref)

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
                       MuTable.build(torch.from_numpy(MUMX)), -2.0, -1.0)
    assert mu_sw_scores.launches == before
    assert np.array_equal(got.numpy(), _port(a, b, -2.0, -1.0))


def test_mu_table_builds_from_the_engine_table():
    """The port's mu_table() is the JAX engine's padded table; MuTable
    keeps it as is for the plain version and holds its 36x36 block as
    int16, padding at -32768, with the block's extremes."""
    assert np.array_equal(mu_table(), MUMX)
    t = MuTable.build(torch.from_numpy(mu_table()))
    assert torch.equal(t.mumx, torch.from_numpy(MUMX))
    tab = t.tab16.numpy()
    assert tab.dtype == np.int16
    assert np.array_equal(tab[:36, :36].astype(np.float32), MUMX[:36, :36])
    assert (tab[36, :] == t.pad).all() and (tab[:, 36] == t.pad).all()
    assert (t.smax, t.smin, t.pad) == (4, -7, -32768)


@pytest.mark.parametrize("where,value,error", [
    ((3, 4), 0.5, ValueError),          # not an integer
    ((0, 0), np.nan, ValueError),
    ((5, 5), 40000.0, ValueError),      # beyond int16
    ((36, 2), -100.0, ValueError),      # padding that would not sink
    (None, None, TypeError)])           # float64
def test_mu_table_rejects(where, value, error):
    m = MUMX.copy()
    if where is None:
        m = m.astype(np.float64)
    else:
        m[where] = value
    with pytest.raises(error):
        MuTable.build(torch.from_numpy(m))


SIDES = (1, 2, 100, 128, 256, 1000, 1024, 4096, 8000, 8191, 8192)


@pytest.mark.parametrize("la", SIDES)
def test_lane_rule_keeps_every_value_in_range(la):
    """For every (LA, LB) of the grid with the real table and penalties,
    the chosen lane type holds every value of the clamped DP: [pad, hi]
    with hi = 4 x min(LA, LB), pad + hi < 0; int16 wherever it fits."""
    t = MuTable.build(torch.from_numpy(MUMX))
    for lb in SIDES:
        bits = mu_lane_bits(la, lb, t.smax, t.smin, -2, -1)
        tmin, tmax, pad = LANES[bits]
        hi = 4 * min(la, lb)
        assert tmin <= min(pad, -7, -2, -1) and hi <= tmax and pad + hi < 0
        assert (bits == 16) == (hi <= 32767), (la, lb, bits)
        assert mu_lane_fits(la, lb, t.smax, t.smin, -2, -1, 32)


def test_lane_rule_boundary_shapes_pick_int32():
    t = MuTable.build(torch.from_numpy(MUMX))
    assert mu_lane_bits(8192, 8192, t.smax, t.smin, -2, -1) == 32
    assert mu_lane_bits(8191, 8192, t.smax, t.smin, -2, -1) == 16
    assert mu_lane_bits(8192, 8191, t.smax, t.smin, -2, -1) == 16
    # a larger table entry moves the boundary
    assert mu_lane_bits(4096, 4096, 8, t.smin, -2, -1) == 32
    assert mu_lane_bits(4095, 8192, 8, t.smin, -2, -1) == 16
    # the largest gap penalty still fits int16 (H' + open >= open)
    assert mu_lane_bits(8, 8, t.smax, t.smin, -32767, -32767) == 16


def test_high_score_self_pairs():
    """Self-pairs of the best-scoring diagonal letter (the largest score
    a shape allows, 4 x length), an odd batch, pairs sharing an A row:
    plain version == fused Pallas kernel == the exact numpy kernel."""
    le = 128
    best = int(np.diag(MUMX[:36, :36]).argmax())
    a = np.full((5, le), best, np.uint8)
    b = a.copy()
    a[1, 70:] = 36                  # a shorter A row
    b[3, 33:] = 36
    a[4] = a[3]                     # pairs 3 and 4 share their A row
    b[4, :] = np.arange(le) % 36
    got = _port(a, b, -2.0, -1.0)
    want = np.asarray(jsweep.mu_sw_score_fused_pallas(
        jnp.asarray(a.astype(np.int32)), jnp.asarray(b.astype(np.int32)),
        jnp.asarray(MUMX), -2.0, -1.0))
    assert np.array_equal(got, want)
    mu = MUMX[:36, :36]
    for k in range(len(a)):
        ra, rb = a[k][a[k] != 36], b[k][b[k] != 36]
        assert got[k] == np.float32(sw_score(
            mu[ra[:, None], rb[None, :]], -2.0, -1.0)), k
    assert got[0] == 4 * le and got[1] == 4 * 70 and got[3] == 4 * 33


@pytest.mark.parametrize("open_,ext", [(-2.5, -1.0), (-2.0, 1.0),
                                       (-40000.0, -1.0)])
def test_gap_penalties_must_be_nonpositive_integers(open_, ext):
    a = np.zeros((2, 8), np.uint8)
    with pytest.raises(ValueError):
        mu_sw_scores(torch.from_numpy(a), torch.from_numpy(a),
                     MuTable.build(torch.from_numpy(MUMX)), open_, ext)
