"""Port's row sweeps (reseek_tpu_torch/ops/sw_sweep.py) against the JAX
package.  The Mu filter against the JAX sweep, its two Pallas kernels
(interpret mode on the CPU) and the exact numpy kernel; its table
(MuTable) and the rule that picks the kernel's int16 or int32 lanes
(integer scores: every comparison is exact).  The float sweep of stage 2
fed by the profiles: its plain version against JAX's sw_score_sweep and
the Pallas row sweep on the gather-sum S of the same profiles, the row
skip, a numpy model of the kernel's decomposition (lanes, warps,
neighbours) bit for bit against the plain version, and the layout
rule."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reseek_tpu.ops import sw_sweep as jsweep
from reseek_tpu.ops.sw_np import sw_score
from reseek_tpu.search.engine import _mu_matrix_padded
from reseek_tpu_torch.constants import DSSParams
from reseek_tpu_torch.ops.smx import (PAD_BYTE, flat_layout, mu_table,
                                      profile_codes, profile_smx)
from reseek_tpu_torch.ops.sw_align import FeatureTable, sw_score_profiles_ref
from reseek_tpu_torch.ops.sw_sweep import (LANES, MuTable, mu_lane_bits,
                                           mu_lane_fits, mu_sw_scores,
                                           mu_sw_scores_ref, sw_score_sweep,
                                           sw_score_sweep_profiles_ref,
                                           sw_score_sweep_ref, sweep_layout)

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


# -- the float row sweep of stage 2, fed by the profiles (sw_score_sweep) --

PARAMS = DSSParams.create("sensitive")
PENALTIES = ((PARAMS.gap_open, PARAMS.gap_ext), (-1.5, -0.25))
FEW3 = (("AA", "Conf", "NENDist"), (0.5, 0.3, 0.2))


def _table(features=PARAMS.features, weights=PARAMS.weights):
    off, _, w = flat_layout(tuple(features), tuple(weights))
    return FeatureTable.build(torch.from_numpy(w), torch.from_numpy(off))


def _sweep_profiles(rng, n, length, table, few=False):
    """[n, F, length] uint8 profiles, PAD_BYTE past each chain's random end
    (row 0 all padding, so a pair with it has no positive cell); few: two
    letters a feature, so that scores tie everywhere."""
    prof = np.full((n, len(table.sizes), length), PAD_BYTE, np.uint8)
    for k in range(1, n):
        ln = rng.integers(1, length + 1)
        for f, size in enumerate(table.sizes):
            prof[k, f, :ln] = rng.integers(0, 2 if few else size, ln)
    return torch.from_numpy(prof)


def _gather_sum(prof, prof_b, ia, ib, table, la, lb):
    """The plain version's S [B, la, lb] (profile_smx)."""
    ca = profile_codes(prof[ia, :, :la], table.offsets, table.pad_code)
    cb = profile_codes(prof_b[ib, :, :lb], table.offsets, table.pad_code)
    return profile_smx(ca, cb, table.w)


# widths across 32, 128 and 512 columns, 8 features and the 3-feature
# table, random and tie-prone letters
SWEEP_CASES = [(40, 33, False, False), (70, 130, False, False),
               (24, 520, False, False), (33, 129, True, False),
               (45, 64, True, True), (30, 140, False, True)]


@pytest.mark.parametrize("la,lb,few,three", SWEEP_CASES)
def test_sweep_profiles_ref_matches_jax(la, lb, few, three):
    """sw_score_sweep_profiles_ref equals JAX's sw_score_sweep on the
    gather-sum S of the same profiles within 1e-4 absolute (XLA may fuse
    the sweep's adds differently from PyTorch's op-by-op rounding), and
    the exact score of the same pairs within the engine's 1e-3; the CPU
    wrapper runs it."""
    rng = np.random.default_rng(la * 1000 + lb)
    table = _table(*FEW3) if three else _table()
    n = 7
    prof = _sweep_profiles(rng, n, max(la, lb), table, few)
    prof_b = _sweep_profiles(rng, n, max(la, lb), table, few)
    ia = torch.from_numpy(rng.integers(0, n, n))
    ib = torch.from_numpy(rng.integers(1, n, n))
    ia[1] = 0
    s = _gather_sum(prof, prof_b, ia, ib, table, la, lb).numpy()
    for open_, ext in PENALTIES:
        args = (prof, prof_b, ia, ib, table, la, lb, open_, ext)
        got = sw_score_sweep_profiles_ref(*args).numpy()
        assert got.dtype == np.float32 and got.shape == (n,)
        assert got[1] == 0.0 and got.max() > 0
        want = np.asarray(jsweep.sw_score_sweep(jnp.asarray(s), open_, ext))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        exact = sw_score_profiles_ref(*args).numpy()
        np.testing.assert_allclose(got, exact, rtol=0, atol=1e-3)
        assert torch.equal(sw_score_sweep(*args), torch.from_numpy(got))


@pytest.mark.parametrize("la,lb,few", [(20, 128, False), (16, 256, True)])
def test_sweep_profiles_ref_matches_pallas(la, lb, few):
    """At lane-aligned LB, the Pallas row sweep (interpret mode) on the
    gather-sum S of the same profiles, within 1e-4 absolute."""
    rng = np.random.default_rng(lb + few)
    table = _table()
    prof = _sweep_profiles(rng, 5, lb, table, few)
    ia = torch.from_numpy(rng.integers(0, 5, 4))
    ib = torch.from_numpy(rng.integers(1, 5, 4))
    s = _gather_sum(prof, prof, ia, ib, table, la, lb).numpy()
    for open_, ext in PENALTIES:
        got = sw_score_sweep_profiles_ref(prof, prof, ia, ib, table, la, lb,
                                          open_, ext).numpy()
        want = np.asarray(jsweep.sw_score_sweep_pallas(jnp.asarray(s),
                                                       open_, ext))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _own_rows(prof_a) -> int:
    """The kernel's row count: the last row of the A side with a byte
    other than PAD_BYTE, plus one."""
    real = np.flatnonzero((np.asarray(prof_a) != PAD_BYTE).any(0))
    return int(real[-1]) + 1 if len(real) else 0


@pytest.mark.parametrize("few", [False, True])
def test_sweep_row_skip_is_exact(few):
    """The plain sweep over each pair's full square and over the pair's own
    rows (those up to the A chain's end, which the kernel sweeps) give the
    same best, bit for bit, with both penalty pairs."""
    rng = np.random.default_rng(21 + few)
    table = _table()
    n, la, lb = 9, 90, 70
    prof = _sweep_profiles(rng, n, la, table, few)
    ia = torch.arange(n)
    ib = torch.from_numpy(rng.integers(1, n, n))
    s = _gather_sum(prof, prof, ia, ib, table, la, lb)
    for open_, ext in PENALTIES:
        full = sw_score_sweep_ref(s, open_, ext)
        for k in range(n):
            rows = _own_rows(prof[k, :, :la])
            own = sw_score_sweep_ref(s[k:k + 1, :rows], open_, ext)
            assert own.numpy()[0] == full.numpy()[k], (k, rows)
        assert float(full[0]) == 0.0


def _kernel_model(s, nrows, v, nw, open_, ext):
    """numpy model of csrc/sw_sweep.cu on one pair: s [LA, 32 V nw] float32
    (padding columns past LB included), V columns a lane, 32 lanes a warp,
    nw warps; the in-lane scan, the warp's shuffle scan, the neighbours
    from the lane below, the warps' totals and edges after the barrier (the
    first two F terms of a warp above warp 0 folded in there), and only
    the first nrows rows swept."""
    f32 = np.float32
    o, e = f32(open_), f32(ext)
    neg, inf = f32(-9e9), f32(-np.inf)
    cols = 32 * v * nw
    kx = (np.arange(cols, dtype=f32) * e).reshape(nw, 32, v)
    hp = np.full((nw, 32, v), neg, f32)
    hp2, ep = hp.copy(), hp.copy()
    best = f32(0)
    lane0 = np.zeros((nw, 32), bool)
    lane0[:, 0] = True
    later = lane0.copy()
    later[0, 0] = False

    def below(x, d=1):
        """x of the lane d below, NEG for lanes < d (shfl_up)."""
        out = np.full_like(x, neg)
        out[:, d:] = x[:, :-d]
        return out

    for i in range(nrows):
        n1, m1 = below(hp[..., v - 1]), below(hp2[..., v - 1])
        n2 = below(hp[..., v - 2]) if v >= 2 else below(hp[..., 0], 2)
        hj2 = np.concatenate([n2[..., None], n1[..., None], hp[..., :-2]],
                             2)[..., :v]
        a = (hj2 + o) - kx
        a[later, :2] = inf
        av = np.maximum.accumulate(a, axis=2)
        incl = np.maximum.accumulate(av[..., -1], axis=1)
        excl = np.concatenate([np.full((nw, 1), inf, f32), incl[:, :-1]], 1)
        if nw > 1:
            # edges of the rows above: H(i-1, last), H(i-1, last-1),
            # H(i-2, last) of each warp's last lane
            t0 = np.full(nw, inf, f32)
            t1 = np.full(nw, inf, f32)
            for u in range(1, nw):
                cw = u * 32 * v
                t0[u] = (hp[u - 1, 31, v - 2] + o) - f32(cw) * e
                t1[u] = (hp[u - 1, 31, v - 1] + o) - f32(cw + 1) * e
            tot = np.maximum(incl[:, -1], np.maximum(t0, t1))
            for w in range(1, nw):
                carry = tot[:w].max()
                n1[w, 0] = hp[w - 1, 31, v - 1]
                m1[w, 0] = hp2[w - 1, 31, v - 1]
                av[w, 0, 0] = max(av[w, 0, 0], t0[w])
                av[w, 0, 1:] = np.maximum(av[w, 0, 1:], max(t0[w], t1[w]))
                excl[w, 1:] = np.maximum(np.maximum(excl[w, 1:], carry),
                                         max(t0[w], t1[w]))
                excl[w, 0] = carry
        fv = np.maximum(excl[..., None], av) + kx
        h2j1 = np.concatenate([m1[..., None], hp2[..., :-1]], 2)
        ev = np.maximum(h2j1 + o, ep + e)
        h1j1 = np.concatenate([n1[..., None], hp[..., :-1]], 2)
        m = np.maximum(np.maximum(h1j1, ev), np.maximum(fv, f32(0)))
        h = m + s[i].reshape(nw, 32, v)
        best = max(best, h.max())
        hp2, hp, ep = hp, h, ev
    return f32(best)


def _layouts(lb, kind):
    if kind == "rule":
        return sweep_layout(lb)
    # V = 8 or 2 over one warp more than LB needs
    v = 8 if kind == "v8_warps" else 2
    return v, -(-lb // (32 * v)) + 1


@pytest.mark.parametrize("kind", ["rule", "v8_warps", "v2_warps"])
@pytest.mark.parametrize("lb", [1, 31, 33, 65, 100, 257])
def test_kernel_model_equals_plain(lb, kind):
    """The kernel's decomposition, modelled in numpy, equals the plain
    version bit for bit at LB across lane and warp edges, with the row
    skip, on random and tie-prone profiles with both penalty pairs."""
    v, nw = _layouts(lb, kind)
    assert 32 * v * nw >= lb and (nw == 1 or v >= 2)
    rng = np.random.default_rng(lb * 10 + len(kind))
    table = _table()
    la = 37
    cols = 32 * v * nw
    for few in (False, True):
        prof = _sweep_profiles(rng, 5, max(la, lb), table, few)
        prof_b = torch.full((5, prof.shape[1], cols), PAD_BYTE,
                            dtype=torch.uint8)
        prof_b[:, :, :lb] = prof[:, :, :lb]
        ia = torch.tensor([1, 2, 3, 4, 0])
        ib = torch.tensor([4, 1, 2, 3, 3])
        s = _gather_sum(prof, prof_b, ia, ib, table, la, cols).numpy()
        for open_, ext in PENALTIES:
            want = sw_score_sweep_ref(torch.from_numpy(s[:, :, :lb]), open_,
                                      ext).numpy()
            for k in range(len(ia)):
                rows = _own_rows(prof[int(ia[k]), :, :la])
                got = _kernel_model(s[k], rows, v, nw, open_, ext)
                assert got == want[k], (k, rows, v, nw)


@pytest.mark.parametrize("lb", [1, 32, 33, 100, 512, 513, 600, 1024, 1100,
                                4096, 8191, 8192])
def test_sweep_layout(lb):
    """One warp a pair up to 512 columns, V the least power of two that
    covers LB; then V = 8 over LB / 256 warps up to 4,096 columns, V = 16
    over LB / 512 warps above; nothing above MAX_LB."""
    v, nw = sweep_layout(lb)
    assert v in (1, 2, 4, 8, 16) and 32 * v * nw >= lb
    if lb <= 512:
        assert nw == 1 and (v == 1 or 16 * v < lb)
    elif lb <= 4096:
        assert (v, nw) == (8, -(-lb // 256))
    else:
        assert (v, nw) == (16, -(-lb // 512))
    with pytest.raises(ValueError):
        sweep_layout(lb + 8192)


@pytest.mark.parametrize("v,nw", [(2, 4), (4, 3), (16, 2)])
def test_kernel_model_gap_across_warps(v, nw):
    """A path whose horizontal gap opens at the last columns of one warp
    and resumes in the next warp's first lanes or in a later warp: its F
    term is one that a warp can only read after the barrier.  The model
    equals the plain version bit for bit, and the path through the gap is
    the best one."""
    cols = 32 * v * nw
    # the diagonal before the gap ends at row cw - 2, column cw - 2 + d
    cases = [(u * 32 * v, gap, d) for u in range(1, nw)
             for gap in (5, 32 * v + 5) for d in (0, 1)
             if u * 32 * v + gap + 21 <= cols]
    assert len(cases) >= 2 * (nw - 1)
    for cw, gap, d in cases:
        la = cw + 20
        s = np.full((la, cols), -1.0, np.float32)
        i = np.arange(la)
        head = i[i <= cw - 2]
        s[head, head + d] = 3.0
        tail = i[i >= cw - 1]
        s[tail, tail + d + gap] = 3.0
        for open_, ext in PENALTIES:
            want = sw_score_sweep_ref(torch.from_numpy(s[None]), open_, ext)
            got = _kernel_model(s, la, v, nw, open_, ext)
            assert got == want.numpy()[0], (cw, gap, d, open_)
            assert got > 3.0 * cw, (cw, gap, d, open_)
