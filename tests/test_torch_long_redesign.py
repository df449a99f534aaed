"""The long-column Mu filter (mu_sweep_long) and LDDT (lddt_long) as
redesigned for the card, on the CPU: their protocols emulated in numpy
against the plain versions and reseek_tpu, their launch plans on "meta"
tensors, and the user path that reaches the long Mu filter, a
``--verysensitive --omega 12`` search, against reseek_tpu's.

Past 8,192 columns the Mu filter is a band kernel (csrc/mu_wavefront.cu):
a pair's tiles of rows run at once as bands of one warp, each band
handing H' of its last two rows and E' of its last row, per column, to
the next through device memory behind a sentinel, bands past the pair's
last letter exiting at once, the best raised by an atomic maximum.
``_emulate_mu_bands`` runs that protocol, bands of a few lanes under a
random schedule, in the kernel's int32 clamped recurrence.

Past 7,680 columns LDDT cuts the column-pair triangle of every pair of
the launch into tiles of 128 x 128 (32 lanes x 4 rows) dealt to warps by
a ticket; each tile adds its row and column totals to per-column counts
with atomics, and a second launch forms the scores and adds them left to
right.  ``_emulate_lddt_tiles`` runs that decomposition with the counts
added in a shuffled order."""

import importlib.util
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reseek_tpu import cli as tpu_cli
from reseek_tpu.ops import postalign_jax
from reseek_tpu.ops.sw_sweep import mu_sw_score_fused_pallas
from reseek_tpu.search.engine import _mu_matrix_padded
from reseek_tpu_torch import __main__ as port_cli
from reseek_tpu_torch import kernels
from reseek_tpu_torch.io.cal import write_cal
from reseek_tpu_torch.io.reader import read_chains
from reseek_tpu_torch.ops import postalign, sw_sweep
from reseek_tpu_torch.ops.postalign import (LONG_TILE, lddt_batch_ref,
                                            lddt_long_blocks)
from reseek_tpu_torch.ops.smx import mu_table
from reseek_tpu_torch.ops.sw_align import band_stats_words

from test_torch_long import fake_card  # noqa: F401  (a fixture)

Q100 = os.path.join(os.path.dirname(__file__), "golden", "q100.cal")
COLUMNS = "query+target+qlo+qhi+tlo+thi+evalue+cigar"
LDDT_TOL = 1e-6
MU_OPEN, MU_EXT = -2, -1          # the Mu filter's gaps (para_mu_gap_*)
torch.set_num_threads(1)


# -- the Mu band kernel, emulated ----------------------------------------

SENTINEL = 0xffffffff
PAD32 = -(1 << 30)                # the int32 table's padding score
I32 = (-(1 << 31), (1 << 31) - 1)


def _tab32() -> np.ndarray:
    """The kernel's int32 table: the 36 integer letters, PAD32 in the
    padding row and column."""
    t = np.full((37, 37), PAD32, np.int64)
    t[:36, :36] = mu_table()[:36, :36].astype(np.int64)
    return t


def _last(row: np.ndarray) -> int:
    """One past the last real letter (< 36) of a row, 0 if none."""
    real = np.flatnonzero(row < 36)
    return int(real[-1]) + 1 if len(real) else 0


def _mu_band(pa, pb, tab, bnd, band, bands, lanes, r, group):
    """One band of the Mu band kernel as a generator: ``lanes`` lanes of
    ``r`` rows, lane k at column T - k at step T, every lane computing
    every step (padding outside the pair's columns); lane 0 takes the
    boundary above from bnd[band - 1] a group of ``group`` columns ahead,
    0 past ncols, re-read while a value it needs is the sentinel (it
    yields "wait" then); the last lane writes H', H', E' of each column
    below ncols to bnd[band] when a band follows.  A band at or past the
    pair's last tile returns None at once; else its maximum H'."""
    la, lb = len(pa), len(pb)
    nrows, ncols = _last(pa), _last(pb)
    tile = lanes * r
    tiles = -(-nrows // tile) if ncols > 0 else 0
    if band >= tiles:
        return None
    rows = band * tile + np.arange(lanes)[:, None] * r + np.arange(r)
    ra = np.where(rows < la, np.minimum(pa[np.minimum(rows, la - 1)], 36),
                  36)
    h1, o1, o2, f1 = (np.zeros((lanes, r), np.int64) for _ in range(4))
    u1, uo1, uo2, uo1p, oh1, oh2, oe = (np.zeros(lanes, np.int64)
                                        for _ in range(7))
    bin_, bout = band > 0, band + 1 < tiles
    nxt = np.zeros((group, 3), np.int64)
    cur = nxt.copy()

    def fetch(c0):
        for g in range(group):
            col = c0 + g
            nxt[g] = bnd[band - 1, col] if col < ncols else 0

    def ready(c0):
        return all(c0 + g >= ncols or not np.any(nxt[g] == SENTINEL)
                   for g in range(group))

    if bin_:
        fetch(0)
    best = 0
    for t in range(ncols + lanes - 1):
        j = t - np.arange(lanes)
        if bin_ and t % group == 0 and t < ncols:
            while not ready(t):
                yield "wait"
                fetch(t)
            cur = nxt.copy()
            fetch(t + group)
        rh1, rh2, re = (np.roll(x, 1) for x in (oh1, oh2, oe))
        rh1[0], rh2[0], re[0] = (cur[t % group] if bin_ and t < ncols
                                 else (0, 0, 0))
        jin = (j >= 0) & (j < ncols)
        cols = np.where(jin, np.minimum(pb[np.clip(j, 0, lb - 1)], 36), 36)
        s = tab[ra, cols[:, None]]
        hn, fn = np.empty((lanes, r), np.int64), np.empty((lanes, r),
                                                          np.int64)
        e_up = re.copy()
        for k in range(r):
            ho2 = o1[:, k - 2] if k >= 2 else (uo1 if k == 1 else uo2)
            hl2 = o2[:, k - 1] if k >= 1 else uo1p
            hd = h1[:, k - 1] if k >= 1 else u1
            ev = np.maximum(np.maximum(e_up + MU_EXT, ho2), 0)
            fv = np.maximum(np.maximum(f1[:, k] + MU_EXT, hl2), 0)
            m = np.maximum(np.maximum(hd, ev), np.maximum(fv, 0))
            hn[:, k] = np.maximum(m + s[:, k], 0)
            fn[:, k] = fv
            e_up = ev
            # no sum leaves the int32 lanes (DPX adds wrap)
            assert I32[0] <= (m + s[:, k]).min() and m.max() <= I32[1]
        best = max(best, int(hn.max()))
        uo1p, u1, uo1, uo2 = uo1, rh1, rh1 + MU_OPEN, rh2 + MU_OPEN
        o2, o1, h1, f1 = o1, hn + MU_OPEN, hn, fn
        oh1, oh2, oe = hn[:, r - 1], hn[:, r - 2], e_up
        if bout and 0 <= j[-1] < ncols:
            assert np.all(bnd[band, j[-1]] == SENTINEL)   # written once
            bnd[band, j[-1]] = (oh1[-1], oh2[-1], oe[-1])
        yield "step"
    return best


def _emulate_mu_bands(a, b, lanes, r, rng, group=8):
    """The Mu band kernel on letters a [B, LA], b [B, LB] uint8: each
    pair's bands (_mu_band) started in ticket order and stepped in a
    random interleaving, the boundaries [bands - 1, LB, 3] set to the
    sentinel first; each band's maximum into the pair's best.  -> (best
    [B] float32, bands that exited at once, waits)."""
    tab = _tab32()
    bsz, la = a.shape
    bands = -(-la // (lanes * r))
    out = np.zeros(bsz, np.float32)
    exits = waits = 0
    for p in range(bsz):
        bnd = np.full((max(bands - 1, 1), b.shape[1], 3), SENTINEL,
                      np.int64)
        gens = [_mu_band(a[p], b[p], tab, bnd, k, bands, lanes, r, group)
                for k in range(bands)]
        started, results = [], {}
        while len(results) < bands:
            live = [k for k in started if k not in results]
            if len(started) < bands and (not live or rng.random() < 0.3):
                started.append(len(started))     # the next ticket
                continue
            k = live[rng.integers(len(live))]
            try:
                waits += next(gens[k]) == "wait"
            except StopIteration as stop:
                results[k] = stop.value
        exits += sum(v is None for v in results.values())
        got = [v for v in results.values() if v is not None]
        out[p] = np.float32(max(got, default=0))
    return out, exits, waits


def _mu_letters(seed, bsz, la, lb, ends_a=None, ends_b=None):
    """Seeded Mu letters a [B, LA], b [B, LB] (36 past each row's end):
    each B row its A row with a third of the letters redrawn, so that the
    pairs score high; ``ends_*`` each row's real letters (default all)."""
    rng = np.random.default_rng(seed)
    n = max(la, lb)
    a = rng.integers(0, 36, (bsz, n)).astype(np.uint8)
    b = np.where(rng.random((bsz, n)) < 0.33,
                 rng.integers(0, 36, (bsz, n)), a).astype(np.uint8)
    a, b = a[:, :la].copy(), b[:, :lb].copy()
    for x, ends in ((a, ends_a), (b, ends_b)):
        for k, e in enumerate(ends or ()):
            x[k, e:] = 36
    return a, b


def _mu_ref(a, b):
    table = torch.from_numpy(mu_table())
    return sw_sweep.mu_sw_scores_ref(torch.from_numpy(a), torch.from_numpy(b),
                                     table, MU_OPEN, MU_EXT).numpy()


def _mu_pallas(a, b):
    return np.asarray(mu_sw_score_fused_pallas(
        jnp.asarray(a.astype(np.int32)), jnp.asarray(b.astype(np.int32)),
        jnp.asarray(_mu_matrix_padded()), float(MU_OPEN), float(MU_EXT)))


@pytest.mark.parametrize("bsz, la, lb, lanes, r, ends_a, ends_b", [
    # one pair, the kernel's bands of 32 lanes x 4 rows (3, the last of 44)
    (1, 300, 256, 32, 4, None, None),
    # LA != LB, 13 bands of 4 x 4 rows a pair
    (3, 200, 384, 4, 4, None, None),
    # ragged trailing padding: A ending mid-band (row 37 of bands of 16)
    # and at row 70, B at column 50, a pair with no real letter
    (4, 160, 128, 4, 4, [37, 70, 0, 160], [128, 50, 128, 100]),
    # wide and short: 3 bands of 8 rows over 512 columns
    (2, 24, 512, 4, 2, None, [512, 300]),
    # 2 lanes of 2 rows: bands of 4 rows, 10 a pair
    (2, 40, 128, 2, 2, [40, 33], None),
])
def test_mu_band_protocol_matches_plain_and_pallas(bsz, la, lb, lanes, r,
                                                   ends_a, ends_b):
    """The Mu band protocol, emulated, gives mu_sw_scores_ref's scores and
    reseek_tpu's fused Pallas Mu kernel's (interpret mode) exactly, with
    the boundary handed down behind the sentinel under a schedule that
    races, and the bands past a pair's last letter exiting at once."""
    seed = la * 7 + lb + lanes
    a, b = _mu_letters(seed, bsz, la, lb, ends_a, ends_b)
    got, exits, waits = _emulate_mu_bands(a, b, lanes, r,
                                          np.random.default_rng(seed))
    want = _mu_ref(a, b)
    assert np.array_equal(got, want)
    assert np.array_equal(got, _mu_pallas(a, b))
    assert got.max() > 0
    bands = -(-la // (lanes * r))
    assert bands == 1 or waits > 0, "the schedule never raced"
    if ends_a is not None:
        # the bands past each pair's last tile, and every band of a pair
        # with no real letter
        tile = lanes * r
        want_exits = sum(bands - (-(-e // tile) if eb and e else 0)
                         for e, eb in zip(ends_a, ends_b or [lb] * bsz))
        assert exits == want_exits > 0
        if 0 in ends_a:
            assert got[ends_a.index(0)] == 0


def test_mu_band_sentinel_is_no_value():
    """The handoff's sentinel, 0xffffffff, is no DP value: every H', E', F'
    lies in [0, hi] with hi = 4 x min(LA, LB) < 2^30 wherever the long
    variant's int32 lanes fit (mu_lane_fits)."""
    mt = sw_sweep.MuTable.build(torch.from_numpy(mu_table()))
    for n in (8193, 16384, 1 << 20):
        assert sw_sweep.mu_lane_fits(n, n, mt.smax, mt.smin, MU_OPEN,
                                     MU_EXT, 32)
        assert mt.smax * n < (1 << 30) <= SENTINEL


# -- the Mu band kernel's launch -----------------------------------------

@pytest.mark.parametrize("b, la, r, bands", [
    (2, 128, 4, 1), (2, 129, 4, 2), (1, 12032, 4, 94), (128, 128, 4, 1),
    (3, 8192, 4, 64), (66, 8192, 4, 64), (67, 8192, 8, 32),
    (128, 16384, 8, 64), (4224, 128, 4, 1), (4225, 128, 8, 1)])
def test_mu_band_plan(b, la, r, bands):
    """Bands of 128 rows (R = 4) while the launch's blocks, b x bands of
    one warp, all fit on an H100's 132 SMs at once (4,224), else of 256
    (R = 8)."""
    assert sw_sweep.mu_band_plan(b, la, 132) == (r, bands, b * bands)
    assert sw_sweep.mu_band_rows(b, la, 132) == r


def test_mu_band_rows_reads_the_sms():
    """The rule scales with the card's SMs: 128 pairs of 8,192 rows fit
    at once on 256 SMs (8,192 blocks), not on 132."""
    assert sw_sweep.mu_band_rows(128, 8192, 132) == 8
    assert sw_sweep.mu_band_rows(128, 8192, 256) == 4


@pytest.mark.parametrize("b, la, lb, budget, pairs", [
    (128, 128, 16384, 1, 128), (128, 16384, 16384, 10 << 30, 128),
    (128, 65536, 65536, 10 << 30, 26), (128, 131072, 131072, 10 << 30, 6),
    (2, 12032, 12032, 1, 1), (5, 300, 8193, 2 * 8193 * 12 * 2, 2)])
def test_mu_band_pairs(b, la, lb, budget, pairs):
    """A launch's boundaries, (ceil(la / 128) - 1) x lb x 12 bytes a pair,
    stay within the budget; one pair at least, and every pair where a
    pair has one band (no boundary)."""
    assert sw_sweep.mu_band_pairs(b, la, lb, budget) == pairs
    per = (-(-la // 128) - 1) * lb * 12
    assert pairs == 1 or pairs * per <= budget


@pytest.mark.parametrize("la, r, bands", [(100, 4, 1), (300, 4, 3),
                                          (300, 8, 2)])
def test_mu_band_scratch(la, r, bands):
    """The band kernel's scratch: out zeroed, each pair's boundaries
    [bands - 1, LB, 3] filled with the sentinel (0xffffffff as int32),
    the ticket 0; out stands in for the boundaries of one band."""
    out = torch.full((3,), 7.0)
    bnd, ticket = sw_sweep.mu_band_scratch(out, 3, la, 8193, r)
    assert torch.equal(out, torch.zeros(3))
    assert torch.equal(ticket, torch.zeros(1, dtype=torch.int32))
    if bands == 1:
        assert bnd is out
    else:
        assert bnd.shape == (3, bands - 1, 8193, 3)
        assert bnd.dtype == torch.int32 and bool((bnd == -1).all())
        assert np.all(bnd.numpy().view(np.uint32) == SENTINEL)


def _meta_letters(b, la, lb):
    meta = torch.device("meta")
    return (torch.empty((b, la), dtype=torch.uint8, device=meta),
            torch.empty((b, lb), dtype=torch.uint8, device=meta),
            sw_sweep.MuTable.build(torch.from_numpy(mu_table())).to(meta))


@pytest.mark.parametrize("stats", [False, True])
def test_mu_band_launch(fake_card, stats):  # noqa: F811
    """Past 8,192 columns the wrapper launches mu_wavefront_long with the
    boundaries, the ticket and the stats buffer (or null), the pairs, the
    shape, the gaps and R = 4, counted on mu_sweep_long."""
    a, b, mt = _meta_letters(3, 300, 8193)
    st = (torch.empty(band_stats_words(3), dtype=torch.int32,
                      device="meta") if stats else None)
    sw_sweep.mu_sw_scores(a, b, mt, MU_OPEN, MU_EXT, stats=st)
    name, args = fake_card.calls[-1]
    assert name == "mu_wavefront_long"
    assert len(args) == len(kernels._SIGNATURES[name])
    assert (args[6] is None) is (not stats)
    assert args[7:13] == (3, 300, 8193, MU_OPEN, MU_EXT, 4)
    assert sw_sweep.mu_sweep_long.launches == 1
    assert sw_sweep.mu_sw_scores.launches == 0


def test_mu_band_stats_checked(fake_card, monkeypatch):  # noqa: F811
    a, b, mt = _meta_letters(3, 300, 8193)
    with pytest.raises(ValueError, match="stats"):
        sw_sweep.mu_sw_scores(a, b, mt, MU_OPEN, MU_EXT, stats=torch.empty(
            band_stats_words(2), dtype=torch.int32, device="meta"))
    # stats of a batch that the scratch budget splits
    monkeypatch.setattr(sw_sweep, "_card", lambda dev: (132, 1))
    with pytest.raises(ValueError, match="more than one launch"):
        sw_sweep.mu_sw_scores(a, b, mt, MU_OPEN, MU_EXT, stats=torch.empty(
            band_stats_words(3), dtype=torch.int32, device="meta"))
    assert fake_card.calls == []


def test_mu_band_launches_split_by_the_budget(fake_card,  # noqa: F811
                                               monkeypatch):
    """Where a batch's boundaries pass the scratch budget, the wrapper
    launches the band kernel on consecutive batches of mu_band_pairs
    pairs, each counted, at the R of its own size."""
    per = 2 * 8193 * 12               # 300 rows: 3 bands, 2 boundaries
    monkeypatch.setattr(sw_sweep, "_card", lambda dev: (132, 2 * per))
    a, b, mt = _meta_letters(5, 300, 8193)
    sw_sweep.mu_sw_scores(a, b, mt, MU_OPEN, MU_EXT)
    assert [c[0] for c in fake_card.calls] == ["mu_wavefront_long"] * 3
    assert [c[1][7] for c in fake_card.calls] == [2, 2, 1]
    assert all(c[1][8:13] == (300, 8193, MU_OPEN, MU_EXT, 4)
               for c in fake_card.calls)
    assert sw_sweep.mu_sweep_long.launches == 3


# -- the LDDT tiles, emulated -----------------------------------------------

def _tile_of(t: int):
    """Tile t of a pair's triangle -> (I, J), I <= J (the kernel's)."""
    j = int((np.sqrt(8.0 * t + 1.0) - 1.0) * 0.5)
    while j * (j + 1) // 2 > t:
        j -= 1
    while (j + 1) * (j + 2) // 2 <= t:
        j += 1
    return t - j * (j + 1) // 2, j


def _dist2(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """[n, 3], [k, 3] float32 -> [n, k] (dx*dx + dy*dy) + dz*dz, each
    product and sum rounded."""
    d = x[:, None, :] - y[None, :, :]
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
        + d[..., 2] * d[..., 2]


def _emulate_lddt_tiles(cq, ct, valid, ncols, blocks, rng, tile=LONG_TILE,
                        with_risky=True):
    """The long LDDT on [B, M] columns: the tiles of every pair taken from
    one ticket by blocks x 8 warps in a random order, each tile's row and
    column totals (pres | cons << 16 of its pairs (row < column on a
    diagonal tile), as lddt_kernel packs them) added to the per-column
    counts (pres | cons << 32) in a shuffled order, the risky flag ORed;
    then each pair's scores added left to right over the M columns.  ->
    (lddt [B] float32, risky [B] bool, {(pair, c, o): times counted},
    {warp: tiles taken})."""
    bsz, m, _ = cq.shape
    nt = -(-m // tile)
    tp = nt * (nt + 1) // 2
    r0 = np.float32(225.0)
    parts, risky, seen, taken = [], np.zeros(bsz, bool), {}, {}
    warps = blocks * postalign.LDDT_WARPS
    for k in range(bsz * tp):
        taken.setdefault(int(rng.integers(warps)), []).append(k)
        pair, (ti, tj) = k // tp, _tile_of(k % tp)
        rows = ti * tile + np.arange(tile)
        cols = tj * tile + np.arange(tile)
        rv = (rows < m) & valid[pair, np.minimum(rows, m - 1)]
        ov = (cols < m) & valid[pair, np.minimum(cols, m - 1)]
        if not rv.any() or not ov.any():
            continue
        pv = rv[:, None] & ov[None, :]
        if ti == tj:
            pv &= np.arange(tile)[:, None] < np.arange(tile)[None, :]
        rc, cc = np.minimum(rows, m - 1), np.minimum(cols, m - 1)
        a1 = _dist2(cq[pair, rc], cq[pair, cc])
        a2 = _dist2(ct[pair, rc], ct[pair, cc])
        cons = pv & ~((a1 > r0) & (a2 > r0))
        dd = np.abs(np.sqrt(a1) - np.sqrt(a2))
        inc = np.where(cons, sum((dd <= np.float32(x)).astype(np.int64)
                                 for x in (0.5, 1.0, 2.0, 4.0))
                       + (4 << 16), 0)
        near_t = np.zeros_like(cons)
        for x in (0.5, 1.0, 2.0, 4.0):
            near_t |= np.abs(dd - np.float32(x)) < np.float32(3e-5)
        near_r0 = (np.abs(a1 - r0) < np.float32(1e-3)) | (
            np.abs(a2 - r0) < np.float32(1e-3))
        risky[pair] |= bool(((near_t & cons) | (near_r0 & pv)).any())
        for c, o in zip(*np.nonzero(pv)):
            key = (pair, int(rows[c]), int(cols[o]))
            seen[key] = seen.get(key, 0) + 1
        for idx, tot in ((rows, inc.sum(1)), (cols, inc.sum(0))):
            parts += [(pair, int(i), int(x)) for i, x in zip(idx, tot) if x]
    counts = np.zeros((bsz, m), np.int64)
    for q in rng.permutation(len(parts)):
        pair, col, x = parts[q]
        assert (x & 0xffff) <= 4 * tile and (x >> 16) <= 4 * tile
        counts[pair, col] += (x & 0xffff) | ((x >> 16) << 32)
    out = np.zeros(bsz, np.float32)
    for p in range(bsz):
        total = np.float32(0)
        for c in range(m):
            pres, cons = counts[p, c] & 0xffffffff, counts[p, c] >> 32
            score = (np.float32(pres) / np.float32(cons) if cons
                     else np.float32(0))
            total = np.float32(total + score)
        out[p] = total / np.float32(max(int(ncols[p]), 1))
    return out, (risky if with_risky else None), seen, taken


@pytest.mark.parametrize("bsz, m, blocks, tile", [
    (1, 1, 1, LONG_TILE), (2, 7, 3, 4), (1, 129, 5, LONG_TILE),
    (3, 40, 1, 8), (2, 300, 528, LONG_TILE)])
def test_lddt_tiles_cover_each_column_pair_once(bsz, m, blocks, tile):
    """Every unordered pair of valid columns of every pair is counted by
    exactly one tile, whichever warp of however many blocks takes it, and
    no warp takes a tile twice."""
    rng = np.random.default_rng(m + bsz)
    cq = rng.normal(0, 8, (bsz, m, 3)).astype(np.float32)
    valid = rng.random((bsz, m)) < 0.8
    valid[:, -1] = bsz > 1      # trailing columns invalid in some pairs
    ncols = valid.sum(1).astype(np.int32)
    _, _, seen, taken = _emulate_lddt_tiles(cq, cq, valid, ncols, blocks,
                                            rng, tile=tile)
    want = {(p, c, o) for p in range(bsz) for c in range(m)
            for o in range(c + 1, m) if valid[p, c] and valid[p, o]}
    assert set(seen) == want and set(seen.values()) <= {1}
    tiles = [k for ks in taken.values() for k in ks]
    assert sorted(tiles) == list(range(len(tiles)))


def _long_columns(rng, chains, bsz, m):
    """Columns of q100 chains joined end to end (50 A apart along x, as
    chip_smoke.py's long chains): cq the chain, ct it with seeded noise
    of 0.25-1 A; pair k valid on a ragged span with holes."""
    xyz, end = [], None
    for c in chains:
        x = c.coords.astype(np.float64)
        if end is not None:
            x[:, 0] += end + 50.0 - x[:, 0].min()
        end = x[:, 0].max()
        xyz.append(x)
    base = np.concatenate(xyz)[:m].astype(np.float32)
    cq = np.repeat(base[None], bsz, 0)
    ct = np.stack([base + rng.normal(0, 0.25 * (k + 1), base.shape).astype(
        np.float32) for k in range(bsz)])
    valid = rng.random((bsz, m)) < 0.95
    for k in range(bsz):
        valid[k, m - k * (m // 7):] = False
    return cq, ct, valid, valid.sum(1).astype(np.int32)


@pytest.mark.parametrize("bsz, m, blocks", [(1, 300, 1), (3, 520, 7)])
def test_lddt_tiles_match_plain_and_jax(bsz, m, blocks):
    """The tiled counts, added in a shuffled order, give lddt_batch_ref's
    values and risky flags bit for bit, and reseek_tpu's lddt_batch's
    within LDDT_TOL with the same risky flags, on q100 columns."""
    rng = np.random.default_rng(bsz * m)
    cq, ct, valid, ncols = _long_columns(rng, read_chains(Q100)[:6], bsz, m)
    got, risky, _, _ = _emulate_lddt_tiles(cq, ct, valid, ncols, blocks,
                                           rng)
    ref, rrisky = lddt_batch_ref(*(torch.from_numpy(x)
                                   for x in (cq, ct, valid, ncols)))
    assert np.array_equal(got, ref.numpy())
    assert np.array_equal(risky, rrisky.numpy())
    want, wrisky = postalign_jax.lddt_batch(
        jnp.asarray(cq), jnp.asarray(ct), jnp.asarray(valid),
        jnp.asarray(ncols), with_risky=True)
    assert np.array_equal(risky, np.asarray(wrisky))
    assert np.max(np.abs(got - np.asarray(want))) <= LDDT_TOL
    assert got.min() > 0.3


def test_lddt_tiles_at_the_boundaries():
    """Coordinates on the R0^2 gate and on each threshold, and just off
    them (test_torch_postalign's cases), through tiles of 2 x 2: risky as
    reseek_tpu's lddt_batch flags it, the values bit-equal to the plain
    version's and, where no pair is flagged, within LDDT_TOL of JAX's."""
    cases = []
    for d2 in (0.5, 1.0, 2.0, 4.0):
        for off in (0.0, 1e-5, 0.25):
            cases.append((10.0, 10.0 + d2 + off))   # a threshold
    cases += [(15.0, 15.0), (15.0, 14.9), (15.0 + 1e-4, 16.0),
              (15.5, 15.5), (3.0, 3.2)]             # the gate
    b, m = len(cases), 4
    cq = np.zeros((b, m, 3), np.float32)
    ct = np.zeros((b, m, 3), np.float32)
    for k, (dq, dt) in enumerate(cases):
        cq[k, 1, 0], ct[k, 1, 0] = dq, dt
        cq[k, 2:, 1] = ct[k, 2:, 1] = (100.0, 107.0)
    valid = np.ones((b, m), bool)
    valid[-1, 3] = False
    ncols = valid.sum(1).astype(np.int32)
    got, risky, _, _ = _emulate_lddt_tiles(cq, ct, valid, ncols, 2,
                                           np.random.default_rng(3), tile=2)
    ref, rrisky = lddt_batch_ref(*(torch.from_numpy(x)
                                   for x in (cq, ct, valid, ncols)))
    assert np.array_equal(got, ref.numpy())
    assert np.array_equal(risky, rrisky.numpy())
    want, wrisky = postalign_jax.lddt_batch(
        jnp.asarray(cq), jnp.asarray(ct), jnp.asarray(valid),
        jnp.asarray(ncols), with_risky=True)
    assert np.array_equal(risky, np.asarray(wrisky))
    assert risky[[0, 3, 6, 9, 12, 13]].all() and not risky.all()
    ok = ~risky
    assert np.max(np.abs(got - np.asarray(want))[ok]) <= LDDT_TOL


# -- far tiles: the next idea for the long LDDT ---------------------------

def _smoke():
    """chip_smoke.py as a module (its phase-13 chains and LDDT columns)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), os.pardir,
                                   "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tile_boxes(x: np.ndarray, v: np.ndarray, tile: int):
    """Each column block's bounding box (lo, hi) of its valid columns, or
    None where it has none."""
    out = []
    for c0 in range(0, len(v), tile):
        k = v[c0:c0 + tile]
        blk = x[c0:c0 + tile][k]
        out.append((blk.min(0), blk.max(0)) if k.any() else None)
    return out


def _box_gap(p, q) -> float:
    """The least distance between two boxes."""
    return float(np.linalg.norm(np.maximum(0.0, np.maximum(
        q[0] - p[1], p[0] - q[1]))))


@pytest.mark.parametrize("m, far, tiles", [(12000, 7743, 8206),
                                           (7681, 3474, 3782)])
def test_far_tiles_of_the_long_gate(m, far, tiles):
    """The share of lddt_long's tiles (128 x 128 column pairs of each
    pair's triangle, both blocks with a valid column) at phase 13's LDDT
    gate columns (chip_smoke.py lddt_long_columns, cut to M columns)
    whose two blocks' bounding boxes lie more than 15 A apart in both
    structures: far, of tiles (ROADMAP §B, the next idea for lddt_long).
    Every column pair of such a tile lies more than 15 A apart in both
    structures, so none is considered and skipping the tile is exact."""
    smoke = _smoke()
    longs = smoke.long_chains(read_chains(Q100))
    cq, ct, valid, _ = smoke.lddt_long_columns(longs, device="cpu")
    cq, ct, valid = (x[:, :m].numpy() for x in (cq, ct, valid))
    got = total = 0
    r0 = np.sqrt(float(postalign.R0_SQ))
    for q, t, v in zip(cq, ct, valid):
        boxes = [_tile_boxes(x, v, LONG_TILE) for x in (q, t)]
        for i in range(len(boxes[0])):
            for j in range(i, len(boxes[0])):
                if boxes[0][i] is None or boxes[0][j] is None:
                    continue
                total += 1
                if not all(_box_gap(b[i], b[j]) > r0 for b in boxes):
                    continue
                got += 1
                for x in (q, t):
                    xi = x[i * LONG_TILE:(i + 1) * LONG_TILE][
                        v[i * LONG_TILE:(i + 1) * LONG_TILE]]
                    xj = x[j * LONG_TILE:(j + 1) * LONG_TILE][
                        v[j * LONG_TILE:(j + 1) * LONG_TILE]]
                    d2 = ((xi[:, None] - xj[None]) ** 2).sum(-1)
                    assert d2.min() > float(postalign.R0_SQ)
    assert (got, total) == (far, tiles)


# -- the LDDT launch ------------------------------------------------------

@pytest.mark.parametrize("b, m, sms, blocks", [
    (1, 1, 132, 1), (1, 7681, 132, 237), (2, 7681, 132, 473),
    (2, 12000, 132, 528), (8, 12000, 132, 528), (1000, 7681, 1, 4),
    (1, 1 << 20, 132, 528)])
def test_lddt_long_blocks(b, m, sms, blocks):
    """A block a LDDT_WARPS tiles of 128 x 128, at most 4 an SM: more than
    one block a pair and the whole card from M = 7,681 at any B."""
    assert lddt_long_blocks(b, m, sms) == blocks
    if m > postalign.MAX_LDDT_COLS and sms == 132:
        assert blocks > sms


@pytest.mark.parametrize("m", [7681, 12000])
def test_lddt_long_launch(fake_card, m):  # noqa: F811
    """Past 7,680 columns the wrapper launches lddt_long with the counts
    and the work buffer and lddt_long_blocks' blocks, whatever cluster it
    is given, counted on lddt_long."""
    meta = torch.device("meta")
    cq = torch.empty((2, m, 3), dtype=torch.float32, device=meta)
    postalign.lddt_batch(
        cq, cq, torch.empty((2, m), dtype=torch.bool, device=meta),
        torch.empty(2, dtype=torch.int32, device=meta), cluster=2)
    name, args = fake_card.calls[-1]
    assert name == "lddt_long"
    assert len(args) == len(kernels._SIGNATURES[name])
    assert args[8:12] == (2, m, 1, lddt_long_blocks(2, m, 132))
    assert postalign.lddt_long.launches == 1


# -- the user path that reaches the long Mu filter ---------------------------

@pytest.fixture(scope="module")
def short8(tmp_path_factory):
    """The 8 shortest q100 chains as a .cal."""
    path = tmp_path_factory.mktemp("omega") / "short8.cal"
    with open(path, "w") as f:
        write_cal(sorted(read_chains(Q100), key=len)[:8], f)
    return str(path)


def _search(main, cal, out, extra, omega=True):
    argv = ["search", cal, "--verysensitive", "-o", out, "--columns",
            COLUMNS] + (["--omega", "12"] if omega else []) + extra
    assert main(argv) == 0
    with open(out) as f:
        return f.read()


def test_verysensitive_omega_search_matches_reseek_tpu(short8, tmp_path,
                                                       monkeypatch):
    """``search --verysensitive --omega 12``: the Mu filter (stage 1), off
    under --verysensitive alone, runs again in both packages and drops
    pairs; the port's TSV, on its host engine and on its device engine on
    the CPU (the kernels' plain versions), is reseek_tpu's byte for
    byte."""
    from reseek_tpu_torch.search import engine as engine_mod
    want = _search(tpu_cli.main, short8, str(tmp_path / "tpu.tsv"),
                   ["--engine", "host"])
    calls = []
    mu = engine_mod.mu_sw_scores
    monkeypatch.setattr(engine_mod, "mu_sw_scores",
                        lambda *a, **k: calls.append(a[0].shape) or mu(*a,
                                                                       **k))
    for extra in (["--engine", "host"],
                  ["--engine", "device", "--device", "cpu"]):
        got = _search(port_cli.main, short8, str(tmp_path / "port.tsv"),
                      extra)
        assert got == want
    assert calls, "the device engine ran no stage 1"
    every = _search(tpu_cli.main, short8, str(tmp_path / "all.tsv"),
                    ["--engine", "host"], omega=False)
    assert 0 < len(want.splitlines()) < len(every.splitlines())
    assert io.StringIO(want).readline().count("\t") == 7
