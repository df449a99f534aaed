"""The port's device path past the kernels' shared-memory column limits,
on the CPU (the kernels' plain versions): LDDT's column cap in the
stage-3 chunks, the shape tests that pick each kernel's long variant and
what each variant's launch hands its C entry, the stage-3 traceback
budget, and the float sweep's limit in the stage-2 prepass.  The long
chains themselves run on the card (chip_smoke.py --long); here the
chains are the 8 shortest of tests/golden/q100.cal.

Past 8,192 columns sw_align and sw_score_profiles run the band kernel
(csrc/sw_align.cu): a pair's rows in bands running at once, each band
handing the boundary below it (H of its two last rows, E of its last) to
the next through device memory, and the bands' bests folded by whichever
band finishes last.  ``_emulate_bands`` runs that protocol in Python,
bands of a few rows under a random schedule, against the plain versions
and reseek_tpu's Pallas kernels (interpret mode)."""

import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reseek_tpu.align.output import parse_columns
from reseek_tpu.constants import ALPHA_SIZES
from reseek_tpu.constants import DSSParams as TpuParams
from reseek_tpu.io.reader import read_chains as tpu_read_chains
from reseek_tpu.ops.substmx import build_smx
from reseek_tpu.ops.sw_np import NEG
from reseek_tpu.ops.sw_pallas import sw_score_pallas, sw_traceback_pallas
from reseek_tpu.search import driver as tpu_driver
from reseek_tpu.search.driver import SearchOptions
from reseek_tpu_torch import kernels
from reseek_tpu_torch.constants import DSSParams
from reseek_tpu_torch.io.reader import read_chains
from reseek_tpu_torch.ops import kernel_wrappers
from reseek_tpu_torch.ops import postalign, sw_align, sw_sweep
from reseek_tpu_torch.ops.smx import (PAD_BYTE, flat_layout, mu_table,
                                      profile_codes, profile_smx)
from reseek_tpu_torch.ops.sw_wavefront import diag_count
from reseek_tpu_torch.search import driver as torch_driver
from reseek_tpu_torch.search import engine as engine_mod
from reseek_tpu_torch.search.host import _encode_all

Q100 = os.path.join(os.path.dirname(__file__), "golden", "q100.cal")
COLUMNS = "query+target+qlo+qhi+tlo+thi+evalue+cigar"
torch.set_num_threads(1)


def _shortest(chains, n=8):
    return sorted(chains, key=len)[:n]


def _verysensitive(fn, chains, **kw):
    out = io.StringIO()
    options = SearchOptions(columns=parse_columns(COLUMNS),
                            mode="verysensitive", max_evalue=float("inf"))
    fn(chains, TpuParams.create("verysensitive"), options, out, **kw)
    return out.getvalue()


def test_lddt_columns_capped_at_the_shorter_chains(monkeypatch):
    """Stage 3 hands LDDT each chunk's largest shorter-chain length, not
    its edge, and the TSV stays reseek_tpu's: its host engine's and its
    JAX device engine's."""
    chunks, ms = [], []
    plan = engine_mod.DeviceSelfSearch._stage3_chunks
    lddt = engine_mod.lddt_batch

    def chunks_of(self, pairs):
        out = plan(self, pairs)
        chunks.extend((lea, leb, self.lens[c]) for lea, leb, c in out)
        return out

    def recorded(cq, *args, **kw):
        ms.append(int(cq.shape[1]))
        return lddt(cq, *args, **kw)

    monkeypatch.setattr(engine_mod.DeviceSelfSearch, "_stage3_chunks",
                        chunks_of)
    monkeypatch.setattr(engine_mod, "lddt_batch", recorded)
    got = _verysensitive(torch_driver.self_search,
                         _shortest(read_chains(Q100)), engine="device",
                         device="cpu")
    want = [int(lens.min(1).max()) for _, _, lens in chunks]
    assert ms == want and len(ms) > 0
    assert all(m < min(lea, leb) for m, (lea, leb, _) in zip(ms, chunks))
    tpu = _shortest(tpu_read_chains(Q100))
    assert got == _verysensitive(tpu_driver.self_search, tpu, engine="host")
    assert got == _verysensitive(tpu_driver.self_search, tpu,
                                 engine="device")
    assert len(got.splitlines()) == 64


@pytest.mark.parametrize("test, n, long", [
    (postalign.lddt_uses_global, 7680, False),
    (postalign.lddt_uses_global, 7681, True),
    (sw_align.sw_align_uses_global, 8192, False),
    (sw_align.sw_align_uses_global, 8193, True),
    (sw_sweep.mu_uses_global, 8192, False),
    (sw_sweep.mu_uses_global, 8193, True),
])
def test_variant_choice_at_the_limits(test, n, long):
    """Each kernel's long variant starts one column past its shared-memory
    limit: 7,680 for LDDT, 8,192 for sw_align / sw_score_profiles and the
    Mu filter."""
    assert test(n) is long


@pytest.mark.parametrize("lb, takes", [(8192, True), (8193, False)])
def test_sweep_limit(lb, takes):
    """The float sweep has no long variant: it takes 8,192 columns at
    most, and its layout refuses more."""
    assert sw_sweep.sweep_takes(lb) is takes
    if takes:
        assert sw_sweep.sweep_layout(lb) == (16, 16)
    else:
        with pytest.raises(ValueError, match="outside"):
            sw_sweep.sweep_layout(lb)


class _FakeLib:
    """Records the C entry called and its arguments; returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def fake_card(monkeypatch):
    """kernels.launch against a recording library, with no card: the
    wrappers see "meta" tensors (not CPU ones), so they take their launch
    path."""
    lib = _FakeLib()

    class Ctx:
        def __init__(self, device):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(kernels.torch.cuda, "device", Ctx)
    monkeypatch.setattr(kernels, "lib", lambda: lib)
    monkeypatch.setattr(kernels, "stream_of", lambda t: "stream")
    # an H100 80GB's SMs and the Mu band kernel's scratch budget (the long
    # LDDT and Mu variants' launch rules read them)
    monkeypatch.setattr(postalign, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(sw_sweep, "_card", lambda dev: (132, 10 << 30))
    for w in kernel_wrappers().values():
        monkeypatch.setattr(w, "launches", 0)
    return lib


def _launch(kernel: str, cols: int, rows: int = 512, **kw):
    """Call ``kernel``'s wrapper on meta tensors with ``cols`` B columns
    (LDDT: columns) and a ``rows``-row A side (SW kernels; ``kw`` to
    them)."""
    p = DSSParams.create("verysensitive")
    meta = torch.device("meta")
    if kernel == "lddt":
        cq = torch.empty((2, cols, 3), dtype=torch.float32, device=meta)
        return postalign.lddt_batch(
            cq, cq, torch.empty((2, cols), dtype=torch.bool, device=meta),
            torch.empty(2, dtype=torch.int32, device=meta), cluster=1)
    if kernel == "mu_sweep":
        a = torch.empty((2, 512), dtype=torch.uint8, device=meta)
        b = torch.empty((2, cols), dtype=torch.uint8, device=meta)
        table = sw_sweep.MuTable.build(torch.from_numpy(mu_table()))
        return sw_sweep.mu_sw_scores(a, b, table.to(meta), -2, -1)
    offsets, _d, w = flat_layout(p.features, p.weights)
    table = sw_align.FeatureTable.build(
        torch.from_numpy(w), torch.tensor(offsets)).to(meta)
    prof = torch.empty((2, len(p.features), max(rows, cols)),
                       dtype=torch.uint8, device=meta)
    ia = torch.empty(2, dtype=torch.int64, device=meta)
    args = (ia, ia, table, rows, cols, p.gap_open, p.gap_ext)
    if kernel == "sw_align":
        return sw_align.sw_align(prof, *args, **kw)
    return sw_align.sw_score_profiles(prof, prof, *args, **kw)


@pytest.mark.parametrize("kernel, entry, long_entry", [
    ("sw_align", "sw_align", "sw_align_long"),
    ("sw_score", "sw_score_profiles", "sw_score_profiles_long"),
    ("lddt", "lddt", "lddt_long"),
    ("mu_sweep", "mu_wavefront", "mu_wavefront_long"),
])
@pytest.mark.parametrize("long", [False, True])
def test_long_variant_launch(fake_card, kernel, entry, long_entry, long):
    """On a tensor off the CPU each wrapper launches its short entry up to
    the limit and its long entry past it, with the arguments the entry's
    C signature declares (the long ones a scratch pointer more), and
    counts the launch on the kernel's wrapper or on its variant's
    counter."""
    limit = 7680 if kernel == "lddt" else 8192
    _launch(kernel, limit + 1 if long else limit)
    name, args = fake_card.calls[-1]
    assert name == (long_entry if long else entry)
    assert len(args) == len(kernels._SIGNATURES[name])
    assert args[-1] == "stream"
    counts = {k: w.launches for k, w in kernel_wrappers().items()}
    want = {k: 0 for k in counts}
    want[kernel + "_long" if long else kernel] = 1
    assert counts == want


@pytest.mark.parametrize("edge, n, want", [
    (131072, 1, 1), (131072, 8, 1), (131072, 100, 1),
    (16384, 100, 8), (65536, 100, 7),
    (512, 3, 8), (512, 100, 128), (512, 1000, 256),
])
def test_stage3_traceback_budget(edge, n, want):
    """A stage-3 chunk of n pairs at a square edge holds at most the
    budget of traceback, here 16 GiB (a fifth of an 80 GB card): one pair
    at edge 131,072 (8 GiB each), seven at 65,536, and below that the cell
    budget's chunks as before."""
    budget = 16 << 30
    got = engine_mod._stage3_batch(n, edge, edge, budget)
    assert got == want
    tb = int(np.prod(sw_align.tb_shape(got, edge, edge)))
    assert got == 1 or tb <= budget
    if edge <= 16384:
        assert got == engine_mod._batch_shape(n, edge,
                                              engine_mod.STAGE3_CELLS)


@pytest.mark.parametrize("mesh", [None, ("cpu", "cpu")])
def test_stage3_budget_from_the_device(mesh):
    """The engine's traceback budget is its devices' memory over
    STAGE3_TB_SHARE (the host's physical memory on the CPU), and its chunk
    plan keeps to it."""
    p = DSSParams.create("sensitive")
    ecs = _encode_all(_shortest(read_chains(Q100)), p, with_self_rev=False)
    pipe = engine_mod.DeviceSelfSearch(ecs, p, device="cpu", mesh=mesh,
                                       with_rev_profiles=False)
    total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert pipe.tb_bytes == total // engine_mod.STAGE3_TB_SHARE
    assert pipe.tb_bytes == engine_mod.stage3_tb_bytes(torch.device("cpu"))
    n = len(ecs)
    pairs = np.stack(np.triu_indices(n), axis=1).astype(np.int64)
    assert max(len(c) for _a, _b, c in pipe._stage3_chunks(pairs)) > 1
    # a budget of one pair's traceback at the widest chunk shape
    pipe.tb_bytes = max(int(np.prod(sw_align.tb_shape(1, lea, leb)))
                        for lea, leb, _c in pipe._stage3_chunks(pairs))
    plan = pipe._stage3_chunks(pairs)
    assert sum(len(c) for _a, _b, c in plan) == len(pairs)
    assert all(len(c) * np.prod(sw_align.tb_shape(1, lea, leb))
               <= pipe.tb_bytes for lea, leb, c in plan)


@pytest.mark.parametrize("limit, exact", [(8192, False), (64, True)])
def test_prepass_past_the_sweep_limit(monkeypatch, limit, exact):
    """The MinFwdScore prepass scores its chunks with the float sweep up to
    the sweep's column limit and with the exact score-only kernel past it
    (the limit cut to 64 here, below the chunks' 128 edge), and keeps the
    pairs those scores keep."""
    p = DSSParams.create("sensitive")
    ecs = _encode_all(_shortest(read_chains(Q100)), p, with_self_rev=False)
    pipe = engine_mod.DeviceSelfSearch(ecs, p, device="cpu",
                                       with_rev_profiles=False)
    n = len(ecs)
    pairs = np.stack(np.triu_indices(n), axis=1).astype(np.int64)
    used = []

    def spy(fn):
        def call(*args):
            used.append(fn.__name__)
            return fn(*args)
        return call

    monkeypatch.setattr(engine_mod, "sw_score_sweep",
                        spy(engine_mod.sw_score_sweep))
    monkeypatch.setattr(engine_mod, "sw_score_profiles",
                        spy(engine_mod.sw_score_profiles))
    monkeypatch.setattr(sw_sweep, "SWEEP_MAX_LB", limit)
    kept = pipe._prepass(pairs, need_all_paths=False, fwd_prefilter=True,
                         evalue_gate=None)
    assert set(used) == {"sw_score_profiles" if exact else "sw_score_sweep"}
    scores = pipe.stage2_scores(pairs, exact=exact)
    want = pairs[scores >= np.float32(p.min_fwd_score)
                 - engine_mod.STAGE2_GUARD]
    assert np.array_equal(kept, want) and 0 < len(kept) < len(pairs)


# -- the band kernel's protocol, emulated --------------------------------

SENTINEL = np.array([0xffffffff], np.uint32).view(np.float32)[0]
F32_NEG = np.float32(-9e9)       # the kernel's NEG
INF = np.iinfo(np.int32).max


def _better(x, y) -> bool:
    """csrc/sw_align.cu's better(): larger v, then smaller i, smaller j."""
    return x[0] > y[0] or (x[0] == y[0] and (x[1] < y[1] or (
        x[1] == y[1] and x[2] < y[2])))


def _band(s, gaps, bnd, band, bands, lanes, r, group, codes, score):
    """One band of the band kernel as a generator: ``lanes`` lanes of ``r``
    rows sweeping the columns of s [LA, LB] one step a yield, lane k at
    column T - k; lane 0 reads the boundary above from bnd[band - 1] a
    group of ``group`` columns ahead (a snapshot, re-read while any value
    is the sentinel: it yields "wait" then), the last lane writes its H,
    H, E to bnd[band].  ``gaps``: (open, ext) float32.  Writes the cells'
    traceback codes into ``codes`` and returns the band's best (v, i, j),
    or its maximum."""
    la, lb = s.shape
    o, e = gaps
    rows = band * lanes * r + np.arange(lanes)[:, None] * r + np.arange(r)
    inside = rows < la
    sp = np.zeros((lanes, r, lb), np.float32)
    sp[inside] = s[rows[inside]]
    h1, h2, f1 = (np.full((lanes, r), F32_NEG) for _ in range(3))
    u1, u2, u1p, oh1, oh2, oe = (np.full(lanes, F32_NEG) for _ in range(6))
    bv = np.where(inside, np.float32(0), np.float32(np.inf))
    bc = np.zeros((lanes, r), np.int64)
    mx = np.float32(0)
    nxt = np.full((group, 3), F32_NEG)
    cur = nxt.copy()

    def fetch(c0):
        for g in range(group):
            if c0 + g < lb:
                nxt[g] = bnd[band - 1, c0 + g]

    def ready(c0):
        return all(c0 + g >= lb or not np.any(
            nxt[g].view(np.uint32) == SENTINEL.view(np.uint32))
            for g in range(group))

    if band > 0:
        fetch(0)
    for t in range(lb + lanes - 1):
        if band > 0 and t % group == 0 and t < lb:
            while not ready(t):
                yield "wait"
                fetch(t)
            cur = nxt.copy()
            fetch(t + group)
        j = t - np.arange(lanes)
        jin = (j >= 0) & (j < lb)
        rh1, rh2, re1 = (np.roll(x, 1) for x in (oh1, oh2, oe))
        top = cur[t % group] if band > 0 and t < lb else [F32_NEG] * 3
        rh1[0], rh2[0], re1[0] = top
        jc = np.clip(j, 0, lb - 1)
        e_up = re1.copy()
        hn, fn, code = (np.empty((lanes, r), t_) for t_ in
                        (np.float32, np.float32, np.uint8))
        for k in range(r):
            hd = h1[:, k - 1] if k >= 1 else u1
            hd2 = h1[:, k - 2] if k >= 2 else (u1 if k == 1 else u2)
            hl2 = h2[:, k - 1] if k >= 1 else u1p
            e_open, e_ext = hd2 + o, e_up + e
            e_pref = e_open >= e_ext
            ev = np.where(e_pref, e_open, e_ext)
            f_open, f_ext = hl2 + o, f1[:, k] + e
            f_pref = f_open >= f_ext
            fv = np.where(f_pref, f_open, f_ext)
            m, src = hd, np.zeros(lanes, np.uint8)
            src = np.where(ev > m, 1, src)
            m = np.where(ev > m, ev, m)
            src = np.where(fv > m, 2, src)
            m = np.where(fv > m, fv, m)
            src = np.where(np.float32(0) >= m, 3, src)
            m = np.where(np.float32(0) >= m, np.float32(0), m)
            hn[:, k] = m + sp[np.arange(lanes), k, jc]
            fn[:, k] = fv
            e_up = ev
            code[:, k] = src | (e_pref * 4) | (f_pref * 8)
        on = jin[:, None]
        sel = on & inside
        codes[rows[sel], np.broadcast_to(j[:, None], rows.shape)[sel]] = \
            code[sel]
        if score:
            if sel.any():
                mx = max(mx, hn[sel].max())
        else:
            up = on & (hn > bv)
            bv = np.where(up, hn, bv)
            bc = np.where(up, j[:, None], bc)
        u1p = np.where(jin, u1, u1p)
        u1 = np.where(jin, rh1, u1)
        u2 = np.where(jin, rh2, u2)
        h2 = np.where(on, h1, h2)
        h1 = np.where(on, hn, h1)
        f1 = np.where(on, fn, f1)
        oh1 = np.where(jin, hn[:, r - 1], oh1)
        oh2 = np.where(jin, hn[:, r - 2], oh2)
        oe = np.where(jin, e_up, oe)
        if band + 1 < bands and jin[-1]:
            bnd[band, j[-1]] = (oh1[-1], oh2[-1], oe[-1])
        yield "step"
    if score:
        return mx
    best = (np.float32(0), INF, INF)
    for lane in range(lanes):
        for k in range(r):
            c = (bv[lane, k], int(rows[lane, k]), int(bc[lane, k]))
            if inside[lane, k] and bv[lane, k] > 0 and _better(c, best):
                best = c
    return best


def _emulate_bands(s, open_, ext, lanes, r, rng, group=8, score=False):
    """The band kernel's protocol on the substitution tensor s [B, LA, LB]
    float32: each pair's bands of lanes x r rows (_band) started in ticket
    order and stepped in a random interleaving, the boundaries
    [bands - 1, LB, 3] set to the sentinel first; the band that finishes
    last folds the bands' bests in a random order.  -> (best, bi, bj
    [B], codes [B, LA, LB] uint8, per-band bests [B][bands])."""
    gaps = (np.float32(open_), np.float32(ext))
    b, la, lb = s.shape
    bands = -(-la // (lanes * r))
    out = np.zeros((3, b), np.float64)
    codes = np.zeros((b, la, lb), np.uint8)
    per_band = []
    for p in range(b):
        bnd = np.full((max(bands - 1, 1), lb, 3), SENTINEL, np.float32)
        gens = [_band(s[p], gaps, bnd, k, bands, lanes, r, group, codes[p],
                      score) for k in range(bands)]
        started, results, waits = [], {}, 0
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
        order = rng.permutation(bands)
        if score:
            out[0, p] = max(results[k] for k in order)
        else:
            fold = (np.float32(0), INF, INF)
            for k in order:
                if _better(results[k], fold):
                    fold = results[k]
            if fold[0] > 0:
                out[:, p] = fold
        per_band.append([results[k] for k in range(bands)])
        assert bands == 1 or waits > 0, "the schedule never raced"
    return (out[0].astype(np.float32), out[1].astype(np.int32),
            out[2].astype(np.int32), codes, per_band)


PARAMS_S = DSSParams.create("sensitive")
SIZES = [ALPHA_SIZES[f] for f in PARAMS_S.features]


def _table():
    off, _d, w = flat_layout(PARAMS_S.features, PARAMS_S.weights)
    return sw_align.FeatureTable.build(torch.from_numpy(w),
                                       torch.from_numpy(off))


def _pairs(seed, n, la, lb, kind):
    """n pairs of seeded profiles [F, L] (PAD_BYTE past each chain's end;
    pair 1's A side all padding when n > 1): each chain the one before
    with a third of its letters redrawn.  kind "few": two letters a
    feature, so that cells tie everywhere; "repeat": each A side two
    copies of its B side's first half end to end (the B side that half),
    so that the best cell's score comes twice, far apart in rows.
    -> (prof [2n, F, L], ia, ib, lens)."""
    rng = np.random.default_rng(seed)
    length = max(la, lb)
    prof = np.full((2 * n, len(SIZES), length), PAD_BYTE, np.uint8)
    top = np.array([2 if kind == "few" else z for z in SIZES])[:, None]
    letters = rng.integers(0, top, (len(SIZES), length))
    lens = np.zeros(2 * n, np.int64)
    for k in range(2 * n):
        redraw = rng.random(letters.shape) < 0.33
        letters = np.where(redraw, rng.integers(0, top, letters.shape),
                           letters)
        lens[k] = rng.integers(length // 2, length + 1)
        prof[k, :, :lens[k]] = letters[:, :lens[k]]
    ia = np.arange(0, 2 * n, 2)[::-1].copy()
    ib = np.arange(1, 2 * n, 2)
    if kind == "repeat":
        half = min(la, lb) // 2
        for a, b in zip(ia, ib):
            prof[b, :, half:] = PAD_BYTE
            prof[a] = PAD_BYTE
            prof[a, :, :half] = prof[a, :, half:2 * half] = prof[b, :, :half]
            lens[a], lens[b] = 2 * half, half
    if n > 1:
        prof[ia[1]] = PAD_BYTE
        lens[ia[1]] = 0
    return prof, ia, ib, lens


def _smx(prof, ia, ib, la, lb, table):
    """The port's substitution tensor of the pairs (the plain versions')."""
    p = torch.from_numpy(prof)
    ca = profile_codes(p[torch.from_numpy(ia), :, :la], table.offsets,
                       table.pad_code)
    cb = profile_codes(p[torch.from_numpy(ib), :, :lb], table.offsets,
                       table.pad_code)
    return profile_smx(ca, cb, table.w).numpy()


def _tpu_smx(prof, ia, ib, lens, la, lb):
    """reseek_tpu's substitution tensor of the pairs: build_smx over each
    pair's own cells, NEG elsewhere."""
    s = np.full((len(ia), la, lb), NEG, np.float32)
    for k, (a, b) in enumerate(zip(ia, ib)):
        na, nb = min(lens[a], la), min(lens[b], lb)
        if na and nb:
            s[k, :na, :nb] = build_smx(PARAMS_S, prof[a, :, :na],
                                       prof[b, :, :nb])
    return s


def _skew(codes):
    """codes [B, LA, LB] -> the skewed bytes [Dp, B, LA] of unpack_tb."""
    b, la, lb = codes.shape
    out = np.zeros((diag_count(la, lb), b, la), np.uint8)
    i = np.arange(la)[:, None]
    j = np.arange(lb)[None, :]
    out[(i + j), :, np.broadcast_to(i, (la, lb))] = codes.transpose(1, 2, 0)
    return out


@pytest.mark.parametrize("n, la, lb, lanes, r, kind", [
    (3, 100, 70, 2, 4, "random"),   # 13 bands of 8 rows, the last of 4
    (3, 96, 64, 2, 4, "repeat"),    # the best in two bands: the fold's tie
    (1, 70, 90, 4, 2, "repeat"),    # one pair, wide
    (3, 72, 80, 2, 4, "few"),       # cells tie everywhere
    (1, 260, 40, 32, 4, "random"),  # the kernel's 128-row bands, ragged
])
def test_band_protocol_matches_plain_and_pallas(n, la, lb, lanes, r, kind):
    """The band protocol, emulated, gives sw_align_ref's best, (i, j) and
    traceback bytes on every cell, and reseek_tpu's Pallas traceback
    kernel's on each pair's own cells."""
    seed = la * 7 + lb + len(kind)
    prof, ia, ib, lens = _pairs(seed, n, la, lb, kind)
    table = _table()
    s = _smx(prof, ia, ib, la, lb, table)
    g_open, g_ext = PARAMS_S.gap_open, PARAMS_S.gap_ext
    best, bi, bj, codes, per_band = _emulate_bands(
        s, g_open, g_ext, lanes, r, np.random.default_rng(seed))
    ref = sw_align.sw_align_ref(torch.from_numpy(prof), torch.from_numpy(ia),
                                torch.from_numpy(ib), table, la, lb, g_open,
                                g_ext)
    assert np.array_equal(best, ref[0].numpy())
    assert np.array_equal(bi, ref[1].numpy())
    assert np.array_equal(bj, ref[2].numpy())
    skew = _skew(codes)
    assert np.array_equal(skew, sw_align.unpack_tb(ref[3], la, lb).numpy())
    jb, jbi, jbj, jtb = (np.asarray(x) for x in sw_traceback_pallas(
        jnp.asarray(_tpu_smx(prof, ia, ib, lens, la, lb)), g_open, g_ext))
    assert np.array_equal(best, jb) and np.array_equal(bi, jbi)
    assert np.array_equal(bj, jbj)
    d = np.arange(skew.shape[0])[:, None]
    i = np.arange(la)[None, :]
    for k in range(n):
        na, nb = min(lens[ia[k]], la), min(lens[ib[k]], lb)
        own = (i < na) & (d - i >= 0) & (d - i < nb)
        assert np.array_equal(skew[:, k][own], jtb[:len(skew), k][own])
    if n > 1:
        assert best[1] == 0 and bi[1] == 0 and bj[1] == 0
    if kind == "repeat":
        for k in range(n):
            if best[k] > 0:
                rows = [i_ for v, i_, _j in per_band[k] if v == best[k]]
                assert len(rows) == 2 and bi[k] == min(rows), k


@pytest.mark.parametrize("n, la, lb, lanes, r", [
    (3, 96, 72, 2, 4),
    (1, 110, 50, 4, 4),
])
def test_band_protocol_score_only(n, la, lb, lanes, r):
    """Score only: the emulated bands' maxima, folded in a random order,
    are sw_score_profiles_ref's and reseek_tpu's sw_score_pallas's best
    on the pairs against the other side reversed (tie-prone letters)."""
    prof, ia, ib, lens = _pairs(la + lb, n, la, lb, "few")
    rev = prof.copy()
    for k in range(len(rev)):
        rev[k, :, :lens[k]] = prof[k, :, :lens[k]][:, ::-1]
    table = _table()
    both = np.concatenate([prof, rev])
    ib_rev = ib + len(prof)
    s = _smx(both, ia, ib_rev, la, lb, table)
    g_open, g_ext = PARAMS_S.gap_open, PARAMS_S.gap_ext
    got = _emulate_bands(s, g_open, g_ext, lanes, r,
                         np.random.default_rng(n), score=True)[0]
    want = sw_align.sw_score_profiles_ref(
        torch.from_numpy(prof), torch.from_numpy(rev), torch.from_numpy(ia),
        torch.from_numpy(ib), table, la, lb, g_open, g_ext)
    assert np.array_equal(got, want.numpy())
    lens2 = np.concatenate([lens, lens])
    jw = np.asarray(sw_score_pallas(
        jnp.asarray(_tpu_smx(both, ia, ib_rev, lens2, la, lb)), g_open,
        g_ext))
    assert np.array_equal(got, jw) and (got > 0).any()


@pytest.mark.parametrize("la, lb, r", [
    (1024, 16384, 4),     # past the column limit: 4 from 1,024 columns
    (1025, 8192, 8),      # the shared-memory kernel: 8 past LA 1,024
    (1025, 8193, 4),      # the band kernel
    (8192, 16384, 4),     # phase 13's gate
    (600, 8448, 4),       # the tie-prone gate
    (2048, 8192, 8),      # the shared-memory kernel's one pass
    (2049, 8192, 4),      # more rows: the band kernel
    (4096, 1024, 4),      # the band kernel's 4 rows from 1,024 columns
    (4096, 1023, 8),      # 8 below
    (4096, 512, 8),
    (4096, 255, 8),       # the shared-memory kernel below 256 columns
])
def test_band_rows_per_lane_at_the_limits(la, lb, r):
    """Rows a lane and band height: the band kernel takes 4 from
    BAND_R4_COLS columns and 8 below, the shared-memory kernel keeps its
    rule; neither depends on the pair count.  At edges that are multiples
    of 256 both R give the traceback the same bytes."""
    assert sw_align.rows_per_lane(la, lb) == r
    for b in (1, 8, 128):
        shape = sw_align.tb_shape(b, la, lb)
        assert shape[1] == -(-la // (32 * r)) and shape[4] == r // 2
    if la % 256 == 0:
        assert shape[1] * shape[4] == -(-la // 256) * 4


@pytest.mark.parametrize("la, lb, bands", [
    (512, 512, False),    # phase 2's shapes keep the shared-memory kernel
    (2100, 255, False),   # (its passes through the scratch row)
    (8500, 96, False),
    (2048, 2048, False),  # one pass of eight warps
    (2100, 256, True),    # passes over BAND_MIN_COLS columns: bands
    (8192, 8192, True),   # stage-3 chunks at edge 8,192 (up to 8 pairs)
    (4096, 4096, True),
    (600, 8193, True),    # past the column limit, any shape
])
def test_sw_align_uses_bands(la, lb, bands):
    """The band kernel takes every shape past MAX_LB columns, and below it
    the shapes that the shared-memory kernel would sweep in passes (LA >
    2,048) over at least BAND_MIN_COLS columns, whatever the pair count;
    the band kernel's R is 4 from BAND_R4_COLS columns."""
    assert sw_align.sw_align_uses_bands(la, lb) is bands
    if bands:
        assert sw_align.rows_per_lane(la, lb) == (4 if lb >= 1024 else 8)


@pytest.mark.parametrize("kernel, variant, at", [
    ("sw_align", sw_align.sw_align_long, 11),
    ("sw_score", sw_align.sw_score_long, 12),
])
def test_band_launch_plan(fake_card, kernel, variant, at):
    """A band launch hands its entry R (argument ``at``), the boundaries,
    the column words and the work buffer, and a null stats buffer unless
    given one; a stats buffer of the wrong size raises."""
    _launch(kernel, 8193)
    name, args = fake_card.calls[-1]
    assert name.endswith("_long") and args[at] == 4   # rows_per_lane
    assert args[-2] is None                           # stats
    assert sw_align.band_work_words(2, 4) == 27
    # below the column limit, two pairs of 4,096 rows x 512: R = 8
    _launch(kernel, 512, rows=4096)
    name, args = fake_card.calls[-1]
    assert name.endswith("_long") and args[at] == 8
    assert variant.launches == 2
    meta = torch.device("meta")
    st = torch.empty(sw_align.band_stats_words(2), dtype=torch.int32,
                     device=meta)
    _launch(kernel, 8193, stats=st)
    assert fake_card.calls[-1][1][-2] is not None
    with pytest.raises(ValueError, match="stats"):
        _launch(kernel, 8193, stats=st[1:])


def test_band_stats_reads_the_work_buffer():
    """band_stats: the plan of the shape, the most blocks live at once and
    each pair's SMs, from the stats buffer's SM masks (bits past 31 of a
    word included)."""
    w = torch.zeros(sw_align.band_stats_words(2), dtype=torch.int32)
    w[1] = 5
    w[2] = -1                        # pair 0: SMs 0-31
    w[3] = 0b101                     # and 32, 34
    w[2 + sw_align.SM_WORDS] = 1 << 3   # pair 1: SM 3
    got = sw_align.band_stats(w, 2, 384, 8193)
    assert got == {"pairs": 2, "rows_per_lane": 4, "band_rows": 128,
                   "bands": 3, "blocks": 6, "blocks_in_flight": 5,
                   "sms_per_pair": [34, 1]}

