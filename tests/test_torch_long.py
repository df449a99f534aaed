"""The port's device path past the kernels' shared-memory column limits,
on the CPU (the kernels' plain versions): LDDT's column cap in the
stage-3 chunks, the shape tests that pick each kernel's long variant and
what each variant's launch hands its C entry, the stage-3 traceback
budget, and the float sweep's limit in the stage-2 prepass.  The long
chains themselves run on the card (chip_smoke.py --long); here the
chains are the 8 shortest of tests/golden/q100.cal."""

import io
import os

import numpy as np
import pytest
import torch

from reseek_tpu.align.output import parse_columns
from reseek_tpu.constants import DSSParams as TpuParams
from reseek_tpu.io.reader import read_chains as tpu_read_chains
from reseek_tpu.search import driver as tpu_driver
from reseek_tpu.search.driver import SearchOptions
from reseek_tpu_torch import kernels
from reseek_tpu_torch.constants import DSSParams
from reseek_tpu_torch.io.reader import read_chains
from reseek_tpu_torch.ops import kernel_wrappers
from reseek_tpu_torch.ops import postalign, sw_align, sw_sweep
from reseek_tpu_torch.ops.smx import flat_layout, mu_table
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
    for w in kernel_wrappers().values():
        monkeypatch.setattr(w, "launches", 0)
    return lib


def _launch(kernel: str, cols: int):
    """Call ``kernel``'s wrapper on meta tensors with ``cols`` B columns
    (LDDT: columns) and a 512-row A side."""
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
    prof = torch.empty((2, len(p.features), cols), dtype=torch.uint8,
                       device=meta)
    ia = torch.empty(2, dtype=torch.int64, device=meta)
    args = (ia, ia, table, 512, cols, p.gap_open, p.gap_ext)
    if kernel == "sw_align":
        return sw_align.sw_align(prof, *args)
    return sw_align.sw_score_profiles(prof, prof, *args)


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
