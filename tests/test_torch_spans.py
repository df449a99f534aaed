"""The port's span recorder (reseek_tpu_torch/utils/spans.py): totals,
nesting and self time, the profiler's ranges only while a profiler runs
and only on the recorder's own thread, the synchronize only where asked;
the self-search's ``device_stats`` built from it; the benchmark's trace
summary unchanged by the program's ranges; the metric readers of its
stats; and tools/trace_spans.py's idle by span."""

import importlib.util
import io
import threading
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from reseek_tpu_torch.constants import DSSParams
from reseek_tpu_torch.io.reader import read_chains
from reseek_tpu_torch.search import driver, host
from reseek_tpu_torch.utils import spans as spans_mod
from reseek_tpu_torch.utils.spans import Spans

ROOT = Path(__file__).resolve().parent.parent
Q100 = str(ROOT / "tests" / "golden" / "q100.cal")
SUBSET = [18, 21, 22, 26, 40, 46, 50, 64, 69, 72, 94, 95, 96, 97, 98, 99]
COLUMNS = "query+target+qlo+qhi+tlo+thi+evalue+cigar"
# one torch thread a test worker, as in the other files of the port
torch.set_num_threads(1)

OLD_KEYS = {"encode_s", "stage1_s", "stage3_s", "finish_s", "survivors"}
NEW_KEYS = {"wall_s", "selfrev_wait_s", "finish_bands_s",
            "finish_recompute_s", "mkf_wait_s", "emit_s", "stage3_pairs",
            "finish_pairs", "recomputed_pairs", "emitted_pairs"}
PARTS = ("encode_s", "stage1_s", "selfrev_wait_s", "stage3_s", "finish_s",
         "mkf_wait_s", "emit_s")


@pytest.fixture
def clock(monkeypatch):
    """The recorder's clock, advanced by hand."""
    now = [0.0]
    monkeypatch.setattr(spans_mod.time, "perf_counter", lambda: now[0])
    return now


@pytest.fixture
def no_ranges(monkeypatch):
    """Every way into a profiler range raises."""
    def refuse(*_a, **_k):
        raise AssertionError("a profiler range was opened")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)


def test_totals_nesting_and_self_time(clock):
    rec = Spans()
    with rec.call("self_search"):
        with rec.span("encode"):
            clock[0] += 1.0
        for _ in range(2):      # a span entered twice adds up
            with rec.span("finish"):
                clock[0] += 1.0
                with rec.span("finish.bands"):
                    clock[0] += 1.5
                rec.add("finish.recompute", 0.25)
                rec.count("recomputed_pairs", 3)
        rec.count("finish_pairs", 10)
        clock[0] += 0.5
    assert rec.seconds == {"encode": 1.0, "finish": 5.0,
                           "finish.bands": 3.0, "finish.recompute": 0.5}
    assert rec.counts == {"recomputed_pairs": 6, "finish_pairs": 10}
    assert rec.wall == 6.5
    assert rec.self_seconds("finish") == 1.5
    assert rec.self_seconds("finish.bands") == 3.0
    assert rec.self_seconds() == 0.5       # the call less its parts
    assert rec.stats() == {
        "encode_s": 1.0, "finish_s": 5.0, "finish_bands_s": 3.0,
        "finish_recompute_s": 0.5, "recomputed_pairs": 6,
        "finish_pairs": 10, "wall_s": 6.5}
    assert "wall_s" not in Spans().stats()


def test_span_records_when_the_body_raises(clock):
    rec = Spans()
    with pytest.raises(KeyError):
        with rec.span("emit"):
            clock[0] += 2.0
            raise KeyError("x")
    assert rec.seconds == {"emit": 2.0}


def test_synchronize_only_where_asked(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    rec = Spans()
    with rec.span("finish"):
        pass
    with rec.span("stage1", sync={torch.device("cpu")}):
        pass
    assert synced == []
    card = torch.device("cuda", 0)
    with rec.span("stage3", sync=[torch.device("cpu"), card]):
        pass
    assert synced == [card, card]           # at the start and at the end


def test_no_range_without_a_profiler(no_ranges):
    assert not spans_mod.profiler_active()
    rec = Spans()
    with rec.call("self_search"):
        with rec.span("stage1"):
            pass
    assert set(rec.seconds) == {"stage1"}


def test_ranges_on_the_profiler_clock():
    """While a profiler runs, each span of the recorder's thread is a
    host-side range of record scope FUNCTION (the profiler adds no
    device copy of such a range), nested as the spans are; a span on
    another thread is timed but opens no range."""
    rec = Spans()

    def pool_work():
        with rec.span("pool"):
            pass

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert spans_mod.profiler_active()
        with rec.call("self_search"):
            with rec.span("finish"):
                with rec.span("finish.bands"):
                    torch.ones(4).sum()
            t = threading.Thread(target=pool_work)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    assert "pool" in rec.seconds
    ours = {e.name: e for e in prof.events()
            if e.name.startswith(spans_mod.PREFIX)}
    assert set(ours) == {"reseek/self_search", "reseek/finish",
                         "reseek/finish.bands"}
    for e in ours.values():
        assert e.device_type == DeviceType.CPU
        assert e.scope == 0         # at::RecordScope::FUNCTION
    assert ours["reseek/finish.bands"].cpu_parent.name == "reseek/finish"
    assert ours["reseek/finish"].cpu_parent.name == "reseek/self_search"
    outer, inner = (ours["reseek/self_search"].time_range,
                    ours["reseek/finish.bands"].time_range)
    assert outer.start <= inner.start <= inner.end <= outer.end


def _options():
    return host.SearchOptions(columns=COLUMNS.split("+"), mode="sensitive",
                              max_evalue=10.0)


@pytest.fixture(scope="module")
def q100():
    return read_chains(Q100)


def test_self_search_stats(q100, no_ranges):
    """The 16-chain subset on the CPU: rows as the host engine's, the
    earlier keys and every new one, the parts within their wholes, and
    the call's wall covered by its parts."""
    chains = [q100[i] for i in SUBSET]
    params = DSSParams.create("sensitive")
    out, want = io.StringIO(), io.StringIO()
    drv = driver.self_search(chains, params, _options(), out,
                             engine="device", device="cpu")
    driver.self_search(chains, params, _options(), want, engine="host")
    assert out.getvalue() == want.getvalue()
    assert len(out.getvalue().splitlines()) == 90
    st = drv.device_stats
    assert OLD_KEYS | NEW_KEYS <= set(st)
    assert st["finish_bands_s"] + st["finish_recompute_s"] <= st["finish_s"]
    assert 0 <= st["recomputed_pairs"] <= st["finish_pairs"]
    assert 0 < st["emitted_pairs"] <= st["stage3_pairs"]
    assert st["stage3_pairs"] == st["survivors"]
    assert sum(st[k] for k in PARTS) >= 0.95 * st["wall_s"]


def test_self_search_ranges_under_a_profiler(q100):
    """Four short chains under a CPU profiler: the call's ranges, each
    part inside the call's."""
    chains = sorted(q100, key=len)[:4]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        drv = driver.self_search(chains, DSSParams.create("sensitive"),
                                 _options(), io.StringIO(), engine="device",
                                 device="cpu")
    got = {}
    for e in prof.events():
        if e.name.startswith(spans_mod.PREFIX):
            got.setdefault(e.name[len(spans_mod.PREFIX):], []).append(
                e.time_range)
    assert {"self_search", "encode", "stage1", "selfrev_wait", "stage3",
            "finish", "finish.bands", "mkf_wait", "emit"} <= set(got)
    (call,) = got.pop("self_search")
    for ranges in got.values():
        for r in ranges:
            assert call.start <= r.start <= r.end <= call.end
    assert drv.device_stats["wall_s"] > 0


# -- the benchmark's trace summary and readers ---------------------------

def _event(name, start, end, cuda=False):
    return SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
        time_range=SimpleNamespace(start=start, end=end))


CALLS = [("self_search#0", 0, 1000), ("self_search#1", 1000, 2000)]
KERNELS = [("mu_wavefront_kernel<S16x2, 8>", 100, 200),
           ("sw_align_kernel<4, 8, false>", 150, 300),
           ("Memcpy DtoH", 600, 610), ("lddt_kernel", 1500, 1600)]
PROGRAM = [("reseek/self_search", 10, 990), ("reseek/stage1", 50, 400),
           ("reseek/finish", 500, 900), ("reseek/finish.bands", 600, 700),
           ("reseek/self_search", 1010, 1990), ("reseek/stage3", 1400, 1700)]


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _base():
    ev = [_event(n, a, b) for n, a, b in CALLS]
    ev += [_event(n, a, b, cuda=True) for n, a, b in CALLS]   # copies
    ev += [_event(n, a, b, cuda=True) for n, a, b in KERNELS]
    return ev


def test_summary_unchanged_by_the_program_ranges():
    """The program's ranges lie on the host's timeline: the benchmark's
    summary (busy, window, kernels, device ops, idle gaps) reads the same
    with them as without."""
    from portbench.trace import summarize
    names = {n for n, _a, _b in CALLS}
    plain = summarize(_Prof(_base()), names)
    ours = summarize(_Prof(_base() + [_event(n, a, b)
                                      for n, a, b in PROGRAM]), names)
    assert ours == plain
    assert plain["busy_s"] == pytest.approx(310e-6)
    assert plain["window_s"] == pytest.approx(2000e-6)


def _trace_spans():
    spec = importlib.util.spec_from_file_location(
        "trace_spans", ROOT / "tools" / "trace_spans.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_idle_by_span_adds_up():
    """tools/trace_spans.py: the idle inside each span, and the idle by
    innermost span summing to the window's idle; device copies of the
    program's ranges are counted apart, never as busy."""
    mod = _trace_spans()
    names = {n for n, _a, _b in CALLS}
    copies = [_event(n, a, b, cuda=True) for n, a, b in PROGRAM[:2]]
    got = mod.program_spans(_Prof(_base() + copies + [
        _event(n, a, b) for n, a, b in PROGRAM]), names)
    assert got["device_copies"] == 2
    sp = {k: (n, w * 1e6, i * 1e6, m * 1e6)
          for k, (n, w, i, m) in got["spans"].items()}
    assert sp["stage1"] == pytest.approx((1, 350, 150, 150))
    assert sp["stage3"] == pytest.approx((1, 300, 200, 200))
    assert sp["finish.bands"] == pytest.approx((1, 100, 90, 90))
    assert sp["finish"] == pytest.approx((1, 400, 390, 300))
    assert sp["self_search"] == pytest.approx((2, 1960, 1650, 910))
    assert sp["-"] == pytest.approx((0, 0, 0, 40))
    idle = 2000 - 310
    assert sum(v[3] for v in sp.values()) == pytest.approx(idle)
    assert sp["self_search"][2] + sp["-"][3] == pytest.approx(idle)


def _reader(name):
    from portbench.harness import Bench
    return Bench().reader(name)


NEW_METRICS = ["selfrev_wait_ms_per_kpair.scop40", "emit_ms_per_kpair.scop40",
               "finish_bands_ms_per_kpair.scop40",
               "finish_recompute_ms_per_kpair.scop40",
               "finish_recompute_pct.scop40", "stage3_yield_pct.scop40"]


@pytest.mark.parametrize("metric, want", zip(NEW_METRICS, [
    1e3 * 0.3 / 3.0, 1e3 * 0.9 / 3.0, 1e3 * 1.5 / 3.0, 1e3 * 0.6 / 3.0,
    100.0 * 30 / 1500, 100.0 * 1200 / 2000]))
def test_new_metric_readers(metric, want):
    stats = {"selfrev_wait_s": 0.1, "emit_s": 0.3, "finish_bands_s": 0.5,
             "finish_recompute_s": 0.2, "recomputed_pairs": 10,
             "finish_pairs": 500, "emitted_pairs": 400, "stage3_pairs": 1000}
    half = {"selfrev_wait_s": 0.2, "emit_s": 0.6, "finish_bands_s": 1.0,
            "finish_recompute_s": 0.4, "recomputed_pairs": 20,
            "finish_pairs": 1000, "emitted_pairs": 800, "stage3_pairs": 1000}
    run = {"calls": [{"work": {"pairs": 1000}, "stats": stats},
                     {"work": {"pairs": 2000}, "stats": half},
                     {"work": {}, "stats": {}, "failed": True}],
           "trace": None}
    assert _reader(metric)(run) == pytest.approx(want)
    # the parent's stats have none of the keys: nothing to read
    parent = {"calls": [{"work": {"pairs": 1000},
                         "stats": {"encode_s": 0.1, "finish_s": 1.0}}],
              "trace": None}
    assert _reader(metric)(parent) is None
