"""The harness: whole-call rates over a window that runs its last call to
the end, and a cell added as files alone."""

import json
import time
import types

import pytest

from portbench import harness, readers


class FakeWorkload:
    """A kind whose calls sleep ``dt`` and do ``work`` pairs each."""
    dt, work = 0.05, 1000

    def __init__(self, config, traffic, seed, device, program="port",
                 root=None):
        self.n = 0

    def next_call(self):
        self.n += 1
        return self.n

    def run(self, k):
        time.sleep(self.dt)
        return {"work": {"pairs": self.work}, "stats": {"finish_s": 0.01},
                "lengths": [10]}

    def check(self, records):
        return {"numbers": {"rows_differing": (0, 0)}, "info": {}}


@pytest.fixture
def fake_kind(monkeypatch):
    mod = types.SimpleNamespace(Workload=FakeWorkload)
    monkeypatch.setattr(harness, "kind_module", lambda traffic: mod)


@pytest.mark.parametrize("seconds", [0.0, 0.12, 0.26])
def test_rate_over_whole_calls(tiny_root, fake_kind, seconds):
    rec = harness.run("scop40.sensitive", 1, seconds, trace=False,
                      device="cpu", root=tiny_root)
    calls = rec["calls"]
    start = calls[0]["start"]
    # calls start back to back until the mark; the last runs to its end
    assert calls[-1]["end"] - start >= seconds
    assert all(c["end"] - start < seconds for c in calls[:-1])
    assert rec["window_s"] == pytest.approx(calls[-1]["end"] - start)
    want = len(calls) * FakeWorkload.work / rec["window_s"]
    assert readers.rate(rec, "pairs") == pytest.approx(want)
    assert readers.ms_per(rec, "finish_s", "pairs", 1e3) == pytest.approx(
        1e3 * 0.01 * len(calls) / (len(calls) * FakeWorkload.work / 1e3))
    assert harness.is_correct(rec)
    assert rec["setup_s"] > 0


def test_pdb90_window_holds_several_calls(tiny_root, fake_kind):
    rec = harness.run("pdb90.fast", 2, 0.2, trace=False, device="cpu",
                      root=tiny_root)
    assert len(rec["calls"]) >= 4


def test_failed_call_is_not_correct(tiny_root, fake_kind, monkeypatch):
    def boom(self, k):
        if k > 2:           # after the warm-up and one sound call
            raise RuntimeError("planted")
        return {"work": {"pairs": 1}, "stats": {}, "lengths": [10]}
    monkeypatch.setattr(FakeWorkload, "run", boom)
    rec = harness.run("scop40.sensitive", 1, 1.0, trace=False, device="cpu",
                      root=tiny_root)
    assert rec["failed"] == 1 and not harness.is_correct(rec)
    assert len(rec["calls"]) == 2


def test_cell_added_as_files(tiny_root):
    """A configuration, a traffic and a metric added as files and an
    entry in BENCHMARK.json: the harness finds and runs them."""
    pb = tiny_root / "portbench"
    cfg = json.loads((pb / "configs" / "scop40.json").read_text())
    cfg.update(name="tiny40", pool_domains=120, domains_per_search=8)
    (pb / "configs" / "tiny40.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "tiny40.fast.json").write_text(json.dumps(
        {"kind": "self_search", "mode": "fast",
         "check": {"jobs": 1, "chains_per_job": 8}}))
    (pb / "metrics" / "rows_per_job.tiny40.py").write_text(
        "def read(run):\n"
        "    return sum(len(c['text'].splitlines()) for c in run['calls'])"
        " / len(run['calls'])\n")
    m = json.loads((tiny_root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "tiny40", "source": "a test",
                         "file": "portbench/configs/tiny40.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "tiny40.fast", "config": "tiny40",
                           "traffic": "fast", "chips": 1, "why": "a test"})
    m["end_to_end"][0]["workloads"].append("tiny40.fast")
    m["per_layer"].append({"name": "rows_per_job.tiny40", "unit": "rows",
                           "better": "higher", "source": "program_counter",
                           "layer": "host finish", "moves": "pairs_per_s",
                           "workloads": ["tiny40.fast"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(m))
    bench = harness.Bench(tiny_root)
    cell = bench.cell("tiny40.fast")
    assert cell["config"]["name"] == "tiny40"
    assert [x["name"] for x in cell["per_layer"]] == ["rows_per_job.tiny40"]
    rec = harness.run("tiny40.fast", 5, 0.0, trace=False, device="cpu",
                      root=tiny_root)
    assert harness.is_correct(rec)
    assert rec["calls"][0]["work"]["pairs"] == 36
    assert bench.reader("rows_per_job.tiny40")(rec) >= 8
    assert bench.reader("pairs_per_s")(rec) > 0
