"""BENCHMARK.json against the benchmark's contract: names, units and
text fields within their characters, every file it names present, every
metric applied where a cell reports it; and the same of BENCHMARK.json
with the held-back cells of portbench/held_back.json added."""

import json
import re

import pytest

from portbench import generate

from portbench.tests.conftest import with_held_back

COMMITTED = json.loads((generate.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def text_ok(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


@pytest.fixture(params=["committed", "with_held_back"])
def M(request):
    return (COMMITTED if request.param == "committed"
            else with_held_back(COMMITTED))


def test_keys_and_sizes(M):
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert 1 <= len(M["command"]) <= 32 and all(map(text_ok, M["command"]))
    assert M["paths"] == ["portbench"]
    assert len((generate.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_unique_and_allowed(M, group):
    names = [x["name"] for x in M[group]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs(M):
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert text_ok(c["source"]) and text_ok(c["why"])
        assert c["file"].startswith("portbench/")
        assert (generate.ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in M["workloads"])


def test_workloads(M):
    pairs = set()
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and text_ok(w["why"])
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        pairs.add((w["config"], w["traffic"]))
        traffic = (generate.ROOT / "portbench" / "traffic"
                   / f"{w['config']}.{w['traffic']}.json")
        kind = json.loads(traffic.read_text())["kind"]
        assert (generate.ROOT / "portbench" / "kinds" / f"{kind}.py").is_file()
    assert len(pairs) == len(M["workloads"])


def reports(metric, cell):
    return cell in metric.get("workloads", [cell])


def test_metrics(M):
    cells = {w["name"] for w in M["workloads"]}
    e2e = {m["name"] for m in M["end_to_end"]}
    assert "setup_s" in e2e
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        assert (generate.ROOT / "portbench" / "metrics"
                / f"{m['name']}.py").is_file()
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert text_ok(m["layer"]) and m["moves"] in e2e
        for cell in m["workloads"]:
            moved = next(x for x in M["end_to_end"] if x["name"] == m["moves"])
            assert reports(moved, cell)
    for cell in cells:
        assert len([m for m in M["end_to_end"] if reports(m, cell)]) >= 2
        assert any(reports(m, cell) for m in M["per_layer"])
