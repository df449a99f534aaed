"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's data
files cut to a size the CPU runs in seconds, and the card, decided inside
a fixture (tests marked ``card`` skip without one)."""

import copy
import json
import shutil

import pytest

from portbench import generate


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


# every size cut to what the CPU's plain kernel versions run in seconds
TINY = {"scop40": {"pool_domains": 300, "domains_per_search": 16},
        "pdb90": {"db_chains": 300}}
TINY_TRAFFIC = {"domains_per_search": 12,
                "check": {"jobs": 1, "chains_per_job": 16, "batches": 1}}


def with_held_back(manifest: dict) -> dict:
    """``manifest`` with the entries of portbench/held_back.json added as
    a later change would add them: its cells, configurations and metrics,
    and each cell of its ``extend`` in the workloads of the metric named."""
    held = json.loads((generate.ROOT / "portbench" / "held_back.json")
                      .read_text())
    m = copy.deepcopy(manifest)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        m[group] += held[group]
    for metric in m["end_to_end"] + m["per_layer"]:
        metric.get("workloads", []).extend(
            held["extend"].get(metric["name"], []))
    return m


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout root holding BENCHMARK.json, with the held-back cells
    added, and the benchmark's data files, every configuration and
    traffic cut to TINY sizes; the code stays the package's."""
    src = generate.ROOT
    manifest = json.loads((src / "BENCHMARK.json").read_text())
    (tmp_path / "BENCHMARK.json").write_text(
        json.dumps(with_held_back(manifest)))
    for sub in ("configs", "traffic", "metrics", "data"):
        shutil.copytree(src / "portbench" / sub, tmp_path / "portbench" / sub)
    for name, cut in TINY.items():
        p = tmp_path / "portbench" / "configs" / f"{name}.json"
        p.write_text(json.dumps({**json.loads(p.read_text()), **cut}))
    for p in (tmp_path / "portbench" / "traffic").glob("scop40.*.json"):
        t = json.loads(p.read_text())
        t["domains_per_search"] = TINY_TRAFFIC["domains_per_search"]
        t["check"] = {k: TINY_TRAFFIC["check"][k] for k in t["check"]}
        p.write_text(json.dumps(t))
    return tmp_path


@pytest.fixture
def card():
    """The CUDA card, or a skip."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: runs on the chip")
    return torch.cuda.get_device_name(0)
