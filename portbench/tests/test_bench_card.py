"""On the card: one short run of each cell through the command, its last
line the contract's result, correct.  Skips without a CUDA card."""

import json
import subprocess
import sys

import pytest

from portbench import generate

M = json.loads((generate.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_cell_runs_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload", cell, "--seed",
         "2147483711", "--seconds", "1", "--trace", "0"],
        cwd=generate.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "check"
