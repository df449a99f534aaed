"""The port's all-vs-all self-search end to end on the CPU (plain versions
of the kernels), byte for byte against reseek_tpu's host engine and its
JAX device engine; the port imports and runs with JAX blocked."""

import io
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from reseek_tpu.align.output import parse_columns
from reseek_tpu.constants import DSSParams
from reseek_tpu.io.reader import read_chains
from reseek_tpu.search import driver as tpu_driver
from reseek_tpu.search.driver import SearchOptions
from reseek_tpu_torch import kernels
from reseek_tpu_torch.device import resolve
from reseek_tpu_torch.search import driver as torch_driver

ROOT = Path(__file__).resolve().parent.parent
Q100 = str(ROOT / "tests" / "golden" / "q100.cal")
SUBSET = [18, 21, 22, 26, 40, 46, 50, 64, 69, 72, 94, 95, 96, 97, 98, 99]
COLUMNS = "query+target+qlo+qhi+tlo+thi+evalue+cigar"
# the test workers share the host's cores: one torch thread each keeps the
# plain versions' many small ops from contending for them
torch.set_num_threads(1)


def _search(fn, chains, mode="sensitive", columns=COLUMNS, **kw):
    out = io.StringIO()
    params = DSSParams.create(mode)
    max_e = float("inf") if mode == "verysensitive" else 10.0
    options = SearchOptions(columns=parse_columns(columns), mode=mode,
                            max_evalue=max_e)
    drv = fn(chains, params, options, out, **kw)
    return out.getvalue(), drv


@pytest.fixture(scope="module")
def subset():
    chains = read_chains(Q100)
    return [chains[i] for i in SUBSET]


def test_slice_matches_host_and_jax_device_engine(subset):
    got, drv = _search(torch_driver.self_search, subset, engine="device",
                       device="cpu")
    host, _ = _search(tpu_driver.self_search, subset, engine="host")
    jax_dev, _ = _search(tpu_driver.self_search, subset, engine="device")
    assert len(got.splitlines()) == 90
    assert got == host
    assert got == jax_dev
    stats = drv.device_stats
    assert stats["survivors"] > 0
    assert {"encode_s", "stage1_s", "stage3_s", "finish_s"} <= stats.keys()


@pytest.mark.parametrize("mode", ["fast", "sensitive"])
def test_display_columns_match_host(subset, mode):
    """Raw-score (dpscore %.4g, raw %.3g), LDDT, TS, P and muscore
    columns: the forward score displayed as stage 3 gives it, the LDDT
    band recompute and the muscore backfill paths."""
    cols = "std+evalue+ts+dpscore+raw+pvalue+lddt+muscore+ids+gaps"
    got, _ = _search(torch_driver.self_search, subset[:10], mode=mode,
                     columns=cols, engine="device", device="cpu")
    host, _ = _search(tpu_driver.self_search, subset[:10], mode=mode,
                      columns=cols, engine="host")
    assert got == host and len(got.splitlines()) > 20


def test_verysensitive_matches_host():
    """Omega 0 (no Mu filter) and no E-value gate."""
    chains = sorted(read_chains(Q100), key=len)[:8]
    got, _ = _search(torch_driver.self_search, chains, mode="verysensitive",
                     engine="device", device="cpu")
    host, _ = _search(tpu_driver.self_search, chains, mode="verysensitive",
                      engine="host")
    assert got == host and len(got.splitlines()) == 64


def test_runs_with_jax_blocked(tmp_path):
    """Every module of the port imports with jax blocked, and the CLI's
    device engine on the CPU writes the host engine's TSV, for the
    self-search and for a --db search."""
    out = tmp_path / "hits.tsv"
    qout = tmp_path / "query.tsv"
    code = f"""
import sys, pkgutil, importlib
sys.modules["jax"] = None
import reseek_tpu_torch
for m in pkgutil.walk_packages(reseek_tpu_torch.__path__, "reseek_tpu_torch."):
    importlib.import_module(m.name)
from reseek_tpu.io.cal import write_cal
from reseek_tpu.io.reader import read_chains
chains = read_chains({Q100!r})[:8]
with open({str(tmp_path / "q8.cal")!r}, "w") as f:
    write_cal(chains, f)
from reseek_tpu_torch.__main__ import main
common = ["--sensitive", "--columns", {COLUMNS!r}, "--engine", "device",
          "--device", "cpu"]
rc = main(["search", {str(tmp_path / "q8.cal")!r}, "-o", {str(out)!r}]
          + common)
rc = rc or main(["search", {str(tmp_path / "q8.cal")!r}, "--db",
                 {str(tmp_path / "q8.cal")!r}, "-o", {str(qout)!r}] + common)
assert "jax" not in sys.modules or sys.modules["jax"] is None
sys.exit(rc)
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr
    chains = read_chains(str(tmp_path / "q8.cal"))
    host, _ = _search(tpu_driver.self_search, chains, engine="host")
    assert out.read_text() == host and host
    qhost = io.StringIO()
    tpu_driver.query_search(chains, chains, DSSParams.create("sensitive"),
                            SearchOptions(columns=parse_columns(COLUMNS),
                                          mode="sensitive"), qhost,
                            engine="host")
    assert qout.read_text() == qhost.getvalue() and qhost.getvalue()


def test_cli_refuses_unported_flags(tmp_path):
    """The multi-process flags belong to the multi-process -fast search
    alone: elsewhere they are refused before anything is written."""
    for extra, says in ((["--sensitive", "--nprocs", "2"],
                         "give --fast --db"),
                        (["--fast", "--db", Q100, "--resume", "--procid",
                          "0"], "--procid, --resume need --nprocs > 1")):
        proc = subprocess.run(
            [sys.executable, "-m", "reseek_tpu_torch", "search", Q100,
             "-o", str(tmp_path / "x.tsv"), *extra],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 2
        assert says in proc.stderr
        assert not (tmp_path / "x.tsv").exists()


def test_cuda_without_a_card_raises(subset):
    """Asking for CUDA never falls back to the CPU."""
    if torch.cuda.is_available():
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        assert resolve("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        resolve("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        _search(torch_driver.self_search, subset[:2], engine="device",
                device="cuda")


def test_unported_options_raise(subset):
    """A mesh that is not a sequence of devices, an empty one, or one that
    names CUDA without a card raises in every driver, before any output:
    never a silent single-device or CPU run."""
    params = DSSParams.create("sensitive")
    opts = SearchOptions(columns=["query"])
    bad = [(object(), TypeError), ("cpu", TypeError), ((), ValueError)]
    if not torch.cuda.is_available():
        bad.append((("cuda:0", "cuda:0"), RuntimeError))
    for fn, args in ((torch_driver.self_search, (subset[:2],)),
                     (torch_driver.query_search, (subset[:1], subset[:2])),
                     (torch_driver.fast_search, (subset[:1], subset[:2]))):
        for mesh, exc in bad:
            out = io.StringIO()
            with pytest.raises(exc):
                fn(*args, params, opts, out, mesh=mesh)
            assert out.getvalue() == ""


@pytest.mark.parametrize("engine", ["device", "host"])
def test_global_matches_host(engine):
    """-global runs reseek_tpu's host global path whatever the engine:
    byte-equal to reseek_tpu on 6 short q100.cal chains."""
    chains = sorted(read_chains(Q100), key=len)[:6]
    cols = "query+target+qlo+qhi+tlo+thi+cigar"
    outs = []
    for fn, kw in ((torch_driver.self_search,
                    {"engine": engine, "device": "cpu"}),
                   (tpu_driver.self_search, {"engine": "host"})):
        out = io.StringIO()
        opts = SearchOptions(columns=parse_columns(cols), mode="sensitive",
                             global_aln=True, scores_are_not_evalues=True)
        fn(chains, DSSParams.create("sensitive"), opts, out, **kw)
        outs.append(out.getvalue())
    assert outs[0] == outs[1] and outs[0].count("\n") >= 6


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build raises rather than substituting anything."""
    monkeypatch.setattr(kernels.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels._nvcc()


def test_no_jax_import_in_port():
    for path in (ROOT / "reseek_tpu_torch").rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
    smoke = (ROOT / "chip_smoke.py").read_text()
    assert "import jax" not in smoke and "from jax" not in smoke
    assert "from tests" not in smoke and "import tests" not in smoke


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py fails, and prints no result, without a CUDA device or
    outside the repository."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, alone)):
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              capture_output=True, text=True, timeout=300,
                              env=dict(os.environ, PYTHONPATH=""))
        if torch.cuda.is_available() and cwd == ROOT:
            continue
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
