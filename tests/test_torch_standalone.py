"""The port stands alone: no module of reseek_tpu_torch and nothing in
chip_smoke.py imports reseek_tpu or jax, shown by an AST scan and by a run
of the port's CLI with both blocked."""

import ast
import io
import os
import subprocess
import sys
from pathlib import Path

from reseek_tpu import cli as tpu_cli
from reseek_tpu.align.output import parse_columns
from reseek_tpu.constants import DSSParams
from reseek_tpu.io.reader import read_chains
from reseek_tpu.search import driver as tpu_driver
from reseek_tpu.search.driver import SearchOptions

ROOT = Path(__file__).resolve().parent.parent
Q100 = str(ROOT / "tests" / "golden" / "q100.cal")
SEPQ = str(ROOT / "tests" / "golden" / "sepq_set.cal")
LOOKUP = str(ROOT / "tests" / "golden" / "sepq_set.lookup")
# four a.1.11.1 chains, two a.1.24.1, two singletons: true and false pairs
SEPQ8 = [0, 9, 10, 11, 12, 13, 26, 27]
COLUMNS = "query+target+qlo+qhi+tlo+thi+evalue+cigar"
BLOCKED = ("reseek_tpu", "jax")


def _blocked(name: str) -> bool:
    return name.split(".")[0] in BLOCKED


def _imports(path: Path):
    """(line, module) of every import in ``path``, relative ones skipped,
    with the constant names given to importlib.import_module."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr",
                          getattr(node.func, "id", "")) in (
                              "import_module", "__import__")):
            yield node.lineno, node.args[0].value


def test_no_import_of_reseek_tpu_or_jax():
    files = sorted((ROOT / "reseek_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 50
    bad = [f"{p.relative_to(ROOT)}:{line} {mod}" for p in files
           for line, mod in _imports(p) if _blocked(mod)]
    assert not bad, bad


_BLOCKED_RUN = """
import importlib, importlib.abc, pkgutil, sys
sys.modules["jax"] = None


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "reseek_tpu" or name.startswith("reseek_tpu."):
            raise ImportError(f"{{name}} is blocked")
        return None


sys.meta_path.insert(0, Refuse())
import reseek_tpu_torch
for m in pkgutil.walk_packages(reseek_tpu_torch.__path__,
                               "reseek_tpu_torch."):
    importlib.import_module(m.name)
from reseek_tpu_torch.io.cal import write_cal
from reseek_tpu_torch.io.reader import read_chains
chains = read_chains({q100!r})[:8]
write_cal(chains, {q8!r})
from reseek_tpu_torch.__main__ import main
common = ["--columns", {columns!r}, "--engine", "device", "--device", "cpu"]
rc = main(["search", {q8!r}, "--sensitive", "-o", {self_out!r}] + common)
rc = rc or main(["search", {q8!r}, "--sensitive", "--db", {q8!r}, "-o",
                 {db_out!r}] + common)
rc = rc or main(["search", {q8!r}, "--fast", "--db", {q8!r}, "-o",
                 {fast_out!r}] + common)
import contextlib
sepq = read_chains({sepq!r})
write_cal([sepq[i] for i in {sepq_idx!r}], {s8!r})
for key, argv in (("bench_out", ["scop40bench", {s8!r}, "--lookup",
                                 {lookup!r}]),
                  ("cal2_out", ["calibrate2", {s8!r}, "--benchlevel",
                                "sf"])):
    with open({paths!r}[key], "w") as f, contextlib.redirect_stdout(f):
        rc = rc or main(argv + ["--engine", "host"])
rc = rc or main(["convert", {q8!r}, "--bca", {q8_bca!r}])
rc = rc or main(["convert", {q8_bca!r}, "--index", {rsdx!r},
                 "--index-modes", "sensitive"])
rc = rc or main(["search", {rsdx!r}, "--sensitive", "-o", {rsdx_out!r}]
                + common)
with open({pair_out!r}, "w") as f, contextlib.redirect_stdout(f):
    rc = rc or main(["alignpair", {q8!r}, "--input2", {s8!r}, "--aln",
                     {pair_aln!r}])
loaded = [k for k in sys.modules if k == "reseek_tpu"
          or k.startswith("reseek_tpu.")]
assert not loaded, loaded
assert sys.modules["jax"] is None
sys.exit(rc)
"""


def test_cli_runs_with_reseek_tpu_and_jax_blocked(tmp_path, capsys):
    """Every module of the port imports, and the CLI's self-search, --db
    and --fast --db, scop40bench, calibrate2, convert --index and a
    search of its .rsdx, and alignpair run on the CPU, with jax and
    reseek_tpu refused; the outputs equal reseek_tpu's."""
    paths = {k: str(tmp_path / f"{k}.tsv")
             for k in ("self_out", "db_out", "fast_out", "bench_out",
                       "cal2_out", "rsdx_out", "pair_out", "pair_aln")}
    q8 = str(tmp_path / "q8.cal")
    s8 = str(tmp_path / "s8.cal")
    q8_bca = str(tmp_path / "q8.bca")
    rsdx = str(tmp_path / "q8.rsdx")
    code = _BLOCKED_RUN.format(q100=Q100, q8=q8, columns=COLUMNS,
                               sepq=SEPQ, sepq_idx=SEPQ8, s8=s8,
                               lookup=LOOKUP, paths=paths, q8_bca=q8_bca,
                               rsdx=rsdx, **paths)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr
    chains = read_chains(q8)
    assert len(chains) == 8
    for key, fn, mode, args in (
            ("self_out", tpu_driver.self_search, "sensitive", (chains,)),
            ("db_out", tpu_driver.query_search, "sensitive",
             (chains, chains)),
            ("fast_out", tpu_driver.fast_search, "fast", (chains, q8))):
        want = io.StringIO()
        fn(*args, DSSParams.create(mode),
           SearchOptions(columns=parse_columns(COLUMNS), mode=mode), want,
           engine="host")
        got = Path(paths[key]).read_text()
        assert got == want.getvalue() and got, key
    for key, argv in (("bench_out", ["scop40bench", s8, "--lookup",
                                     LOOKUP]),
                      ("cal2_out", ["calibrate2", s8, "--benchlevel",
                                    "sf"])):
        capsys.readouterr()
        assert tpu_cli.main(argv + ["--engine", "host"]) == 0
        want = capsys.readouterr().out
        assert Path(paths[key]).read_text() == want and want, key
    # the .rsdx holds the .bca's chains: its rows are the .bca's
    want = io.StringIO()
    tpu_driver.self_search(read_chains(q8_bca), DSSParams.create(
        "sensitive"), SearchOptions(columns=parse_columns(COLUMNS),
                                    mode="sensitive"), want, engine="host")
    assert Path(paths["rsdx_out"]).read_text() == want.getvalue()
    aln = tmp_path / "tpu.aln"
    capsys.readouterr()
    assert tpu_cli.main(["alignpair", q8, "--input2", s8, "--aln",
                         str(aln)]) == 0
    assert Path(paths["pair_out"]).read_text() == capsys.readouterr().out
    assert Path(paths["pair_aln"]).read_text() == aln.read_text()
