"""The port's structure I/O and format commands (reseek_tpu_torch/cli.py)
byte for byte against ``reseek_tpu.cli.main`` on the in-repo structure
sets: stdout, stderr and every file each run writes.  Also the round trips
of q100.cal through convert, the .rsdx index that ``convert --index``
writes (searched on the host engine and on the device engine on the CPU)
and the reference binary's single-dash spelling of a command line.

Every search is of 16 chains or fewer."""

import gzip
import io
import os
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from reseek_tpu import cli as tpu_cli
from reseek_tpu_torch import __main__ as port_cli
from reseek_tpu_torch.io.bca import BCAWriter
from reseek_tpu_torch.io.cal import write_cal
from reseek_tpu_torch.io.pdb import ONE_TO_THREE
from reseek_tpu_torch.io.reader import read_chains

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden"
Q100 = str(GOLDEN / "q100.cal")
# q100.cal: chains of 245-1,231 residues, five of them >= 500
SUBSET = [18, 21, 22, 26, 40, 46, 50, 64, 69, 72, 94, 95, 96, 97, 98, 99]
COLUMNS = "query+target+qlo+qhi+tlo+thi+evalue+cigar"
LOG_VARIES = ("Finished", "Elapsed", "Max memory")
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The 16-chain q100 subset as .cal and .bca, its first four chains,
    one PDB file per chain of those four (the port's chains2pdbs), a small
    mmCIF of two chains and a gzipped text."""
    d = tmp_path_factory.mktemp("inputs")
    q100 = read_chains(Q100)
    q16 = [q100[i] for i in SUBSET]
    paths = {"dir": str(d)}
    for name, chains in (("q16", q16), ("q4", q16[:4])):
        paths[name] = str(d / f"{name}.cal")
        with open(paths[name], "w") as f:
            write_cal(chains, f)
    paths["q16_bca"] = str(d / "q16.bca")
    with BCAWriter(paths["q16_bca"]) as w:
        for c in q16:
            w.write_chain(c)
    paths["pdbs"] = str(d / "pdbs")
    with redirect_stderr(io.StringIO()):
        assert port_cli.main(["chains2pdbs", paths["q4"], "--outdir",
                              paths["pdbs"]]) == 0
    paths["cif"] = str(d / "two.cif")
    with open(paths["cif"], "w") as f:
        f.write(_mmcif("TEST", [(q16[0], "A"), (q16[1], "B")], 30))
    paths["gz"] = str(d / "lines.txt.gz")
    with gzip.open(paths["gz"], "wt") as f:
        f.write("first line\r\nsecond\n\nlast without newline")
    paths["labels"] = str(d / "labels.txt")
    with open(paths["labels"], "w") as f:
        f.write(f"{q16[3].label.lower()}\n\n{q16[7].label}\n")
    return paths


def _mmcif(name: str, chains, n: int) -> str:
    """An mmCIF _atom_site loop of the first ``n`` residues of each
    (chain, asym id): an N and a CA atom per residue."""
    fields = ["group_PDB", "id", "label_atom_id", "label_comp_id",
              "auth_asym_id", "Cartn_x", "Cartn_y", "Cartn_z",
              "pdbx_PDB_model_num"]
    lines = [f"data_{name}", "#", "loop_"]
    lines += [f"_atom_site.{x}" for x in fields]
    k = 0
    for c, asym in chains:
        for i in range(n):
            x, y, z = (float(v) for v in c.coords[i])
            for atom, dx in (("N", -1.2), ("CA", 0.0)):
                k += 1
                lines.append(f"ATOM {k} {atom} {ONE_TO_THREE[c.seq[i]]} "
                             f"{asym} {x + dx:.3f} {y:.3f} {z:.3f} 1")
    return "\n".join(lines + ["#", ""])


def both(tmp_path, argv, log_files=()):
    """``argv`` run by reseek_tpu and by the port, in-process, "{d}" in it
    standing for a directory of the run's own: the exit codes, stdout,
    stderr and every file in the directory (the log files in
    ``log_files`` without their timing lines) must be byte-equal.
    Returns the port's (stdout, stderr, {file name: bytes})."""
    runs = []
    for who, main in (("tpu", tpu_cli.main), ("port", port_cli.main)):
        d = tmp_path / who
        d.mkdir(parents=True)
        out, err = io.StringIO(), io.StringIO()
        with redirect_stdout(out), redirect_stderr(err):
            rc = main([a.replace("{d}", str(d)) for a in argv])
        files = {}
        for p in sorted(d.rglob("*")):
            if p.is_file():
                data = p.read_bytes()
                if p.name in log_files:
                    data = b"".join(ln for ln in data.splitlines(True)
                                    if not ln.startswith(tuple(
                                        x.encode() for x in LOG_VARIES)))
                files[p.relative_to(d).as_posix()] = data
        runs.append((rc, out.getvalue().replace(str(d), "{d}"),
                     err.getvalue().replace(str(d), "{d}"), files))
    assert runs[1] == runs[0]
    assert runs[1][0] == 0
    return runs[1][1:]


CONVERT = {
    "outputs": ["--bca", "{d}/x.bca", "--cal", "{d}/x.cal", "--fasta",
                "{d}/x.fa", "--pdb", "{d}/x.pdb", "--feature-fasta",
                "{d}/x.mu.fa"],
    "alpha": ["--feature-fasta", "{d}/x.ss3.fa", "--alpha", "SS3"],
    "reverse": ["--reverse", "--cal", "{d}/x.cal", "--pdb", "{d}/x.pdb"],
    "flip": ["--flip", "--cal", "{d}/x.cal", "--bca", "{d}/x.bca"],
    "labels": ["--labels", "{labels}", "--cal", "{d}/x.cal"],
    "subsample": ["--subsample", "3", "--cal", "{d}/x.cal"],
    "minchainlength": ["--minchainlength", "400", "--fasta", "{d}/x.fa"],
    "filters": ["--reverse", "--flip", "--subsample", "2",
                "--minchainlength", "300", "--bca", "{d}/x.bca"],
}


@pytest.mark.parametrize("case", sorted(CONVERT))
def test_convert(inputs, tmp_path, case):
    argv = [a.replace("{labels}", inputs["labels"]) for a in CONVERT[case]]
    _, err, files = both(tmp_path, ["convert", inputs["q16"], *argv])
    assert files and all(files.values())
    assert err.endswith(" chains converted\n")
    if case == "labels":
        assert files["x.cal"].count(b">") == 2


def test_convert_round_trips(tmp_path):
    """q100.cal -> .cal, and -> .bca -> .cal, give q100.cal byte for
    byte, on both packages."""
    want = Path(Q100).read_bytes()
    _, _, files = both(tmp_path / "a", ["convert", Q100, "--bca",
                                        "{d}/q100.bca", "--cal",
                                        "{d}/q100.cal"])
    assert files["q100.cal"] == want
    bca = tmp_path / "q100.bca"
    bca.write_bytes(files["q100.bca"])
    _, _, files = both(tmp_path / "b", ["convert", str(bca), "--cal",
                                        "{d}/back.cal"])
    assert files["back.cal"] == want


HOST_CMDS = {
    "convert2mu": ["convert2mu", "{q16}", "--output", "{d}/mu.fa",
                   "--minchainlength", "300"],
    "getchains": ["getchains", "{q16}"],
    "pdb2ss": ["pdb2ss", "{q4}"],
    "pdb2ss_pdb": ["pdb2ss", "{pdbs}"],
    "bca-stats": ["bca-stats", "{q16_bca}"],
    "pdb2mega": ["pdb2mega", "{q4}", "--output", "{d}/mega.txt"],
    "pdb2mega_reverse": ["pdb2mega", "{q4}", "--output", "{d}/mega.txt",
                         "--reverse"],
    "shuffle": ["shuffle", "{q16}", "--bca", "{d}/sh.bca", "--seed", "7"],
    "split": ["split", "{q16}", "-n", "3", "--prefix", "{d}/part",
              "--minchainlength", "300"],
    "prepare-query": ["prepare-query", "{q16}", "--output", "{d}/pq.tsv",
                      "--bca", "{d}/pq.bca"],
    "prepare-query_n": ["prepare-query", "{q16}", "--output", "{d}/pq.tsv",
                        "-n", "6", "--minchainlength", "300"],
    "cif2pdb": ["cif2pdb", "{cif}", "--output", "{d}/two.pdb"],
    "chains2pdbs": ["chains2pdbs", "{q16}", "--outdir", "{d}/pdbs"],
    "gunzip": ["gunzip", "{gz}", "--output", "{d}/lines.txt"],
    "gunzip-lines": ["gunzip-lines", "{gz}", "--output", "{d}/lines.txt"],
    "scan-files": ["scan-files", "{pdbs}", "--output", "{d}/files.txt"],
}


@pytest.mark.parametrize("case", sorted(HOST_CMDS))
def test_host_command(inputs, tmp_path, case):
    argv = [a.format(**inputs) if a.startswith("{") and not a.startswith(
        "{d}") else a for a in HOST_CMDS[case]]
    out, err, files = both(tmp_path, argv)
    assert out or files


def test_cif2pdb_reads_both_chains(inputs, tmp_path):
    """The mmCIF's CA atoms make two chains of 30 residues, written at
    the input's coordinates."""
    _, err, files = both(tmp_path, ["cif2pdb", inputs["cif"], "--output",
                                    "{d}/two.pdb"])
    assert err == "2 chains written\n"
    ca = [ln for ln in files["two.pdb"].decode().splitlines()
          if ln.startswith("ATOM")]
    assert len(ca) == 60
    first = read_chains(inputs["q16"])[0]
    assert np.allclose([float(ca[0][30:38]), float(ca[0][38:46]),
                        float(ca[0][46:54])], first.coords[0], atol=1e-3)


def test_prepare_query_golden(tmp_path):
    """The port's prepare-query on q100 (-minchainlength 50 -n 30) equals
    the reference binary's status TSV (tests/golden/prepare_query_q100.tsv,
    which reseek_tpu's tests hold it to), through the BLOSUM62
    global-identity screen."""
    out = tmp_path / "pq.tsv"
    with redirect_stderr(io.StringIO()):
        assert port_cli.main(["prepare-query", Q100, "--output", str(out),
                              "--minchainlength", "50", "-n", "30"]) == 0
    assert out.read_bytes() == (GOLDEN / "prepare_query_q100.tsv").read_bytes()


def _search(main, argv):
    with redirect_stderr(io.StringIO()):
        assert main(argv) == 0


@pytest.fixture(scope="module")
def index(inputs, tmp_path_factory):
    """``convert --index --index-modes sensitive`` of the 16 chains' .bca
    by each package, and the searches of it."""
    d = tmp_path_factory.mktemp("index")
    paths = {}
    for who, main in (("tpu", tpu_cli.main), ("port", port_cli.main)):
        paths[who] = str(d / f"{who}.rsdx")
        _search(main, ["convert", inputs["q16_bca"], "--index", paths[who],
                       "--index-modes", "sensitive"])
    paths["dir"] = d
    return paths


def test_index_arrays_equal_reseek_tpu(index):
    with np.load(index["port"], allow_pickle=True) as a, \
            np.load(index["tpu"], allow_pickle=True) as b:
        assert sorted(a.files) == sorted(b.files)
        assert "selfrev_sensitive" in a.files and "selfrev_fast" not in a
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("mode", ["sensitive", "fast"])
def test_index_search(inputs, index, mode):
    """A search of the .rsdx equals one of the .bca it was built from, on
    the port's host engine, its device engine on the CPU and reseek_tpu's
    host engine; --fast recomputes the self-rev scores the index lacks.
    (A .bca holds integer coordinates: its chains are not bit-equal to the
    .cal's parsed text, so the .cal's rows differ.)"""
    d = index["dir"]
    got = {}
    for name, main, src, engine in (
            ("tpu_bca", tpu_cli.main, inputs["q16_bca"], ["host"]),
            ("tpu_rsdx", tpu_cli.main, index["tpu"], ["host"]),
            ("host_bca", port_cli.main, inputs["q16_bca"], ["host"]),
            ("host_rsdx", port_cli.main, index["port"], ["host"]),
            ("device_rsdx", port_cli.main, index["port"],
             ["device", "--device", "cpu"])):
        out = str(d / f"{mode}.{name}.tsv")
        _search(main, ["search", src, f"--{mode}", "-o", out, "--columns",
                       COLUMNS, "--engine", *engine])
        got[name] = Path(out).read_text()
    assert got["tpu_bca"].count("\n") > 16
    for name, text in got.items():
        assert text == got["tpu_bca"], name


def test_reference_spelling_rewrites_as_reseek_tpu():
    """Each of the port's commands spelt -<command> with single-dash
    options is rewritten as reseek_tpu rewrites it; values that start
    with '-' pass untouched; a command the port lacks passes unrewritten."""
    cases = [
        ["-search", "x.cal", "-sensitive", "-evalue", "-.5", "-output",
         "o.tsv", "-label1", "-foo", "-label2", "-bar", "-o", "y"],
        ["-convert", "x.cal", "-cal", "y.cal", "-index_modes", "fast",
         "-feature_fasta", "z.fa"],
        ["-prepare_query", "x.cal", "-minchainlength", "50", "-n", "3"],
        ["-test_xdrop", "-log", "x.log"],
        ["-create_foldseekdb", "x.cal", "-3di", "y.fa", "-output", "db"],
        ["search", "-sensitive"],
    ]
    for argv in cases:
        assert port_cli._reference_style(argv) == tpu_cli._reference_style(
            argv)
    assert port_cli._reference_style(
        ["-search", "x", "-evalue", "-.5"])[-1] == "-.5"
    assert port_cli._reference_style(["-lddt_msa", "x.afa"]) == [
        "-lddt_msa", "x.afa"]
    assert len(port_cli.REFERENCE_COMMANDS) == 59


def test_reference_spelling_runs(inputs, tmp_path):
    """``-convert X -cal Y`` and ``-search X -sensitive ...`` give the
    bytes of their GNU spellings, on the port and on reseek_tpu; a
    negative -evalue reaches the search as a value."""
    q16 = inputs["q16"]
    runs = {}
    for spelling, argv in (
            ("gnu", ["search", q16, "--sensitive", "--columns", COLUMNS,
                     "-o", "{d}/hits.tsv", "--engine", "host"]),
            ("ref", ["-search", q16, "-sensitive", "-columns", COLUMNS,
                     "-output", "{d}/hits.tsv", "-engine", "host"]),
            ("ref_evalue", ["-search", q16, "-sensitive", "-evalue", "-.5",
                            "-output", "{d}/hits.tsv", "-engine", "host"]),
            ("convert_gnu", ["convert", q16, "--cal", "{d}/y.cal"]),
            ("convert_ref", ["-convert", q16, "-cal", "{d}/y.cal"])):
        runs[spelling] = both(tmp_path / spelling, argv)[2]
    assert runs["ref"] == runs["gnu"] and runs["gnu"]["hits.tsv"]
    assert runs["ref_evalue"]["hits.tsv"] == b""
    assert runs["convert_ref"] == runs["convert_gnu"]
    assert runs["convert_gnu"]["y.cal"] == Path(q16).read_bytes()


def test_reference_spelling_from_the_shell(inputs, tmp_path):
    """``python -m reseek_tpu_torch -search X -sensitive --engine host``
    writes the rows of ``search X --sensitive``."""
    out = tmp_path / "ref.tsv"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "reseek_tpu_torch", "-search", inputs["q4"],
         "-sensitive", "--engine", "host", "-output", str(out)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    want = tmp_path / "gnu.tsv"
    _search(port_cli.main, ["search", inputs["q4"], "--sensitive",
                            "--engine", "host", "--output", str(want)])
    assert out.read_text() == want.read_text() and want.read_text()
