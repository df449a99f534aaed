"""The port's pair-alignment commands (reseek_tpu_torch/cli.py: alignpair,
align-bag, align-bags, alignselfrev, tracealn, test-xdrop) byte for byte
against ``reseek_tpu.cli.main`` on the in-repo structure sets and on PDB
files that the port's chains2pdbs writes; test-xdrop also against the
reference binary's log (tests/golden/test_xdrop.txt), and the port's
Kabsch superposition (ops/kabsch.py) against reseek_tpu's."""

import io
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import numpy as np
import pytest

from reseek_tpu.ops.kabsch import kabsch_path as tpu_kabsch_path
from reseek_tpu_torch import __main__ as port_cli
from reseek_tpu_torch.io.reader import read_chains
from reseek_tpu_torch.ops.kabsch import kabsch_path

from test_torch_cli_io import GOLDEN, both, inputs  # noqa: F401


def _pdb(inputs, k: int) -> str:
    """The PDB file chains2pdbs wrote for the k-th chain of q4."""
    label = read_chains(inputs["q4"])[k].label
    return str(Path(inputs["pdbs"]) / (label.replace("/", "_") + ".pdb"))


# q4's chains 2 and 3 are homologous (E ~1e-4 in a sensitive search)
ALIGNPAIR = {
    "row": [],
    "aln": ["--aln", "{d}/pair.aln"],
    "output": ["--output", "{d}/super.pdb"],
    "global": ["--global", "--aln", "{d}/pair.aln", "--output",
               "{d}/super.pdb"],
}


@pytest.mark.parametrize("case", sorted(ALIGNPAIR))
def test_alignpair(inputs, tmp_path, case):
    out, _, files = both(tmp_path, ["alignpair", _pdb(inputs, 2),
                                    "--input2", _pdb(inputs, 3),
                                    *ALIGNPAIR[case]])
    assert len(out.rstrip("\n").split("\t")) == 12
    assert all(files.values())


def test_alignpair_best_pair_of_two_files(inputs, tmp_path):
    """Of q4 against q4 the best pair is a chain with itself: the row
    spans the whole chain."""
    out, _, _ = both(tmp_path, ["alignpair", inputs["q4"], "--input2",
                                inputs["q4"]])
    q, t, qlo, qhi, tlo, thi = out.split("\t")[:6]
    n = {c.label: len(c) for c in read_chains(inputs["q4"])}[q]
    assert q == t and (qlo, tlo) == ("1", "1")
    assert (int(qhi), int(thi)) == (n, n)


def test_alignpair_self_superposes(inputs, tmp_path):
    """A chain aligned with itself: the row spans the chain, and the
    superposed PDB lies within 1e-3 A of the input's coordinates."""
    pdb = _pdb(inputs, 1)
    out, _, files = both(tmp_path, ["alignpair", pdb, "--input2", pdb,
                                    "--output", "{d}/super.pdb"])
    n = len(read_chains(inputs["q4"])[1])
    assert out.split("\t")[2:6] == ["1", str(n), "1", str(n)]
    sup = tmp_path / "super.pdb"
    sup.write_bytes(files["super.pdb"])
    (got,), (want,) = read_chains(str(sup)), read_chains(pdb)
    assert np.abs(got.coords - want.coords).max() < 1e-3


def test_align_bag(inputs, tmp_path):
    both(tmp_path, ["align-bag", _pdb(inputs, 2), "--input2",
                    _pdb(inputs, 3), "--output", "{d}/bag.txt"])
    out, err, _ = both(tmp_path / "self", [
        "align-bag", _pdb(inputs, 0), "--input2", _pdb(inputs, 0)])
    assert out and not err


@pytest.mark.parametrize("cmd", ["align-bags", "alignselfrev"])
def test_all_chains(inputs, tmp_path, cmd):
    _, err, files = both(tmp_path, [cmd, inputs["q16"], "--output",
                                    "{d}/rows.tsv"])
    rows = files["rows.tsv"].decode().splitlines()
    if cmd == "align-bags":
        assert len(rows) > 5 and err.startswith("align-bags: ")
    else:
        assert len(rows) == 16


def test_tracealn(inputs, tmp_path):
    _, _, files = both(tmp_path, ["tracealn", inputs["q4"], "--db",
                                  inputs["q4"], "--log", "{d}/trace.log"],
                       log_files=("trace.log",))
    assert files["trace.log"].count(b"\nQ>") == 16


def test_test_xdrop_golden(tmp_path):
    """test-xdrop's log equals the reference binary's, without the timing
    lines, on both packages."""
    _, _, files = both(tmp_path, ["test-xdrop", "--log", "{d}/x.log"],
                       log_files=("x.log",))
    want = (GOLDEN / "test_xdrop.txt").read_text()
    assert files["x.log"].decode().rstrip("\n") == want.rstrip("\n")


def test_reference_spelling_alignpair(inputs, tmp_path):
    argv = ["alignpair", _pdb(inputs, 2), "--input2", _pdb(inputs, 3),
            "--global", "--aln"]
    runs = []
    for spelling in (argv, ["-" + argv[0], argv[1], "-input2", argv[3],
                            "-global", "-aln"]):
        out = io.StringIO()
        aln = tmp_path / f"{len(runs)}.aln"
        with redirect_stdout(out), redirect_stderr(io.StringIO()):
            assert port_cli.main(spelling + [str(aln)]) == 0
        runs.append((out.getvalue(), aln.read_text()))
    assert runs[1] == runs[0]


def test_kabsch_path_equals_reseek_tpu():
    """kabsch_path of two chains under random gapped paths: translation,
    rotation and mean squared deviation equal to reseek_tpu's, bit for
    bit."""
    rng = np.random.default_rng(5)
    chains = read_chains(str(GOLDEN / "q100.cal"))[:6]
    for a, b in zip(chains, chains[1:]):
        lo_a, lo_b = int(rng.integers(0, 20)), int(rng.integers(0, 20))
        n = min(len(a) - lo_a, len(b) - lo_b) - 10
        path = "".join(rng.choice(list("MMMMMMDI"), n))
        got = kabsch_path(a.coords, b.coords, lo_a, lo_b, path)
        want = tpu_kabsch_path(a.coords, b.coords, lo_a, lo_b, path)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
        assert np.isfinite(got[2]) and got[1].shape == (3, 3)
