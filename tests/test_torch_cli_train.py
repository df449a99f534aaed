"""The port's table, training and diagnostic commands (reseek_tpu_torch/
cli.py, with benchmarks/train.py) byte for byte against
``reseek_tpu.cli.main`` in-process on the in-repo inputs: stdout, stderr
and every file each run writes; where the reference binary's output is in
tests/golden, byte-equal to it too.  Also: the port's parser registers
exactly reseek_tpu's 59 command names."""

import io
import re
from contextlib import redirect_stderr, redirect_stdout

import pytest

from reseek_tpu import cli as tpu_cli
from reseek_tpu_torch import __main__ as port_cli

from test_torch_cli_io import GOLDEN, both, inputs  # noqa: F401

MSTA = GOLDEN / "msta.afa"


def _msta_pairs(path) -> str:
    """The MSA's three row pairs as a FASTA of trusted alignments (records
    2k and 2k+1 form one), labels those of msta_set.cal."""
    recs = [r.partition("\n") for r in MSTA.read_text().split(">")[1:]]
    rows = [(lab.strip(), seq.replace("\n", "")) for lab, _, seq in recs]
    with open(path, "w") as f:
        for i in range(len(rows)):
            for j in range(i + 1, len(rows)):
                for lab, seq in (rows[i], rows[j]):
                    f.write(f">{lab}\n{seq}\n")
    return str(path)


CASES = {
    "musubstmx": ["musubstmx", "--output", "{d}/mu.c"],
    "musubstmx-stdout": ["musubstmx"],
    "mu-mapping": ["mu-mapping", "--output", "{d}/mu.tsv"],
    "float-feature-bins": ["float-feature-bins", str(GOLDEN / "ffb_pairs.fa"),
                           "--train-cal", str(GOLDEN / "sepq_set.cal"),
                           "--feature", "NENDist", "--alpha-size", "16",
                           "--output", "{d}/ffb.txt"],
    "float-feature-bins-sizes": ["float-feature-bins",
                                 str(GOLDEN / "ffb_pairs.fa"), "--train-cal",
                                 str(GOLDEN / "sepq_set.cal"), "--feature",
                                 "HelixDens", "--output", "{d}/ffb.txt"],
    "sscluster": ["sscluster", "{q16}", "-k", "8", "-n", "2000",
                  "--output", "{d}/ssc.txt"],
    "sscluster-seed": ["sscluster", "{q16}", "-k", "8", "-n", "2000",
                       "--randseed", "7", "--myss3", "--output",
                       "{d}/ssc.txt"],
    "train-features": ["train-features", str(GOLDEN / "msta_set.cal"),
                       "--alns", "{pairs}", "--output", "{d}/lo.tsv"],
    "train-features-some": ["train-features", str(GOLDEN / "msta_set.cal"),
                            "--alns", "{pairs}", "--features",
                            "AA,NENDist,Conf", "--output", "{d}/lo.tsv"],
    "feature-stats": ["feature-stats"],
    "mudex": ["mudex", str(GOLDEN / "q100.mu.fa"), "--log",
              "{d}/mudex.log"],
    "binner": ["binner", str(GOLDEN / "binner_vals.tsv"), "--fieldnr", "2",
               "--bins", "8", "--output", "{d}/h.tsv", "--accum",
               "{d}/a.tsv", "--accumrev", "{d}/r.tsv"],
    "binner-log10": ["binner", str(GOLDEN / "binner_vals.tsv"),
                     "--fieldnr", "2", "--log10", "--minval", "-1",
                     "--maxval", "1.5", "--output", "{d}/h.tsv"],
}
# case -> {file written or "stdout": its golden in tests/golden}
GOLDENS = {
    "binner": {"h.tsv": "binner_hist.tsv", "a.tsv": "binner_accum.tsv",
               "r.tsv": "binner_accumrev.tsv"},
    "feature-stats": {"stdout": "feature_stats.txt"},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_command(inputs, tmp_path, case):  # noqa: F811
    subst = {"{q16}": inputs["q16"],
             "{pairs}": _msta_pairs(tmp_path / "pairs.fa")}
    argv = [subst.get(a, a) for a in CASES[case]]
    out, err, files = both(tmp_path / "run", argv, log_files=("mudex.log",))
    assert out or files
    for name, golden in GOLDENS.get(case, {}).items():
        got = out if name == "stdout" else files[name].decode()
        assert got == (GOLDEN / golden).read_text(), name
    if case == "float-feature-bins":
        mine = [ln for ln in files["ffb.txt"].decode().splitlines()
                if re.search(r"ALPHA_SIZE|BIN_T|expected", ln)]
        assert mine == (GOLDEN / "ffb_nendist16.txt").read_text(
            ).splitlines()
    if case.startswith("sscluster"):
        means = [ln for ln in files["ssc.txt"].decode().splitlines()
                 if ln.startswith("Mean[")]
        assert len(means) == 8
    if case == "mudex":
        assert out == ("Validate OK\n"
                       "Max letters [1] = 3796 (14.0%)\n"
                       "Max letters [2] = 15285 (56.4%)\n"
                       "Max letters [3] = 6204 (22.9%)\n"
                       "Max letters [4] = 1424 (5.3%)\n"
                       "Max letters [5] = 409 (1.5%)\n")
        assert ("SelfScores: N=60466176, Min=20, LoQ=43, Med=47, HiQ=51, "
                "Max=75, Avg=47.3611") in files["mudex.log"].decode()
    if case == "binner":
        assert ("Min=-0.133, LoQ=3.67, Med=5.01, HiQ=6.18, Max=10.8, "
                "Avg=4.97") in err


def test_mukmerfilter_is_obsolete():
    """Both packages end mukmerfilter in SystemExit("Obsolete"), as the
    reference binary dies."""
    for main in (tpu_cli.main, port_cli.main):
        with redirect_stdout(io.StringIO()), redirect_stderr(io.StringIO()):
            with pytest.raises(SystemExit, match="^Obsolete$"):
                main(["mukmerfilter"])
    with pytest.raises(SystemExit, match="^Obsolete$"):
        port_cli.main(["-mukmerfilter"])


def _names(parser) -> set:
    return set(parser._subparsers._group_actions[0].choices)


def test_parser_registers_reseek_tpus_names():
    """The port's parser has exactly reseek_tpu's 59 command names, and
    the reference spelling knows each of them."""
    names = _names(port_cli.build_parser())
    assert names == _names(tpu_cli.build_parser())
    assert len(names) == 59
    for name in names:
        assert port_cli._known_options(name) is not None, name
