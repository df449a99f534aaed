"""The port's MSA scoring commands (reseek_tpu_torch/cli.py, with
benchmarks/msa.py) byte for byte against ``reseek_tpu.cli.main``
in-process, on the in-repo MSA fixture (tests/golden/msta.afa, three
perturbed replicas of a q100 chain, and their structures msta_set.cal):
stdout, stderr and every file each run writes; where the reference
binary's output is in tests/golden, byte-equal to it too.  Also the
reference binary's single-dash spelling of two commands."""

import shutil

import pytest

from test_torch_cli_io import GOLDEN, both

MSTA = str(GOLDEN / "msta.afa")
MSTA_SET = str(GOLDEN / "msta_set.cal")
SCORE = ["--input", MSTA_SET]


@pytest.fixture(scope="module")
def msa_dirs(tmp_path_factory):
    """Test directories of the batch commands (shared by both packages'
    runs, whose outputs name them): ``one`` holds the MSA as fam1, ``td1``
    and ``td2`` as msta.afa; the accession lists that name them; and a
    DALI-format TSV of the MSA's three row pairs."""
    d = tmp_path_factory.mktemp("msa")
    for sub, name in (("one", "fam1"), ("td1", "msta.afa"),
                      ("td2", "msta.afa")):
        (d / sub).mkdir()
        shutil.copy(MSTA, d / sub / name)
    (d / "accs.txt").write_text("fam1\nmissing_fam\n")
    (d / "accs2.txt").write_text("msta.afa\n")
    rows = {}
    for rec in GOLDEN.joinpath("msta.afa").read_text().split(">")[1:]:
        label, _, seq = rec.partition("\n")
        rows[label.strip()] = seq.replace("\n", "")
    labels = sorted(rows)
    with open(d / "dali.tsv", "w") as f:
        for i, a in enumerate(labels):
            for b in labels[i + 1:]:
                f.write("\t".join([a, b, "%.1f" % (10.0 + i), "0", "0", "0",
                                   "0", rows[a], rows[b]]) + "\n")
    return d


def _cases(d):
    """name -> (argv, {file written: its golden, or None})."""
    return {
        "lddt-msa": (["lddt-msa", MSTA, *SCORE, "--output", "{d}/o.tsv"],
                     {"o.tsv": "lddt_msa.tsv"}),
        "lddt-msa-core": (["lddt-msa", MSTA, *SCORE, "--core", "--output",
                           "{d}/o.tsv"], {"o.tsv": None}),
        "daliscore-msa": (["daliscore-msa", MSTA, *SCORE, "--output",
                           "{d}/o.tsv"], {"o.tsv": "daliscore_msa.tsv"}),
        "lddt-msa-foldmason": (["lddt-msa-foldmason", MSTA, *SCORE,
                                "--output", "{d}/o.tsv"],
                               {"o.tsv": "lddt_msa_foldmason.tsv"}),
        "lddt-msas": (["lddt-msas", str(d / "accs.txt"), *SCORE,
                       "--testdir", str(d / "one"), "--output", "{d}/o.tsv"],
                      {"o.tsv": None}),
        "daliscore-msas": (["daliscore-msas", str(d / "accs.txt"), *SCORE,
                            "--testdir", str(d / "one"), "--core",
                            "--output", "{d}/o.tsv"], {"o.tsv": None}),
        "daliscore-msas2": (["daliscore-msas2", str(d / "accs2.txt"),
                             *SCORE, "--testdir", str(d / "td1"),
                             "--testdir2", str(d / "td2"), "--output",
                             "{d}/o.tsv"], {"o.tsv": "daliscore_msas2.tsv"}),
        "daliscore-tsv": (["daliscore-tsv", str(d / "dali.tsv"), *SCORE,
                           "--output", "{d}/o.tsv"], {"o.tsv": None}),
        "lddt-bench": (["lddt-bench", MSTA, *SCORE], {}),
        "msta-score": (["msta-score", MSTA, *SCORE, "--output",
                        "{d}/o.tsv"], {"o.tsv": "msta_score.tsv"}),
        "msta-scores": (["msta-scores", str(d / "accs.txt"), *SCORE,
                         "--testdir", str(d / "one"), "--output",
                         "{d}/o.tsv"], {"o.tsv": "msta_scores.tsv"}),
        "msta-lddtmuw": (["msta-lddtmuw", MSTA, *SCORE, "--label", "m0",
                          "--lddtmuw-jalview", "{d}/o.jv",
                          "--lddtmuw-pymol", "{d}/o.pml"],
                         {"o.jv": "msta_lddtmuw.jalview",
                          "o.pml": "msta_lddtmuw_m0.pml"}),
        "msta-lddtmuw1": (["msta-lddtmuw1", MSTA, *SCORE, "--label", "m0",
                           "--output", "{d}/o.txt"],
                          {"o.txt": "msta_lddtmuw1_m0.txt"}),
        "msa2cmp": (["msa2cmp", MSTA, *SCORE, "--output", "{d}/o.tsv"],
                    {"o.tsv": "msa2cmp.tsv"}),
    }


def _golden(name: str, d) -> str:
    """A golden as this run's output would read: the reference binary's
    test directories are this fixture's."""
    text = (GOLDEN / name).read_text()
    return (text.replace("/tmp/msta_dir/", str(d / "one") + "/")
                .replace("/tmp/td1/", str(d / "td1") + "/")
                .replace("/tmp/td2/", str(d / "td2") + "/"))


@pytest.mark.parametrize("case", sorted(_cases(GOLDEN)))
def test_msa_command(msa_dirs, tmp_path, case):
    argv, files = _cases(msa_dirs)[case]
    out, err, written = both(tmp_path, argv)
    assert sorted(written) == sorted(files)
    for name, golden in files.items():
        got = written[name].decode()
        assert got
        if golden is None:
            continue
        want = _golden(golden, msa_dirs)
        if case == "msta-lddtmuw1":
            got, want = got.rstrip("\n"), want.rstrip("\n")
        assert got == want, name
    if case == "lddt-bench":
        assert out == "LDDT=0.7564 MSA=msta\n"
    if case == "lddt-msas":
        assert "LDDT_mu=0.7644" in written["o.tsv"].decode()
    if case == "daliscore-tsv":
        assert written["o.tsv"].decode().count("\n") == 3


@pytest.mark.parametrize("case", ["lddt-msa", "msta-lddtmuw"])
def test_reference_spelling(msa_dirs, tmp_path, case):
    """-lddt_msa X -input Y -output Z and -msta_lddtmuw X -input Y
    -lddtmuw_jalview Z give the bytes of their GNU spellings."""
    ref = {"lddt-msa": ["-lddt_msa", MSTA, "-input", MSTA_SET, "-output",
                        "{d}/o.tsv"],
           "msta-lddtmuw": ["-msta_lddtmuw", MSTA, "-input", MSTA_SET,
                            "-label", "m0", "-lddtmuw_jalview", "{d}/o.jv",
                            "-lddtmuw_pymol", "{d}/o.pml"]}[case]
    argv, _ = _cases(msa_dirs)[case]
    assert both(tmp_path / "ref", ref) == both(tmp_path / "gnu", argv)
