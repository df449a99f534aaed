"""The port's benchmark and calibration commands (reseek_tpu_torch/cli.py)
byte for byte against ``reseek_tpu.cli.main`` with ``--engine host``: the
search-driven ones (scop40bench, distmx, calibrate, calibrate2) on the
port's device engine on the CPU (``--engine device --device cpu``, the
kernels' plain versions) and on its host engine; the evaluator, fit and
prefilter commands on the in-repo goldens.  Every search is of 16 chains
or fewer; the 139-chain SEPQ check runs under ``-m slow``."""

import io
import os

import numpy as np
import pytest
import torch

from reseek_tpu import cli as tpu_cli
from reseek_tpu.align.output import parse_columns
from reseek_tpu.constants import DSSParams
from reseek_tpu.search import driver as tpu_driver
from reseek_tpu.search.driver import SearchOptions
from reseek_tpu_torch import __main__ as port_cli
from reseek_tpu_torch.align.output import parse_columns as port_columns
from reseek_tpu_torch.constants import DSSParams as PortParams
from reseek_tpu_torch.io.cal import write_cal
from reseek_tpu_torch.io.reader import read_chains
from reseek_tpu_torch.search import driver as port_driver

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
SEPQ_CAL = os.path.join(GOLDEN, "sepq_set.cal")
SEPQ_LOOKUP = os.path.join(GOLDEN, "sepq_set.lookup")
Q100 = os.path.join(GOLDEN, "q100.cal")
Q100_MU = os.path.join(GOLDEN, "q100.mu.fa")
HITS = os.path.join(GOLDEN, "sepq_hits3.tsv")
BIT = os.path.join(GOLDEN, "sepq_hits.bit")
# sepq_set.cal: the four a.1.11.1 chains, the three a.1.24.1, two each of
# a.1.31.1, a.1.40.1 (528 and 547 residues: the fast MKF route) and
# a.1.48.1, 1amo_A (601: the sensitive MKF route) and two singletons
SEPQ16 = [0, 9, 10, 11, 12, 13, 26, 27, 28, 35, 36, 47, 51, 52, 64, 65]
A_1_11_1 = [10, 11, 12, 13]
# q100.cal: chains of 245-1,231 residues, five of them >= 500
SUBSET = [18, 21, 22, 26, 40, 46, 50, 64, 69, 72, 94, 95, 96, 97, 98, 99]
COLUMNS = "query+target+qlo+qhi+tlo+thi+evalue+cigar"
ENGINES = {"device": ["--engine", "device", "--device", "cpu"],
           "host": ["--engine", "host"]}
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The labeled 16-chain sepq set and its lookup, the four a.1.11.1
    chains, the q100 subset, a .bca of q100, the first 10 q100 chains and
    Mu records."""
    d = tmp_path_factory.mktemp("bench")
    sepq = read_chains(SEPQ_CAL)
    q100 = read_chains(Q100)
    paths = {}

    def cal(name, chains):
        paths[name] = str(d / f"{name}.cal")
        with open(paths[name], "w") as f:
            write_cal(chains, f)

    cal("sepq16", [sepq[i] for i in SEPQ16])
    cal("a111", [sepq[i] for i in A_1_11_1])
    cal("q16", [q100[i] for i in SUBSET])
    cal("q10", q100[:10])
    keep = {sepq[i].label.partition("/")[0] for i in SEPQ16}
    paths["sepq16_lookup"] = str(d / "sepq16.lookup")
    with open(SEPQ_LOOKUP) as f, open(paths["sepq16_lookup"], "w") as g:
        g.writelines(ln for ln in f if ln.split("\t")[0] in keep)
    from reseek_tpu_torch.io.bca import BCAWriter
    paths["q100_bca"] = str(d / "q100.bca")
    with BCAWriter(paths["q100_bca"]) as w:
        for c in q100:
            w.write_chain(c)
    paths["q10_mu"] = str(d / "q10.mu.fa")
    with open(Q100_MU) as f:
        recs = f.read().split(">")[1:11]
    with open(paths["q10_mu"], "w") as g:
        g.write("".join(">" + r for r in recs))
    paths["dir"] = str(d)
    return paths


def _same(files, capsys, argv_of, outputs=(), engine=None):
    """The command run by reseek_tpu and by the port, each writing its own
    copy of the files named by ``outputs``: stdout, the files and stderr
    (but for the output paths and the rate line) must be byte-equal.
    ``engine``: reseek_tpu runs --engine host, the port ENGINES[engine].
    Returns reseek_tpu's (stdout, stderr, [file bytes])."""
    runs = []
    for who, main in (("tpu", tpu_cli.main), ("port", port_cli.main)):
        outs = [os.path.join(files["dir"], f"{o}.{who}") for o in outputs]
        extra = [] if engine is None else ENGINES[
            "host" if who == "tpu" else engine]
        capsys.readouterr()
        assert main(argv_of(*outs) + extra) == 0
        out, err = capsys.readouterr()
        err = "".join(ln for ln in err.replace(f".{who}", ".out").splitlines(
            True) if not ln.startswith("Seqs/sec"))
        runs.append((out, err, [open(o, "rb").read() for o in outs]))
    assert runs[1] == runs[0]
    return runs[0]


@pytest.mark.parametrize("engine", ["device", "host"])
@pytest.mark.parametrize("mode", ["fast", "sensitive"])
def test_scop40bench(files, capsys, mode, engine):
    out, _, (hits,) = _same(files, capsys, lambda o: [
        "scop40bench", files["sepq16"], f"--{mode}", "--lookup",
        files["sepq16_lookup"], "--output", o], [f"{mode}.tsv"], engine)
    assert out.startswith("SEPQ0.1=")
    rows = [r.split("\t") for r in hits.decode().splitlines()]
    assert len({q for q, t, _ in rows if q == t}) >= 12


@pytest.mark.parametrize("engine", ["device", "host"])
def test_distmx(files, capsys, engine):
    _, err, (mx,) = _same(files, capsys, lambda o: [
        "distmx", files["q16"], "--output", o], ["mx.tsv"], engine)
    assert mx and err.startswith("maxts ")


@pytest.mark.parametrize("engine", ["device", "host"])
def test_calibrate(files, capsys, engine):
    out, _, (fit,) = _same(files, capsys, lambda o: [
        "calibrate", files["q16"], "--output", o], ["fit.txt"], engine)
    assert "shipped:" in out and fit


def test_calibrate_prints_the_shipped_statsig(files):
    """calibrate's `shipped:` line is the port's copy of StatSig, equal to
    reseek_tpu's."""
    from reseek_tpu.constants import StatSig as TpuStatSig
    from reseek_tpu_torch.constants import StatSig
    for k in ("X1", "M0", "C0", "M", "C"):
        assert getattr(StatSig, k) == getattr(TpuStatSig, k)
    for ts in (-0.1, 0.0, 0.05, 0.11, 0.3):
        assert StatSig.pvalue(ts) == TpuStatSig.pvalue(ts)


def test_fast_self_search_device_matches_host(files):
    """The device self-search in fast mode (Omega 22, MKF from 500
    residues) on the port's plain kernels, byte-equal to reseek_tpu's
    host engine."""
    chains = read_chains(files["q16"])
    got, want = io.StringIO(), io.StringIO()
    drv = port_driver.self_search(
        chains, PortParams.create("fast"),
        port_driver.SearchOptions(columns=port_columns(COLUMNS),
                                  mode="fast"),
        got, engine="device", device="cpu")
    tpu_driver.self_search(chains, DSSParams.create("fast"),
                           SearchOptions(columns=parse_columns(COLUMNS),
                                         mode="fast"), want, engine="host")
    assert got.getvalue() == want.getvalue() and want.getvalue()
    assert drv.device_stats["survivors"] > 0


@pytest.mark.parametrize("engine", ["device", "host"])
def test_calibrate2(files, capsys, engine):
    out, _, (fit,) = _same(files, capsys, lambda o: [
        "calibrate2", files["sepq16"], "--benchlevel", "sf", "--output",
        o], ["cal2.tsv"], engine)
    assert out.startswith("Linear fit") and fit.startswith(b"TS\t")


def test_calibrate2_without_false_pairs(files, capsys, monkeypatch):
    """C3: with every chain in one superfamily (the four a.1.11.1 chains)
    the port's calibrate2 ends in a SystemExit before any search, where
    reseek_tpu's searches and then divides by the false-pair count 0."""
    with pytest.raises(ZeroDivisionError):
        tpu_cli.main(["calibrate2", files["a111"], "--benchlevel", "sf",
                      "--engine", "host"])

    def no_search(*a, **kw):
        raise AssertionError("calibrate2 searched a set without false "
                             "pairs")
    monkeypatch.setattr(port_driver, "self_search", no_search)
    for level in ("sf", "fold"):
        with pytest.raises(SystemExit, match="no false pairs at bench "
                                             f"level {level}"):
            port_cli.main(["calibrate2", files["a111"], "--benchlevel",
                           level, "--engine", "host"])


@pytest.mark.parametrize("cmd", ["scop40bench", "distmx", "calibrate",
                                 "calibrate2"])
@pytest.mark.parametrize("engine", ["auto", "device"])
def test_device_commands_need_a_card(files, monkeypatch, tmp_path, cmd,
                                     engine):
    """Without a card, --engine auto or device on cuda (the default)
    raises: the host engine is never a silent substitute."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_host(*a, **kw):
        raise AssertionError("fell back to the host engine")
    monkeypatch.setattr(port_driver.host, "self_search", no_host)
    argv = {"scop40bench": ["--lookup", files["sepq16_lookup"]],
            "distmx": ["--output", str(tmp_path / "mx")],
            "calibrate": [],
            "calibrate2": ["--benchlevel", "sf"]}[cmd]
    with pytest.raises(RuntimeError, match="cuda"):
        port_cli.main([cmd, files["sepq16"], *argv, "--engine", engine])


@pytest.mark.parametrize("cmd", [
    "scop40bench", "distmx", "calibrate", "calibrate2", "scop40bench-tsv",
    "scop40bit", "scop40bit2tsv", "scop40bit-roc", "scop40tsv2bit",
    "fit-gumbel", "test-gumbel", "prefilter-mu", "postmufilter"])
def test_help(capsys, cmd):
    with pytest.raises(SystemExit) as exc:
        port_cli.main([cmd, "--help"])
    assert exc.value.code == 0
    assert f"usage: python -m reseek_tpu_torch {cmd}" in capsys.readouterr(
        ).out


@pytest.mark.parametrize("evalues", [True, False])
def test_scop40bench_tsv(files, capsys, evalues):
    flag = [] if evalues else ["--scores-are-not-evalues"]
    out, _, _ = _same(files, capsys, lambda: [
        "scop40bench-tsv", HITS, "--lookup", SEPQ_LOOKUP, *flag])
    assert out.startswith("SEPQ0.1=")


def test_scop40bit_chain(files, capsys):
    """scop40bit (TSV -> .bit), then scop40bit2tsv and scop40bit-roc on
    the .bit it wrote and on the golden one."""
    _, err, (bit,) = _same(files, capsys, lambda o: [
        "scop40bit", HITS, "--lookup", SEPQ_LOOKUP, "--output", o], ["bit"])
    assert bit and "hits" in err
    bit_path = os.path.join(files["dir"], "bit.tpu")
    for src in (bit_path, BIT):
        _, _, (tsv,) = _same(files, capsys, lambda o: [
            "scop40bit2tsv", src, "--lookup", SEPQ_LOOKUP, "--output", o],
            ["bit.tsv"])
        assert tsv
        for flag in ([], ["--scores-are-not-evalues"]):
            out, _, _ = _same(files, capsys, lambda: [
                "scop40bit-roc", src, "--lookup", SEPQ_LOOKUP, *flag])
            assert out.startswith("SEPQ0.1=")


@pytest.mark.parametrize("field", [None, 3])
def test_scop40tsv2bit(files, capsys, field):
    flag = [] if field is None else ["--scorefieldnr", str(field)]
    out, _, (bit,) = _same(files, capsys, lambda o: [
        "scop40tsv2bit", HITS, "--input", SEPQ_CAL, "--output", o, *flag],
        ["tsv2bit"])
    assert bit and "Sens1FP" in out


def test_fit_gumbel(files, capsys):
    """fit-gumbel on a histogram made from a seed (`x0<TAB>dx`, then a
    count a line)."""
    rng = np.random.default_rng(8)
    counts, edges = np.histogram(rng.gumbel(1.1, 0.7, 2000), bins=40)
    path = os.path.join(files["dir"], "hist.txt")
    with open(path, "w") as f:
        f.write("%.6g\t%.6g\n" % (edges[0], edges[1] - edges[0]))
        f.writelines("%d\n" % c for c in counts)
    out, _, _ = _same(files, capsys, lambda: ["fit-gumbel", path])
    assert out.startswith("mu=")


def test_test_gumbel(files, capsys):
    out, _, _ = _same(files, capsys, lambda: ["test-gumbel"])
    assert out.startswith("FitScale")


@pytest.mark.parametrize("mode", ["idxq", "idxt"])
def test_prefilter_mu(files, capsys, mode):
    _, _, (tsv,) = _same(files, capsys, lambda o: [
        "prefilter-mu", files["q10_mu"], "--db", Q100_MU, "--output", o,
        "--mode", mode], [f"pf_{mode}"])
    assert tsv.startswith(b"prefilter\t")


def test_postmufilter(files, capsys):
    """The 10 queries' stage 2 over q100 as .bca from the prefilter-mu
    TSV of those queries (host kernels in both packages)."""
    pf = os.path.join(files["dir"], "pf_post.tsv")
    port_cli.main(["prefilter-mu", files["q10_mu"], "--db", Q100_MU,
                   "--output", pf, "--mode", "idxq"])
    assert len(open(pf).read().splitlines()) > 2
    _, _, (rows,) = _same(files, capsys, lambda o: [
        "postmufilter", files["q10"], "--db", files["q100_bca"], "--filin",
        pf, "--output", o, "--columns", COLUMNS], ["post"])
    assert rows


@pytest.mark.slow
def test_sepq_139_on_the_device_engine(capsys):
    """The full 139-chain set, sensitive, on the port's device engine on
    the CPU: the reference binary's SEPQs within 5e-4."""
    port_cli.main(["scop40bench", SEPQ_CAL, "--sensitive", "--lookup",
                   SEPQ_LOOKUP, "--engine", "device", "--device", "cpu"])
    line = capsys.readouterr().out.split()
    got = {k: float(v) for k, v in (f.split("=") for f in line[:3])}
    for k, ref in (("SEPQ0.1", 0.3831), ("SEPQ1", 0.6057),
                   ("SEPQ10", 0.6405)):
        assert abs(got[k] - ref) < 5e-4, (k, got[k])
