"""The port's query-vs-DB and -fast searches end to end on the CPU (plain
versions of the kernels), byte for byte against reseek_tpu's host engine
(and, for query-vs-DB, its JAX device engine), through the driver and the
command line."""

import io
import subprocess
import sys

import pytest
import torch

from reseek_tpu.align.output import parse_columns
from reseek_tpu.constants import DSSParams
from reseek_tpu.encoder.dss import encode_chain, feature_string
from reseek_tpu.io.bca import BCAWriter
from reseek_tpu.io.cal import write_cal
from reseek_tpu.io.reader import read_chains
from reseek_tpu.search import driver as tpu_driver
from reseek_tpu.search.driver import SearchOptions
from reseek_tpu.search.prefilter import prefilter_search
from reseek_tpu_torch.search import driver as torch_driver
from reseek_tpu_torch.search.host import _encode_all as port_encode_all

from test_torch_search import COLUMNS, Q100, ROOT

QUERIES = [18, 21, 22]
FAST_COLUMNS = "query+target+qlo+qhi+tlo+thi+evalue+cigar+muscore"
# the test workers share the host's cores: one torch thread each keeps the
# plain versions' many small ops from contending for them
torch.set_num_threads(1)


def _opts(mode, columns=COLUMNS):
    return SearchOptions(columns=parse_columns(columns), mode=mode,
                         max_evalue=10.0)


@pytest.fixture(scope="module")
def chains():
    return read_chains(Q100)


@pytest.fixture(scope="module")
def db_path(chains, tmp_path_factory):
    """The first 40 q100 chains as a .cal file."""
    path = tmp_path_factory.mktemp("db") / "db40.cal"
    with open(path, "w") as f:
        write_cal(chains[:40], f)
    return str(path)


@pytest.fixture(scope="module")
def query_host(chains):
    out = io.StringIO()
    tpu_driver.query_search([chains[i] for i in QUERIES], chains[:40],
                            DSSParams.create("sensitive"),
                            _opts("sensitive"), out, engine="host")
    assert out.getvalue().count("\n") > 5
    return out.getvalue()


def _query(chains, db, **kw):
    out = io.StringIO()
    drv = torch_driver.query_search(
        [chains[i] for i in QUERIES], db, DSSParams.create("sensitive"),
        _opts("sensitive"), out, engine="device", device="cpu", **kw)
    return out.getvalue(), drv


def test_query_search_matches_host_and_jax(chains, query_host):
    got, drv = _query(chains, chains[:40])
    assert got == query_host
    jax_dev = io.StringIO()
    tpu_driver.query_search([chains[i] for i in QUERIES], chains[:40],
                            DSSParams.create("sensitive"),
                            _opts("sensitive"), jax_dev, engine="device")
    assert got == jax_dev.getvalue()
    st = drv.device_stats
    assert st["chunks"] == 1 and st["mu_pairs"] >= st["survivors"] > 0
    assert drv.processed_pairs == 3 * 40 and drv.query_count == 40


def test_query_search_chunked_path_stream(chains, db_path, query_host):
    """A path-streamed DB in chunks of 16 (three engines, chunk N+1's
    encode overlapped) writes the same bytes."""
    got, drv = _query(chains, db_path, chunk_size=16)
    assert got == query_host
    assert drv.device_stats["chunks"] == 3


def test_query_search_e_prepass(chains, query_host, monkeypatch):
    """RESEEK_E_PREPASS_MIN=1 turns on the E-bound stage-2 prepass
    (the float row sweep): same bytes."""
    monkeypatch.setenv("RESEEK_E_PREPASS_MIN", "1")
    got, drv = _query(chains, chains[:40])
    assert got == query_host
    assert drv.device_stats["stage2_s"] > 0


def _fast(fn, chains, db, mode=None, **kw):
    out = io.StringIO()
    drv = fn([chains[i] for i in QUERIES], db, DSSParams.create("fast"),
             _opts("fast", FAST_COLUMNS), out, prefilter_mode=mode, **kw)
    return out.getvalue(), drv


@pytest.fixture(scope="module")
def fast_host(chains):
    """reseek_tpu's host -fast output on q100.cal, by prefilter mode."""
    return {mode: _fast(tpu_driver.fast_search, chains, Q100, mode,
                        engine="host")[0] for mode in (None, "idxt")}


@pytest.mark.parametrize("db,mode", [("cal", None), ("cal", "idxt"),
                                     ("bca", None), ("list", None)])
def test_fast_search_matches_host(chains, fast_host, tmp_path, db, mode):
    """-fast on q100 (prefilter, survivor read, device stage 2 with the
    muscore fill) against the host path: a .cal path (second-pass read),
    a .bca path (random-access read) and an in-memory list with some
    chains already encoded."""
    if db == "cal":
        src = Q100
    elif db == "bca":
        src = str(tmp_path / "q100.bca")
        with BCAWriter(src) as w:
            for c in chains:
                w.write_chain(c)
    else:
        # pre-encoded chains are the port's own EncodedChain
        src = (chains[:50]
               + port_encode_all(chains[50:], DSSParams.create("sensitive"),
                                 with_self_rev=False))
    got, drv = _fast(torch_driver.fast_search, chains, src, mode,
                     engine="device", device="cpu")
    assert got == fast_host[mode] and got.count("\n") > 10
    st = drv.fast_stats
    assert st["engine"] == "device" and st["candidates"] >= st["mu_pairs"]
    assert st["mkf_pairs"] > 0 and st["survivors"] > 0
    assert drv.processed_pairs == 3 * 100


def test_fast_search_dbmu_and_auto(chains, tmp_path):
    """-dbmu feeds the prefilter from a Mu FASTA; auto routing keeps
    reseek_tpu's rule (host stage 2 below RESEEK_FAST_DEVICE_MIN
    candidates) on the device it is given, and without a card raises
    unless that device is the CPU."""
    mufa = tmp_path / "db.mu.fa"
    with open(mufa, "w") as f:
        for c in chains:
            mu = feature_string(encode_chain(c), "Mu")
            f.write(f">{c.label}\n{mu}\n")
    want, _ = _fast(tpu_driver.fast_search, chains, Q100, engine="host",
                    dbmu=str(mufa))
    got, drv = _fast(torch_driver.fast_search, chains, Q100, engine="device",
                     device="cpu", dbmu=str(mufa))
    assert got == want
    auto, drv = _fast(torch_driver.fast_search, chains, Q100, device="cpu")
    assert auto == want
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            _fast(torch_driver.fast_search, chains, Q100)
    assert drv.fast_stats["engine"] == (
        "device" if torch.cuda.is_available()
        and drv.fast_stats["candidates"] >= 20000 else "host")


def test_idxq_selection_is_per_query(chains):
    """In idxq mode each query's top-B target list does not depend on the
    other queries, so a subset of queries can be checked against a run
    of all of them."""
    q_mu = [encode_chain(c).mu_letters for c in chains[:30]]
    t_mu = [(i, encode_chain(c).mu_letters) for i, c in enumerate(chains)]
    full = prefilter_search(q_mu, iter(t_mu), mode="idxq")
    pick = [2, 7, 18, 21, 29]
    sub = prefilter_search([q_mu[i] for i in pick], iter(t_mu), mode="idxq")
    for k, qi in enumerate(pick):
        assert sub.query_targets[k] == full.query_targets[qi]
        assert len(full.query_targets[qi]) > 0


def test_cli_db_and_fast_db(chains, db_path, query_host, tmp_path):
    """`--db` and `--fast --db` through the port's command line on the
    CPU write the host engine's bytes."""
    qpath = tmp_path / "q3.cal"
    with open(qpath, "w") as f:
        write_cal([chains[i] for i in QUERIES], f)
    base = [sys.executable, "-m", "reseek_tpu_torch", "search", str(qpath),
            "--columns", COLUMNS, "--engine", "device", "--device", "cpu"]
    out = tmp_path / "q.tsv"
    proc = subprocess.run(base + ["--sensitive", "--db", db_path, "-o",
                                  str(out)], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert out.read_text() == query_host
    fout = tmp_path / "f.tsv"
    proc = subprocess.run(base + ["--fast", "--db", Q100, "--idxt", "-o",
                                  str(fout)], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    want = io.StringIO()
    tpu_driver.fast_search(read_chains(str(qpath)), Q100,
                           DSSParams.create("fast"), _opts("fast"), want,
                           engine="host", prefilter_mode="idxt")
    assert fout.read_text() == want.getvalue()
