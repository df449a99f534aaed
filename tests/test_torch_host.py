"""The port's own copy of the host layer (reseek_tpu_torch: io, encoder,
align, the native host code, search/host.py) byte-equal to reseek_tpu's,
on the 16-chain q100 subset: the encoder's output, the host engine's
self, query-vs-DB and -fast TSVs, the .cal/.bca files.  The native
libraries load from reseek_tpu_torch/_build/; engine="auto" means the
device and raises without a card."""

import importlib
import io
from pathlib import Path

import numpy as np
import pytest
import torch

from reseek_tpu.align import pipeline as tpu_pipeline
from reseek_tpu.align.output import parse_columns as tpu_parse_columns
from reseek_tpu.constants import DSSParams as TpuParams
from reseek_tpu.io import bca as tpu_bca
from reseek_tpu.io import cal as tpu_cal
from reseek_tpu.io.reader import read_chains as tpu_read_chains
from reseek_tpu.search import driver as tpu_driver
from reseek_tpu_torch.align import pipeline
from reseek_tpu_torch.align.output import parse_columns
from reseek_tpu_torch.constants import DSSParams
from reseek_tpu_torch.io import bca, cal
from reseek_tpu_torch.io.reader import read_chains
from reseek_tpu_torch.parallel import multihost
from reseek_tpu_torch.search import driver, host

ROOT = Path(__file__).resolve().parent.parent
Q100 = str(ROOT / "tests" / "golden" / "q100.cal")
SUBSET = [18, 21, 22, 26, 40, 46, 50, 64, 69, 72, 94, 95, 96, 97, 98, 99]
COLUMNS = "query+target+qlo+qhi+tlo+thi+evalue+cigar"
NATIVE = ("encoder.native", "align.mkf_native", "ops.lddt", "ops.sw_native",
          "search.prefilter")


@pytest.fixture(scope="module")
def subset():
    """The subset as the port reads it, and as reseek_tpu reads it."""
    return ([read_chains(Q100)[i] for i in SUBSET],
            [tpu_read_chains(Q100)[i] for i in SUBSET])


def _run(fn, mode, *args, opts_cls, params_cls, columns, **kw) -> str:
    out = io.StringIO()
    fn(*args, params_cls.create(mode),
       opts_cls(columns=columns(COLUMNS), mode=mode), out, **kw)
    return out.getvalue()


def _both(name, mode, port_args, tpu_args, **kw):
    """(the port's host-engine TSV, reseek_tpu's host-engine TSV)."""
    got = _run(getattr(driver, name), mode, *port_args,
               opts_cls=host.SearchOptions, params_cls=DSSParams,
               columns=parse_columns, engine="host", **kw)
    want = _run(getattr(tpu_driver, name), mode, *tpu_args,
                opts_cls=tpu_driver.SearchOptions, params_cls=TpuParams,
                columns=tpu_parse_columns, engine="host", **kw)
    return got, want


def test_native_libraries_load_from_the_port_build():
    build = ROOT / "reseek_tpu_torch" / "_build"
    for mod in NATIVE:
        lib = importlib.import_module("reseek_tpu_torch." + mod)._lib()
        assert lib is not None, mod
        assert Path(lib._name).resolve().parent == build.resolve(), mod


def test_encoder_matches(subset):
    """Mu letters, k-mers, profiles and self-reversal scores."""
    params, tparams = DSSParams.create("sensitive"), TpuParams.create(
        "sensitive")
    for c, tc in zip(*subset):
        ec = pipeline.encode_for_search(c, params)
        tec = tpu_pipeline.encode_for_search(tc, tparams)
        assert np.array_equal(ec.mu_letters, tec.mu_letters), c.label
        assert np.array_equal(ec.mu_kmers, tec.mu_kmers), c.label
        assert np.array_equal(ec.profile, tec.profile), c.label
        assert ec.profile.dtype == tec.profile.dtype
        assert ec.self_rev_score == tec.self_rev_score, c.label


def test_self_search_matches(subset):
    got, want = _both("self_search", "sensitive", subset[:1], subset[1:])
    assert got == want and len(got.splitlines()) == 90


def test_query_search_matches(subset):
    port, tpu = subset
    got, want = _both("query_search", "sensitive", (port[:6], port),
                      (tpu[:6], tpu))
    assert got == want and got


def test_fast_search_matches(subset, tmp_path):
    """-fast with the DB as a .bca file and as a chain list."""
    port, tpu = subset
    db = str(tmp_path / "db.bca")
    bca.write_bca(port, db)
    for kw in ({}, {"prefilter_mode": "idxt"}):
        got, want = _both("fast_search", "fast", (port[:6], db),
                          (tpu[:6], db), **kw)
        assert got == want and got
    got, want = _both("fast_search", "fast", (port[:6], port),
                      (tpu[:6], tpu))
    assert got == want and got


def test_cal_bca_round_trip(subset, tmp_path):
    """Both packages write the same .cal and .bca bytes and read each
    file to the same chains; .cal gives the chains back as written (.bca
    stores its coordinates quantized)."""
    port, _ = subset
    for ext, write, twrite, read, tread in (
            ("cal", cal.write_cal, tpu_cal.write_cal, cal.read_cal,
             tpu_cal.read_cal),
            ("bca", bca.write_bca, tpu_bca.write_bca, bca.read_bca,
             tpu_bca.read_bca)):
        mine, theirs = tmp_path / f"port.{ext}", tmp_path / f"tpu.{ext}"
        write(port, str(mine))
        twrite(port, str(theirs))
        assert mine.read_bytes() == theirs.read_bytes(), ext
        got, want = read(str(mine)), tread(str(theirs))
        assert len(got) == len(want) == len(port)
        for a, b, c in zip(got, want, port):
            assert a.label == b.label == c.label and a.seq == b.seq == c.seq
            assert np.array_equal(a.coords, b.coords)
            if ext == "cal":
                assert np.array_equal(a.coords, c.coords)


def test_auto_engine_needs_a_card(subset, monkeypatch):
    """engine="auto" is the device engine: without a card every driver
    and the multi-process mesh raise before writing anything; the CPU runs
    only when asked for (engine="host", device="cpu")."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port, _ = subset
    params = DSSParams.create("sensitive")
    opts = host.SearchOptions(columns=parse_columns(COLUMNS))
    for fn, args in ((driver.self_search, (port[:2],)),
                     (driver.query_search, (port[:1], port[:2])),
                     (driver.fast_search, (port[:1], port[:2]))):
        out = io.StringIO()
        with pytest.raises(RuntimeError, match="cuda"):
            fn(*args, params, opts, out)
        assert out.getvalue() == ""
    with pytest.raises(RuntimeError, match="cuda"):
        multihost.global_mesh()
    assert multihost.global_mesh("cpu").devices[0].type == "cpu"
    out = io.StringIO()
    driver.self_search(port[:2], params, opts, out, engine="host")
    assert out.getvalue()


@pytest.mark.slow
def test_full_q100_self_search_matches():
    got = _run(driver.self_search, "sensitive", read_chains(Q100),
               opts_cls=host.SearchOptions, params_cls=DSSParams,
               columns=parse_columns, engine="host")
    want = _run(tpu_driver.self_search, "sensitive", tpu_read_chains(Q100),
                opts_cls=tpu_driver.SearchOptions, params_cls=TpuParams,
                columns=tpu_parse_columns, engine="host")
    assert got == want and len(got.splitlines()) == 428
