"""The port's copy of the benchmark evaluators (reseek_tpu_torch.benchmarks)
against reseek_tpu's: the SCOP40 evaluator and its readers, the .bit
dumps, and the calibration fits, on the in-repo hits and on numpy inputs
made from a seed.  The same numpy code on both sides, so every result is
held equal with tolerance 0."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from reseek_tpu.benchmarks import calibrate as tpu_cal
from reseek_tpu.benchmarks import scop40 as tpu_scop40
from reseek_tpu_torch.benchmarks import calibrate as port_cal
from reseek_tpu_torch.benchmarks import scop40 as port_scop40

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
HITS = os.path.join(GOLDEN, "sepq_hits3.tsv")
LOOKUP = os.path.join(GOLDEN, "sepq_set.lookup")
BIT = os.path.join(GOLDEN, "sepq_hits.bit")
SEED = 20260
torch.set_num_threads(1)


def test_readers_match():
    for fn, args in (("read_dom_scopid", (LOOKUP,)),
                     ("read_lookup_doms", (LOOKUP,)),
                     ("read_hits_tsv", (HITS,))):
        want = getattr(tpu_scop40, fn)(*args)
        got = getattr(port_scop40, fn)(*args)
        assert got == want and got, fn


@pytest.mark.parametrize("evalues", [True, False])
@pytest.mark.parametrize("level", ["sf2", "sf", "fold"])
def test_scop40_eval_matches(level, evalues):
    """evaluate and summary() on the real hits, at each level and score
    sense the evaluator takes."""
    d1, d2, sc = tpu_scop40.read_hits_tsv(HITS)
    hits = list(zip(d1, d2, sc))
    results = []
    for mod in (tpu_scop40, port_scop40):
        ev = mod.Scop40Eval(mod.read_dom_scopid(LOOKUP), level=level,
                            scores_are_evalues=evalues)
        results.append(ev.evaluate(iter(hits)))
    want, got = results
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.summary() == want.summary()
    assert want.ntp > 0 and want.nfp > 0


def test_scop40_eval_tsv_matches():
    want = tpu_scop40.Scop40Eval(
        tpu_scop40.read_dom_scopid(LOOKUP)).evaluate_tsv(HITS)
    got = port_scop40.Scop40Eval(
        port_scop40.read_dom_scopid(LOOKUP)).evaluate_tsv(HITS)
    assert got.summary() == want.summary()


def test_bit_round_trip_matches(tmp_path):
    """write_bit of the hits from both packages: identical bytes, and
    read_bit of either file gives identical arrays from both."""
    doms = tpu_scop40.read_lookup_doms(LOOKUP)
    idx = {d: i for i, d in enumerate(doms)}
    d1, d2, sc = tpu_scop40.read_hits_tsv(HITS)
    a = [idx[x] for x in d1]
    b = [idx[x] for x in d2]
    paths = []
    for name, mod in (("tpu", tpu_scop40), ("port", port_scop40)):
        p = str(tmp_path / f"{name}.bit")
        mod.write_bit(p, len(doms), a, b, sc)
        paths.append(p)
    with open(paths[0], "rb") as f, open(paths[1], "rb") as g:
        assert f.read() == g.read()
    for p in paths + [BIT]:
        want = tpu_scop40.read_bit(p)
        got = port_scop40.read_bit(p)
        assert got[0] == want[0]
        for x, y in zip(got[1:], want[1:]):
            assert x.dtype == y.dtype
            assert np.array_equal(x, y)


def test_read_bit_refuses_truncated(tmp_path):
    p = tmp_path / "short.bit"
    p.write_bytes(open(BIT, "rb").read()[:-4])
    for mod in (tpu_scop40, port_scop40):
        with pytest.raises(ValueError, match="truncated"):
            mod.read_bit(str(p))


@pytest.mark.parametrize("case", range(3))
def test_fit_gumbel_matches(case):
    rng = np.random.default_rng(SEED + case)
    mu, beta = rng.uniform(-1, 3), rng.uniform(0.3, 2)
    xs = np.sort(rng.uniform(-5, 15, 1)) + 0.25 * np.arange(48)
    ys = tpu_cal.gumbel_pdf(mu, beta, xs) * (1 + 0.05 * rng.normal(
        size=xs.size))
    want = tpu_cal.fit_gumbel(xs, ys, n_grid=24)
    got = port_cal.fit_gumbel(xs, ys, n_grid=24)
    assert got == want


@pytest.mark.parametrize("case", range(3))
def test_fit_log_linear_matches(case):
    rng = np.random.default_rng(SEED + 10 + case)
    ts = rng.gumbel(0.05, 0.03, 500 + 100 * case)
    n_queries = 40 + case
    want = tpu_cal.fit_log_linear(ts, n_queries=n_queries)
    got = port_cal.fit_log_linear(ts, n_queries=n_queries)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for t in (-0.1, 0.0, want.x1, 0.5):
        assert got.pvalue(t) == want.pvalue(t)
    with pytest.raises(ValueError):
        port_cal.fit_log_linear(ts[:9], n_queries=n_queries)


def test_gumbel_cdf_pdf_match():
    rng = np.random.default_rng(SEED + 20)
    xs = rng.uniform(-10, 30, 257)
    for mu, beta in ((1.3, 0.8), (-2.0, 3.5), (10.0, 0.1)):
        assert np.array_equal(port_cal.gumbel_cdf(mu, beta, xs),
                              tpu_cal.gumbel_cdf(mu, beta, xs))
        assert np.array_equal(port_cal.gumbel_pdf(mu, beta, xs),
                              tpu_cal.gumbel_pdf(mu, beta, xs))
