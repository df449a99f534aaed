"""The port's commands beside ``search``.  Their bodies and parsers are
copied from reseek_tpu.cli, and each output is byte-equal to ``python -m
reseek_tpu <cmd>`` (``--engine host`` for the search-driven ones).

  search-driven, on the device engine (``--engine auto|device|host``,
  ``--device cuda|cpu``; ``auto`` is the device, which raises without a
  card):  scop40bench, distmx, calibrate, calibrate2
  evaluator only:  scop40bench-tsv, scop40bit, scop40bit2tsv,
  scop40bit-roc, scop40tsv2bit
  fits only:  fit-gumbel, test-gumbel
  host, as in reseek_tpu:
    the Mu prefilter pair:  prefilter-mu, postmufilter
    structure I/O and formats:  convert (``--index`` writes a .rsdx that
    ``search`` loads), convert2mu, cif2pdb, chains2pdbs, getchains,
    pdb2ss, bca-stats, pdb2mega, shuffle, split, prepare-query, gunzip,
    gunzip-lines, scan-files
    Foldseek and MMseqs files:  create-foldseekdb, convert-foldseekdb,
    mmseqs-index-dump
    pair alignment on the host aligner:  alignpair, align-bag,
    align-bags, alignselfrev, tracealn, test-xdrop

``calibrate2`` ends in a SystemExit before any search when the set has no
false pair at its bench level, where reseek_tpu's raises ZeroDivisionError
after the search.
"""

from __future__ import annotations

import argparse
import io
import sys
from typing import Optional

import numpy as np


def add_mode_args(p: argparse.ArgumentParser) -> None:
    g = p.add_mutually_exclusive_group()
    g.add_argument("--fast", action="store_true")
    g.add_argument("--sensitive", action="store_true")
    g.add_argument("--verysensitive", action="store_true")


def mode_from_args(args, default: Optional[str] = None) -> str:
    if args.fast:
        return "fast"
    if args.sensitive:
        return "sensitive"
    if args.verysensitive:
        return "verysensitive"
    if default is None:
        raise SystemExit("Must set --fast, --sensitive or --verysensitive")
    return default


def add_engine_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--engine", default="auto",
                   choices=["auto", "device", "host"],
                   help="device engine (auto), or the host per-pair "
                        "engine")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device of the device engine")


def _self_search(args, chains, params, options, out) -> None:
    """The all-vs-all on the engine and device the command names; its
    driver (with ``device_stats`` on the device engine) is left on
    ``args.drv`` for a caller that runs the command in-process."""
    from reseek_tpu_torch.device import disable_tf32
    from reseek_tpu_torch.search.driver import self_search
    disable_tf32()
    args.drv = self_search(chains, params, options, out, engine=args.engine,
                           device=args.device)


def _options(columns: str, mode: str, **kw):
    from reseek_tpu_torch.align.output import parse_columns
    from reseek_tpu_torch.search.host import SearchOptions
    return SearchOptions(columns=parse_columns(columns), mode=mode, **kw)


def cmd_scop40bench(args) -> int:
    """All-vs-all SCOP40-style benchmark: self-search then SEPQ/ROC report
    (src/scop40bench.cpp:767, test_scripts/check_scop40.py)."""
    from reseek_tpu_torch.benchmarks.scop40 import (Scop40Eval,
                                                    read_dom_scopid)
    from reseek_tpu_torch.constants import DSSParams
    from reseek_tpu_torch.io.reader import read_chains

    mode = mode_from_args(args, default="fast")
    params = DSSParams.create(mode)
    options = _options("query+target+evalue", mode,
                       max_evalue=args.evalue if args.evalue is not None
                       else 10.0)
    chains = read_chains(args.input)
    buf = io.StringIO()
    _self_search(args, chains, params, options, buf)
    text = buf.getvalue()
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
    ev = Scop40Eval(read_dom_scopid(args.lookup))

    def gen():
        for line in text.splitlines():
            q, t, e = line.split("\t")
            yield q, t, float(e)
    print(ev.evaluate(gen()).summary())
    return 0


def cmd_distmx(args) -> int:
    """-distmx (src/distmx.cpp:26-64): all-vs-all self search writing
    `idxA<TAB>idxB<TAB>newts` rows for pairs with E <= max (Up rows only),
    then `maxts`."""
    from reseek_tpu_torch.constants import DSSParams
    from reseek_tpu_torch.io.reader import read_chains

    mode = mode_from_args(args, default="fast")
    params = DSSParams.create(mode)
    chains = read_chains(args.input)
    idx = {c.label: i for i, c in enumerate(chains)}
    opts = _options("query+target+newts+evalue", mode,
                    max_evalue=args.evalue if args.evalue is not None
                    else 10.0)
    buf = io.StringIO()
    _self_search(args, chains, params, opts, buf)
    max_ts = float("-inf")
    with open(args.output, "w") as f:
        seen = set()
        for line in buf.getvalue().splitlines():
            q, t, ts, _e = line.split("\t")
            key = (idx[q], idx[t])
            if key in seen:   # Up row only (src/distmx.cpp:28-29)
                continue
            seen.add(key)
            seen.add((key[1], key[0]))
            ts_f = float(ts)
            max_ts = max(max_ts, ts_f)
            f.write("%u\t%u\t%.3f\n" % (idx[q], idx[t], ts_f))
    print("maxts %.3f" % max_ts, file=sys.stderr)
    return 0


def cmd_calibrate(args) -> int:
    """P-value model calibration from an all-vs-all search of a decoy set
    (cmd_calibrate, src/calibrate.cpp:12-60 + src/gumbel.cpp): runs the
    search, histograms the test statistics, fits Gumbel + the two-piece
    log-linear StatSig model, and prints the fitted constants next to the
    shipped ones (src/statsig.cpp:27-44)."""
    from reseek_tpu_torch.benchmarks.calibrate import (fit_gumbel,
                                                       fit_log_linear)
    from reseek_tpu_torch.constants import DSSParams, StatSig
    from reseek_tpu_torch.io.reader import read_chains

    mode = mode_from_args(args, default="fast")
    params = DSSParams.create(mode)
    chains = [c for c in read_chains(args.input) if len(c) >= 1]
    options = _options("query+target+newts", mode, max_evalue=float("inf"),
                       scores_are_not_evalues=True)
    buf = io.StringIO()
    _self_search(args, chains, params, options, buf)
    ts_vals = []
    for line in buf.getvalue().splitlines():
        q, t, ts = line.split("\t")
        if q != t:           # self pairs are not decoys
            ts_vals.append(float(ts))
    ts = np.asarray(ts_vals, np.float64)
    if len(ts) < 10:
        raise SystemExit("too few aligned pairs to calibrate")
    # histogram (the reference bins per chain then accumulates; a global
    # TS histogram gives the same fitted curve family)
    nbins = 32
    ys, edges = np.histogram(ts, bins=nbins)
    xs = (edges[:-1] + edges[1:]) / 2
    mu, beta, _scale = fit_gumbel(xs, ys / max(ys.sum(), 1))
    fit = fit_log_linear(ts, n_queries=len(chains))
    print(f"gumbel: mu={mu:.6g} beta={beta:.6g}")
    print(f"loglinear: x1={fit.x1:.6g} m0={fit.m0:.6g} c0={fit.c0:.6g} "
          f"m={fit.m:.6g} c={fit.c:.6g}")
    print(f"shipped:   x1={StatSig.X1:.6g} m0={StatSig.M0:.6g} "
          f"c0={StatSig.C0:.6g} m={StatSig.M:.6g} c={StatSig.C:.6g}")
    if args.output:
        with open(args.output, "w") as f:
            f.write("%.6g\t%.6g\n" % (xs[0], xs[1] - xs[0]))
            for y in ys:
                f.write("%d\n" % y)
            f.write("# gumbel mu=%.6g beta=%.6g\n" % (mu, beta))
            f.write("# P(TS>=t) fit: x1=%.6g m0=%.6g c0=%.6g m=%.6g "
                    "c=%.6g\n" % (fit.x1, fit.m0, fit.c0, fit.m, fit.c))
    return 0


def cmd_calibrate2(args) -> int:
    """-calibrate2 (src/calibrate2.cpp:55-142): fit the P-value model
    from a labeled all-vs-all benchmark — ROC steps over TS, FP rate
    P(FP | TS >= t) = NFP/NQ^2 for thresholds with NFP in
    [NQ/100, NQ*100], linear fit of TS to -log(P) (f32 LinearFit,
    src/calibrate2.cpp:19-52).  Prints `Linear fit to -log(P) m=.. b=..`
    and the optional 5-column table.

    A set with no false pair at the bench level (every chain in one
    group) has no FP rate: it ends in a SystemExit before the search.
    When the reference's ROC-step smoothing (SmoothROCSteps: <=100
    subsampled points under --maxfpr) has too few steps, the raw
    in-window steps are fitted, with a warning."""
    from collections import Counter

    from reseek_tpu_torch.constants import DSSParams
    from reseek_tpu_torch.io.reader import read_chains

    params = DSSParams.create("fast")  # DM_DefaultFast
    chains = read_chains(args.input)
    doms = [c.label.partition("/")[0] for c in chains]
    scopids = {c.label.partition("/")[0]: c.label.partition("/")[2]
               for c in chains}
    level = args.benchlevel

    def group(d):
        parts = scopids[d].split(".")
        return ".".join(parts[:3] if level == "sf" else parts[:2])

    nq = len(doms)
    cnt = Counter(group(d) for d in doms)
    nt = sum(k * (k - 1) for k in cnt.values())
    nf = nq * (nq - 1) - nt
    if nf == 0:
        raise SystemExit(f"calibrate2: {args.input} has no false pairs at "
                         f"bench level {level} ({nq} chains, {len(cnt)} "
                         "group): nothing to calibrate")

    options = _options("query+target+newts", "fast", max_evalue=10.0)
    buf = io.StringIO()
    _self_search(args, chains, params, options, buf)
    hits = []
    for line in buf.getvalue().splitlines():
        q, t, ts = line.split("\t")
        hits.append((q.partition("/")[0], t.partition("/")[0], float(ts)))

    # GetROCSteps over TS descending (scop40benchroc.cpp:454-513)
    hits.sort(key=lambda h: -h[2])
    steps_ts, steps_ntp, steps_nfp = [], [], []
    cur = hits[0][2] if hits else 0.0
    ntp = nfp = 0
    for q, t, ts in hits:
        if q == t:
            continue
        if ts != cur:
            steps_ts.append(cur)
            steps_ntp.append(ntp)
            steps_nfp.append(nfp)
            cur = ts
        if group(q) == group(t):
            ntp += 1
        else:
            nfp += 1
    steps_ts.append(cur)
    steps_ntp.append(ntp)
    steps_nfp.append(nfp)

    # SmoothROCSteps (scop40benchroc.cpp:393-453): subsample to <=100
    # points below MaxFPR
    max_fpr = args.maxfpr if args.maxfpr is not None else 0.005
    ns = len(steps_ts)
    n = ns - 1
    for i in range(ns):
        if steps_nfp[i] / nf >= max_fpr:
            n = i
            break
    if ns >= 100 and n >= 200:
        nbins = 100
        idxs = [0] + [(b * n) // nbins for b in range(1, nbins - 1)] \
            + [n - 1]
    else:
        print(f"warning: only {n} ROC steps below FPR {max_fpr:g}; "
              "fitting raw in-window steps (the reference's smoothing "
              "needs >= 200)", file=sys.stderr)
        idxs = list(range(max(n, 1)))

    tss, ps = [], []
    for i in idxs:
        nfp_i = steps_nfp[i]
        if nfp_i < nq // 100:
            continue
        if nfp_i > nq * 100:
            break
        tss.append(np.float32(steps_ts[i]))
        ps.append(np.float32(nfp_i / float(nq * nq)))
    if len(tss) < 2:
        raise SystemExit("too few thresholds in the NFP window to fit")
    mlp = [np.float32(-np.log(p)) for p in ps]

    # LinearFit, f32 accumulation (src/calibrate2.cpp:19-52)
    sx = sx2 = sy = sxy = np.float32(0.0)
    for x, y in zip(tss, mlp):
        sx += x
        sx2 += x * x
        sy += y
        sxy += x * y
    nn = np.float32(len(tss))
    m = np.float32((nn * sxy - sx * sy) / (nn * sx2 - sx * sx))
    b = np.float32(sy / nn - m * (sx / nn))
    print("Linear fit to -log(P) m=%.3g b=%.3g" % (m, b))

    if args.output:
        with open(args.output, "w") as f:
            f.write("TS\tP\tMinusLogP\tMinusLogP_fit\tP_fit\n")
            for x, p, y in zip(tss, ps, mlp):
                yfit = np.float32(m * x + b)
                f.write("%.4g\t%.4g\t%.4g\t%.4g\t%.4g\n"
                        % (x, p, y, yfit, np.float32(np.exp(-yfit))))
    return 0


def cmd_scop40bit(args) -> int:
    """-scop40bit (src/scop40bit.cpp:6-16): hits TSV + lookup -> binary
    .bit hit dump (benchmark checkpoint artifact)."""
    from reseek_tpu_torch.benchmarks.scop40 import (read_hits_tsv,
                                                    read_lookup_doms,
                                                    write_bit)
    doms = read_lookup_doms(args.lookup)
    idx = {d: i for i, d in enumerate(doms)}
    d1, d2, sc = read_hits_tsv(args.hits)
    keep = [(idx[a], idx[b], s) for a, b, s in zip(d1, d2, sc)
            if a in idx and b in idx]
    write_bit(args.output, len(doms), [k[0] for k in keep],
              [k[1] for k in keep], [k[2] for k in keep])
    print(f"{len(keep)} hits, {len(doms)} doms -> {args.output}",
          file=sys.stderr)
    return 0


def cmd_scop40bit2tsv(args) -> int:
    """-scop40bit2tsv (src/scop40benchroc.cpp:681-723): .bit + lookup ->
    `dom1<TAB>dom2<TAB>%.6g score` rows."""
    from reseek_tpu_torch.benchmarks.scop40 import (_sf, read_bit,
                                                    read_dom_scopid,
                                                    read_lookup_doms)
    doms = read_lookup_doms(args.lookup)
    scopids = read_dom_scopid(args.lookup)
    # the reference stores "dom/SF" labels (AddDom,
    # src/scop40bench.cpp:176)
    labels = [f"{d}/{_sf(scopids[d])}" for d in doms]
    n_doms, d1, d2, sc = read_bit(args.bit)
    if n_doms != len(doms):
        raise SystemExit(f"dom count mismatch: .bit {n_doms}, "
                         f"lookup {len(doms)}")
    with open(args.output, "w") as out:
        for a, b, s in zip(d1, d2, sc):
            out.write("%s\t%s\t%.6g\n" % (labels[a], labels[b], s))
    print(f"{len(d1)} hits", file=sys.stderr)
    return 0


def cmd_scop40bit_roc(args) -> int:
    """-scop40bit_roc (src/scop40benchroc.cpp:788-802): SEPQ/ROC report
    from a .bit dump."""
    from reseek_tpu_torch.benchmarks.scop40 import (Scop40Eval, read_bit,
                                                    read_dom_scopid,
                                                    read_lookup_doms)
    doms = read_lookup_doms(args.lookup)
    n_doms, d1, d2, sc = read_bit(args.bit)
    if n_doms != len(doms):
        raise SystemExit("dom count mismatch")
    ev = Scop40Eval(read_dom_scopid(args.lookup),
                    scores_are_evalues=not args.scores_are_not_evalues)
    res = ev.evaluate((doms[a], doms[b], float(s))
                      for a, b, s in zip(d1, d2, sc))
    print(res.summary())
    return 0


def cmd_scop40bench_tsv(args) -> int:
    """-scop40bench_tsv (src/scop40benchroc.cpp:772-786): SEPQ/ROC
    report from a hits TSV + lookup."""
    from reseek_tpu_torch.benchmarks.scop40 import (Scop40Eval,
                                                    read_dom_scopid,
                                                    read_hits_tsv)
    d1, d2, sc = read_hits_tsv(args.hits)
    ev = Scop40Eval(read_dom_scopid(args.lookup),
                    scores_are_evalues=not args.scores_are_not_evalues)
    res = ev.evaluate(zip(d1, d2, (float(s) for s in sc)))
    print(res.summary())
    return 0


def cmd_scop40tsv2bit(args) -> int:
    """-scop40tsv2bit (src/scop40benchroc.cpp:760-770): structures give
    the dom list (labels `dom/cls.fold.sf.fam`), a hits TSV gives scored
    pairs; writes the binary .bit hit dump and prints hit count +
    sensitivity-to-first-FP."""
    from reseek_tpu_torch.benchmarks.scop40 import Scop40Eval, write_bit
    from reseek_tpu_torch.io.reader import read_chains

    chains = read_chains(args.input)
    doms, dom2scopid = [], {}
    for c in chains:
        dom, _, scopid = c.label.partition("/")
        doms.append(dom)
        dom2scopid[dom] = scopid
    idx = {d: i for i, d in enumerate(doms)}
    score_col = (args.scorefieldnr - 1) if args.scorefieldnr else 2
    d1, d2, sc = [], [], []
    with open(args.hits) as f:
        for line in f:
            fields = line.rstrip("\n").split("\t")
            a = fields[0].partition("/")[0]
            b = fields[1].partition("/")[0]
            if a not in idx or b not in idx:
                raise SystemExit(f"unknown dom in hits: {a} {b}")
            d1.append(idx[a])
            d2.append(idx[b])
            sc.append(float(fields[score_col]))
    if args.output:
        write_bit(args.output, len(doms), d1, d2, sc)
    ev = Scop40Eval(dom2scopid)
    res = ev.evaluate((doms[a], doms[b], s)
                      for a, b, s in zip(d1, d2, sc))
    print(f"{len(d1)} hits, Sens1FP {res.n_first_fp}")
    return 0


def cmd_fit_gumbel(args) -> int:
    """Fit Scale*Gumbel(mu, beta) to a histogram file; input format of
    cmd_fit_gumbel (src/gumbel.cpp:253-283): first line `x0<TAB>dx`, then
    one y value per line; ys normalized to sum 1."""
    from reseek_tpu_torch.benchmarks.calibrate import fit_gumbel
    with open(args.input) as f:
        lines = [line.strip() for line in f if line.strip()]
    x0, dx = (float(v) for v in lines[0].split("\t"))
    ys = np.array([float(v) for v in lines[1:]], np.float64)
    ys = ys / ys.sum()
    xs = x0 + dx * np.arange(len(ys))
    mu, beta, scale = fit_gumbel(xs, ys)
    print(f"mu={mu:.6g} beta={beta:.6g} scale={scale:.6g}")
    return 0


def cmd_test_gumbel(args) -> int:
    """-test_gumbel (src/gumbel.cpp:230-251): self-test of the Gumbel
    fitter — generate gumbel(mu=1.3, beta=0.8) on [-5, 20) step 0.1, fit,
    print the recovered parameters."""
    from reseek_tpu_torch.benchmarks.calibrate import fit_gumbel, gumbel_pdf
    xs = np.arange(-5.0, 20.0, 0.1)
    ys = gumbel_pdf(1.3, 0.8, xs)
    mu, beta, scale = fit_gumbel(xs, ys)
    print("FitScale %.3g, FitMu %.3g, FitBeta %.3g" % (scale, mu, beta))
    return 0


def cmd_prefilter_mu(args) -> int:
    """-prefilter_mu (src/cmd_prefiltermu.cpp:50-130): Mu k-mer two-hit
    prefilter of a query Mu FASTA against a target Mu FASTA; writes the
    RankedScoresBag TSV (`prefilter<TAB>n` header, then
    `targetIdx<TAB>nQ<TAB>q1 q2 ...` rows, rankedscoresbag.cpp:185-232)."""
    import time

    from reseek_tpu_torch.search.prefilter import (prefilter_search,
                                                   read_mu_fasta)
    _qlabels, q_mu = read_mu_fasta(args.input)
    _tlabels, t_mu = read_mu_fasta(args.db)
    t0 = time.time()
    # both sides come from Mu FASTA -> both already in g_CharToLetterMu
    # space; no extra query-side swap (unlike the -search pipeline)
    pf = prefilter_search(q_mu, enumerate(t_mu), mode=args.mode,
                          ascii_roundtrip=False)
    secs = max(time.time() - t0, 1e-9)
    print("Seqs/sec         %.3g" % (len(t_mu) / secs), file=sys.stderr)
    t2q = pf.target_to_queries()
    with open(args.output, "w") as f:
        f.write("prefilter\t%u\n" % len(t2q))
        for tidx in sorted(t2q):
            qs = t2q[tidx]
            f.write("%u\t%u" % (tidx, len(qs)))
            for q in qs:
                f.write("\t%u" % q)
            f.write("\n")
    return 0


def cmd_postmufilter(args) -> int:
    """-postmufilter (src/postmufilter.cpp:303-326): standalone stage 2
    of the fast pipeline — read a prefilter TSV (the prefilter-mu
    output: `prefilter<TAB>n` header then `tidx<TAB>nQ<TAB>q1 q2 ...`),
    re-read surviving targets from the .bca and align them against the
    query set with SENSITIVE parameters on the host kernels, emitting one
    row per hit."""
    from reseek_tpu_torch.constants import DSSParams
    from reseek_tpu_torch.io.bca import BCAReader
    from reseek_tpu_torch.io.reader import read_chains
    from reseek_tpu_torch.search.host import (SearchDriver, _encode_all,
                                              _fast_align_host)

    sens = DSSParams.create("sensitive")
    queries = read_chains(args.input)
    t2q = {}
    with open(args.filin) as f:
        header = f.readline().split()
        if not header or header[0] != "prefilter":
            raise SystemExit(f"{args.filin}: not a prefilter TSV")
        for line in f:
            parts = [int(x) for x in line.split()]
            t2q[parts[0]] = parts[2: 2 + parts[1]]
    options = _options(args.columns, "sensitive",
                       max_evalue=args.evalue if args.evalue is not None
                       else 10.0)
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        drv = SearchDriver(sens, options, out)
        q_ecs = _encode_all(queries, sens, with_self_rev=False)

        def survivors():
            # filter-TSV line order (the reference scans lines in order)
            with BCAReader(args.db) as r:
                for tidx in t2q:
                    yield tidx, r.read_chain(tidx)

        _fast_align_host(drv, q_ecs, survivors(), t2q, sens)
    finally:
        if args.output:
            out.close()
    return 0


def cmd_convert(args) -> int:
    """Format conversion with the reference's chain filters
    (src/convert.cpp:110-199: -reverse, -flip, label set, -minchainlength,
    -subsample N keeps every Nth input chain)."""
    from reseek_tpu_torch.encoder.dss import encode_chain, feature_string
    from reseek_tpu_torch.io.bca import BCAWriter
    from reseek_tpu_torch.io.cal import write_cal
    from reseek_tpu_torch.io.reader import read_chains

    label_set = None
    if args.labels:
        with open(args.labels) as f:
            label_set = {line.strip().upper() for line in f if line.strip()}

    from reseek_tpu_torch.chain import Chain
    chains = []
    for i, c in enumerate(read_chains(args.input), 1):
        if args.reverse:
            # in-place Reverse() keeps the label (src/pdbchain.cpp:470-483)
            c = Chain(c.label, c.seq[::-1], c.coords[::-1].copy())
        if args.flip:
            c = c.flipped()
        if label_set is not None and c.label.upper() not in label_set:
            continue
        if args.minchainlength and len(c) < args.minchainlength:
            continue
        if args.subsample and i % args.subsample != 0:
            continue
        chains.append(c)
    if args.bca:
        with BCAWriter(args.bca) as w:
            for c in chains:
                w.write_chain(c)
    if args.cal:
        with open(args.cal, "w") as f:
            write_cal(chains, f)
    if args.fasta:
        from reseek_tpu_torch.io.mufasta import seq_to_fasta
        with open(args.fasta, "w") as f:
            for c in chains:
                seq_to_fasta(f, c.label, c.seq)
    if args.pdb:
        # multi-PDB: MODEL/TITLE/ENDMDL per chain (src/convert.cpp:169-182)
        from reseek_tpu_torch.io.pdb import write_pdb
        with open(args.pdb, "w") as f:
            for k, c in enumerate(chains):
                f.write("MODEL%10u\n" % k)
                f.write("TITLE     %s\n" % (c.label or "_blank_%u" % k))
                write_pdb(c, f)
                f.write("ENDMDL\n")
    if args.feature_fasta:
        from reseek_tpu_torch.io.mufasta import seq_to_fasta
        with open(args.feature_fasta, "w") as f:
            for c in chains:
                seq_to_fasta(f, c.label,
                             feature_string(encode_chain(c), args.alpha))
    if args.index:
        from reseek_tpu_torch.io.artifact import write_artifact
        modes = [m for m in args.index_modes.split(",") if m]
        write_artifact(args.index, chains, modes=modes,
                       progress=lambda i, n: print(
                           f"\rindexed {i}/{n} chains", end="",
                           file=sys.stderr))
        print(file=sys.stderr)
    print(f"{len(chains)} chains converted", file=sys.stderr)
    return 0


def cmd_convert2mu(args) -> int:
    """-convert2mu (src/convert2mu.cpp:7-60): structures -> Mu-letter
    FASTA (streamed)."""
    from reseek_tpu_torch.encoder.dss import encode_chain, feature_string
    from reseek_tpu_torch.io.mufasta import seq_to_fasta
    from reseek_tpu_torch.io.reader import iter_chains
    n = 0
    with open(args.output, "w") as f:
        for c in iter_chains(args.input):
            if len(c) < max(args.minchainlength, 1):
                continue
            seq_to_fasta(f, c.label, feature_string(encode_chain(c), "Mu"))
            n += 1
    print(f"{n} chains converted", file=sys.stderr)
    return 0


def cmd_cif2pdb(args) -> int:
    """-cif2pdb (src/cif2pdb.cpp:238): mmCIF -> PDB."""
    from reseek_tpu_torch.io.cif import read_cif
    from reseek_tpu_torch.io.pdb import write_pdb
    chains = list(read_cif(args.input))
    with open(args.output, "w") as f:
        for c in chains:
            write_pdb(c, f)
    print(f"{len(chains)} chains written", file=sys.stderr)
    return 0


def cmd_chains2pdbs(args) -> int:
    """Write each chain to its own PDB file (src/chains2pdbs.cpp)."""
    import os
    from reseek_tpu_torch.io.pdb import write_pdb
    from reseek_tpu_torch.io.reader import read_chains
    os.makedirs(args.outdir, exist_ok=True)
    n = 0
    for c in read_chains(args.input):
        safe = c.label.replace("/", "_")
        with open(os.path.join(args.outdir, safe + ".pdb"), "w") as f:
            write_pdb(c, f)
        n += 1
    print(f"{n} chains written", file=sys.stderr)
    return 0


def cmd_getchains(args) -> int:
    """List chain labels and lengths."""
    from reseek_tpu_torch.io.reader import read_chains
    for c in read_chains(args.input):
        print(f"{c.label}\t{len(c)}")
    return 0


def cmd_pdb2ss(args) -> int:
    from reseek_tpu_torch.encoder.dss import encode_chain
    from reseek_tpu_torch.io.reader import read_chains

    for c in read_chains(args.input):
        print(f"{c.label}   SecStr  {encode_chain(c).ss_string}")
    return 0


def cmd_bca_stats(args) -> int:
    from reseek_tpu_torch.io.bca import BCAReader

    with BCAReader(args.input) as r:
        print(f"{len(r):10d}  Chains")
        print(f"{int(r.seq_lengths.sum()):10d}  Residues")
    return 0


def cmd_pdb2mega(args) -> int:
    """Input file for Muscle-3D MSA (src/pdb2mega.cpp): header, per-feature
    freqs + weighted log-odds (lower triangles), then per-residue profile
    letter strings."""
    from reseek_tpu_torch.constants import ALPHA_SIZES, AMINO_ALPHABET, DSSParams
    from reseek_tpu_torch.data.tables import get_tables
    from reseek_tpu_torch.encoder.dss import encode_chain
    from reseek_tpu_torch.io.reader import read_chains
    from reseek_tpu_torch.ops.substmx import weighted_matrices

    params = DSSParams.create("fast")
    t = get_tables()
    mats = weighted_matrices(params.features, params.weights)
    chains = read_chains(args.input)
    if args.reverse:
        chains = [c.reversed() for c in chains]
    nf = len(params.features)
    with open(args.output, "w") as f:
        f.write(f"mega\t{nf}\t{len(chains)}\t"
                f"{-params.gap_open:.4g}\t{-params.gap_ext:.4g}\n")
        for i, feat in enumerate(params.features):
            a = ALPHA_SIZES[feat]
            f.write(f"{i}\t{feat}\t{a}\t{params.weights[i]:.6g}\n")
            freqs = t.bg_freqs(feat)
            f.write("freqs" + "".join(f"\t{v:.4g}" for v in freqs[:a])
                    + "\n")
            fm = t.freq_mx(feat)
            for l1 in range(a):
                f.write(str(l1) + "".join(f"\t{fm[l1, l2]:.4g}"
                                          for l2 in range(l1 + 1)) + "\n")
            f.write("logoddsmx\n")
            sm = mats[feat]
            for l1 in range(a):
                c = (AMINO_ALPHABET[l1] if feat == "AA"
                     else chr(ord("a") + l1))
                f.write(f"{l1}\t{c}" + "".join(
                    f"\t{sm[l1, l2]:.4g}" for l2 in range(l1 + 1)) + "\n")
        for ci, chain in enumerate(chains):
            enc = encode_chain(chain)
            prof = enc.profile(params)
            f.write(f"chain\t{ci}\t{chain.label}\t{len(chain)}\n")
            for pos in range(len(chain)):
                srow = []
                for fi, feat in enumerate(params.features):
                    if feat == "AA":
                        srow.append(chain.seq[pos])
                    else:
                        srow.append(chr(ord("A") + int(prof[fi, pos])))
                f.write(f"{ci}\t{pos}\t{''.join(srow)}\n")
    print(f"{len(chains)} chains written", file=sys.stderr)
    return 0


def cmd_shuffle(args) -> int:
    """-shuffle (src/shuffle.cpp:5-26): random chain order -> .bca."""
    import random

    from reseek_tpu_torch.io.bca import BCAWriter
    from reseek_tpu_torch.io.reader import read_chains
    chains = read_chains(args.input)
    order = list(range(len(chains)))
    rng = random.Random(args.seed)
    rng.shuffle(order)
    with BCAWriter(args.bca) as w:
        for i in order:
            w.write_chain(chains[i])
    print(f"{len(chains)} chains shuffled", file=sys.stderr)
    return 0


def cmd_split(args) -> int:
    """-split (src/split.cpp:107-130): divide a DB into N .bca splits of
    ceil(count/N) chains each, filenames <prefix><k>.bca."""
    from reseek_tpu_torch.io.bca import BCAWriter
    from reseek_tpu_torch.io.reader import read_chains
    chains = [c for c in read_chains(args.input)
              if len(c) >= max(args.minchainlength, 1)]
    per = -(-len(chains) // args.n)
    print(f"{per} chains/split", file=sys.stderr)
    for k in range(args.n):
        part = chains[k * per: (k + 1) * per]
        if not part:
            break
        with BCAWriter(f"{args.prefix}{k + 1}.bca") as w:
            for c in part:
                w.write_chain(c)
    return 0


def _global_pctid(seq_i: str, seq_j: str) -> float:
    """prepare_query's GetPctId (src/prepare_query.cpp:10-45): BLOSUM62
    global alignment (open -1, ext -0.05, free terminal gaps,
    ViterbiFastMem char overload), identities / columns."""
    from reseek_tpu_torch.data.blosum62 import char_subst_mx
    from reseek_tpu_torch.ops.nw import nw_align
    if seq_i == seq_j:
        return 100.0
    m = char_subst_mx()
    a = np.frombuffer(seq_i.encode("latin-1"), np.uint8)
    b = np.frombuffer(seq_j.encode("latin-1"), np.uint8)
    _score, path = nw_align(m[a[:, None], b[None, :]])
    pa = pb = ids = 0
    for c in path:
        if c == "M":
            if seq_i[pa] == seq_j[pb]:
                ids += 1
            pa += 1
            pb += 1
        elif c == "D":
            pa += 1
        else:
            pb += 1
    return (100.0 * ids) / len(path)


def cmd_prepare_query(args) -> int:
    """-prepare_query (src/prepare_query.cpp:48-130): keep up to N query
    chains that are >= minchainlength and < 90% BLOSUM-global-identity
    to an earlier kept chain; status TSV + .bca output.  Like the
    reference, -n is only honored when -minchainlength is given
    (otherwise the cap is 4)."""
    from reseek_tpu_torch.io.bca import BCAWriter
    from reseek_tpu_torch.io.reader import read_chains
    chains = read_chains(args.input)
    min_len = (args.minchainlength if args.minchainlength is not None
               else 1)
    max_chains = (args.n if args.minchainlength is not None else 4)
    kept = []
    n_queries = 0
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        for i, c in enumerate(chains):
            out.write(f"{i}\t{c.label}\t{len(c)}")
            if len(c) < min_len:
                out.write("\tshort\n")
                continue
            if n_queries >= max_chains:
                out.write("\ttoomany\n")
                continue
            dup = None
            for j, k in kept:
                if len(k) < min_len:
                    continue
                pct = _global_pctid(c.seq, k.seq)
                if pct >= 90.0:
                    dup = (pct, j)
                    break
            if dup is not None:
                out.write("\t%.1f%%%u\n" % dup)
                continue
            kept.append((i, c))
            n_queries += 1
            out.write("\tquery\n")
    finally:
        if args.output:
            out.close()
    if args.bca:
        with BCAWriter(args.bca) as w:
            for _j, c in kept:
                w.write_chain(c)
    print(f"{len(kept)} queries kept", file=sys.stderr)
    return 0


def cmd_gunzip(args) -> int:
    """-gunzip (src/gzipfileio.cpp:90-111)."""
    import gzip
    import shutil
    with gzip.open(args.input, "rb") as fin, \
            open(args.output, "wb") as fout:
        shutil.copyfileobj(fin, fout)
    return 0


def cmd_gunzip_lines(args) -> int:
    """-gunzip_lines (src/gzipfileio.cpp): gunzip to text lines."""
    import gzip
    with gzip.open(args.input, "rt") as f:
        lines = [ln.rstrip("\r\n") for ln in f]
    if args.output:
        with open(args.output, "w") as out:
            for ln in lines:
                out.write(ln + "\n")
    return 0


def cmd_scan_files(args) -> int:
    """-scan_files (src/pdbfilescanner.cpp:138-162): list every structure
    file the scanner finds under a directory / .files list."""
    from reseek_tpu_torch.io.reader import scan_structure_files
    files = scan_structure_files(args.input)
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        for fn in files:
            out.write(fn + "\n")
    finally:
        if args.output:
            out.close()
    print(f"{len(files)} files total", file=sys.stderr)
    return 0


def cmd_create_foldseekdb(args) -> int:
    """-create_foldseekdb (src/create_foldseekdb.cpp:17-170): write a
    Foldseek-format database from structures + a 3Di FASTA (byte-level
    format parity incl. the packed int16-delta C-alpha codec)."""
    from reseek_tpu_torch.io.foldseek import write_foldseek_db
    from reseek_tpu_torch.io.mufasta import iter_fasta
    from reseek_tpu_torch.io.reader import read_chains

    chains = read_chains(args.input)
    seqs_3di = {label.split()[0]: seq
                for label, seq in iter_fasta(args.tdi)}
    n = write_foldseek_db(chains, seqs_3di, args.output, dupes=args.n)
    print(f"{n} entries -> {args.output}", file=sys.stderr)
    return 0


def cmd_convert_foldseekdb(args) -> int:
    """-convert_foldseekdb (src/convert_foldseekdb.cpp:140-267): parse a
    Foldseek database back to aa FASTA, 3Di FASTA and/or .cal."""
    from reseek_tpu_torch.chain import Chain
    from reseek_tpu_torch.io.cal import write_cal
    from reseek_tpu_torch.io.foldseek import read_foldseek_db

    from reseek_tpu_torch.io.mufasta import seq_to_fasta
    entries = read_foldseek_db(args.prefix)
    if args.fasta:
        with open(args.fasta, "w") as f:
            for label, seq, _s3, _c in entries:
                seq_to_fasta(f, label, seq)
    if args.tdi:
        with open(args.tdi, "w") as f:
            for label, _seq, s3, _c in entries:
                seq_to_fasta(f, label, s3)
    if args.cal:
        chains = [Chain(label, seq, coords)
                  for label, seq, _s3, coords in entries]
        write_cal(chains, args.cal)
    print(f"{len(entries)} entries from {args.prefix}", file=sys.stderr)
    return 0


def cmd_mmseqs_index_dump(args) -> int:
    """-mmseqs_index_dump (src/mmseqs_index_dump.cpp:21-96): dump an
    MMseqs2/Foldseek hits DB (prefix + .index + .dbtype) as text —
    `index\\t<pos>\\t<len>` per record then its lines, non-printing bytes
    shown as '@'."""
    import os as _os
    prefix = args.prefix
    with open(prefix + ".dbtype", "rb") as f:
        dbtype = f.read()
    if len(dbtype) != 4:
        raise SystemExit(f"{prefix}.dbtype: expected 4 bytes")
    print("0x%04x  %s.dbtype" % (int.from_bytes(dbtype, "little"),
                                 prefix), file=sys.stderr)
    out = open(args.output, "w") if args.output else None
    recnr = hitcount = nonprint = 0
    nextpos = 0
    with open(prefix, "rb") as fhits, open(prefix + ".index") as fidx:
        for line in fidx:
            recidx, recpos, reclen = (int(x) for x in line.split("\t"))
            if recidx != recnr or recpos != nextpos or reclen <= 0:
                raise SystemExit(
                    f"bad index record {recnr}: {line.strip()}")
            recnr += 1
            nextpos += reclen
            fhits.seek(recpos)
            buf = fhits.read(reclen)
            if buf[-1] != 0:
                raise SystemExit(f"record {recidx} not NUL-terminated")
            if out is not None:
                out.write(f"index\t{recpos}\t{reclen}\n")
                for b in buf[:-1]:
                    c = chr(b)
                    if c == "\n":
                        out.write("\n")
                        hitcount += 1
                    elif c.isprintable() or c == "\t":
                        out.write(c)
                    else:
                        nonprint += 1
                        out.write("@")
                out.write("\n")
    if out is not None:
        out.close()
    if nextpos != _os.path.getsize(prefix):
        print("warning: index does not cover the hits file "
              f"({nextpos} != {_os.path.getsize(prefix)})",
              file=sys.stderr)
    print(f"{recnr} records, {hitcount} hits, {nonprint} "
          "non-printing bytes", file=sys.stderr)
    return 0


def cmd_alignpair(args) -> int:
    from reseek_tpu_torch.align.output import format_row
    from reseek_tpu_torch.align.pipeline import PairAligner, encode_for_search
    from reseek_tpu_torch.constants import DSSParams
    from reseek_tpu_torch.io.reader import read_chains
    from reseek_tpu_torch.ops.kabsch import kabsch_path

    params = DSSParams.create("sensitive")
    params.omega = 0.0  # src/alignpair.cpp:179-185
    qs = read_chains(args.input, save_lines=True)
    ts = read_chains(args.input2, save_lines=True)
    if not qs or not ts:
        raise SystemExit("No chains found")

    pa = PairAligner(params)
    best = None
    for qc in qs:
        q = encode_for_search(qc, params)
        for tc in ts:
            t = encode_for_search(tc, params)
            res = pa.align(q, t, apply_filter=False)
            if best is None or res.fwd_score > best[0].fwd_score:
                best = (res, q, t)
    res, q, t = best
    if args.global_aln:
        from reseek_tpu_torch.ops.nw import nw_align
        from reseek_tpu_torch.ops.substmx import build_smx
        smx = build_smx(params, q.profile, t.profile)
        score, path = nw_align(smx)
        res.fwd_score, res.lo_a, res.lo_b, res.path = score, 0, 0, path
        from reseek_tpu_torch.search.engine import finish_result
        res.hi_a = len(q) - 1
        res.hi_b = len(t) - 1
        finish_result(res, q, t, params)
    if not res.path:
        raise SystemExit("No alignment found")

    cols = ["query", "target", "qlo", "qhi", "tlo", "thi", "pctid",
            "dpscore", "lddt", "newts", "evalue", "cigar"]
    print(format_row(cols, res, q, t, True))

    if args.aln:
        from reseek_tpu_torch.align.output import _row_strings
        ra, rb = _row_strings(res, q, t, True, False)
        with open(args.aln, "w") as f:
            f.write(f"Query   >{q.label}\nTarget  >{t.label}\n\n")
            for k in range(0, len(ra), 80):
                f.write(ra[k:k + 80] + "\n" + rb[k:k + 80] + "\n\n")
            f.write(f"E-value {res.evalue:.3g}  dpscore {res.fwd_score:.4g}"
                    f"  lddt {res.lddt:.4g}\n")
    if args.output:
        t_vec, u, _msd = kabsch_path(q.chain.coords, t.chain.coords,
                                     res.lo_a, res.lo_b, res.path)
        rotated = q.chain.transformed(t_vec, u)
        from reseek_tpu_torch.io.pdb import write_pdb
        with open(args.output, "w") as f:
            write_pdb(rotated, f)
    return 0


def cmd_align_bag(args) -> int:
    """-align_bag (src/align_bag.cpp:49-94): align exactly one chain
    from each of two files through the MKF bag path (sensitive, UsePara
    off, Omega 0) and print the pretty alignment."""
    from reseek_tpu_torch.align.mkf import align_mkf
    from reseek_tpu_torch.align.pipeline import encode_for_search
    from reseek_tpu_torch.align.prettyaln import pretty_aln
    from reseek_tpu_torch.constants import DSSParams
    from reseek_tpu_torch.io.reader import read_chains

    params = DSSParams.create("sensitive")
    params.use_para = False
    params.omega = 0.0
    qs = read_chains(args.input)
    ts = read_chains(args.input2)
    if len(qs) != 1 or len(ts) != 1:
        raise SystemExit("align-bag needs exactly one chain per file")
    q = encode_for_search(qs[0], params)
    t = encode_for_search(ts[0], params)
    res = align_mkf(q, t, params)
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        if not res.path:
            print("No alignment found", file=sys.stderr)
        else:
            pretty_aln(out, res, q, t, True)
    finally:
        if args.output:
            out.close()
    return 0


def cmd_align_bags(args) -> int:
    """MKF-vs-full-SW self-check (reference -align_bags,
    src/align_bag.cpp:97-199): all-vs-all pairs with both chains >= 400
    residues, full sensitive SW (UsePara off, Omega 0) kept at E <= 1,
    re-aligned through the MKF bag path; prints E-value and pctid for
    both and flags PROBLEM rows (bag chain missing at E_sw < 0.01, or
    pctid drop > 5)."""
    import copy

    from reseek_tpu_torch.align.mkf import align_mkf
    from reseek_tpu_torch.align.output import _pct_id
    from reseek_tpu_torch.align.pipeline import PairAligner, encode_for_search
    from reseek_tpu_torch.constants import DSSParams
    from reseek_tpu_torch.encoder.dss import encode_chain
    from reseek_tpu_torch.io.reader import read_chains
    from reseek_tpu_torch.search.engine import _exact_fwd_score

    params = DSSParams.create("sensitive")
    params.use_para = False
    params.omega = 0.0
    chains = read_chains(args.input)
    out = open(args.output, "w") if args.output else sys.stdout
    pa = PairAligner(params)
    # bag side: standard self-rev (MKF quirk for chains >= mkfl, Mu
    # k-mers passed — src/align_bag.cpp:29-31); SW side: the reference
    # passes NO Mu k-mers to GetSelfRevScore (align_bag.cpp:135), so the
    # self-rev there is FULL SW even for long chains
    ecs = [encode_for_search(c, params) for c in chains]
    sw_ecs = []
    for ec in ecs:
        rev_profile = encode_chain(ec.chain.reversed()).profile(params)
        sw_ec = copy.copy(ec)
        sw_ec.self_rev_score = max(
            _exact_fwd_score(params, ec.profile, rev_profile), 0.0)
        sw_ecs.append(sw_ec)
    n_problem = 0
    n_rows = 0

    def e2(v):
        return "%.2e" % np.float32(v)  # reference stores E as float32

    try:
        for a in range(len(ecs)):
            for b in range(a, len(ecs)):
                q, t = ecs[a], ecs[b]
                if len(q) < 400 or len(t) < 400:
                    continue
                res_sw = pa.align_no_accel(sw_ecs[a], sw_ecs[b])
                if res_sw.evalue > 1:
                    continue
                res_bag = align_mkf(q, t, params)
                has_bag = res_bag.best_chain_score > 0
                problem = False
                row = [q.label, t.label, e2(res_sw.evalue)]
                if has_bag:
                    row.append(e2(res_bag.evalue))
                else:
                    if res_sw.evalue < 0.01:
                        problem = True
                    row.append("PROBE")
                pct_sw = _pct_id(res_sw, q, t)
                row.append("%.1f" % pct_sw)
                if has_bag:
                    pct_bag = _pct_id(res_bag, q, t)
                    if pct_sw - pct_bag > 5:
                        problem = True
                    row.append("%.1f" % pct_bag)
                else:
                    row.append("nobag")
                if problem:
                    row.append("PROBLEM")
                    n_problem += 1
                n_rows += 1
                out.write("\t".join(row) + "\n")
    finally:
        if args.output:
            out.close()
    print(f"align-bags: {n_rows} rows, {n_problem} PROBLEM",
          file=sys.stderr)
    return 0


def cmd_alignselfrev(args) -> int:
    """-alignselfrev (src/alignselfrev.cpp:5-49): align every chain
    against its own reversal with full SW (sensitive, UsePara off,
    Omega 0, self-rev scores unset so RevDPScore = 0) and print the
    standard TSV row per chain."""
    from reseek_tpu_torch.align.output import format_row, parse_columns
    from reseek_tpu_torch.align.pipeline import (EncodedChain, PairAligner,
                                           encode_for_search)
    from reseek_tpu_torch.constants import DSSParams
    from reseek_tpu_torch.encoder.dss import encode_chain, mu_kmers
    from reseek_tpu_torch.io.reader import read_chains

    params = DSSParams.create("sensitive")
    params.use_para = False
    params.omega = 0.0
    cols = parse_columns("std")
    pa = PairAligner(params)
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        for c in read_chains(args.input):
            q = encode_for_search(c, params, with_self_rev=False)
            rev = c.reversed()
            rev.label = c.label  # reference keeps the chain's label
            rev_enc = encode_chain(rev)
            t = EncodedChain(chain=rev, enc=rev_enc,
                             profile=rev_enc.profile(params),
                             mu_letters=rev_enc.mu_letters,
                             mu_kmers=mu_kmers(rev_enc.mu_letters,
                                               params.mkf_pattern))
            res = pa.align_no_accel(q, t)
            out.write(format_row(cols, res, q, t, True))
            out.write("\n")
    finally:
        if args.output:
            out.close()
    return 0


def cmd_tracealn(args) -> int:
    """-tracealn (src/tracealn.cpp:11-89): per-pair pipeline trace of
    every query x target pair in DEFAULT FAST params, logged in the
    reference's exact format (golden-tested vs the reference binary's
    -log output on q10 x q10)."""
    from reseek_tpu_torch.align.mkf import should_use_mkf
    from reseek_tpu_torch.align.pipeline import (FLT_MAX, PairAligner,
                                           encode_for_search)
    from reseek_tpu_torch.constants import DSSParams
    from reseek_tpu_torch.io.reader import read_chains
    from reseek_tpu_torch.utils.logger import open_log

    lg = open_log(args.log)
    params = DSSParams.create("fast")
    pa = PairAligner(params)
    qs = [encode_for_search(c, params, with_self_rev=True)
          for c in read_chains(args.input)]
    ts = [encode_for_search(c, params, with_self_rev=True)
          for c in read_chains(args.db)]
    for q in qs:
        for t in ts:
            lg.log("\n______________________________________________\n")
            lg.log("Q>%s(%u)\n" % (q.label, len(q)))
            lg.log("T>%s(%u)\n" % (t.label, len(t)))
            lg.log("SelfRevScoreQ=%.1f\n" % q.self_rev_score)
            lg.log("SelfRevScoreT=%.1f\n" % t.self_rev_score)
            res = pa.align(q, t)
            path = res.path if res is not None else ""
            fwd = res.fwd_score if res is not None else 0.0
            e = res.evalue if res is not None else FLT_MAX
            lg.log("Path=(%u)%.10s...\n" % (len(path), path[:10]))
            if e > 1e5:
                lg.log("EvalueA=%.3g\n" % e)
            else:
                lg.log("EvalueA=%.1f\n" % e)
            lg.log("AlnFwdScore=%.3g\n" % fwd)
            do_mkf = should_use_mkf(q, t, params)
            lg.log("DoMKF=%c\n" % ("T" if do_mkf else "F"))
            if do_mkf:
                lg.log("m_MKF.BestChainScore=%d\n"
                       % (res.best_chain_score if res else 0))
                lg.log("m_XDropScore=%.1f\n" % fwd)
            lg.log("Omega=%.1f\n" % params.omega)
            lg.log("DoMuFilter=%c\n" % ("T" if params.omega > 0 else "F"))
            ok = pa.mu_filter(q, t)
            lg.log("MuFilterOk=%c\n" % ("T" if ok else "F"))
    return 0


def cmd_test_xdrop(args) -> int:
    """-test_xdrop (src/test_xdrop.cpp:78-187): x-drop fwd/bwd extension
    self-test on three BLOSUM62 string pairs, byte-identical log output
    to the reference binary (including its display quirks: the Fwd
    alignment is logged one position off its true start, and the merged
    path keeps the seed column both sides)."""
    from reseek_tpu_torch.align.mkf import xdrop_fwd, xdrop_bwd
    from reseek_tpu_torch.data.blosum62 import char_subst_mx
    from reseek_tpu_torch.ops.sw_np import sw_align
    from reseek_tpu_torch.utils.logger import open_log

    lg = open_log(args.log)
    b62 = char_subst_mx()

    def log_aln(a, b, lo_a, lo_b, open_, ext, path):
        if not path:
            return
        pa, pb = lo_a, lo_b
        row_a, row_b = [], []
        score = np.float32(0.0)
        for col, c in enumerate(path):
            if c == "M":
                score += np.float32(b62[ord(a[pa]), ord(b[pb])])
                row_a.append(a[pa]); pa += 1
                row_b.append(b[pb]); pb += 1
            elif c == "D":
                score += np.float32(
                    ext if col and path[col - 1] == "D" else open_)
                row_a.append(a[pa]); pa += 1
                row_b.append("-")
            else:
                score += np.float32(
                    ext if col and path[col - 1] == "I" else open_)
                row_a.append("-")
                row_b.append(b[pb]); pb += 1
        lg.log("\n%s\n%s\nScore %.3g\n"
               % ("".join(row_a), "".join(row_b), score))

    def test(a, b):
        open_, ext, x = -3.0, -1.0, 8.0
        la, lb = len(a), len(b)
        smx = np.empty((la, lb), np.float32)
        for i in range(la):
            for j in range(lb):
                smx[i, j] = b62[ord(a[i]), ord(b[j])]

        def scorer(pa, pb):
            return np.float32(smx[pa, pb])

        lg.log("______________________________SWFast"
               "________________________\n")
        sw_score, lo_a, lo_b, sw_path = sw_align(smx, open_, ext)
        lg.log("SW score = %.3g Path = %s\n" % (sw_score, sw_path))
        log_aln(a, b, lo_a, lo_b, open_, ext, sw_path)
        if len(sw_path) < 8:
            return
        mid_a, mid_b = lo_a, lo_b
        for c in sw_path[: len(sw_path) // 2]:
            if c in "MD":
                mid_a += 1
            if c in "MI":
                mid_b += 1
        lg.log("Mid %u, %u\n" % (mid_a, mid_b))

        lg.log("______________________________Fwd"
               "________________________\n")
        fwd_score, fwd_path = xdrop_fwd(scorer, x, open_, ext,
                                        mid_a + 1, la, mid_b + 1, lb)
        lg.log("FwdScore = %.3g Path = (%u,%u) %s\n"
               % (fwd_score, mid_a + 1, mid_b + 1, fwd_path))
        log_aln(a, b, mid_a, mid_b, open_, ext, fwd_path)  # ref quirk

        lg.log("______________________________Bwd"
               "________________________\n")
        bwd_score, bwd_path = xdrop_bwd(scorer, x, open_, ext,
                                        mid_a, la, mid_b, lb)
        lg.log("BwdScore = %.3g (%u,%u) Path = %s\n"
               % (bwd_score, mid_a, mid_b, bwd_path))
        lolo_a = mid_a + 1 - sum(c in "MD" for c in bwd_path)
        lolo_b = mid_b + 1 - sum(c in "MI" for c in bwd_path)
        log_aln(a, b, lolo_a, lolo_b, open_, ext, bwd_path)
        comb = np.float32(fwd_score) + np.float32(bwd_score) \
            - np.float32(b62[ord(a[mid_a]), ord(b[mid_b])])
        lg.log("FB score %.3g  %s\n" % (comb, bwd_path + fwd_path[1:]))
        lg.log("SW score %.3g  %s\n" % (sw_score, sw_path))

        lg.log("______________________________Merged"
               "________________________\n")
        # MergeFwdBwd (src/mergefwdback.cpp:6-50)
        merged = bwd_path + fwd_path
        hi_a = mid_a + sum(c in "MD" for c in fwd_path) \
            if fwd_path else mid_a
        hi_b = mid_b + sum(c in "MI" for c in fwd_path) \
            if fwd_path else mid_b
        m_lo_a = lolo_a if bwd_path else mid_a + 1
        m_lo_b = lolo_b if bwd_path else mid_b + 1
        lg.log("Merged A %u-%u, B %u-%u, Path %s\n"
               % (m_lo_a, m_lo_b, hi_a, hi_b, merged))
        log_aln(a, b, m_lo_a, m_lo_b, open_, ext, merged)
        lg.log("===================================================="
               "================\n")

    test("DVLGYLRFLTKGERQANLNF", "WVLGLRFLTKGERQANLNF")
    test("DVLGYLRFLTERQANLNF", "WVLGLRFLTKGERQANLNF")
    test("DVLGYLRFLTKGERQANLNF", "WVLGLINSRFLTKGERQANLNF")
    return 0


def add_commands(sub) -> None:
    """Register the commands of this module on ``sub`` (the subparsers of
    ``__main__.build_parser``)."""
    p = sub.add_parser("scop40bench",
                       help="all-vs-all benchmark with SEPQ/ROC report")
    p.add_argument("input")
    add_mode_args(p)
    p.add_argument("--lookup", required=True,
                   help="dom<TAB>scopid truth table")
    p.add_argument("--output")
    p.add_argument("--evalue", type=float)
    add_engine_args(p)
    p.set_defaults(fn=cmd_scop40bench)

    p = sub.add_parser("distmx", help="TS distance matrix (idx pairs)")
    p.add_argument("input")
    add_mode_args(p)
    p.add_argument("--output", required=True)
    p.add_argument("--evalue", type=float)
    add_engine_args(p)
    p.set_defaults(fn=cmd_distmx)

    p = sub.add_parser("calibrate",
                       help="fit P-value model constants from a decoy "
                            "all-vs-all search")
    p.add_argument("input")
    add_mode_args(p)
    p.add_argument("--output", help="write the TS histogram + fits")
    add_engine_args(p)
    p.set_defaults(fn=cmd_calibrate)

    p = sub.add_parser("calibrate2",
                       help="fit the P-value model from a labeled "
                            "all-vs-all benchmark")
    p.add_argument("input", help="structures with dom/scopid labels")
    p.add_argument("--benchlevel", required=True,
                   choices=["sf", "fold"])
    p.add_argument("--maxfpr", type=float)
    p.add_argument("--output")
    add_engine_args(p)
    p.set_defaults(fn=cmd_calibrate2)

    p = sub.add_parser("scop40bit", help="hits TSV -> binary .bit dump "
                                         "(reference -scop40bit)")
    p.add_argument("hits")
    p.add_argument("--lookup", required=True)
    p.add_argument("--output", required=True)
    p.set_defaults(fn=cmd_scop40bit)

    p = sub.add_parser("scop40bit2tsv",
                       help=".bit dump -> hits TSV (reference "
                            "-scop40bit2tsv)")
    p.add_argument("bit")
    p.add_argument("--lookup", required=True)
    p.add_argument("--output", required=True)
    p.set_defaults(fn=cmd_scop40bit2tsv)

    p = sub.add_parser("scop40bit-roc",
                       help="SEPQ/ROC report from a .bit dump "
                            "(reference -scop40bit_roc)")
    p.add_argument("bit")
    p.add_argument("--lookup", required=True)
    p.add_argument("--scores-are-not-evalues", action="store_true")
    p.set_defaults(fn=cmd_scop40bit_roc)

    p = sub.add_parser("scop40bench-tsv",
                       help="SEPQ/ROC report from a hits TSV "
                            "(reference -scop40bench_tsv)")
    p.add_argument("hits")
    p.add_argument("--lookup", required=True)
    p.add_argument("--scores-are-not-evalues", action="store_true")
    p.set_defaults(fn=cmd_scop40bench_tsv)

    p = sub.add_parser("scop40tsv2bit",
                       help="hits TSV + structure labels -> .bit dump")
    p.add_argument("hits")
    p.add_argument("--input", required=True,
                   help="structures with dom/scopid labels")
    p.add_argument("--output")
    p.add_argument("--scorefieldnr", type=int,
                   help="1-based score column (default 3)")
    p.set_defaults(fn=cmd_scop40tsv2bit)

    p = sub.add_parser("fit-gumbel",
                       help="fit a Gumbel curve to a histogram file")
    p.add_argument("input")
    p.set_defaults(fn=cmd_fit_gumbel)

    p = sub.add_parser("test-gumbel",
                       help="self-test of the Gumbel fitter")
    p.add_argument("input", nargs="?", help="ignored (reference arg slot)")
    p.set_defaults(fn=cmd_test_gumbel)

    p = sub.add_parser("prefilter-mu",
                       help="Mu k-mer prefilter of query vs target "
                            "Mu FASTAs (reference -prefilter_mu)")
    p.add_argument("input", help="query Mu FASTA")
    p.add_argument("--db", required=True, help="target Mu FASTA")
    p.add_argument("--output", required=True)
    p.add_argument("--mode", default=None,
                   choices=[None, "idxq", "idxt", "exact"],
                   help="neighborhood mode (default: reference rule — "
                        "idxq for <=100 queries else idxt)")
    p.set_defaults(fn=cmd_prefilter_mu)

    p = sub.add_parser("postmufilter",
                       help="stage 2 of the fast pipeline from a "
                            "prefilter TSV (reference -postmufilter)")
    p.add_argument("input", help="query structures")
    p.add_argument("--db", required=True, help=".bca database")
    p.add_argument("--filin", required=True,
                   help="prefilter TSV (prefilter-mu output)")
    p.add_argument("--output")
    p.add_argument("--columns", default="std")
    p.add_argument("--evalue", type=float)
    p.set_defaults(fn=cmd_postmufilter)

    p = sub.add_parser("convert", help="convert structures between formats")
    p.add_argument("input")
    p.add_argument("--bca")
    p.add_argument("--cal")
    p.add_argument("--fasta")
    p.add_argument("--feature-fasta", dest="feature_fasta")
    p.add_argument("--alpha", default="Mu")
    p.add_argument("--pdb", help="multi-PDB output (MODEL per chain)")
    p.add_argument("--minchainlength", type=int, default=0)
    p.add_argument("--labels", help="keep only labels listed in this file")
    p.add_argument("--subsample", type=int, default=0,
                   help="keep every Nth input chain")
    p.add_argument("--reverse", action="store_true",
                   help="reverse residue order")
    p.add_argument("--flip", action="store_true",
                   help="negate coordinates (mirror image)")
    p.add_argument("--index", help="write a pre-encoded .rsdx artifact "
                                   "(search loads it with zero DSS work)")
    p.add_argument("--index-modes", default="fast,sensitive",
                   help="modes whose self-rev scores to precompute")
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("convert2mu", help="structures -> Mu FASTA")
    p.add_argument("input")
    p.add_argument("--output", required=True)
    p.add_argument("--minchainlength", type=int, default=1)
    p.set_defaults(fn=cmd_convert2mu)

    p = sub.add_parser("cif2pdb", help="mmCIF -> PDB")
    p.add_argument("input")
    p.add_argument("--output", required=True)
    p.set_defaults(fn=cmd_cif2pdb)

    p = sub.add_parser("chains2pdbs", help="one PDB file per chain")
    p.add_argument("input")
    p.add_argument("--outdir", required=True)
    p.set_defaults(fn=cmd_chains2pdbs)

    p = sub.add_parser("getchains", help="list chain labels and lengths")
    p.add_argument("input")
    p.set_defaults(fn=cmd_getchains)

    p = sub.add_parser("pdb2ss", help="print secondary structure strings")
    p.add_argument("input")
    p.set_defaults(fn=cmd_pdb2ss)

    p = sub.add_parser("bca-stats", help="print .bca database statistics")
    p.add_argument("input")
    p.set_defaults(fn=cmd_bca_stats)

    p = sub.add_parser("pdb2mega", help="write Muscle-3D mega input")
    p.add_argument("input")
    p.add_argument("--output", required=True)
    p.add_argument("--reverse", action="store_true")
    p.set_defaults(fn=cmd_pdb2mega)

    p = sub.add_parser("shuffle", help="random chain order -> .bca")
    p.add_argument("input")
    p.add_argument("--bca", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.set_defaults(fn=cmd_shuffle)

    p = sub.add_parser("split", help="divide a DB into N .bca splits")
    p.add_argument("input")
    p.add_argument("-n", type=int, required=True)
    p.add_argument("--prefix", default="split")
    p.add_argument("--minchainlength", type=int, default=1)
    p.set_defaults(fn=cmd_split)

    p = sub.add_parser("prepare-query",
                       help="select non-redundant query chains")
    p.add_argument("input")
    p.add_argument("--bca")
    p.add_argument("--output")
    p.add_argument("-n", type=int, default=4)
    p.add_argument("--minchainlength", type=int)
    p.set_defaults(fn=cmd_prepare_query)

    p = sub.add_parser("gunzip", help="decompress a .gz file")
    p.add_argument("input")
    p.add_argument("--output", required=True)
    p.set_defaults(fn=cmd_gunzip)

    p = sub.add_parser("gunzip-lines",
                       help="gunzip to text lines (reference "
                            "-gunzip_lines)")
    p.add_argument("input")
    p.add_argument("--output")
    p.set_defaults(fn=cmd_gunzip_lines)

    p = sub.add_parser("scan-files",
                       help="list structure files found by the scanner")
    p.add_argument("input")
    p.add_argument("--output")
    p.set_defaults(fn=cmd_scan_files)

    p = sub.add_parser("create-foldseekdb",
                       help="write a Foldseek-format DB from structures "
                            "+ 3Di FASTA (reference -create_foldseekdb)")
    p.add_argument("input")
    p.add_argument("--3di", dest="tdi", required=True,
                   help="3Di FASTA (labels must match the chains)")
    p.add_argument("--output", required=True, help="DB path prefix")
    p.add_argument("-n", type=int, default=1,
                   help="duplicate each entry n times (reference -n)")
    p.set_defaults(fn=cmd_create_foldseekdb)

    p = sub.add_parser("convert-foldseekdb",
                       help="Foldseek DB -> aa FASTA / 3Di FASTA / .cal "
                            "(reference -convert_foldseekdb)")
    p.add_argument("prefix")
    p.add_argument("--fasta")
    p.add_argument("--3di", dest="tdi")
    p.add_argument("--cal")
    p.set_defaults(fn=cmd_convert_foldseekdb)

    p = sub.add_parser("mmseqs-index-dump",
                       help="dump an MMseqs2/Foldseek hits DB as text "
                            "(reference -mmseqs_index_dump)")
    p.add_argument("prefix")
    p.add_argument("--output")
    p.set_defaults(fn=cmd_mmseqs_index_dump)

    p = sub.add_parser("alignpair", help="align best chain pair of two files")
    p.add_argument("input")
    p.add_argument("--input2", required=True)
    p.add_argument("--aln")
    p.add_argument("--output")
    p.add_argument("--global", dest="global_aln", action="store_true",
                   help="global (NW) alignment with free terminal gaps")
    p.set_defaults(fn=cmd_alignpair)

    p = sub.add_parser("align-bag",
                       help="MKF bag alignment of one chain pair "
                            "(reference -align_bag)")
    p.add_argument("input")
    p.add_argument("--input2", required=True)
    p.add_argument("--output")
    p.set_defaults(fn=cmd_align_bag)

    p = sub.add_parser("align-bags",
                       help="MKF-vs-full-SW self-check (reference "
                            "-align_bags); prints PROBLEM rows")
    p.add_argument("input")
    p.add_argument("--output")
    p.set_defaults(fn=cmd_align_bags)

    p = sub.add_parser("alignselfrev",
                       help="align each chain against its reversal "
                            "(reference -alignselfrev)")
    p.add_argument("input")
    p.add_argument("--output")
    p.set_defaults(fn=cmd_alignselfrev)

    p = sub.add_parser("tracealn",
                       help="per-pair pipeline trace (reference -tracealn)")
    p.add_argument("input")
    p.add_argument("--db", required=True)
    p.add_argument("--log")
    p.set_defaults(fn=cmd_tracealn)

    p = sub.add_parser("test-xdrop",
                       help="x-drop kernel self-test (reference golden)")
    p.add_argument("input", nargs="?", help="ignored (reference arg slot)")
    p.add_argument("--log")
    p.set_defaults(fn=cmd_test_xdrop)
