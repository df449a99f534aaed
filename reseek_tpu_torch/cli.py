"""The port's commands beside ``search``: the SCOP40 benchmark, the
calibrations and their file tools, and the standalone Mu prefilter pair.
Their bodies and parsers are copied from reseek_tpu.cli, and each output
is byte-equal to ``python -m reseek_tpu <cmd> --engine host``.

  search-driven, on the device engine (``--engine auto|device|host``,
  ``--device cuda|cpu``; ``auto`` is the device, which raises without a
  card):  scop40bench, distmx, calibrate, calibrate2
  evaluator only:  scop40bench-tsv, scop40bit, scop40bit2tsv,
  scop40bit-roc, scop40tsv2bit
  fits only:  fit-gumbel, test-gumbel
  host, as in reseek_tpu:  prefilter-mu, postmufilter

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
