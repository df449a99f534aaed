"""Command line of the port.

Usage:  python -m reseek_tpu_torch search INPUT (--sensitive |
        --verysensitive | --fast) [--db DB [--dbmu MU.fa] [--idxq |
        --idxt]] [--global] [-o OUT] [--columns ...]
        [--engine auto|device|host] [--device cuda|cpu]
        [--nprocs N [--procid I] [--coord HOST:PORT] [--scratch DIR]
        [--resume]]

Without ``--db`` the all-vs-all self-search; with ``--db`` query-vs-DB,
and with ``--fast --db`` the -fast prefilter pipeline (``--dbmu``,
``--idxq``, ``--idxt`` as in reseek_tpu).  ``--global`` runs the host
global path.  ``--fast --db X.bca --nprocs N`` is the
multi-process -fast search (parallel/multihost.py): every rank runs the
same command with its own rank, from ``--procid``/``--coord`` or from
torch's RANK, MASTER_ADDR and MASTER_PORT; only rank 0 writes ``-o`` and
``--aln``; the ranks share ``--scratch`` (default: the directory of
``-o``, else the temporary directory), where ``--resume`` reuses a
rank's finished rows when their fingerprint matches the run.  The
argument helpers, the parameter handling and the routing follow
reseek_tpu.cli's ``search`` command.

The other commands (the SCOP40 benchmark, the calibrations and their
file tools, prefilter-mu and postmufilter, the structure I/O and format
commands, the Foldseek and MMseqs files, the pair alignments) are in
cli.py: ``python -m reseek_tpu_torch <command> --help``.

The reference binary's spelling is accepted too, as reseek_tpu accepts
it: ``python -m reseek_tpu_torch -search db.cal -sensitive -output
hits.tsv`` runs ``search db.cal --sensitive --output hits.tsv``.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import tempfile
from typing import List, Optional

from reseek_tpu_torch.cli import (add_commands, add_engine_args, add_mode_args,
                                  mode_from_args)

MULTI_PROCESS_FLAGS = ("procid", "coord", "scratch", "resume")


def _read_chains_or_artifact(path: str, params):
    """A .rsdx path loads pre-encoded chains (skipping all DSS work);
    anything else parses structures (src/search.cpp:96-99 -dbmu role)."""
    from reseek_tpu_torch.io.artifact import is_artifact, load_artifact
    from reseek_tpu_torch.io.reader import read_chains
    if is_artifact(path):
        return load_artifact(path, params, mode=params.mode)
    return read_chains(path)


def cmd_search(args) -> int:
    from reseek_tpu_torch.align.output import parse_columns
    from reseek_tpu_torch.constants import DSSParams
    from reseek_tpu_torch.device import disable_tf32
    from reseek_tpu_torch.search import driver
    from reseek_tpu_torch.search.host import SearchOptions
    from reseek_tpu_torch.utils.logger import open_log

    mode = mode_from_args(args)
    distributed = args.nprocs > 1
    if distributed and not (args.db and mode == "fast"):
        print("reseek_tpu_torch search: --nprocs > 1 runs the "
              "multi-process -fast search: give --fast --db", file=sys.stderr)
        return 2
    given = {f: getattr(args, f) for f in MULTI_PROCESS_FLAGS}
    flags = [f for f, v in given.items() if v is not None and v is not False]
    if flags and not distributed:
        print("reseek_tpu_torch search: "
              + ", ".join("--" + f for f in flags) + " need --nprocs > 1",
              file=sys.stderr)
        return 2
    if args.params:
        params = DSSParams.from_tsv(args.params)
        params.mode = mode
    elif args.paramstr:
        params = DSSParams.from_param_str(args.paramstr)
        params.mode = mode
    else:
        params = DSSParams.create(mode)
    if args.omega is not None:
        params.omega = args.omega
    if args.minfwdscore is not None:
        params.min_fwd_score = args.minfwdscore
    # positive-penalty convention on the command line (reference usage.h)
    if args.gapopen is not None:
        params.gap_open = -abs(args.gapopen)
    if args.gapext is not None:
        params.gap_ext = -abs(args.gapext)
    # NOTE: like the reference binary, -dbsize is accepted but the E-value
    # always uses SCOP40c_DBSIZE=8340 (src/statsig.h:3; the only consumer
    # of -dbsize is cmd_postmufilter's assert, src/postmufilter.cpp:317)
    open_log(args.log)
    disable_tf32()

    max_e = args.evalue if args.evalue is not None else (
        float("inf") if mode == "verysensitive" else 10.0)
    trace = ((args.label1, args.label2)
             if args.label1 and args.label2 else None)
    options = SearchOptions(columns=parse_columns(args.columns),
                            max_evalue=max_e, no_self=args.noself,
                            mode=mode, global_aln=args.global_aln,
                            scores_are_not_evalues=args.scores_are_not_evalues,
                            trace_labels=trace)
    if distributed:
        return _search_distributed(args, params, options)
    out = open(args.output, "w") if args.output else sys.stdout
    aln = open(args.aln, "w") if args.aln else None
    options.aln_out = aln
    try:
        chains = _read_chains_or_artifact(args.input, params)
        kw = {"engine": args.engine, "device": args.device}
        if args.db and mode == "fast":
            drv = driver.fast_search(
                chains, args.db, params, options, out, dbmu=args.dbmu,
                prefilter_mode=("idxq" if args.idxq
                                else "idxt" if args.idxt else None), **kw)
        elif args.db:
            from reseek_tpu_torch.io.artifact import is_artifact
            # structure files stream (memory O(queries + chunk)); .rsdx
            # artifacts load pre-encoded
            db = (_read_chains_or_artifact(args.db, params)
                  if is_artifact(args.db) else args.db)
            drv = driver.query_search(chains, db, params, options, out, **kw)
        else:
            drv = driver.self_search(chains, params, options, out, **kw)
        drv.run_stats(n_threads=max(1, args.threads))
        args.drv = drv   # for a caller that runs the command in-process
    finally:
        if args.output:
            out.close()
        if aln:
            aln.close()
    return 0


def _search_distributed(args, params, options) -> int:
    """One rank of the multi-process -fast search
    (parallel/multihost.py); rank 0 alone opens the outputs."""
    import torch.distributed as dist

    from reseek_tpu_torch.parallel.multihost import (distributed_fast_search,
                                                     global_mesh,
                                                     init_distributed,
                                                     rank_from_env)
    coord, procid = rank_from_env(args.nprocs, args.procid, args.coord)
    rank, _world = init_distributed(coord, args.nprocs, procid)
    scratch = args.scratch or (
        os.path.dirname(os.path.abspath(args.output)) if args.output
        else tempfile.gettempdir())
    out = aln = None
    try:
        if rank == 0:
            out = open(args.output, "w") if args.output else sys.stdout
            aln = open(args.aln, "w") if args.aln else None
        chains = _read_chains_or_artifact(args.input, params)
        drv = distributed_fast_search(
            chains, args.db, options, out, scratch_dir=scratch,
            dbmu=args.dbmu, prefilter_mode=("idxq" if args.idxq else "idxt"
                                            if args.idxt else None),
            engine=args.engine, mesh=global_mesh(args.device),
            resume=args.resume, aln_out=aln, with_aln=bool(args.aln))
        drv.run_stats(n_threads=max(1, args.threads))
        print(f"reseek_tpu_torch: rank {rank}: "
              f"{json.dumps(drv.fast_stats)}", file=sys.stderr)
    finally:
        if out is not None and args.output:
            out.close()
        if aln is not None:
            aln.close()
        dist.destroy_process_group()
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m reseek_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("search", help="all-vs-all, query-vs-DB or -fast "
                                      "structure search")
    p.add_argument("input")
    add_mode_args(p)
    p.add_argument("--output", "-o")
    p.add_argument("--columns", default="std")
    p.add_argument("--evalue", type=float)
    p.add_argument("--omega", type=float)
    p.add_argument("--minfwdscore", type=float)
    p.add_argument("--gapopen", type=float,
                   help="gap-open penalty (>= 0 convention)")
    p.add_argument("--gapext", type=float,
                   help="gap-extend penalty (>= 0 convention)")
    p.add_argument("--dbsize", type=int,
                   help="accepted for reference compatibility (E-values "
                        "use the fitted SCOP40c constant, like reseek)")
    p.add_argument("--noself", action="store_true")
    p.add_argument("--scores-are-not-evalues", dest="scores_are_not_evalues",
                   action="store_true", help="disable the E-value output gate")
    p.add_argument("--threads", type=int, default=0,
                   help="host threads reported in the run stats")
    p.add_argument("--log", help="write a log file (reference -log)")
    add_engine_args(p)
    p.add_argument("--params", help="name<TAB>value parameter file")
    p.add_argument("--paramstr", help="AA:0.4_Conf:0.2_... parameter string")
    p.add_argument("--aln", help="write pretty alignment blocks")
    p.add_argument("--label1", help="with --label2: log a pipeline trace "
                                    "for this chain pair")
    p.add_argument("--label2")
    p.add_argument("--db", help="database: query-vs-DB search, or with "
                                "--fast the prefilter pipeline")
    p.add_argument("--dbmu", help="with --fast --db: Mu-letter FASTA of "
                                  "the database for the prefilter")
    p.add_argument("--global", dest="global_aln", action="store_true",
                   help="global alignment (host path)")
    p.add_argument("--idxq", action="store_true",
                   help="with --fast: query-neighbourhood prefilter index")
    p.add_argument("--idxt", action="store_true",
                   help="with --fast: target-neighbourhood prefilter index")
    p.add_argument("--nprocs", type=int, default=1,
                   help="with --fast --db X.bca: processes of the "
                        "multi-process -fast search")
    p.add_argument("--procid", type=int,
                   help="this process's rank (default: $RANK)")
    p.add_argument("--coord", help="HOST:PORT of rank 0's process group "
                                   "(default: $MASTER_ADDR:$MASTER_PORT)")
    p.add_argument("--scratch", help="directory the ranks share for their "
                                     "row files")
    p.add_argument("--resume", action="store_true",
                   help="reuse a rank's finished row file when its "
                        "fingerprint matches this run")
    p.set_defaults(fn=cmd_search)
    add_commands(sub)
    return ap


# reseek_tpu's command names: the first argument -<name> (or -<name_with_
# underscores>) asks for the reference spelling of the command line
REFERENCE_COMMANDS = frozenset({
    "convert", "search", "alignpair", "pdb2ss", "pdb2mega", "scop40bench",
    "prefilter-mu", "distmx", "shuffle", "split", "convert2mu", "gunzip",
    "cif2pdb", "prepare-query", "lddt-msa", "daliscore-msa",
    "train-features", "fit-gumbel", "calibrate", "chains2pdbs",
    "getchains", "bca-stats", "align-bags", "msta-score", "msta-scores",
    "float-feature-bins", "sscluster", "mmseqs-index-dump",
    "create-foldseekdb", "convert-foldseekdb", "alignselfrev",
    "mu-mapping", "lddt-msa-foldmason", "lddt-msas", "daliscore-msas",
    "gunzip-lines", "musubstmx", "postmufilter", "scop40bit",
    "scop40bit2tsv", "scop40bit-roc", "scop40bench-tsv", "daliscore-tsv",
    "align-bag", "tracealn", "feature-stats", "test-gumbel",
    "scop40tsv2bit", "lddt-bench", "msta-lddtmuw", "msta-lddtmuw1",
    "mudex", "mukmerfilter", "scan-files", "test-xdrop", "msa2cmp",
    "binner", "calibrate2", "daliscore-msas2"})


def _reference_style(argv: List[str]) -> List[str]:
    """Accept the reference binary's flag spelling (src/myutils.cpp option
    parser): `reseek -search db.bca -sensitive -output hits.tsv` becomes
    `search db.bca --sensitive --output hits.tsv`.  Triggered only when
    the first argument is -<command> of a command this CLI registers;
    single-dash long options are rewritten to GNU style, underscores to
    dashes.  A command of REFERENCE_COMMANDS that the port lacks passes
    through unrewritten, for argparse to reject."""
    if not argv or not argv[0].startswith("-"):
        return argv
    head = argv[0].lstrip("-").replace("_", "-")
    if head not in REFERENCE_COMMANDS:
        return argv
    known = _known_options(head)
    if known is None:
        return argv
    # only rewrite tokens naming a KNOWN option of this subcommand, so
    # option VALUES that begin with '-' (e.g. `-label -foo`, `-evalue -.5`)
    # pass through untouched
    out = [head]
    for a in argv[1:]:
        name = a[1:].replace("_", "-") if a.startswith("-") else ""
        if (a.startswith("-") and not a.startswith("--") and len(a) > 2
                and name in known):
            out.append("--" + name)
        else:
            out.append(a)
    return out


@functools.lru_cache(maxsize=None)
def _known_options(head: str) -> Optional[frozenset]:
    """Long-option names (without --) of subcommand ``head``, None when
    the parser has no such subcommand.  Cached: the argparse tree is only
    built once per process even when main() is called repeatedly (e.g.
    from tests)."""
    ap = build_parser()
    for act in ap._subparsers._group_actions:  # type: ignore[union-attr]
        choices = getattr(act, "choices", None)
        if choices and head in choices:
            return frozenset(s[2:] for a in choices[head]._actions
                             for s in a.option_strings if s.startswith("--"))
    return None


def main(argv: Optional[List[str]] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    args = build_parser().parse_args(_reference_style(list(argv)))
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
