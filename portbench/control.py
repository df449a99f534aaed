"""The control of the output check: the reference put in the program's
place and computed one precision lower than the configuration states.

The configurations state float32 substitution scores (the per-feature
log-odds tables times their weights, src/dssparams.cpp:344-364, summed a
cell in float32).  The control rounds those tables to bfloat16, the step
that would tempt a later change, and runs the reference's whole search
with them; the check, run at float32 as always, has to find it incorrect.

    python -m portbench.control --workload NAME --seed N [--device cuda]

runs one call of a cell's traffic through the control (the harness's own
loop, a window of one call, no warm-up) and prints the check's numbers:
run it on the card's machine at the cell's own size, on three seeds or
more, to set the check's limits.  The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def bfloat16(x: np.ndarray) -> np.ndarray:
    """float32 rounded to the nearest bfloat16 (ties to even), as float32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    r = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))
         ) & np.uint32(0xFFFF0000)
    return r.view(np.float32)


@contextlib.contextmanager
def lower_precision():
    """The reference's substitution tables in bfloat16 while inside."""
    from portbench.reference.align import mkf_native
    from portbench.reference.data.tables import Tables
    from portbench.reference.ops import substmx
    orig = Tables.weighted_score_mx

    def rounded(self, feature, weight):
        return bfloat16(orig(self, feature, weight))

    def clear():
        substmx.weighted_matrices.cache_clear()
        mkf_native._packed_weights.cache_clear()

    Tables.weighted_score_mx = rounded
    clear()
    try:
        yield
    finally:
        Tables.weighted_score_mx = orig
        clear()


def self_search(pool, members, mode: str, columns: str, out) -> dict:
    """A whole all-vs-all job on the reference in bfloat16 (pairs on a
    thread pool, rows in self_search's order); returns no stage walls."""
    from portbench.kinds.self_search import options_for
    from portbench.reference.align.pipeline import PairAligner
    from portbench.reference.chain import Chain
    from portbench.reference.constants import DSSParams
    from portbench.reference.search import host
    params = DSSParams.create(mode)
    with lower_precision():
        ecs = host._encode_all(pool.chains(Chain, members), params,
                               with_self_rev=True)
        pairs = host.self_search_pairs(ecs)
        local = threading.local()

        def align(pair):
            if not hasattr(local, "aligner"):
                local.aligner = PairAligner(params)
            return local.aligner.align(ecs[pair[0]], ecs[pair[1]])

        with ThreadPoolExecutor(max_workers=os.cpu_count()) as tp:
            results = list(tp.map(align, pairs, chunksize=256))
    drv = host.SearchDriver(params, options_for(mode, columns, host), out)
    for (a, b), res in zip(pairs, results):
        host.emit_pair(drv, ecs, a, b, res)
    return {}


def fast_search(workload, queries, out) -> dict:
    """A query batch's -fast search on the reference in bfloat16."""
    with lower_precision():
        return {"candidates": workload.reference_fast(queries, out)}


def main(argv=None) -> int:
    from portbench import harness
    ap = argparse.ArgumentParser(prog="python -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = harness.run(args.workload, args.seed, 0.0, trace=False,
                      device=args.device, program="control", warmup=False)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "control": res["check"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
