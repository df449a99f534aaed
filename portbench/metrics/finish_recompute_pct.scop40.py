"""finish_recompute_pct.scop40 (%): 100 x the program's
`recomputed_pairs` over its `finish_pairs` (drv.device_stats of
self_search: the pairs the host finish recomputed exactly, of the pairs
it gave a result), each summed over the window's jobs; None where no job
reports them."""


def read(run):
    calls = [c["stats"] for c in run["calls"]
             if "recomputed_pairs" in c["stats"]
             and "finish_pairs" in c["stats"]]
    den = sum(s["finish_pairs"] for s in calls)
    if den <= 0:
        return None
    return 100.0 * sum(s["recomputed_pairs"] for s in calls) / den
