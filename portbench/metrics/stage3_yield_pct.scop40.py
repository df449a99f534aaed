"""stage3_yield_pct.scop40 (%): 100 x the program's `emitted_pairs` over
its `stage3_pairs` (drv.device_stats of self_search: the pairs stage 3
aligned that wrote a row, of all it aligned), each summed over the
window's jobs; None where no job reports them."""


def read(run):
    calls = [c["stats"] for c in run["calls"]
             if "emitted_pairs" in c["stats"]
             and "stage3_pairs" in c["stats"]]
    den = sum(s["stage3_pairs"] for s in calls)
    if den <= 0:
        return None
    return 100.0 * sum(s["emitted_pairs"] for s in calls) / den
