"""emit_ms_per_kpair.scop40 (ms/kpair): the program's `emit_s` span
(drv.device_stats of self_search: the muscore backfill, the sort of the
pairs and the loop that formats and writes every row) summed over the
window's jobs, per thousand pairs of them."""

from portbench.readers import ms_per


def read(run):
    return ms_per(run, "emit_s", "pairs", 1e3)
