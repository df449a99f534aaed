"""finish_ms_per_kpair.scop40 (ms/kpair): the program's `finish_s` wall
(drv.device_stats of self_search) summed over the window's jobs, per
thousand pairs of them."""

from portbench.readers import ms_per


def read(run):
    return ms_per(run, "finish_s", "pairs", 1e3)
