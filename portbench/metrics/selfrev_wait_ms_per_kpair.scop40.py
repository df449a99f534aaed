"""selfrev_wait_ms_per_kpair.scop40 (ms/kpair): the program's
`selfrev_wait_s` span (drv.device_stats of self_search: the main thread's
wait on the host pool's self-reversal scores, between stage 1 and stage
3) summed over the window's jobs, per thousand pairs of them."""

from portbench.readers import ms_per


def read(run):
    return ms_per(run, "selfrev_wait_s", "pairs", 1e3)
