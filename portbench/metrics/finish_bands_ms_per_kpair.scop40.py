"""finish_bands_ms_per_kpair.scop40 (ms/kpair): the program's
`finish_bands_s` span (drv.device_stats of self_search: the host finish's
per-pair display-band checks, a part of `finish_s`) summed over the
window's jobs, per thousand pairs of them."""

from portbench.readers import ms_per


def read(run):
    return ms_per(run, "finish_bands_s", "pairs", 1e3)
