"""finish_recompute_ms_per_kpair.scop40 (ms/kpair): the program's
`finish_recompute_s` counter (drv.device_stats of self_search: the
seconds of the host finish's exact recomputes, native SW and LDDT, of the
pairs its band checks flag; a part of `finish_s`) summed over the
window's jobs, per thousand pairs of them."""

from portbench.readers import ms_per


def read(run):
    return ms_per(run, "finish_recompute_s", "pairs", 1e3)
