"""align_ms_per_query.pdb90 (ms/query): the program's `align_s` wall
(drv.fast_stats of fast_search: the candidates' encode, stage 1, stage 3,
the MKF pool and the finish) summed over the window's batches, per
query."""

from portbench.readers import ms_per


def read(run):
    return ms_per(run, "align_s", "queries")
