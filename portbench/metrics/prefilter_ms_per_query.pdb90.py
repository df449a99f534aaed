"""prefilter_ms_per_query.pdb90 (ms/query): the program's `prefilter_s`
wall (drv.fast_stats of fast_search: query encode and the Mu k-mer
prefilter over the DB) summed over the window's batches, per query."""

from portbench.readers import ms_per


def read(run):
    return ms_per(run, "prefilter_s", "queries")
