"""queries_per_s (queries/s): the queries of every -fast batch of the
window over the time from the first batch's start to the last one's end
(host clock)."""

from portbench.readers import rate


def read(run):
    return rate(run, "queries")
