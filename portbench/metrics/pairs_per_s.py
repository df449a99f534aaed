"""pairs_per_s (pairs/s): the n(n+1)/2 pairs of every all-vs-all job of
the window over the time from the first job's start to the last one's
end (host clock)."""

from portbench.readers import rate


def read(run):
    return rate(run, "pairs")
