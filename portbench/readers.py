"""What the metric readers (portbench/metrics/<metric>.py) share: sums over
a run's calls of the program's stage walls and of the work, and the
profiler's kernel seconds.  A reader returns None where its run has
nothing for it to read."""

from __future__ import annotations

import re


def work(run: dict, unit: str) -> float:
    """The window's work in ``unit`` ("pairs", "queries")."""
    return float(sum(c["work"].get(unit, 0) for c in run["calls"]))


def ms_per(run: dict, stat: str, unit: str, per: float = 1.0):
    """Milliseconds of the program's wall ``stat`` summed over the
    window's calls, per ``per`` units of work; None if no call reports
    the stat."""
    calls = [c for c in run["calls"] if stat in c["stats"]]
    w = work(run, unit)
    if not calls or w <= 0:
        return None
    return 1e3 * sum(float(c["stats"][stat]) for c in calls) / (w / per)


def rate(run: dict, unit: str):
    """Work a second over the window (first call's start to last call's
    end)."""
    w = work(run, unit)
    return w / run["window_s"] if w > 0 else None


def kernel_seconds(run: dict, pattern: str) -> float:
    """Profiler seconds of the device operations whose name matches
    ``pattern`` (a regular expression, searched)."""
    rx = re.compile(pattern)
    return sum(s for name, s in run["trace"]["kernels"].items()
               if rx.search(name))


def roofline_pct(run: dict, pattern: str, work_of):
    """100 x the least time the card could take for the window's calls
    (``work_of(lengths)`` -> (bytes, operations) a call, from its chains'
    lengths) over the profiler seconds of the kernels ``pattern``; None
    without a trace or a launch."""
    from portbench.yardstick import least_seconds
    if run["trace"] is None:
        return None
    t = kernel_seconds(run, pattern)
    if t <= 0:
        return None
    least = sum(least_seconds(*work_of(c["lengths"])) for c in run["calls"])
    return 100.0 * least / t


def idle_pct(run: dict):
    t = run["trace"]
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
