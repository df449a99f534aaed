"""The device's idle time inside the port's spans
(reseek_tpu_torch/utils/spans.py), over one traced window of a portbench
cell.

    python3 tools/trace_spans.py --workload scop40.fast --seed N [--seconds S]

Runs the cell as ``python3 -m portbench --workload ... --trace 1`` does
(``portbench.harness.run``: set-up, the window under torch.profiler, the
check) on the card, and reads the same profiler events as
``portbench.trace.summarize``.  Prints one JSON line: whether the run was
correct, its rate, the device busy and window seconds as summarize gives
them, the program's stats summed over the calls, and for each span name
(``reseek/<name>``) its ranges, wall seconds, the device-idle seconds
inside them and the idle seconds whose innermost span it is (``-``: the
window outside every span of the program).  The program opens its ranges
on the host's timeline only; ``device_copies`` counts any of them the
trace shows on the device's, which would count as device busy there.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

PREFIX = "reseek/"


class Busy:
    """Merged device-busy intervals, and the busy time within any range."""

    def __init__(self, merged):
        self.starts = [a for a, _b in merged]
        self.ends = [b for _a, b in merged]
        self.before = [0.0]
        for a, b in merged:
            self.before.append(self.before[-1] + (b - a))

    def upto(self, x: float) -> float:
        """Busy time before ``x``."""
        k = bisect.bisect_right(self.starts, x) - 1
        if k < 0:
            return 0.0
        return self.before[k] + min(x, self.ends[k]) - self.starts[k]

    def idle(self, a: float, b: float) -> float:
        return max(0.0, (b - a) - (self.upto(b) - self.upto(a)))


def span_idle(spans, busy: Busy, lo: float, hi: float) -> dict:
    """{name: [ranges, wall, idle inside, idle innermost]} of ``spans``
    ((start, end, name), nested as one thread opens them) within [lo,
    hi]; ``-`` takes the idle outside every span."""
    out = {"-": [0, 0.0, 0.0, 0.0]}
    stack, t = [], lo

    def innermost(upto):
        nonlocal t
        name = stack[-1][1] if stack else "-"
        out[name][3] += busy.idle(t, upto)
        t = upto

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        while stack and stack[-1][0] <= s:
            innermost(stack[-1][0])
            stack.pop()
        innermost(s)
        rec = out.setdefault(name, [0, 0.0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += e - s
        rec[2] += busy.idle(s, e)
        stack.append((e, name))
    while stack:
        innermost(stack[-1][0])
        stack.pop()
    innermost(hi)
    return out


def program_spans(prof, calls: set) -> dict:
    """The program's spans in ``prof``'s events over the window of the
    benchmark's spans ``calls``, in seconds."""
    from torch.autograd import DeviceType

    from portbench.trace import _union
    own, dev, spans, copies = [], [], [], 0
    for e in prof.events():
        tr, cuda = e.time_range, e.device_type == DeviceType.CUDA
        if e.name.startswith(PREFIX):
            if cuda:
                copies += 1
            else:
                spans.append((tr.start, tr.end, e.name[len(PREFIX):]))
        elif e.name in calls:
            if not cuda:
                own.append((tr.start, tr.end))
        elif cuda and e.name:
            dev.append((tr.start, tr.end))
    lo = min(a for a, _b in own)
    hi = max(b for _a, b in own)
    table = span_idle(spans, Busy(_union(dev, lo, hi)), lo, hi)
    return {"device_copies": copies,
            "spans": {k: [v[0]] + [x * 1e-6 for x in v[1:]]
                      for k, v in table.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 tools/trace_spans.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args(argv)
    from portbench import harness, trace
    got = {}
    summarize = trace.summarize

    def keep(prof, calls):
        got.update(program_spans(prof, calls))
        return summarize(prof, calls)

    trace.summarize = keep
    rec = harness.run(args.workload, args.seed, args.seconds, True)
    stats = {}
    for c in rec["calls"]:
        for k, v in c["stats"].items():
            stats[k] = stats.get(k, 0) + v
    work = {k: sum(c["work"].get(k, 0) for c in rec["calls"])
            for c in rec["calls"][:1] for k in c["work"]}
    print(json.dumps({
        "correct": harness.is_correct(rec), "calls": len(rec["calls"]),
        "window_s": rec["window_s"], "work": work,
        "rate": {k: v / rec["window_s"] for k, v in work.items()},
        "busy_s": rec["trace"]["busy_s"],
        "trace_window_s": rec["trace"]["window_s"],
        "stats": stats, **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
