"""The traced window: torch.profiler (CPU and CUDA activity) around the
calls, each call inside a span of the benchmark's own
(``record_function("<kind>#<call>")``), reduced to what the per-layer
metrics and the result's ``device`` and ``breakdown`` read."""

from __future__ import annotations

import re


def profiler():
    """A profiler of host and device activity (no shapes, stacks or
    memory)."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def short_name(name: str) -> str:
    """A kernel's or copy's name without ``void``, its arguments and
    non-name characters, cut to 64 characters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    name = name.split("(", 1)[0]
    return re.sub(r"[^A-Za-z0-9_.<>,]", "_", name).replace(" ", "")[:64]


def _union(intervals, lo, hi) -> list:
    """The merged intervals, clipped to [lo, hi], of (start, end) pairs."""
    merged = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(prof, spans: set) -> dict:
    """Device activity over the window the benchmark's spans cover: busy
    seconds (the union of kernel, copy and set intervals), the window's
    seconds, seconds by device operation, and the idle gaps, each named by
    the span it falls in ("between_calls" outside them).  Times in
    seconds."""
    from torch.autograd import DeviceType
    dev, own = [], []
    for e in prof.events():
        tr = e.time_range
        if e.name in spans:
            # the span itself; on the device timeline the profiler adds a
            # copy of it (a user annotation), which is not device work
            if e.device_type != DeviceType.CUDA:
                own.append((tr.start, tr.end, e.name))
        elif e.device_type == DeviceType.CUDA and e.name:
            dev.append((tr.start, tr.end, e.name))
    if not own:
        raise RuntimeError("the trace holds none of the benchmark's spans")
    lo = min(a for a, _b, _n in own)
    hi = max(b for _a, b, _n in own)
    busy = _union([(a, b) for a, b, _n in dev], lo, hi)
    kernels = {}
    for a, b, name in dev:
        kernels[name] = kernels.get(name, 0.0) + (b - a) * 1e-6
    gaps, prev = [], lo
    for a, b in busy + [[hi, hi]]:
        if a > prev:
            mid = (a + prev) / 2
            where = next((n for s, e, n in own if s <= mid < e),
                         "between_calls")
            gaps.append((where, (a - prev) * 1e-6))
        prev = max(prev, b)
    by_op = {}
    for name, s in kernels.items():
        k = short_name(name)
        by_op[k] = by_op.get(k, 0.0) + s
    return {"busy_s": sum(b - a for a, b in busy) * 1e-6,
            "window_s": (hi - lo) * 1e-6,
            "kernels": kernels,
            "device_ops": sorted(by_op.items(), key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(gaps, key=lambda g: -g[1])[:10]}
