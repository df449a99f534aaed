"""Spans and counters of one search call.

A driver call (``self_search``, ``query_search``, ``fast_search``, the
multi-process -fast search, the legacy ``batched_self_search``) makes one
``Spans`` recorder, and every span and counter of that call, the device
engine's included, adds into its totals by name: ``seconds`` for spans,
``counts`` for counters.  The drivers' ``device_stats`` / ``fast_stats``
are ``stats()`` of their recorder.

Names nest by dots: ``finish.bands`` is a part of ``finish``, and
``self_seconds`` is a span's total less its children's.  Top-level names
are the parts of the call; ``call(name)`` times the call itself
(``wall``), whose self time is what no top-level span covers.

Off a profiler, a span costs two ``perf_counter`` reads and a dict add.
While a torch profiler runs (torch's own flag, read once a span), a span
entered on the thread that made the recorder, the one that drives the
device, also opens a profiler range ``reseek/<name>``, so its start and
end lie on the profiler's clock beside the device's kernels.  The range
is of record scope FUNCTION, as an operator's: the profiler keeps it on
the host's timeline and adds no copy of it to the device's (it does so
for ``torch.profiler.record_function``, a user scope), so a trace's device
busy time reads the same with the program's ranges as without.  Work on
pool threads is recorded as counters (``add`` of seconds, ``count``)."""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, Optional

import torch

PREFIX = "reseek/"


def profiler_active() -> bool:
    """Whether a torch profiler is recording (torch's own flag)."""
    return torch.autograd.profiler._is_profiler_enabled


def profiler_range(name: str):
    """A profiler range ``reseek/<name>`` of record scope FUNCTION."""
    return torch._C._profiler._RecordFunctionFast(PREFIX + name)


def synchronize(devices: Iterable[torch.device]) -> None:
    """Wait for the queued work of each CUDA device of ``devices``."""
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class _Span:
    __slots__ = ("rec", "name", "sync", "wall", "t0", "range")

    def __init__(self, rec: "Spans", name: str, sync, wall: bool):
        self.rec, self.name, self.sync, self.wall = rec, name, sync, wall

    def __enter__(self) -> "_Span":
        if self.sync:
            synchronize(self.sync)
        self.range = None
        if profiler_active() and threading.get_ident() == self.rec.owner:
            self.range = profiler_range(self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self.sync:
            synchronize(self.sync)
        dt = time.perf_counter() - self.t0
        if self.range is not None:
            self.range.__exit__(None, None, None)
        if self.wall:
            self.rec.wall += dt
        else:
            self.rec.add(self.name, dt)


class Spans:
    """Per-call totals: ``seconds`` of spans and of timed counters,
    ``counts`` of counters, ``wall`` of the call."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.wall: Optional[float] = None
        self.owner = threading.get_ident()

    def span(self, name: str, sync: Optional[Iterable[torch.device]] = None
             ) -> _Span:
        """A context that adds its seconds to ``seconds[name]``.  ``sync``:
        devices whose queued work is waited for at the start and at the
        end, so the span covers the device work it launched."""
        return _Span(self, name, tuple(sync) if sync else (), False)

    def call(self, name: str) -> _Span:
        """The span of the whole call (``wall``, ``wall_s``); ``name``
        names its profiler range."""
        self.wall = 0.0
        return _Span(self, name, (), True)

    def add(self, name: str, seconds: float) -> None:
        """Seconds timed by the caller (a counter of seconds)."""
        self.seconds[name] = self.seconds.get(name, 0.0) + seconds

    def count(self, name: str, n: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + int(n)

    def self_seconds(self, name: Optional[str] = None) -> float:
        """``name``'s seconds less its children's (the next dotted level);
        None: the call's wall less the top-level spans'."""
        if name is None:
            return (self.wall or 0.0) - sum(
                v for k, v in self.seconds.items() if "." not in k)
        depth = name.count(".") + 1
        return self.seconds.get(name, 0.0) - sum(
            v for k, v in self.seconds.items()
            if k.startswith(name + ".") and k.count(".") == depth)

    def stats(self) -> Dict[str, float]:
        """The stats dict: ``<name>_s`` per span (dots as underscores),
        each counter by its name, and ``wall_s`` where the call was
        timed."""
        out = {k.replace(".", "_") + "_s": v
               for k, v in self.seconds.items()}
        out.update(self.counts)
        if self.wall is not None:
            out["wall_s"] = self.wall
        return out
