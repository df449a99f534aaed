# Frozen copy of reseek_tpu_torch/align/cigar.py (commit f533a72), the benchmark's plain
# reference: imports renamed, nothing else changed.
"""Alignment path (MDI chars) <-> CIGAR strings (src/cigar.cpp)."""

from __future__ import annotations

import re

import numpy as np

_FLIP_DI = bytes.maketrans(b"DI", b"ID")


def path_to_cigar(path: str, flip_di: bool = False) -> str:
    """Run-length encode an M/D/I path (src/cigar.cpp:95-126), vectorized
    (numpy run boundaries — called once per emitted hit row).
    flip_di swaps D and I for the target-orientation row."""
    if not path:
        return ""
    b = path.encode("ascii")
    if flip_di:
        b = b.translate(_FLIP_DI)
    a = np.frombuffer(b, np.uint8)
    starts = np.concatenate(([0], np.flatnonzero(a[1:] != a[:-1]) + 1))
    lens = np.diff(np.concatenate((starts, [len(a)])))
    return "".join(f"{n}{chr(a[s])}" for s, n in zip(starts, lens))


def cigar_to_path(cigar: str) -> str:
    """Expand a CIGAR back to an M/D/I path; S/T prefixes are skipped."""
    path = []
    for count, op in re.findall(r"(\d+)([MDIST])", cigar):
        if op in "MDI":
            path.append(op * int(count))
    return "".join(path)
