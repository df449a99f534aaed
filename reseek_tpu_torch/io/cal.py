""".cal text format: '>label' then one 'aa\\tX\\tY\\tZ' line per residue
(coords printed with 1 decimal).  Reference: src/pdbchaincal.cpp,
src/pdbchain.cpp:160-188 (ToCalSeg)."""

from __future__ import annotations

import gzip
from typing import IO, Iterator, List, Union

import numpy as np

from reseek_tpu_torch.chain import Chain


def _open_text(path_or_f: Union[str, IO], mode="rt"):
    if isinstance(path_or_f, str):
        if path_or_f.endswith(".gz"):
            return gzip.open(path_or_f, mode)
        return open(path_or_f, mode)
    return path_or_f


def iter_cal(path_or_f: Union[str, IO]) -> Iterator[Chain]:
    f = _open_text(path_or_f)
    label = None
    seq: List[str] = []
    coords: List[List[float]] = []

    def flush():
        if label is None:
            return None
        arr = (np.array(coords, dtype=np.float64).astype(np.float32)
               if coords else np.zeros((0, 3), np.float32))
        return Chain(label, "".join(seq), arr)

    for line in f:
        line = line.rstrip("\n")
        if not line:
            continue
        if line.startswith(">"):
            c = flush()
            if c is not None:
                yield c
            label = line[1:]
            seq, coords = [], []
        else:
            fields = line.split("\t")
            if len(fields) != 4 or len(fields[0]) != 1:
                raise ValueError(f"Invalid .cal record {line!r}")
            seq.append(fields[0])
            coords.append([float(fields[1]), float(fields[2]),
                           float(fields[3])])
    c = flush()
    if c is not None:
        yield c
    if isinstance(path_or_f, str):
        f.close()


def read_cal(path: str) -> List[Chain]:
    return list(iter_cal(path))


def write_cal(chains, path_or_f: Union[str, IO]) -> None:
    f = _open_text(path_or_f, "wt")
    close = isinstance(path_or_f, str)
    try:
        if isinstance(chains, Chain):
            chains = [chains]
        for c in chains:
            f.write(f">{c.label}\n")
            for i in range(len(c)):
                x, y, z = c.coords[i]
                f.write(f"{c.seq[i]}\t{x:.1f}\t{y:.1f}\t{z:.1f}\n")
    finally:
        if close:
            f.close()
