""".bca binary C-alpha database format, byte-compatible with the reference.

Layout (reference src/bcadata.cpp):
  uint32 magic 0xBCABCA
  uint64 chain_count          (placeholder, written on close)
  uint64 seq_lengths_offset   (placeholder)
  uint64 label_data_size      (placeholder)
  per chain: seq bytes [L], uint16 ICs [3L]   (7 bytes/residue)
  uint32 seq_lengths [chain_count]
  NUL-terminated labels, concatenated
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

from reseek_tpu_torch.chain import Chain

BCA_MAGIC = 0xBCABCA
_HEADER = struct.Struct("<IQQQ")


class BCAReader:
    """Random-access .bca reader (thread-safe for reads via per-call seek)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        magic, chain_count, seqlen_pos, label_size = _HEADER.unpack(
            self._f.read(_HEADER.size))
        if magic != BCA_MAGIC:
            raise ValueError(f"Bad magic {magic:#x}, invalid .bca file {path}")
        self._f.seek(seqlen_pos)
        self.seq_lengths = np.frombuffer(
            self._f.read(4 * chain_count), dtype="<u4")
        label_data = self._f.read(label_size)
        self.labels = label_data.split(b"\0")[:-1]
        if len(self.labels) != chain_count:
            raise ValueError(
                f"Bad BCA file: {chain_count} chains, {len(self.labels)} labels")
        self.labels = [l.decode("utf-8", "replace") for l in self.labels]
        # chain record offsets start right after the 28-byte header
        sizes = 7 * self.seq_lengths.astype(np.int64)
        self.offsets = _HEADER.size + np.concatenate(
            ([0], np.cumsum(sizes)[:-1]))

    def __len__(self) -> int:
        return len(self.labels)

    def read_chain(self, idx: int) -> Chain:
        L = int(self.seq_lengths[idx])
        self._f.seek(int(self.offsets[idx]))
        buf = self._f.read(7 * L)
        seq = buf[:L].decode("ascii", "replace")
        ics = np.frombuffer(buf[L:], dtype="<u2")
        return Chain.from_ics(self.labels[idx], seq, ics)

    def read_all(self) -> List[Chain]:
        return [self.read_chain(i) for i in range(len(self))]

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class BCAWriter:
    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "wb")
        self._f.write(_HEADER.pack(BCA_MAGIC, 0, 0, 0))
        self._labels: List[str] = []
        self._lengths: List[int] = []

    def write_chain(self, chain: Chain) -> None:
        L = len(chain)
        self._labels.append(chain.label)
        self._lengths.append(L)
        self._f.write(chain.seq.encode("ascii"))
        self._f.write(chain.ics().astype("<u2").tobytes())

    def close(self) -> None:
        seqlen_pos = self._f.tell()
        self._f.write(np.asarray(self._lengths, "<u4").tobytes())
        label_data = b"".join(l.encode("utf-8") + b"\0" for l in self._labels)
        self._f.write(label_data)
        self._f.seek(4)
        self._f.write(struct.pack("<QQQ", len(self._labels), seqlen_pos,
                                  len(label_data)))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_bca(path: str) -> List[Chain]:
    with BCAReader(path) as r:
        return r.read_all()


def write_bca(chains, path: str) -> None:
    with BCAWriter(path) as w:
        for c in chains:
            w.write_chain(c)
