"""The benchmark's one generator: structure sets read from the .cal files
under ``portbench/data``, replicated in bulk with Gaussian coordinate noise
drawn from ``--seed``, and cut into the calls a traffic file describes.

Rewritten in numpy from ``replica()`` of chip_smoke.py (the q100 or SCOP40
chains cycled, 0.25 A noise a coordinate, labels ``<label>/r<k>``) and
tools/make_scale_db.py (a 329k-chain DB of q100 replicas and its Mu-letter
FASTA, the -dbmu artifact of the reference's pdb90 speed check).  Neither
is imported or run.

A ``Structures`` holds a set as flat arrays, so that a DB of hundreds of
thousands of chains is one coordinate array; ``chains(cls, idx)`` wraps
members in a chain class (the port's or the reference's) as views.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Sequence

import numpy as np

# the checkout's root: files named in BENCHMARK.json are relative to it
ROOT = Path(__file__).resolve().parent.parent
# the seed's independent streams (numpy SeedSequence spawn keys)
STREAM_DATA, STREAM_CALLS, STREAM_CHECK = 0, 1, 2


def data_path(rel: str, root=None) -> Path:
    """A file named relative to the checkout's root (or to ``root``)."""
    return Path(root or ROOT) / rel


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of ``seed`` (any non-negative integer;
    the same seed and stream give the same draws)."""
    return np.random.default_rng([stream, int(seed)])


@dataclasses.dataclass
class Structures:
    labels: List[str]
    seqs: List[str]
    coords: np.ndarray      # float32 [residues, 3], chains end to end
    off: np.ndarray         # int64 [n + 1], chain k is off[k]:off[k + 1]

    def __len__(self) -> int:
        return len(self.labels)

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.off)

    def chain(self, cls, k: int):
        """Member ``k`` as ``cls(label, seq, coords)``, the coordinates a
        view of the flat array."""
        return cls(self.labels[k], self.seqs[k],
                   self.coords[self.off[k]:self.off[k + 1]])

    def chains(self, cls, idx: Sequence[int] = None) -> list:
        """Members ``idx`` (default all) as chains of ``cls``."""
        idx = range(len(self)) if idx is None else idx
        return [self.chain(cls, k) for k in idx]


def read_cal(path) -> Structures:
    """A .cal file: '>label' then 'aa<TAB>x<TAB>y<TAB>z' a residue
    (src/pdbchaincal.cpp); coordinates parsed as reseek_tpu_torch/io/cal.py
    does (float64 text to float32)."""
    labels, seqs, rows, off = [], [], [], [0]
    seq: List[str] = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith(">"):
                if labels:
                    seqs.append("".join(seq))
                    off.append(len(rows))
                labels.append(line[1:])
                seq = []
            else:
                aa, x, y, z = line.split("\t")
                seq.append(aa)
                rows.append((float(x), float(y), float(z)))
    if labels:
        seqs.append("".join(seq))
        off.append(len(rows))
    coords = np.array(rows, np.float64).astype(np.float32).reshape(-1, 3)
    return Structures(labels, seqs, coords, np.asarray(off, np.int64))


def subset(s: Structures, idx: Sequence[int]) -> Structures:
    idx = np.asarray(idx, np.int64)
    lens = s.lengths[idx]
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    coords = (np.concatenate([s.coords[s.off[k]:s.off[k + 1]] for k in idx])
              if len(idx) else np.zeros((0, 3), np.float32))
    return Structures([s.labels[k] for k in idx], [s.seqs[k] for k in idx],
                      coords, off)


def copy_label(label: str, tag: str) -> str:
    """``<dom>_<tag>/<scop id>`` for a SCOP label ``<dom>/<scop id>``
    (the benchmark commands read the id after the slash), else
    ``<label>/<tag>``."""
    if "/" in label:
        dom, rest = label.split("/", 1)
        return f"{dom}_{tag}/{rest}"
    return f"{label}/{tag}"


def replicate(base: Structures, members: np.ndarray, tags: Sequence[str],
              noise: float, rng: np.random.Generator) -> Structures:
    """One chain a member: base chain ``members[k]`` with label tag
    ``tags[k]`` and independent Gaussian noise of ``noise`` A on every
    coordinate, drawn in one call."""
    members = np.asarray(members, np.int64)
    lens = base.lengths[members]
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    # gather the members' coordinates in one pass: residue r of member k
    # is base residue base.off[members[k]] + (r - off[k])
    starts = np.repeat(base.off[members] - off[:-1], lens)
    coords = base.coords[np.arange(off[-1]) + starts]
    coords += rng.standard_normal(coords.shape, dtype=np.float32) * np.float32(
        noise)
    return Structures([copy_label(base.labels[b], t)
                       for b, t in zip(members, tags)],
                      [base.seqs[b] for b in members], coords, off)


def cycled(base: Structures, n: int, noise: float,
           rng: np.random.Generator) -> Structures:
    """``n`` chains: the base cycled, copy k of chain b tagged ``r<k>``
    (member m is base m mod len(base), copy m // len(base))."""
    m = np.arange(n)
    nb = len(base)
    return replicate(base, m % nb, [f"r{k}" for k in m // nb], noise, rng)


def even_picks(lengths: np.ndarray, r: int) -> np.ndarray:
    """``r`` base chains spread evenly over the length order (the same on
    every seed)."""
    order = np.argsort(lengths, kind="stable")
    n = len(order)
    return order[((np.arange(r) + 0.5) * n / r).astype(np.int64)]


def job_members(n_base: int, pool_size: int, lengths: np.ndarray,
                job_size: int, rng: np.random.Generator) -> np.ndarray:
    """Pool indices of one all-vs-all job of ``job_size`` chains.  The pool
    is ``cycled``: member m is base m mod n_base.  Every job holds
    job_size // n_base copies of every base chain and one more of
    job_size % n_base chains spread over the length order, so its lengths
    are the same on every seed; the seed picks which noisy copies, and
    their order."""
    q, r = divmod(job_size, n_base)
    counts = np.full(n_base, q)
    counts[even_picks(lengths, r)] += 1
    picked = []
    for b in range(n_base):
        copies = np.arange(b, pool_size, n_base)
        if counts[b] > len(copies):
            raise ValueError(f"pool of {pool_size} has too few copies of "
                             f"chain {b} for jobs of {job_size}")
        picked.append(rng.choice(copies, counts[b], replace=False))
    return rng.permutation(np.concatenate(picked))


MU_CHARS = np.frombuffer(b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghij", np.uint8)


def mu_fasta(labels: Sequence[str], letters: Sequence[np.ndarray]) -> bytes:
    """A Mu-letter FASTA (letter 0-25 'A'-'Z', 26-35 'a'-'j', as
    GetFeatureChar, src/pdbchain.cpp:70-125, and the reference's -dbmu
    input): one line a chain."""
    parts = []
    for label, mu in zip(labels, letters):
        parts.append(b">" + label.encode() + b"\n")
        parts.append(MU_CHARS[np.asarray(mu, np.int64)].tobytes() + b"\n")
    return b"".join(parts)
