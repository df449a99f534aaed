"""Feature training: aligned-pair frequency counting -> log-odds score
matrices (the reference's -train_features pipeline,
src/train_features.cpp:28-119 + src/logodds.cpp:45-190).

Input = trusted pairwise alignments (FASTA with two gapped rows per pair,
labels matching structure chain labels) + the structures.  Output = per
feature: background freqs, joint aligned freqs, log-odds matrix (nat log
of observed/expected) and an int8-scaled variant — the same artifacts
that were baked into src/trained_features.cpp by the author's training
runs (via train_features2cpp.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from reseek_tpu_torch.chain import Chain
from reseek_tpu_torch.constants import ALPHA_SIZES


@dataclasses.dataclass
class LogOdds:
    """Counting + log-odds math (src/logodds.cpp:45-190)."""

    alpha_size: int

    def __post_init__(self):
        self.background = np.zeros(self.alpha_size, np.int64)
        self.true_mx = np.zeros((self.alpha_size, self.alpha_size),
                                np.int64)

    def add_background(self, letters: np.ndarray) -> None:
        v = letters[letters < self.alpha_size]
        np.add.at(self.background, v, 1)

    def add_true_pairs(self, la: np.ndarray, lb: np.ndarray) -> None:
        """Symmetrized pair counts (AddTruePair, logodds.cpp:68-75)."""
        ok = (la < self.alpha_size) & (lb < self.alpha_size)
        a, b = la[ok], lb[ok]
        np.add.at(self.true_mx, (a, b), 1)
        np.add.at(self.true_mx, (b, a), 1)

    def background_freqs(self) -> np.ndarray:
        return self.background / max(self.background.sum(), 1)

    def true_freq_mx(self) -> np.ndarray:
        return self.true_mx / max(self.true_mx.sum(), 1)

    def log_odds_mx(self) -> Tuple[np.ndarray, float]:
        """Score[i,j] = ln(obs/expected); returns (matrix, expected
        score = sum obs*score) (GetLogOddsMx, logodds.cpp:137-169)."""
        f = self.background_freqs()
        obs = self.true_freq_mx()
        expected = f[:, None] * f[None, :]
        mx = np.zeros_like(obs)
        ok = (obs > 0) & (expected > 0)
        mx[ok] = np.log(obs[ok] / expected[ok])
        return mx, float((obs[ok] * mx[ok]).sum())

    def log_odds_mx_int8(self, max_abs: int = 20) -> np.ndarray:
        """Scaled int8 matrix (GetLogOddsMxInt8, logodds.cpp:170-190)."""
        mx, _ = self.log_odds_mx()
        amax = np.abs(mx).max()
        if amax == 0:
            return np.zeros_like(mx, np.int8)
        return np.round(mx * (max_abs / amax)).astype(np.int8)


def read_aligned_pairs(path: str) -> List[Tuple[str, str, str, str]]:
    """FASTA of gapped row pairs: records 2k and 2k+1 form one trusted
    alignment (train_features.cpp:58-75; labels truncated at the first
    space)."""
    labels, rows = [], []
    label, parts = None, []
    with open(path) as f:
        for line in f:
            line = line.rstrip()
            if not line:
                continue
            if line.startswith(">"):
                if label is not None:
                    labels.append(label)
                    rows.append("".join(parts))
                label = line[1:].split()[0]
                parts = []
            else:
                parts.append(line)
    if label is not None:
        labels.append(label)
        rows.append("".join(parts))
    if len(labels) % 2:
        raise ValueError("odd number of FASTA records; need row pairs")
    return [(labels[2 * i], rows[2 * i], labels[2 * i + 1], rows[2 * i + 1])
            for i in range(len(labels) // 2)]


def _aligned_positions(row_q: str, row_r: str) -> Tuple[np.ndarray,
                                                        np.ndarray]:
    """Ungapped positions of aligned (both non-gap) columns."""
    q = np.frombuffer(row_q.encode("ascii"), np.uint8)
    r = np.frombuffer(row_r.encode("ascii"), np.uint8)
    if len(q) != len(r):
        raise ValueError("aligned rows differ in length")
    gap_q = (q == ord("-")) | (q == ord("."))
    gap_r = (r == ord("-")) | (r == ord("."))
    pos_q = np.cumsum(~gap_q) - 1
    pos_r = np.cumsum(~gap_r) - 1
    both = ~gap_q & ~gap_r
    return pos_q[both], pos_r[both]


def train_features(chains: Sequence[Chain], alns_path: str,
                   features: Iterable[str]) -> Dict[str, LogOdds]:
    """Count background + aligned-pair frequencies per feature
    (TrainFeature, src/train_features.cpp:28-119)."""
    from reseek_tpu_torch.encoder.dss import encode_chain

    by_label = {}
    encs = {}
    for c in chains:
        by_label[c.label] = c
    feats = list(features)
    los = {f: LogOdds(ALPHA_SIZES[f]) for f in feats}

    def enc(label: str):
        if label not in encs:
            if label not in by_label:
                raise KeyError(f"alignment label {label!r} not in chains")
            encs[label] = encode_chain(by_label[label])
        return encs[label]

    for c in chains:
        e = encode_chain(c)
        encs[c.label] = e
        for f in feats:
            los[f].add_background(e.features[f])

    for ql, qrow, rl, rrow in read_aligned_pairs(alns_path):
        eq, er = enc(ql), enc(rl)
        pos_q, pos_r = _aligned_positions(qrow, rrow)
        if len(pos_q) and (pos_q[-1] >= len(by_label[ql])
                           or pos_r[-1] >= len(by_label[rl])):
            raise ValueError(f"alignment rows longer than chains "
                             f"({ql} vs {rl})")
        for f in feats:
            los[f].add_true_pairs(eq.features[f][pos_q],
                                  er.features[f][pos_r])
    return los


def write_trained(f, los: Dict[str, LogOdds], max_abs_i8: int = 20) -> None:
    """TSV dump in the WriteLOInt8 layout (train_features.cpp:121-160):
    FEATURE <name> <alpha> <expected-score>, then int8 matrix rows."""
    for name, lo in los.items():
        mx, expected = lo.log_odds_mx()
        mxi = lo.log_odds_mx_int8(max_abs_i8)
        f.write("FEATURE\t%s\t%u\t%.3f\n" % (name, lo.alpha_size, expected))
        for i in range(lo.alpha_size):
            f.write("\t".join(str(int(v)) for v in mxi[i]) + "\n")
