"""Mu-letter FASTA I/O (the reference's -dbmu input and
`-convert -feature_fasta -alpha Mu` output).

Characters: 0-25 -> 'A'-'Z', 26-35 -> 'a'-'j' (GetFeatureChar,
src/pdbchain.cpp:70-125); reading applies the reference's
g_CharToLetterMu table ('K'->11, 'L'->10 swap — see the parity note in
search/prefilter.py).  Canonical implementation lives in
search/prefilter.py (mu_from_ascii / read_mu_fasta); this module is the
io-layer entry point.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from reseek_tpu_torch.search.prefilter import mu_from_ascii, read_mu_fasta

__all__ = ["mu_from_ascii", "read_mu_fasta", "iter_mu_fasta",
           "iter_fasta", "seq_to_fasta"]


def iter_fasta(path: str) -> Iterator[Tuple[str, str]]:
    """Yield (label, sequence) as plain text per record."""
    label, parts = None, []
    with open(path) as f:
        for line in f:
            line = line.rstrip()
            if not line:
                continue
            if line.startswith(">"):
                if label is not None:
                    yield label, "".join(parts)
                label = line[1:]
                parts = []
            else:
                parts.append(line)
    if label is not None:
        yield label, "".join(parts)


def iter_mu_fasta(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield (label, mu_letters uint8) per record."""
    labels, seqs = read_mu_fasta(path)
    yield from zip(labels, seqs)


def seq_to_fasta(f, label: str, seq: str, rowlen: int = 80) -> None:
    """FASTA record writer, byte-compatible with the reference's
    SeqToFasta (src/sfasta.cpp:5-26, default ROWLEN=80 from
    src/myutils.h:380-383): empty sequences write nothing."""
    if not seq:
        return
    f.write(f">{label}\n")
    for i in range(0, len(seq), rowlen):
        f.write(seq[i:i + rowlen])
        f.write("\n")
