# Frozen copy of reseek_tpu_torch/encoder/dss.py (commit f533a72), the benchmark's plain
# reference: imports renamed; the native encoder only (the port's numpy
# encoder left out): DSSEncoding, mu_kmers and encode_chain.
"""DSS encoder: per-residue discrete structure-state features from C-alpha
geometry, numerically faithful to the reference (src/dss.cpp, src/myss.cpp,
src/getss.cpp, src/valuetoint.cpp), computed by the native C++ encoder
(native/dss_encoder.cpp)."""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from portbench.reference.chain import Chain
from portbench.reference.constants import DSSParams


@dataclasses.dataclass
class DSSEncoding:
    """All computed per-residue features for one chain."""

    chain: Chain
    features: Dict[str, np.ndarray]  # name -> uint8 [L] feature letters
    nen: np.ndarray                  # int32 [L], -1 = undefined
    ren: np.ndarray
    ss: np.ndarray                   # uint8 [L]: h=0 s=1 t=2 ~=3

    @property
    def mu_letters(self) -> np.ndarray:
        """uint8 [L] Mu letters (undefined -> 0, src/dss.cpp:700-714)."""
        return self.features["Mu"]

    def profile(self, params: DSSParams) -> np.ndarray:
        """uint8 [F, L] integer profile in params feature order
        (src/dss.cpp:716-741)."""
        return np.stack([self.features[f] for f in params.features])

    @property
    def ss_string(self) -> str:
        return "".join("hst~"[v] for v in self.ss)


def mu_kmers(mu_letters: np.ndarray, pattern: str = "111") -> np.ndarray:
    """Spaced-seed k-mers over Mu letters (src/dss.cpp:659-682).

    Kmer at pos p = sum over pattern '1' positions j of letter[p+j], base-36,
    most-significant first.  Returns int64 [max(L-len(pattern)+1, 0)].
    """
    L = len(mu_letters)
    n = len(pattern)
    if L < n:
        return np.zeros(0, np.int64)
    lets = mu_letters.astype(np.int64)
    kmers = np.zeros(L - n + 1, np.int64)
    for j, c in enumerate(pattern):
        if c == "1":
            kmers = kmers * 36 + lets[j: L - n + 1 + j]
    return kmers



def encode_chain(chain: Chain) -> DSSEncoding:
    """Compute all DSS features for one chain."""
    from portbench.reference.encoder import native
    feats = native.encode_features(chain)
    L = len(chain)
    return DSSEncoding(chain=chain, features=feats,
                       nen=np.full(L, -1, np.int32),
                       ren=np.full(L, -1, np.int32), ss=feats["SS"])
