"""Chain data model: label + sequence + C-alpha coordinates.

Equivalent of the reference PDBChain (src/pdbchain.h:10-91) with numpy
coordinate storage.  Coordinates are float32 [L, 3], matching the reference's
vector<float> m_Xs/m_Ys/m_Zs so that downstream float distance math agrees
bit-for-bit.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


def coord_to_ic(x: np.ndarray) -> np.ndarray:
    """float coord -> uint16 integer coord: (X+1000)*10 + 0.5 truncated
    (src/pdbchain.h:89)."""
    return ((np.asarray(x, np.float32) + 1000) * 10 + 0.5).astype(np.uint16)


def ic_to_coord(ic: np.ndarray) -> np.ndarray:
    """uint16 -> float coord: IC/10 - 1000 (src/pdbchain.h:90)."""
    return (np.asarray(ic).astype(np.float32) / np.float32(10.0)
            - np.float32(1000.0))


@dataclasses.dataclass
class Chain:
    label: str
    seq: str
    coords: np.ndarray  # float32 [L, 3]
    lines: Optional[List[str]] = None  # original ATOM lines when requested

    def __post_init__(self):
        self.coords = np.ascontiguousarray(self.coords, dtype=np.float32)
        if self.coords.ndim != 2 or self.coords.shape[1] != 3:
            raise ValueError(f"coords must be [L,3], got {self.coords.shape}")
        if len(self.seq) != self.coords.shape[0]:
            raise ValueError(
                f"seq length {len(self.seq)} != coords {self.coords.shape[0]}")

    def __len__(self) -> int:
        return len(self.seq)

    def dist_matrix(self) -> np.ndarray:
        """Pairwise CA distances, float32 — float arithmetic matches
        PDBChain::GetDist (src/pdbchain.cpp:310-318)."""
        d = self.coords[:, None, :] - self.coords[None, :, :]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        return np.sqrt(d2)

    def dist(self, i: int, j: int) -> np.float32:
        d = self.coords[i] - self.coords[j]
        return np.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])

    def reversed(self) -> "Chain":
        """Residue-order reversal (src/pdbchain.cpp:470-483)."""
        return Chain(self.label + ".rev", self.seq[::-1],
                     self.coords[::-1].copy())

    def flipped(self) -> "Chain":
        """Coordinate negation = mirror image (PDBChain::Flip)."""
        return Chain(self.label, self.seq, -self.coords)

    def ics(self) -> np.ndarray:
        """Flattened uint16 integer coords x0,y0,z0,x1,... [3L]."""
        return coord_to_ic(self.coords).reshape(-1)

    @staticmethod
    def from_ics(label: str, seq: str, ics: np.ndarray) -> "Chain":
        coords = ic_to_coord(np.asarray(ics, np.uint16).reshape(-1, 3))
        return Chain(label, seq, coords)

    def transformed(self, t: np.ndarray, R: np.ndarray) -> "Chain":
        """Apply rigid transform x' = t + R @ x (Kabsch output convention)."""
        new = (np.asarray(t, np.float64)[None, :]
               + self.coords.astype(np.float64) @ np.asarray(R, np.float64).T)
        return Chain(self.label, self.seq, new.astype(np.float32))
