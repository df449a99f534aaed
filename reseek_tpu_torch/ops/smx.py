"""Substitution tensors, counterpart of reseek_tpu/ops/smx_jax.py and of
the ``smx`` closures of reseek_tpu/search/engine.py.

Profiles become flat codes into a concatenated alphabet (D = sum of the
feature alphabet sizes) with a block-diagonal weighted table W [D+1, D+1];
code D is padding.  The profile substitution tensor

    S[b, i, j] = sum_f W[ca[b, f, i], cb[b, f, j]]

is built as a gather-sum in feature order (first feature assigned, the
rest added, all float32): the additions of ops/substmx.build_smx and of
the reference's SetSMx_NoRev, so S equals build_smx bit for bit.  (The
JAX engine's one-hot HIGHEST-precision matmul deviates from it by up to
~1e-6 relative; its host finish carries a band for that.)  This is plain
tensor code in the JAX package too, so it stays plain torch.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from reseek_tpu.constants import ALPHA_SIZES
from reseek_tpu.ops.substmx import weighted_matrices
from reseek_tpu.search.engine import PAD_BYTE, _mu_matrix_padded

NEG = np.float32(-9e9)


@functools.lru_cache(maxsize=4)
def flat_layout(features: Tuple[str, ...], weights: Tuple[float, ...]):
    """(offsets per feature [F] int32, D, W [D+1, D+1] block-diagonal
    float32), as reseek_tpu.ops.smx_jax.flat_layout.  Row and column D
    (padding) hold NEG/F, so a padded cell sums to ~NEG over F features."""
    mats = weighted_matrices(features, weights)
    sizes = [ALPHA_SIZES[f] for f in features]
    offsets = np.concatenate(([0], np.cumsum(sizes)[:-1])).astype(np.int32)
    d = int(sum(sizes))
    w = np.zeros((d + 1, d + 1), np.float32)
    for f, off, sz in zip(features, offsets, sizes):
        w[off: off + sz, off: off + sz] = mats[f]
    pad_pen = NEG / np.float32(len(features))
    w[d, :] = pad_pen
    w[:, d] = pad_pen
    return offsets, d, w


def mu_table() -> np.ndarray:
    """The padded 37x37 float32 Mu table (reseek_tpu's engine table): the
    36 integer letters, and padding letter 36, which scores NEG/2 against
    everything.  NEG is finite, never inf, so cells next to padding stay
    finite through every add of the sweep."""
    return _mu_matrix_padded()


def profile_codes(prof: torch.Tensor, offsets: torch.Tensor,
                  pad_code: int) -> torch.Tensor:
    """uint8 profiles [B, F, L] (PAD_BYTE past a chain's end) -> int64 flat
    codes [B, F, L], padding -> pad_code."""
    p = prof.long()
    return torch.where(p == PAD_BYTE, pad_code, p + offsets[None, :, None])


def profile_smx(codes_a: torch.Tensor, codes_b: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """S [B, LA, LB] float32 from flat codes [B, F, LA] and [B, F, LB]:
    the gather-sum in feature order."""
    s = w[codes_a[:, 0, :, None], codes_b[:, 0, None, :]]
    for f in range(1, codes_a.shape[1]):
        s += w[codes_a[:, f, :, None], codes_b[:, f, None, :]]
    return s
