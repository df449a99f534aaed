# Frozen copy of reseek_tpu_torch/fp.py (commit f533a72), the benchmark's plain
# reference: imports renamed, nothing else changed.
"""Float32 FMA emulation.

The reference binary is compiled with GCC's default -ffp-contract=fast, so
expressions like `dx*dx + dy*dy + dz*dz` (src/pdbchain.cpp:320-340) and
`dpw*m_AlnFwdScore - revtsw*RevDPScore` (src/dssaligner.cpp:888-889)
compile to fused multiply-adds (verified by disassembling a probe compiled
with the same flags).  Bit-parity with those values requires replicating
the single-rounding FMA, which numpy lacks for float32; we emulate it in
float64: the f64 product of two f32 values is exact (24+24 <= 53 mantissa
bits), so f32(f64(a)*f64(b) + f64(c)) differs from fmaf(a, b, c) only in
double-rounding corner cases (the f64 sum landing exactly between two f32
values AND at an f64 rounding boundary), which are ~2^-30 probable and
irrelevant at our data scales.
"""

from __future__ import annotations

import numpy as np


def fma32(a, b, c):
    """float32 fused multiply-add a*b + c (single rounding), vectorized."""
    r = (np.asarray(a, np.float64) * np.asarray(b, np.float64)
         + np.asarray(c, np.float64))
    return np.float32(r) if np.isscalar(a) or np.ndim(r) == 0 \
        else r.astype(np.float32)


def fms32(a, b, c):
    """float32 fused multiply-subtract a*b - c (single rounding)."""
    r = (np.asarray(a, np.float64) * np.asarray(b, np.float64)
         - np.asarray(c, np.float64))
    return np.float32(r) if np.isscalar(a) or np.ndim(r) == 0 \
        else r.astype(np.float32)
