"""Mu-filter Smith-Waterman scores, counterpart of reseek_tpu/ops/sw_sweep.py.

The 36-letter Mu filter scores with an integer matrix and integer gap
penalties, so every DP value is an exact small integer in float32 and any
evaluation order gives the scores of ops/sw_np.sw_score bit for bit.
``mu_sw_scores`` launches the CUDA row-sweep kernel (csrc/mu_sweep.cu,
which replaces the Pallas kernels sw_score_sweep_pallas and
mu_sw_score_fused_pallas) on CUDA tensors, and runs ``mu_sw_scores_ref``,
its plain version, on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from reseek_tpu_torch import kernels

NEG = np.float32(-9e9)
MAX_LB = 8192


def mu_sw_scores(a: torch.Tensor, b: torch.Tensor, mumx: torch.Tensor,
                 open_: float, ext: float) -> torch.Tensor:
    """Best local SW score [B] float32 (>= 0) for each pair of Mu letter
    rows a [B, LA], b [B, LB] (uint8, letter 36 = padding, trailing only)
    under the padded 37x37 table ``mumx``."""
    if a.device.type == "cpu":
        return mu_sw_scores_ref(a, b, mumx, open_, ext)
    if a.dtype != torch.uint8 or b.dtype != torch.uint8:
        raise TypeError("mu_sw_scores: letters must be uint8")
    if mumx.dtype != torch.float32 or tuple(mumx.shape) != (37, 37):
        raise TypeError("mu_sw_scores: mumx must be float32 [37, 37]")
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"mu_sw_scores: bad shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if not (b.device == a.device == mumx.device):
        raise ValueError("mu_sw_scores: tensors on different devices")
    if not (a.is_contiguous() and b.is_contiguous()
            and mumx.is_contiguous()):
        raise ValueError("mu_sw_scores: tensors must be contiguous")
    bsz, la = a.shape
    lb = b.shape[1]
    if lb > MAX_LB:
        raise ValueError(f"mu_sw_scores: LB {lb} > {MAX_LB}")
    out = torch.empty(bsz, dtype=torch.float32, device=a.device)
    if bsz == 0:
        return out
    mu_sw_scores.launches += 1
    kernels.check(kernels.lib().mu_sweep(
        kernels.ptr(a), kernels.ptr(b), kernels.ptr(mumx), kernels.ptr(out),
        bsz, la, lb, float(open_), float(ext), kernels.stream_of(a)),
        "mu_sweep")
    return out


mu_sw_scores.launches = 0


def mu_sw_scores_ref(a: torch.Tensor, b: torch.Tensor, mumx: torch.Tensor,
                     open_: float, ext: float) -> torch.Tensor:
    """Plain version: the row sweep of reseek_tpu sw_sweep.sw_score_sweep
    over substitution rows gathered from the table one row at a time (the
    [B, LA, LB] tensor is never built), F as a running max
    (``torch.cummax``) of its closed form."""
    bsz, la = a.shape
    lb = b.shape[1]
    dev = a.device
    al = a.long()
    bl = b.long()
    o = float(np.float32(open_))
    e = float(np.float32(ext))
    kext = torch.arange(lb, dtype=torch.float32, device=dev) * e
    neg = torch.full((bsz, lb), float(NEG), dtype=torch.float32, device=dev)
    h_prev = h_prev2 = e_prev = neg
    best = torch.zeros((bsz, lb), dtype=torch.float32, device=dev)
    # rows after the last real letter score NEG/2 and cannot raise the best
    real = (al != 36).any(0).nonzero()
    nrows = int(real[-1]) + 1 if len(real) else 0
    for i in range(nrows):
        s_row = mumx[al[:, i, None], bl]
        # F(i,j) = j*ext + cummax_{k<=j}(H(i-1,k-2) + open - k*ext)
        fa = torch.cat([neg[:, :2], h_prev[:, :-2]], 1) + o
        f = torch.cummax(fa - kext, dim=1).values + kext
        # E(i,j) = max(H(i-2,j-1) + open, E(i-1,j) + ext)
        ev = torch.maximum(torch.cat([neg[:, :1], h_prev2[:, :-1]], 1) + o,
                           e_prev + e)
        m = torch.cat([neg[:, :1], h_prev[:, :-1]], 1)
        m = torch.maximum(torch.maximum(m, ev), f.clamp_min(0.0))
        h = m + s_row
        h_prev2, h_prev, e_prev = h_prev, h, ev
        best = torch.maximum(best, h)
    return best.amax(1).clamp_min(0.0)
