"""Row-sweep Smith-Waterman scores, counterpart of
reseek_tpu/ops/sw_sweep.py.

Two entries, one CUDA source (csrc/mu_sweep.cu, which replaces the Pallas
kernels sw_score_sweep_pallas and mu_sw_score_fused_pallas):

- ``mu_sw_scores``: the Mu filter on letter rows.  The 36-letter matrix
  and the gap penalties are integers, so every DP value is an exact small
  integer in float32 and any evaluation order gives the scores of
  ops/sw_np.sw_score bit for bit.
- ``sw_score_sweep``: the same sweep over a float32 substitution tensor
  (the score-only stage-2 prepass).  It follows the op order of the JAX
  ``_row_step`` (F as kext + cummax(H + open - kext), kext = float(k) *
  ext), so the kernel equals its plain version bit for bit; the closed
  form of F rounds differently from the wavefront, by up to ~1e-3 on
  profile scores, and callers gate with a guard band.

Each launches its kernel on CUDA tensors and runs its plain version
(``mu_sw_scores_ref``, ``sw_score_sweep_ref``) on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from reseek_tpu_torch import kernels

NEG = np.float32(-9e9)
MAX_LB = 8192


@kernels.counted
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
    kernels.launch(mu_sw_scores, "mu_sweep", a, kernels.ptr(a),
                   kernels.ptr(b), kernels.ptr(mumx), kernels.ptr(out), bsz,
                   la, lb, float(open_), float(ext))
    return out



@kernels.counted
def sw_score_sweep(s: torch.Tensor, open_: float,
                   ext: float) -> torch.Tensor:
    """Best local SW score [B] float32 (>= 0) of each substitution matrix
    s [B, LA, LB] float32 (NEG at padding)."""
    if s.device.type == "cpu":
        return sw_score_sweep_ref(s, open_, ext)
    if s.dtype != torch.float32 or s.dim() != 3:
        raise TypeError("sw_score_sweep: s must be float32 [B, LA, LB]")
    if not s.is_contiguous():
        raise ValueError("sw_score_sweep: s must be contiguous")
    bsz, la, lb = s.shape
    if lb > MAX_LB:
        raise ValueError(f"sw_score_sweep: LB {lb} > {MAX_LB}")
    out = torch.zeros(bsz, dtype=torch.float32, device=s.device)
    if bsz == 0 or la == 0 or lb == 0:
        return out
    kernels.launch(sw_score_sweep, "sw_score_sweep", s, kernels.ptr(s),
                   kernels.ptr(out), bsz, la, lb, float(open_), float(ext))
    return out



def _sweep_ref(rows, nrows: int, bsz: int, lb: int, open_: float,
               ext: float, dev) -> torch.Tensor:
    """The row sweep of reseek_tpu sw_sweep.sw_score_sweep over the
    substitution rows rows(i) [B, LB], i < nrows, in the op order of its
    ``_row_step``; F as a running max (``torch.cummax``) of its closed
    form."""
    o = float(np.float32(open_))
    e = float(np.float32(ext))
    kext = torch.arange(lb, dtype=torch.float32, device=dev) * e
    neg = torch.full((bsz, lb), float(NEG), dtype=torch.float32, device=dev)
    h_prev = h_prev2 = e_prev = neg
    best = torch.zeros((bsz, lb), dtype=torch.float32, device=dev)
    for i in range(nrows):
        # F(i,j) = kext(j) + cummax_{k<=j}((H(i-1,k-2) + open) - kext(k))
        fa = torch.cat([neg[:, :2], h_prev[:, :-2]], 1) + o
        f = torch.cummax(fa - kext, dim=1).values + kext
        # E(i,j) = max(H(i-2,j-1) + open, E(i-1,j) + ext)
        ev = torch.maximum(torch.cat([neg[:, :1], h_prev2[:, :-1]], 1) + o,
                           e_prev + e)
        m = torch.cat([neg[:, :1], h_prev[:, :-1]], 1)
        m = torch.maximum(torch.maximum(m, ev), f.clamp_min(0.0))
        h = m + rows(i)
        h_prev2, h_prev, e_prev = h_prev, h, ev
        best = torch.maximum(best, h)
    return best.amax(1).clamp_min(0.0)


def mu_sw_scores_ref(a: torch.Tensor, b: torch.Tensor, mumx: torch.Tensor,
                     open_: float, ext: float) -> torch.Tensor:
    """Plain version of mu_sw_scores: the row sweep over substitution rows
    gathered from the table one row at a time (the [B, LA, LB] tensor is
    never built), trailing rows of padding skipped (they score NEG/2 and
    cannot raise the best)."""
    bsz = a.shape[0]
    lb = b.shape[1]
    al = a.long()
    bl = b.long()
    real = (al != 36).any(0).nonzero()
    nrows = int(real[-1]) + 1 if len(real) else 0
    if lb == 0:
        return torch.zeros(bsz, dtype=torch.float32, device=a.device)
    return _sweep_ref(lambda i: mumx[al[:, i, None], bl], nrows, bsz, lb,
                      open_, ext, a.device)


def sw_score_sweep_ref(s: torch.Tensor, open_: float,
                       ext: float) -> torch.Tensor:
    """Plain version of sw_score_sweep: the row sweep over the rows of
    s."""
    bsz, la, lb = s.shape
    if la == 0 or lb == 0:
        return torch.zeros(bsz, dtype=torch.float32, device=s.device)
    return _sweep_ref(lambda i: s[:, i, :], la, bsz, lb, open_, ext,
                      s.device)
