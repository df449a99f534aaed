"""Bit-exact Smith-Waterman wavefront, counterpart of
reseek_tpu/ops/sw_pallas.py (sw_traceback_pallas, sw_score_pallas) and
ops/sw_jax.py.

Same per-cell float32 arithmetic and tie rules as the Pallas kernels'
``_step`` (itself ops/sw_np.py, src/sw.cpp:79-212).  The traceback keeps
the JAX package's skewed layout at this public function: tb [Dp, B, LA]
uint8 with tb[d, b, i] = src | 4*e_pref | 8*f_pref for cell (i, d-i), Dp =
LA+LB-1 rounded up to 8.  Only cells with 0 <= d-i < LB are defined.

``sw_score`` (score only, equal to sw_traceback_ref's best bit for bit)
launches the CUDA kernel of csrc/sw_traceback.cu on CUDA tensors and runs
``sw_score_ref``, its plain version, on CPU tensors.  ``sw_traceback_ref``
is the plain traceback wavefront; on the card, stage 3 runs
ops/sw_align.py, which builds its substitution scores in the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from reseek_tpu_torch import kernels

NEG = np.float32(-9e9)
K_DIAGS = 8      # diagonal-count padding of the Pallas kernel's layout
MAX_LA = 8192


def diag_count(la: int, lb: int) -> int:
    """Dp: LA+LB-1 diagonals rounded up to a multiple of K_DIAGS."""
    return -(-(la + lb - 1) // K_DIAGS) * K_DIAGS


def _check(name: str, s: torch.Tensor) -> None:
    if s.dtype != torch.float32 or s.dim() != 3:
        raise TypeError(f"{name}: s must be float32 [B, LA, LB]")
    if not s.is_contiguous():
        raise ValueError(f"{name}: s must be contiguous")
    if s.shape[1] > MAX_LA:
        raise ValueError(f"{name}: LA {s.shape[1]} > {MAX_LA}")


@kernels.counted
def sw_score(s: torch.Tensor, open_: float, ext: float) -> torch.Tensor:
    """s [B, LA, LB] float32 (NEG-padded) -> best local score [B] float32
    (>= 0), bit-equal to sw_traceback_ref's best."""
    if s.device.type == "cpu":
        return sw_score_ref(s, open_, ext)
    _check("sw_score", s)
    b, la, lb = s.shape
    best = torch.zeros(b, dtype=torch.float32, device=s.device)
    if b == 0 or la == 0 or lb == 0:
        return best
    kernels.launch(sw_score, "sw_score", s, kernels.ptr(s),
                   kernels.ptr(best), b, la, lb, float(open_), float(ext))
    return best


def _wavefront_ref(s: torch.Tensor, open_: float, ext: float, trace: bool):
    """Yield (d, H of diagonal d [B, LA], tb byte row [B, LA] or None) for
    each anti-diagonal d < LA+LB-1: one step over [B, LA] lanes in the
    exact op order of the Pallas ``_step``, S = NEG outside the band."""
    b, la, lb = s.shape
    dev = s.device
    o = float(np.float32(open_))
    e = float(np.float32(ext))
    lane = torch.arange(la, device=dev)
    neg = torch.full((b, la), float(NEG), dtype=torch.float32, device=dev)
    neg1 = neg[:, :1]
    neg2 = neg[:, :2]
    h1 = h2 = h3 = e1 = f1 = neg
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for d in range(la + lb - 1):
        j = d - lane
        in_band = (j >= 0) & (j < lb)
        s_diag = torch.where(in_band, s[:, lane, j.clamp(0, lb - 1)],
                             float(NEG))
        e_open = torch.cat([neg2, h3[:, :-2]], 1) + o
        e_ext = torch.cat([neg1, e1[:, :-1]], 1) + e
        e_pref = e_open >= e_ext
        ev = torch.where(e_pref, e_open, e_ext)
        f_open = torch.cat([neg1, h3[:, :-1]], 1) + o
        f_ext = f1 + e
        f_pref = f_open >= f_ext
        fv = torch.where(f_pref, f_open, f_ext)
        m = torch.cat([neg1, h2[:, :-1]], 1)
        take_e = ev > m
        m = torch.where(take_e, ev, m)
        take_f = fv > m
        m = torch.where(take_f, fv, m)
        floor = zero >= m
        m = torch.where(floor, zero, m)
        h = m + s_diag
        h3, h2, h1, e1, f1 = h2, h1, h, ev, fv
        code = None
        if trace:
            code = torch.zeros((b, la), dtype=torch.uint8, device=dev)
            code[take_e] = 1
            code[take_f] = 2
            code[floor] = 3
            code |= (e_pref.to(torch.uint8) << 2) | (f_pref.to(torch.uint8)
                                                     << 3)
        yield d, h, code


def sw_traceback_ref(s: torch.Tensor, open_: float, ext: float):
    """Plain version: the wavefront of ``_wavefront_ref``; the best cell by
    the Pallas diagonal rule (strict improvement, or an equal value at a
    smaller i while the best is > 0).  Diagonals past LA+LB-1 are
    zero-filled."""
    b, la, lb = s.shape
    dev = s.device
    best = torch.zeros(b, dtype=torch.float32, device=dev)
    bi = torch.zeros(b, dtype=torch.int32, device=dev)
    bj = torch.zeros(b, dtype=torch.int32, device=dev)
    tb = torch.zeros((diag_count(la, lb), b, la), dtype=torch.uint8,
                     device=dev)
    for d, h, code in _wavefront_ref(s, open_, ext, trace=True):
        dmax = h.amax(1)
        di = h.argmax(1).to(torch.int32)    # first index among equal maxima
        take = (dmax > best) | ((dmax == best) & (di < bi) & (best > 0))
        best = torch.where(take, dmax, best)
        bi = torch.where(take, di, bi)
        bj = torch.where(take, d - di, bj)
        tb[d] = code
    return best, bi, bj, tb


def sw_score_ref(s: torch.Tensor, open_: float, ext: float) -> torch.Tensor:
    """Plain version of sw_score: the running max of every diagonal's H
    (out-of-band lanes sit near NEG and never reach it), floored at 0, as
    the Pallas ``_score_kernel`` keeps its bestv."""
    best = torch.zeros(s.shape[0], dtype=torch.float32, device=s.device)
    if s.shape[1] == 0 or s.shape[2] == 0:
        return best
    for _, h, _ in _wavefront_ref(s, open_, ext, trace=False):
        best = torch.maximum(best, h.amax(1))
    return best
