"""Bit-exact Smith-Waterman with traceback, counterpart of
reseek_tpu/ops/sw_pallas.py (sw_traceback_pallas) and ops/sw_jax.py.

Same per-cell float32 arithmetic and tie rules as the Pallas kernel's
``_step`` (itself ops/sw_np.py, src/sw.cpp:79-212).  The traceback keeps
the JAX package's skewed layout at this public function: tb [Dp, B, LA]
uint8 with tb[d, b, i] = src | 4*e_pref | 8*f_pref for cell (i, d-i), Dp =
LA+LB-1 rounded up to 8.  Only cells with 0 <= d-i < LB are defined.

``sw_traceback`` launches the CUDA kernel (csrc/sw_traceback.cu) on CUDA
tensors and runs ``sw_traceback_ref``, its plain version, on CPU tensors.
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


def sw_traceback(s: torch.Tensor, open_: float, ext: float):
    """s [B, LA, LB] float32 (NEG-padded) -> (best [B] float32, bi [B]
    int32, bj [B] int32, tb [Dp, B, LA] uint8)."""
    if s.device.type == "cpu":
        return sw_traceback_ref(s, open_, ext)
    if s.dtype != torch.float32 or s.dim() != 3:
        raise TypeError("sw_traceback: s must be float32 [B, LA, LB]")
    if not s.is_contiguous():
        raise ValueError("sw_traceback: s must be contiguous")
    b, la, lb = s.shape
    if la > MAX_LA:
        raise ValueError(f"sw_traceback: LA {la} > {MAX_LA}")
    dp = diag_count(la, lb)
    dev = s.device
    best = torch.empty(b, dtype=torch.float32, device=dev)
    bi = torch.empty(b, dtype=torch.int32, device=dev)
    bj = torch.empty(b, dtype=torch.int32, device=dev)
    tb = torch.empty((dp, b, la), dtype=torch.uint8, device=dev)
    if b == 0:
        return best, bi, bj, tb
    sw_traceback.launches += 1
    kernels.check(kernels.lib().sw_traceback(
        kernels.ptr(s), kernels.ptr(best), kernels.ptr(bi), kernels.ptr(bj),
        kernels.ptr(tb), b, la, lb, dp, float(open_), float(ext),
        kernels.stream_of(s)), "sw_traceback")
    return best, bi, bj, tb


sw_traceback.launches = 0


def sw_traceback_ref(s: torch.Tensor, open_: float, ext: float):
    """Plain version: one step per anti-diagonal over [B, LA] lanes, the
    exact op order of the Pallas ``_step``; the best cell by its diagonal
    rule (strict improvement, or an equal value at a smaller i while the
    best is > 0).  Diagonals past LA+LB-1 are zero-filled."""
    b, la, lb = s.shape
    dev = s.device
    o = float(np.float32(open_))
    e = float(np.float32(ext))
    d_total = la + lb - 1
    lane = torch.arange(la, device=dev)
    neg = torch.full((b, la), float(NEG), dtype=torch.float32, device=dev)
    neg1 = neg[:, :1]
    neg2 = neg[:, :2]
    h1 = h2 = h3 = e1 = f1 = neg
    best = torch.zeros(b, dtype=torch.float32, device=dev)
    bi = torch.zeros(b, dtype=torch.int32, device=dev)
    bj = torch.zeros(b, dtype=torch.int32, device=dev)
    tb = torch.zeros((diag_count(la, lb), b, la), dtype=torch.uint8,
                     device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for d in range(d_total):
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
        src = torch.zeros((b, la), dtype=torch.uint8, device=dev)
        take_e = ev > m
        m = torch.where(take_e, ev, m)
        src[take_e] = 1
        take_f = fv > m
        m = torch.where(take_f, fv, m)
        src[take_f] = 2
        floor = zero >= m
        m = torch.where(floor, zero, m)
        src[floor] = 3
        h = m + s_diag
        h3, h2, h1, e1, f1 = h2, h1, h, ev, fv

        dmax = h.amax(1)
        di = h.argmax(1).to(torch.int32)    # first index among equal maxima
        take = (dmax > best) | ((dmax == best) & (di < bi) & (best > 0))
        best = torch.where(take, dmax, best)
        bi = torch.where(take, di, bi)
        bj = torch.where(take, d - di, bj)
        tb[d] = src | (e_pref.to(torch.uint8) << 2) | (f_pref.to(torch.uint8)
                                                       << 3)
    return best, bi, bj, tb
