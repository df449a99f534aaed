"""Stage-3 alignment from profiles: Smith-Waterman with traceback whose
substitution scores are built inside the kernel, counterpart of
reseek_tpu/ops/sw_pallas.py's sw_traceback_pallas fed by the engine's
substitution tensor.

``sw_align`` launches csrc/sw_align.cu on CUDA tensors and runs
``sw_align_ref``, its plain version (``profile_smx`` followed by
``sw_traceback_ref``, the traceback packed), on CPU tensors.  Outputs:
best [B] float32, bi, bj [B] int32 (as sw_traceback_ref) and the packed
traceback

    tb [B, tiles, LB + 31, 32, R // 2] uint8

of 4-bit codes (src | 4*e_pref | 8*f_pref): rows go in tiles of 32*R, a
tile's rows in strips of R (one per lane of the kernel's warp), and cell
(i, j) of strip k sits at step t = j + k, in byte r // 2 of word [tile,
t, k], low nibble for even r (r = the row within the strip).  Cells at i
>= LA and (step, strip) slots without a column hold 0.  ``unpack_tb``
gives the JAX package's skewed bytes back.

``sw_score_profiles`` is the score-only instantiation of the same kernel
(counterpart of sw_pallas.py's sw_score_pallas on the engine's
substitution tensor): best [B] float32 only, the B side read from its own
profile tensor; its plain version is ``profile_smx`` followed by
``sw_score_ref``.

Both take any LB: up to MAX_LB columns the kernel stages each column's
table offsets in shared memory; past it (``sw_align_uses_global``) the
wrappers launch the kernel's long variant (the ``_long`` C entries), which
reads them from a device-memory scratch and is otherwise the same code,
and count those launches apart, on ``sw_align_long`` and
``sw_score_long``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Tuple

import torch

from reseek_tpu_torch import kernels
from reseek_tpu_torch.ops.smx import profile_codes, profile_smx
from reseek_tpu_torch.ops.sw_wavefront import (diag_count, sw_score_ref,
                                               sw_traceback_ref)

MAX_FEATURES = 8
MAX_LB = 8192         # B columns the kernel stages in shared memory
KERNEL_WARPS = 8      # tiles the kernel sweeps at once, one warp each
MAX_PENALTY = 512.0   # |open|, |ext| below NEG's float32 spacing / 2
MAX_TABLE_FLOATS = 16383   # the kernel's 16-bit byte offsets into them


# launch counts of the long variants (LB > MAX_LB)
sw_align_long = kernels.variant("sw_align_long")
sw_score_long = kernels.variant("sw_score_long")


def sw_align_uses_global(lb: int) -> bool:
    """Whether sw_align and sw_score_profiles at LB columns take the
    kernel's long variant (the column words in device memory)."""
    return lb > MAX_LB


def _column_words(b: int, lb: int, device) -> torch.Tensor:
    """The long variant's scratch: a 16-byte word a B column a pair."""
    return torch.empty((b, lb, 16), dtype=torch.uint8, device=device)


def rows_per_lane(la: int) -> int:
    """R, the rows of a strip: 4 up to LA 1024 (at most eight tiles of 128
    rows, one pass of the kernel's eight warps), else 8."""
    return 4 if la <= 32 * 4 * KERNEL_WARPS else 8


def tb_shape(b: int, la: int, lb: int) -> Tuple[int, ...]:
    r = rows_per_lane(la)
    return (b, -(-la // (32 * r)), lb + 31, 32, r // 2)


@dataclasses.dataclass
class FeatureTable:
    """The weighted table W [D+1, D+1] (code D is padding), the feature
    offsets into it, and each feature's block with its pad row and column,
    B-major: T_f[b][a] = W[code_f(a), code_f(b)] for letter indices a, b
    in [0, n_f], n_f standing for padding.  ``blocks`` concatenates the
    T_f (the kernel's table), on W's device."""
    w: torch.Tensor
    offsets: torch.Tensor
    sizes: List[int]
    blocks: torch.Tensor

    @classmethod
    def build(cls, w: torch.Tensor, offsets: torch.Tensor) -> "FeatureTable":
        d = int(w.shape[0]) - 1
        offs = [int(x) for x in offsets.tolist()]
        sizes = [b - a for a, b in zip(offs, offs[1:] + [d])]
        parts = []
        for off, n in zip(offs, sizes):
            code = torch.cat([torch.arange(off, off + n), torch.tensor([d])])
            code = code.to(w.device)
            parts.append(w[code[:, None], code[None, :]].t().reshape(-1))
        return cls(w, offsets, sizes, torch.cat(parts).contiguous())

    def to(self, device) -> "FeatureTable":
        return FeatureTable(self.w.to(device), self.offsets.to(device),
                            self.sizes, self.blocks.to(device))

    @property
    def pad_code(self) -> int:
        return int(self.w.shape[0]) - 1


def check_pairs(prof, ia, ib, table, la, lb, open_, ext) -> None:
    """Raise unless the profiles, the pair indices, the table, the DP shape
    and the penalties are what the profile-fed kernels take."""
    if prof.dtype != torch.uint8 or prof.dim() != 3:
        raise TypeError("sw_align: prof must be uint8 [N, F, L]")
    if ia.dtype != torch.int64 or ib.dtype != torch.int64:
        raise TypeError("sw_align: ia, ib must be int64")
    if ia.shape != ib.shape or ia.dim() != 1:
        raise ValueError("sw_align: ia, ib must be [B]")
    if not (1 <= la <= prof.shape[2] and 1 <= lb <= prof.shape[2]):
        raise ValueError(f"sw_align: shape {(la, lb)} outside the profiles' "
                         f"length {prof.shape[2]}")
    if prof.shape[1] != len(table.sizes) or prof.shape[1] > MAX_FEATURES:
        raise ValueError(f"sw_align: {prof.shape[1]} features, table has "
                         f"{len(table.sizes)} (at most {MAX_FEATURES})")
    if table.blocks.numel() > MAX_TABLE_FLOATS:
        raise ValueError(f"sw_align: {table.blocks.numel()} table floats > "
                         f"{MAX_TABLE_FLOATS}")
    if max(abs(open_), abs(ext)) >= MAX_PENALTY:
        raise ValueError("sw_align: gap penalties must be below "
                         f"{MAX_PENALTY} in magnitude")
    for t in (prof, ia, ib, table.blocks):
        if t.device != prof.device:
            raise ValueError("sw_align: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError("sw_align: tensors must be contiguous")


def check_b_side(prof, prof_b, name: str) -> None:
    """Raise unless prof_b is a contiguous uint8 tensor of prof's shape and
    device (the B side of a score-only kernel)."""
    if (prof_b.dtype != torch.uint8 or prof_b.shape != prof.shape
            or prof_b.device != prof.device or not prof_b.is_contiguous()):
        raise ValueError(f"{name}: prof_b must be a contiguous uint8 tensor "
                         "of prof's shape and device")


@kernels.counted
def sw_align(prof: torch.Tensor, ia: torch.Tensor, ib: torch.Tensor,
             table: FeatureTable, la: int, lb: int, open_: float,
             ext: float):
    """Pairs (prof[ia], prof[ib]) of profiles prof [N, F, L] uint8
    (PAD_BYTE past a chain's end), DP shape [la, lb] -> (best [B] float32,
    bi [B] int32, bj [B] int32, packed tb (module notes))."""
    if prof.device.type == "cpu":
        return sw_align_ref(prof, ia, ib, table, la, lb, open_, ext)
    check_pairs(prof, ia, ib, table, la, lb, open_, ext)
    b = int(ia.shape[0])
    dev = prof.device
    best = torch.empty(b, dtype=torch.float32, device=dev)
    bi = torch.empty(b, dtype=torch.int32, device=dev)
    bj = torch.empty(b, dtype=torch.int32, device=dev)
    shape = tb_shape(b, la, lb)
    tb = torch.empty(shape, dtype=torch.uint8, device=dev)
    if b == 0:
        return best, bi, bj, tb
    # the boundary row between passes of KERNEL_WARPS tiles
    scratch = (torch.empty((b, lb, 3), dtype=torch.float32, device=dev)
               if shape[1] > KERNEL_WARPS else best)
    sizes = (ctypes.c_int * len(table.sizes))(*table.sizes)
    args = (kernels.ptr(prof), kernels.ptr(ia), kernels.ptr(ib),
            kernels.ptr(table.blocks), table.blocks.numel(), sizes,
            len(table.sizes), prof.shape[2], b, la, lb, 2 * shape[4],
            float(open_), float(ext), kernels.ptr(best), kernels.ptr(bi),
            kernels.ptr(bj), kernels.ptr(tb), kernels.ptr(scratch))
    if sw_align_uses_global(lb):
        cols = _column_words(b, lb, dev)
        kernels.launch(sw_align_long, "sw_align_long", prof, *args,
                       kernels.ptr(cols))
    else:
        kernels.launch(sw_align, "sw_align", prof, *args)
    return best, bi, bj, tb


@kernels.counted
def sw_score_profiles(prof: torch.Tensor, prof_b: torch.Tensor,
                      ia: torch.Tensor, ib: torch.Tensor, table: FeatureTable,
                      la: int, lb: int, open_: float,
                      ext: float) -> torch.Tensor:
    """Score only: pairs (prof[ia], prof_b[ib]) of profiles [N, F, L] uint8
    (prof_b of prof's shape, e.g. the reversed chains'), DP shape [la, lb]
    -> best local score [B] float32 (>= 0), bit-equal to sw_align's best."""
    if prof.device.type == "cpu":
        return sw_score_profiles_ref(prof, prof_b, ia, ib, table, la, lb,
                                     open_, ext)
    check_pairs(prof, ia, ib, table, la, lb, open_, ext)
    check_b_side(prof, prof_b, "sw_score_profiles")
    b = int(ia.shape[0])
    r = rows_per_lane(la)
    best = torch.empty(b, dtype=torch.float32, device=prof.device)
    if b == 0:
        return best
    scratch = (torch.empty((b, lb, 3), dtype=torch.float32,
                           device=prof.device)
               if -(-la // (32 * r)) > KERNEL_WARPS else best)
    sizes = (ctypes.c_int * len(table.sizes))(*table.sizes)
    args = (kernels.ptr(prof), kernels.ptr(prof_b), kernels.ptr(ia),
            kernels.ptr(ib), kernels.ptr(table.blocks), table.blocks.numel(),
            sizes, len(table.sizes), prof.shape[2], b, la, lb, r,
            float(open_), float(ext), kernels.ptr(best), kernels.ptr(scratch))
    if sw_align_uses_global(lb):
        cols = _column_words(b, lb, prof.device)
        kernels.launch(sw_score_long, "sw_score_profiles_long", prof, *args,
                       kernels.ptr(cols))
    else:
        kernels.launch(sw_score_profiles, "sw_score_profiles", prof, *args)
    return best


def sw_score_profiles_ref(prof: torch.Tensor, prof_b: torch.Tensor,
                          ia: torch.Tensor, ib: torch.Tensor,
                          table: FeatureTable, la: int, lb: int,
                          open_: float, ext: float) -> torch.Tensor:
    """Plain version: the gather-sum substitution tensor (profile_smx),
    then the score-only wavefront sw_score_ref."""
    ca = profile_codes(prof[ia, :, :la], table.offsets, table.pad_code)
    cb = profile_codes(prof_b[ib, :, :lb], table.offsets, table.pad_code)
    return sw_score_ref(profile_smx(ca, cb, table.w), open_, ext)


def sw_align_ref(prof: torch.Tensor, ia: torch.Tensor, ib: torch.Tensor,
                 table: FeatureTable, la: int, lb: int, open_: float,
                 ext: float):
    """Plain version: the gather-sum substitution tensor (profile_smx),
    the wavefront of sw_traceback_ref, the traceback packed."""
    ca = profile_codes(prof[ia, :, :la], table.offsets, table.pad_code)
    cb = profile_codes(prof[ib, :, :lb], table.offsets, table.pad_code)
    best, bi, bj, tb = sw_traceback_ref(profile_smx(ca, cb, table.w),
                                        open_, ext)
    return best, bi, bj, pack_tb(tb, la, lb)


def _cells(la: int, lb: int, device):
    """Index grids (i [LA, LB], j [LA, LB]) of the DP cells."""
    i = torch.arange(la, device=device)[:, None].expand(la, lb)
    j = torch.arange(lb, device=device)[None, :].expand(la, lb)
    return i, j


def pack_tb(tb: torch.Tensor, la: int, lb: int) -> torch.Tensor:
    """Skewed traceback [Dp, B, LA] (tb[i+j, b, i] = code of cell (i, j))
    -> the packed layout; cells outside the band are dropped."""
    b = tb.shape[1]
    shape = tb_shape(b, la, lb)
    _, tiles, _, _, half = shape
    r = 2 * half
    i, j = _cells(la, lb, tb.device)
    cells = torch.zeros((b, tiles * 32 * r, lb), dtype=torch.uint8,
                        device=tb.device)
    cells[:, :la] = tb[i + j, :, i].permute(2, 0, 1)
    cells = cells.reshape(b, tiles, 32, r, lb)
    nib = torch.zeros((b, tiles, lb + 31, 32, r), dtype=torch.uint8,
                      device=tb.device)
    for k in range(32):
        nib[:, :, k:k + lb, k, :] = cells[:, :, k].transpose(-1, -2)
    return (nib[..., 0::2] | (nib[..., 1::2] << 4)).contiguous()


def unpack_tb(tb: torch.Tensor, la: int, lb: int) -> torch.Tensor:
    """The packed traceback -> the skewed bytes [Dp, B, LA] of the JAX
    package (Dp = diag_count(la, lb)), 0 outside the band 0 <= d-i < LB."""
    b, tiles, _, _, half = tb.shape
    r = 2 * half
    nib = torch.stack([tb & 15, tb >> 4], -1).reshape(b, tiles, lb + 31, 32,
                                                       r)
    cells = torch.empty((b, tiles, 32, r, lb), dtype=torch.uint8,
                        device=tb.device)
    for k in range(32):
        cells[:, :, k] = nib[:, :, k:k + lb, k, :].transpose(-1, -2)
    cells = cells.reshape(b, tiles * 32 * r, lb)[:, :la]
    out = torch.zeros((diag_count(la, lb), b, la), dtype=torch.uint8,
                      device=tb.device)
    i, j = _cells(la, lb, tb.device)
    out[i + j, :, i] = cells.permute(1, 2, 0)
    return out
