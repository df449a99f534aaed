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

Both take any LB.  Up to MAX_LB columns the kernel is one block a pair
with the column words (each B column's table offsets) in shared memory.
Past it, and below it where that block would sweep a pair in passes
over enough columns (``sw_align_uses_bands``: LA > 2,048 and LB >=
256), the wrappers launch the band kernel, the
``_long`` C entries, and count those launches apart, on
``sw_align_long`` and ``sw_score_long``.  There a pair's tiles are
bands, one block of one warp each, all running at once on many SMs
(csrc/sw_align.cu's header):

- handoff: band p's last lane writes H of its two last rows and E of its
  last row, per column, to a boundary row in device memory that the
  entry fills with a sentinel NaN first; band p+1 loads a group of
  BAND_GROUP columns ahead and, at each group, waits until none of them
  is the sentinel;
- ordering: a block takes its (pair, band) from an atomic ticket in the
  order blocks start, so it only ever waits on a band that started
  before it;
- fold: each band writes its best cell (or its maximum) to the work
  buffer, and the last band of a pair to finish folds them in any order,
  since ``better`` (larger score, then smaller i, then smaller j) is a
  total order.

The band kernel's rows a lane (``rows_per_lane``: 4 from 1,024 columns,
else 8) and so its band height follow the shape alone, not the pair
count; the traceback keeps its layout (``tb_shape``) for the R chosen.
Given a stats buffer, the band kernel also records the blocks in flight
and the SMs each pair ran on, which ``band_stats`` reads.
tests/test_torch_long.py runs the same protocol in Python against the
plain versions.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Tuple

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
# the band kernel below MAX_LB columns: from this many columns where the
# A side passes 2,048 rows; its 4 rows a lane from BAND_R4_COLS columns
# (8 below); the words of a pair's SM mask in its stats buffer
# (csrc/sw_align.cu: stats_words)
BAND_MIN_COLS = 256
BAND_R4_COLS = 1024
SM_WORDS = 8


# launch counts of the band kernel's entries (sw_align_uses_bands)
sw_align_long = kernels.variant("sw_align_long")
sw_score_long = kernels.variant("sw_score_long")


def sw_align_uses_global(lb: int) -> bool:
    """Whether LB columns exceed the shared-memory kernel's column words
    (so that sw_align and sw_score_profiles take the band kernel)."""
    return lb > MAX_LB


def sw_align_uses_bands(la: int, lb: int) -> bool:
    """Whether sw_align and sw_score_profiles on [la, lb] take the band
    kernel: past MAX_LB columns always; below, where the shared-memory
    kernel would sweep a pair's tiles in passes on one SM (LA > 2,048 at
    8 rows a lane) over at least BAND_MIN_COLS columns.  At 128 columns
    a pair's bands, starting ~47 steps apart, take longer than its passes
    (128 x 4,096 x 128: 0.87 ms against 0.47; chip_smoke.py --bands)."""
    return sw_align_uses_global(lb) or (
        la > 32 * 8 * KERNEL_WARPS and lb >= BAND_MIN_COLS)


def rows_per_lane(la: int, lb: int) -> int:
    """R, the rows of a strip.  The shared-memory kernel: 4 up to LA 1024
    (at most eight tiles of 128 rows, one pass of its eight warps), else
    8.  The band kernel: 4 from BAND_R4_COLS columns, where more and
    shorter steps run at once (R = 8 25-36% slower at 2 x 8,192 x 16,384
    and 1 x 16,384²), else 8, where the bands' start lag (~47 steps a
    band) weighs more than the step (R = 4 8-24% slower at 512 columns;
    even at 1,024; chip_smoke.py --bands)."""
    if sw_align_uses_bands(la, lb):
        return 4 if lb >= BAND_R4_COLS else 8
    return 4 if la <= 32 * 4 * KERNEL_WARPS else 8


def tb_shape(b: int, la: int, lb: int) -> Tuple[int, ...]:
    r = rows_per_lane(la, lb)
    return (b, -(-la // (32 * r)), lb + 31, 32, r // 2)


def band_work_words(b: int, bands: int) -> int:
    """int32 words of the band kernel's work buffer: the ticket, done [b]
    and the bands' bests [b, bands, 3]."""
    return 1 + b + 3 * b * bands


def band_stats_words(b: int) -> int:
    """int32 words of the band kernel's stats buffer: blocks live, the most
    live at once and the SM masks [b, SM_WORDS]."""
    return 2 + b * SM_WORDS


def _band_launch(variant, name, prof, args, b, la, lb, r, stats) -> None:
    """Launch a band entry: ``args`` the short entry's with the pass
    scratch left out; the boundaries, the column words (16 bytes a B
    column a pair) and the work buffer allocated here; ``stats`` the
    caller's stats buffer or None."""
    bands = -(-la // (32 * r))
    dev = prof.device
    bnd = torch.empty((b, bands - 1, lb, 3), dtype=torch.float32, device=dev)
    cols = torch.empty((b, lb, 16), dtype=torch.uint8, device=dev)
    work = torch.empty(band_work_words(b, bands), dtype=torch.int32,
                       device=dev)
    if stats is not None and (stats.dtype != torch.int32
                              or stats.numel() != band_stats_words(b)
                              or stats.device != dev):
        raise ValueError(f"{name}: stats must be int32 "
                         f"[{band_stats_words(b)}] on {dev}")
    kernels.launch(variant, name, prof, *args, kernels.ptr(bnd),
                   kernels.ptr(cols), kernels.ptr(work),
                   None if stats is None else kernels.ptr(stats))


def band_stats(stats: torch.Tensor, b: int, la: int, lb: int,
               r: Optional[int] = None) -> dict:
    """A band launch on b pairs of [la, lb] that filled ``stats``: its plan
    (rows a lane, band height, bands a pair, blocks), the most blocks
    live at once, and the SMs each pair's bands ran on.  ``r``: the
    launch's rows a lane (default rows_per_lane's; the Mu filter's band
    kernel passes its own)."""
    r = rows_per_lane(la, lb) if r is None else r
    bands = -(-la // (32 * r))
    w = stats.cpu()
    masks = w[2:].view(b, SM_WORDS)
    sms = [sum(bin(int(x) & 0xffffffff).count("1") for x in row)
           for row in masks.tolist()]
    return {"pairs": b, "rows_per_lane": r, "band_rows": 32 * r,
            "bands": bands, "blocks": b * bands,
            "blocks_in_flight": int(w[1]), "sms_per_pair": sms}


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
             ext: float, stats: Optional[torch.Tensor] = None):
    """Pairs (prof[ia], prof[ib]) of profiles prof [N, F, L] uint8
    (PAD_BYTE past a chain's end), DP shape [la, lb] -> (best [B] float32,
    bi [B] int32, bj [B] int32, packed tb (module notes)).  ``stats``, an
    int32 tensor of band_stats_words(B) on prof's device, is filled where
    the band kernel runs (band_stats reads it), else left as it is."""
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
    sizes = (ctypes.c_int * len(table.sizes))(*table.sizes)
    args = (kernels.ptr(prof), kernels.ptr(ia), kernels.ptr(ib),
            kernels.ptr(table.blocks), table.blocks.numel(), sizes,
            len(table.sizes), prof.shape[2], b, la, lb, 2 * shape[4],
            float(open_), float(ext), kernels.ptr(best), kernels.ptr(bi),
            kernels.ptr(bj), kernels.ptr(tb))
    if sw_align_uses_bands(la, lb):
        _band_launch(sw_align_long, "sw_align_long", prof, args, b, la, lb,
                     2 * shape[4], stats)
    else:
        # the boundary row between passes of KERNEL_WARPS tiles
        scratch = (torch.empty((b, lb, 3), dtype=torch.float32, device=dev)
                   if shape[1] > KERNEL_WARPS else best)
        kernels.launch(sw_align, "sw_align", prof, *args,
                       kernels.ptr(scratch))
    return best, bi, bj, tb


@kernels.counted
def sw_score_profiles(prof: torch.Tensor, prof_b: torch.Tensor,
                      ia: torch.Tensor, ib: torch.Tensor, table: FeatureTable,
                      la: int, lb: int, open_: float, ext: float,
                      stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Score only: pairs (prof[ia], prof_b[ib]) of profiles [N, F, L] uint8
    (prof_b of prof's shape, e.g. the reversed chains'), DP shape [la, lb]
    -> best local score [B] float32 (>= 0), bit-equal to sw_align's best.
    ``stats`` as sw_align's."""
    if prof.device.type == "cpu":
        return sw_score_profiles_ref(prof, prof_b, ia, ib, table, la, lb,
                                     open_, ext)
    check_pairs(prof, ia, ib, table, la, lb, open_, ext)
    check_b_side(prof, prof_b, "sw_score_profiles")
    b = int(ia.shape[0])
    r = rows_per_lane(la, lb)
    best = torch.empty(b, dtype=torch.float32, device=prof.device)
    if b == 0:
        return best
    sizes = (ctypes.c_int * len(table.sizes))(*table.sizes)
    args = (kernels.ptr(prof), kernels.ptr(prof_b), kernels.ptr(ia),
            kernels.ptr(ib), kernels.ptr(table.blocks), table.blocks.numel(),
            sizes, len(table.sizes), prof.shape[2], b, la, lb, r,
            float(open_), float(ext), kernels.ptr(best))
    if sw_align_uses_bands(la, lb):
        _band_launch(sw_score_long, "sw_score_profiles_long", prof, args, b,
                     la, lb, r, stats)
    else:
        scratch = (torch.empty((b, lb, 3), dtype=torch.float32,
                               device=prof.device)
                   if -(-la // (32 * r)) > KERNEL_WARPS else best)
        kernels.launch(sw_score_profiles, "sw_score_profiles", prof, *args,
                       kernels.ptr(scratch))
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
