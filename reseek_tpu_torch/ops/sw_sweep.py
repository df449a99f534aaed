"""Smith-Waterman best scores without traceback, counterpart of
reseek_tpu/ops/sw_sweep.py.

Two entries, two CUDA sources:

- ``mu_sw_scores``: the Mu filter on letter rows (csrc/mu_wavefront.cu,
  which replaces the Pallas kernel mu_sw_score_fused_pallas).  The
  36-letter table and the gap penalties are integers, so every DP value
  is an exact small integer and any evaluation order gives the scores of
  ops/sw_np.sw_score bit for bit; the kernel runs the DP in int16 pairs
  or int32 on Hopper's DPX instructions, with the lane type that
  ``mu_lane_bits`` proves cannot wrap.  Past MU_MAX_LB columns
  (``mu_uses_global``) it launches the kernel's long variant, the band
  kernel (int32 lanes; a pair's tiles of rows run at once as bands of one
  warp, handing their boundary through device memory,
  ``mu_band_scratch``, in launches of ``mu_band_pairs`` pairs, whose
  boundaries fit a share of the card's memory), counted apart on
  ``mu_sweep_long``.  Its table
  is a ``MuTable``, built and checked once.
- ``sw_score_sweep``: the float row sweep of the score-only stage-2
  prepass (csrc/sw_sweep.cu; replaces sw_score_sweep_pallas and the
  gather-sum that fed it a substitution tensor), up to SWEEP_MAX_LB
  columns (``sweep_takes``; the engine gives longer chunks the exact
  score).  It takes the pairs'
  uint8 profiles and the per-feature tables, as sw_align.sw_score_profiles
  does, and builds each cell's score in the kernel in profile_smx's
  order, so no [B, LA, LB] tensor exists.  It follows the op order of the
  JAX ``_row_step`` (F as kext + cummax(H + open - kext), kext = float(k)
  * ext), so the kernel equals its plain version bit for bit; the closed
  form of F rounds differently from the wavefront, by up to ~1e-3 on
  profile scores, and callers gate with a guard band.  ``sweep_layout``
  gives the kernel's columns a lane and warps a pair.

Each launches its kernel on CUDA tensors and runs its plain version
(``mu_sw_scores_ref``; ``sw_score_sweep_profiles_ref``: profile_smx, then
``sw_score_sweep_ref``, the row sweep over an S) on CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from reseek_tpu_torch import kernels
from reseek_tpu_torch.ops.smx import profile_codes, profile_smx
from reseek_tpu_torch.ops.sw_align import (FeatureTable, band_stats_words,
                                           check_b_side, check_pairs)

NEG = np.float32(-9e9)
SWEEP_MAX_LB = 8192        # columns of the float sweep (no long variant)
MU_MAX_LB = 8192           # columns the Mu filter keeps in shared memory
# blocks of one warp a Hopper SM holds at once: the band kernel's bands
# all run at once up to this many an SM
MU_BAND_BLOCKS_PER_SM = 32
# the band kernel's boundaries of one launch take at most the device's
# memory over this
MU_BAND_SCRATCH_SHARE = 8
SWEEP_MAX_V = 16           # B columns a lane of the float sweep
SWEEP_MAX_LETTERS = 63     # alphabet size: 4 x letter fits a byte
SWEEP_MAX_SLOTS = 256      # the tables' rows (alphabet sizes + 1, summed)
MU_PAD = 36                # the padding letter
PAD16 = -32768             # the int16 table's padding entries
MAX_ENTRY = 32767          # |entry| bound of the 36x36 block
MAX_GAP = 32767            # |open|, |ext| bound
# each lane type: (smallest, largest value it holds, the padding score
# the kernel gives letter 36 in it)
LANES = {16: (-(1 << 15), (1 << 15) - 1, PAD16),
         32: (-(1 << 31), (1 << 31) - 1, -(1 << 30))}
# the float table's padding entries must sink every padded cell of the
# plain version below 0 at any shape the wrapper takes
MAX_FLOAT_PAD = -float(1 << 30)


@dataclasses.dataclass(frozen=True)
class MuTable:
    """The padded 37x37 Mu table, checked once: ``mumx`` float32 (the
    plain version's), ``tab16`` int16 (the kernel's: the 36x36 block, and
    ``pad`` in letter 36's row and column), the block's largest and
    smallest entries ``smax``, ``smin``.  All tensors on one device."""
    mumx: torch.Tensor
    tab16: torch.Tensor
    smax: int
    smin: int
    pad: int = PAD16

    @classmethod
    def build(cls, mumx: torch.Tensor) -> "MuTable":
        """Raises unless ``mumx`` is float32 [37, 37] with an integer 36x36
        block in [-MAX_ENTRY, MAX_ENTRY] and padding entries (row and
        column 36) at most MAX_FLOAT_PAD."""
        if mumx.dtype != torch.float32 or tuple(mumx.shape) != (37, 37):
            raise TypeError("MuTable: mumx must be float32 [37, 37]")
        m = mumx.detach().cpu().double()
        block = m[:MU_PAD, :MU_PAD]
        if not bool(torch.isfinite(block).all()) or not torch.equal(
                block, block.round()):
            raise ValueError("MuTable: the 36x36 block must be integers")
        if float(block.abs().max()) > MAX_ENTRY:
            raise ValueError(f"MuTable: entries beyond +-{MAX_ENTRY}")
        pads = torch.cat([m[MU_PAD, :], m[:, MU_PAD]])
        if not float(pads.max()) <= MAX_FLOAT_PAD:
            raise ValueError("MuTable: the padding row and column must be "
                             f"<= {MAX_FLOAT_PAD}")
        tab = torch.full((37, 37), PAD16, dtype=torch.int16)
        tab[:MU_PAD, :MU_PAD] = block.to(torch.int16)
        return cls(mumx.contiguous(), tab.to(mumx.device),
                   int(block.max()), int(block.min()))

    def to(self, device) -> "MuTable":
        return dataclasses.replace(self, mumx=self.mumx.to(device),
                                   tab16=self.tab16.to(device))


def mu_lane_fits(la: int, lb: int, smax: int, smin: int, open_: int,
                 ext: int, bits: int) -> bool:
    """True when no value the kernel's clamped DP forms at shape [la, lb]
    leaves the ``bits`` lane type (DPX adds wrap) and a padded cell stays
    below 0 (pad + hi < 0, so its H' is 0).  Every H', E', F' lies in
    [0, hi], hi = max(smax, 0) * min(la, lb): a local path's score gains
    at most smax per diagonal step and at most min(la, lb) of them, gaps
    only cost.  The sums below 0 are H' + open, E' + ext (>= the penalty)
    and m + S with m in [0, hi] (>= smin, or >= the lane's padding score
    on a padded cell)."""
    tmin, tmax, pad = LANES[bits]
    lo = min(pad, smin, open_, ext, 0)
    hi = max(smax, 0) * min(la, lb)
    return tmin <= lo and hi <= tmax and pad + hi < 0


def mu_uses_global(lb: int) -> bool:
    """Whether mu_sw_scores at LB columns takes the kernel's long variant
    (int32 lanes, the column words in device memory)."""
    return lb > MU_MAX_LB


def mu_lane_bits(la: int, lb: int, smax: int, smin: int, open_: int,
                 ext: int) -> int:
    """The kernel's lane type for a shape: 16 (two pairs a 32-bit word)
    where every value fits int16, else 32; the long variant has int32
    lanes only.  Raises where no lane type it has fits."""
    for bits in ((32,) if mu_uses_global(lb) else (16, 32)):
        if mu_lane_fits(la, lb, smax, smin, open_, ext, bits):
            return bits
    raise ValueError(f"mu_sw_scores: no lane type holds shape {(la, lb)}")


def mu_rows_per_lane(la: int) -> int:
    """R, the rows of a lane's strip in the shared-memory kernel: 4 up to
    LA 128 (one tile of 32 R rows), else 8 (tiles of 256 rows, passes
    beyond)."""
    return 4 if la <= 128 else 8


def mu_band_rows(b: int, la: int, sms: int) -> int:
    """R, the rows of a lane's strip in the band kernel (bands of 32 R
    rows) on b pairs of la rows, on a card of ``sms`` SMs: 4 while the
    launch's bands of 128 rows all fit on the card at once
    (MU_BAND_BLOCKS_PER_SM blocks of one warp an SM), where a band's step
    is the limit and a shorter one wins; else 8, which issues fewer
    instructions a cell where the blocks queue.  (On an H100, R = 4 4-16%
    faster at 1-8 pairs of 2,048-12,032 rows and at a stage-1 block of
    128 x 128 x 16,384; R = 8 26-30% faster at the stage-1 blocks of 128
    pairs x 8,192 or 16,384 rows x 16,384 columns, 8,192-16,384 blocks;
    chip_smoke.py --mu-bands, PERF.md §6.)"""
    return 4 if b * -(-la // 128) <= MU_BAND_BLOCKS_PER_SM * sms else 8


def mu_band_plan(b: int, la: int, sms: int) -> Tuple[int, int, int]:
    """(R, bands a pair, blocks) of the band kernel on b pairs of la rows
    on a card of ``sms`` SMs: a block of one warp a band."""
    r = mu_band_rows(b, la, sms)
    bands = -(-la // (32 * r))
    return r, bands, b * bands


def mu_band_pairs(b: int, la: int, lb: int, budget: int) -> int:
    """Pairs of one band-kernel launch on b pairs of [la, lb], so that the
    launch's boundaries ([pairs, bands - 1, lb, 3] int32, counted at R =
    4, the most bands) take at most ``budget`` bytes; at least one.  On
    an H100 80GB (budget MU_BAND_SCRATCH_SHARE: ~10 GB) one pair fits up
    to an edge of ~330,000; a stage-1 block of 128 pairs of 16,384² (3.2
    GB) is one launch, of 65,536² five."""
    per = (-(-la // 128) - 1) * lb * 12
    return b if per == 0 else max(1, min(b, budget // per))


def mu_band_scratch(out: torch.Tensor, b: int, la: int, lb: int, r: int):
    """What the band kernel at R = ``r`` is handed besides the letters:
    ``out`` zeroed (each band raises its pair's best by an atomic
    maximum), the boundaries below each band [b, bands - 1, lb, 3] int32
    filled with the sentinel -1 (0xffffffff, which no DP value takes:
    they lie in [0, 2^30)), or ``out`` itself when a pair has one band,
    and the ticket, one int32 0.  -> (bnd, ticket)."""
    bands = -(-la // (32 * r))
    out.zero_()
    dev = out.device
    bnd = (torch.full((b, bands - 1, lb, 3), -1, dtype=torch.int32,
                      device=dev) if bands > 1 else out)
    return bnd, torch.zeros(1, dtype=torch.int32, device=dev)


@functools.lru_cache(maxsize=8)
def _card(dev: torch.device) -> Tuple[int, int]:
    """(SMs, the band kernel's scratch bytes a launch) of the card."""
    prop = torch.cuda.get_device_properties(dev)
    return (prop.multi_processor_count,
            prop.total_memory // MU_BAND_SCRATCH_SHARE)


def _gap_penalties(open_: float, ext: float) -> Tuple[int, int]:
    """The penalties as integers in [-MAX_GAP, 0]; raises otherwise (the
    integer kernel has no other form of them)."""
    out = []
    for name, x in (("open", open_), ("ext", ext)):
        if float(x) != round(float(x)) or not -MAX_GAP <= float(x) <= 0:
            raise ValueError(f"mu_sw_scores: gap {name} {x} must be an "
                             f"integer in [-{MAX_GAP}, 0]")
        out.append(int(round(float(x))))
    return out[0], out[1]


# launch counts of the Mu filter's long variant (LB > MU_MAX_LB)
mu_sweep_long = kernels.variant("mu_sweep_long")


def sweep_takes(lb: int) -> bool:
    """Whether the float sweep takes LB columns (no long variant: it runs
    only in the engine's optional prepasses, which give longer chunks the
    exact score, ops/sw_align.sw_score_profiles)."""
    return lb <= SWEEP_MAX_LB


@kernels.counted
def mu_sw_scores(a: torch.Tensor, b: torch.Tensor, table: MuTable,
                 open_: float, ext: float,
                 stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Best local SW score [B] float32 (>= 0) for each pair of Mu letter
    rows a [B, LA], b [B, LB] (uint8, letter 36 = padding, trailing only)
    under ``table``; open_, ext integer penalties <= 0.  ``stats``: for
    the band kernel only, an int32 [band_stats_words(B)] buffer that the
    launch fills with its blocks in flight and each pair's SMs
    (ops/sw_align.py band_stats reads it); None in production."""
    io, ie = _gap_penalties(open_, ext)
    if a.device.type == "cpu":
        return mu_sw_scores_ref(a, b, table.mumx, open_, ext)
    if a.dtype != torch.uint8 or b.dtype != torch.uint8:
        raise TypeError("mu_sw_scores: letters must be uint8")
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"mu_sw_scores: bad shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if not (b.device == a.device == table.tab16.device):
        raise ValueError("mu_sw_scores: tensors on different devices")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("mu_sw_scores: tensors must be contiguous")
    bsz, la = a.shape
    lb = b.shape[1]
    if bsz == 0 or la == 0 or lb == 0:
        return torch.zeros(bsz, dtype=torch.float32, device=a.device)
    out = torch.empty(bsz, dtype=torch.float32, device=a.device)
    bits = mu_lane_bits(la, lb, table.smax, table.smin, io, ie)
    tab = (kernels.ptr(a), kernels.ptr(b), kernels.ptr(table.tab16),
           kernels.ptr(out))
    if mu_uses_global(lb):
        sms, budget = _card(a.device)
        step = mu_band_pairs(bsz, la, lb, budget)
        if stats is not None:
            if (stats.dtype != torch.int32 or stats.device != a.device
                    or stats.numel() != band_stats_words(bsz)):
                raise ValueError("mu_sw_scores: stats must be int32 "
                                 f"[{band_stats_words(bsz)}] on {a.device}")
            if step < bsz:
                raise ValueError("mu_sw_scores: stats of a batch that "
                                 "takes more than one launch")
            stats.zero_()
        # batches of step pairs, so that their boundaries fit the budget
        for k in range(0, bsz, step):
            n = min(step, bsz - k)
            r = mu_band_rows(n, la, sms)
            bnd, ticket = mu_band_scratch(out[k:k + n], n, la, lb, r)
            kernels.launch(mu_sweep_long, "mu_wavefront_long", a,
                           kernels.ptr(a[k:k + n]), kernels.ptr(b[k:k + n]),
                           tab[2], kernels.ptr(out[k:k + n]),
                           kernels.ptr(bnd), kernels.ptr(ticket),
                           None if stats is None else kernels.ptr(stats), n,
                           la, lb, io, ie, r)
        return out
    r = mu_rows_per_lane(la)
    groups = -(-bsz // (2 if bits == 16 else 1))
    # the boundary rows between passes of 32 R rows, two alternating
    bnd = (torch.empty((groups, 2, 3, lb), dtype=torch.int32,
                       device=a.device) if la > 32 * r else out)
    kernels.launch(mu_sw_scores, "mu_wavefront", a, *tab, kernels.ptr(bnd),
                   bsz, la, lb, io, ie, bits, r)
    return out


def sweep_layout(lb: int) -> Tuple[int, int]:
    """(V columns a lane, warps a pair) of the float sweep at LB columns:
    one warp a pair up to 512 columns, V the smallest power of two with
    32 V >= LB; then V = 8 over LB / 256 warps up to 4,096 columns, V = 16
    over LB / 512 warps above.  (On an H100 one warp a pair was the
    fastest up to 512 columns, and four warps of 8 columns the fastest at
    34 x 1,024 x 1,024: PERF.md §6.)"""
    if not 1 <= lb <= SWEEP_MAX_LB:
        raise ValueError(f"sw_score_sweep: LB {lb} outside "
                         f"[1, {SWEEP_MAX_LB}]")
    if lb > 4096:
        return SWEEP_MAX_V, -(-lb // (32 * SWEEP_MAX_V))
    if lb > 512:
        return 8, -(-lb // 256)
    v = 1
    while 32 * v < lb:
        v *= 2
    return v, 1


@kernels.counted
def sw_score_sweep(prof: torch.Tensor, prof_b: torch.Tensor,
                   ia: torch.Tensor, ib: torch.Tensor, table: FeatureTable,
                   la: int, lb: int, open_: float,
                   ext: float) -> torch.Tensor:
    """Float row sweep: pairs (prof[ia], prof_b[ib]) of profiles [N, F, L]
    uint8 (PAD_BYTE past a chain's end; prof_b of prof's shape), DP shape
    [la, lb] -> best local score [B] float32 (>= 0), bit-equal to
    ``sw_score_sweep_profiles_ref``."""
    if prof.device.type == "cpu":
        return sw_score_sweep_profiles_ref(prof, prof_b, ia, ib, table, la,
                                           lb, open_, ext)
    check_pairs(prof, ia, ib, table, la, lb, open_, ext)
    check_b_side(prof, prof_b, "sw_score_sweep")
    if (max(table.sizes) > SWEEP_MAX_LETTERS
            or sum(n + 1 for n in table.sizes) > SWEEP_MAX_SLOTS):
        raise ValueError(f"sw_score_sweep: alphabets above "
                         f"{SWEEP_MAX_LETTERS} letters or "
                         f"{SWEEP_MAX_SLOTS} table rows")
    v, nw = sweep_layout(lb)
    b = int(ia.shape[0])
    best = torch.empty(b, dtype=torch.float32, device=prof.device)
    if b == 0:
        return best
    sizes = (ctypes.c_int * len(table.sizes))(*table.sizes)
    kernels.launch(
        sw_score_sweep, "sw_score_sweep", prof, kernels.ptr(prof),
        kernels.ptr(prof_b), kernels.ptr(ia), kernels.ptr(ib),
        kernels.ptr(table.blocks), table.blocks.numel(), sizes,
        len(table.sizes), prof.shape[2], b, la, lb, v, nw, float(open_),
        float(ext), kernels.ptr(best))
    return best


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


def sw_score_sweep_profiles_ref(prof: torch.Tensor, prof_b: torch.Tensor,
                                ia: torch.Tensor, ib: torch.Tensor,
                                table: FeatureTable, la: int, lb: int,
                                open_: float, ext: float) -> torch.Tensor:
    """Plain version of sw_score_sweep: the gather-sum substitution tensor
    (profile_smx), then the row sweep over it."""
    ca = profile_codes(prof[ia, :, :la], table.offsets, table.pad_code)
    cb = profile_codes(prof_b[ib, :, :lb], table.offsets, table.pad_code)
    return sw_score_sweep_ref(profile_smx(ca, cb, table.w), open_, ext)


def sw_score_sweep_ref(s: torch.Tensor, open_: float,
                       ext: float) -> torch.Tensor:
    """The row sweep over the rows of a substitution tensor s [B, LA, LB]
    float32 (NEG at padding): JAX's sw_score_sweep."""
    bsz, la, lb = s.shape
    if la == 0 or lb == 0:
        return torch.zeros(bsz, dtype=torch.float32, device=s.device)
    return _sweep_ref(lambda i: s[:, i, :], la, bsz, lb, open_, ext,
                      s.device)
