"""Post-alignment ops of stage 3, counterpart of
reseek_tpu/ops/postalign_jax.py: the batched traceback walk and batched
LDDT.  On CUDA tensors each launches its kernel (csrc/postalign.cu); on
CPU tensors each runs its plain version, defined beside it.  LDDT past
MAX_LDDT_COLS columns (``lddt_uses_global``) launches the kernel's long
variant, counted apart on ``lddt_long``: the column-pair tiles of all the
launch's pairs dealt over ``lddt_long_blocks`` blocks, the columns and
their counts in device memory."""

from __future__ import annotations

import functools

import numpy as np
import torch

from reseek_tpu_torch import kernels
from reseek_tpu_torch.ops.sw_align import tb_shape, unpack_tb
from reseek_tpu_torch.ops.sw_wavefront import diag_count

# path codes
PM, PD, PI, PEND = 1, 2, 3, 0

R0_SQ = np.float32(225.0)
THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
MAX_LDDT_COLS = 7680     # shared-memory bound of the kernel (29 B/column)
MAX_LDDT_LONG_COLS = 1 << 20   # the long variant's int32 tile index
# launch counts of the long variant (M > MAX_LDDT_COLS)
lddt_long = kernels.variant("lddt_long")


def lddt_uses_global(m: int) -> bool:
    """Whether lddt_batch at M columns takes the kernel's long variant
    (coordinates and per-column counts in device memory)."""
    return m > MAX_LDDT_COLS
LDDT_WARPS = 8           # warps of a block of the kernel
MAX_CLUSTER = 8          # blocks of a thread-block cluster (portable limit)
LONG_TILE = 128          # the long variant's tiles: 128 x 128 column pairs
LONG_BLOCKS_PER_SM = 4   # the long variant's blocks an SM, at most


def lddt_cluster(b: int, m: int, sms: int) -> int:
    """Blocks per pair (a thread-block cluster): doubled from 1 while the
    launch has fewer than 4 blocks an SM, up to MAX_CLUSTER, as long as
    every warp of the cluster still gets two tiles of the triangle."""
    nt = -(-m // 32)
    tiles = nt * (nt + 1) // 2
    c = 1
    while (c < MAX_CLUSTER and b * c < 4 * sms
           and 2 * 2 * c * LDDT_WARPS <= tiles):
        c *= 2
    return c


def lddt_long_blocks(b: int, m: int, sms: int) -> int:
    """Blocks of the long variant's first launch on b pairs of m columns:
    one a LDDT_WARPS tiles of LONG_TILE x LONG_TILE column pairs (the
    warps take the tiles of every pair from one ticket), at most
    LONG_BLOCKS_PER_SM an SM, so that the card fills at any b."""
    nt = -(-m // LONG_TILE)
    tiles = b * nt * (nt + 1) // 2
    return max(1, min(-(-tiles // LDDT_WARPS), LONG_BLOCKS_PER_SM * sms))


@functools.lru_cache(maxsize=8)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _cuda_inputs(name: str, *ts: torch.Tensor) -> None:
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


@kernels.counted
def walk_traceback_batch(tb: torch.Tensor, best: torch.Tensor,
                         bi: torch.Tensor, bj: torch.Tensor, la: int):
    """Backward walk from the best cells (bi, bj) over the packed
    traceback of a [la, LB] DP shape (ops/sw_align.py; src/sw.cpp:8-77
    semantics).  Returns (lo_a [B], lo_b [B], plen [B] int32, path_rev
    [B, Dp+1] uint8) with path_rev holding PM/PD/PI codes backward from the
    alignment end, then PEND; Dp = diag_count(la, LB)."""
    if tb.device.type == "cpu":
        return walk_traceback_batch_ref(tb, best, bi, bj, la)
    if tb.dtype != torch.uint8 or tb.dim() != 5:
        raise TypeError("walk_traceback_batch: tb must be the packed uint8 "
                        "traceback [B, tiles, LB+31, 32, R/2]")
    if (best.dtype != torch.float32 or bi.dtype != torch.int32
            or bj.dtype != torch.int32):
        raise TypeError("walk_traceback_batch: best f32, bi/bj int32")
    b, lb = tb.shape[0], tb.shape[2] - 31
    if tb.shape != tb_shape(b, la, lb):
        raise ValueError(f"walk_traceback_batch: tb {tuple(tb.shape)} is not "
                         f"the layout of a {(la, lb)} shape")
    if not (best.shape == bi.shape == bj.shape == (b,)):
        raise ValueError("walk_traceback_batch: best/bi/bj must be [B]")
    _cuda_inputs("walk_traceback_batch", tb, best, bi, bj)
    if tb.data_ptr() % 16:
        raise ValueError("walk_traceback_batch: tb must be 16-byte aligned")
    dp = diag_count(la, lb)
    dev = tb.device
    lo_a = torch.empty(b, dtype=torch.int32, device=dev)
    lo_b = torch.empty(b, dtype=torch.int32, device=dev)
    plen = torch.empty(b, dtype=torch.int32, device=dev)
    path_rev = torch.empty((b, dp + 1), dtype=torch.uint8, device=dev)
    if b == 0:
        return lo_a, lo_b, plen, path_rev
    kernels.launch(
        walk_traceback_batch, "walk_traceback", tb, kernels.ptr(tb),
        kernels.ptr(best), kernels.ptr(bi), kernels.ptr(bj),
        kernels.ptr(lo_a), kernels.ptr(lo_b), kernels.ptr(plen),
        kernels.ptr(path_rev), b, la, lb, dp, 2 * tb.shape[4])
    return lo_a, lo_b, plen, path_rev


def walk_traceback_batch_ref(tb: torch.Tensor, best: torch.Tensor,
                             bi: torch.Tensor, bj: torch.Tensor, la: int):
    """Plain version: the packed traceback unpacked to the skewed bytes
    [Dp, B, LA] (0 outside the band), then the masked step of
    postalign_jax's scan over them, Dp+1 steps (stopping early once every
    pair is done: later steps only emit PEND)."""
    tb = unpack_tb(tb, la, tb.shape[2] - 31)
    dp, b, la = tb.shape
    dev = tb.device
    steps = dp + 1
    rows = torch.arange(b, device=dev)

    def at(i, j):
        # tb[i + j, :, i] per pair, clamped
        return tb[(i + j).clamp(0, dp - 1), rows, i.clamp(0, la - 1)].long()

    i = bi.long() + 1
    j = bj.long() + 1
    st = torch.zeros(b, dtype=torch.long, device=dev)
    done = best <= 0
    codes = torch.zeros((steps, b), dtype=torch.uint8, device=dev)
    for t in range(steps):
        if bool(done.all()):
            break
        codes[t] = torch.where(done, PEND, st + 1).to(torch.uint8)
        t_m = at(i - 1, j - 1) & 3
        # MD bit of cell (i-1, j) and MI bit of cell (i, j-1) both live at
        # skew location [i+j, i]
        t_gap = at(i, j)
        is_m, is_d = st == 0, st == 1
        stop = is_m & (t_m == 3)
        nst = torch.where(
            is_m, torch.where(t_m == 3, 0, t_m),
            torch.where(is_d, torch.where((t_gap & 4) > 0, 0, 1),
                        torch.where((t_gap & 8) > 0, 0, 2)))
        move = ~done & ~stop
        ni = torch.where(move & (is_m | is_d), i - 1, i)
        nj = torch.where(move & (is_m | (st == 2)), j - 1, j)
        st = torch.where(done, st, nst)
        i, j = ni, nj
        done = done | stop
    path_rev = codes.t().contiguous()
    plen = (path_rev != PEND).sum(1).to(torch.int32)
    return (i - 1).to(torch.int32), (j - 1).to(torch.int32), plen, path_rev


@kernels.counted
def lddt_batch(cq: torch.Tensor, ct: torch.Tensor, valid: torch.Tensor,
               ncols: torch.Tensor, with_risky: bool = True,
               cluster: int = 0):
    """Batched LDDT_mu_fast (src/lddt.cpp:63-124) of aligned-column
    coordinates cq, ct [B, M, 3] float32 with column mask valid [B, M] bool
    and true column counts ncols [B] int32.  Returns lddt [B] float32 and,
    with_risky, a [B] bool flag for pairs where a threshold comparison
    (|d1-d2| within 3e-5 of 0.5/1/2/4) or the R0^2 gate (d^2 within 1e-3
    of 225) sits near its boundary: callers recompute those exactly on the
    host.  ``cluster`` sets the shared-memory kernel's blocks per pair
    (1-8; 0 takes ``lddt_cluster``'s); the long variant (M past
    MAX_LDDT_COLS) ignores it and runs on ``lddt_long_blocks``."""
    if cq.device.type == "cpu":
        return lddt_batch_ref(cq, ct, valid, ncols, with_risky)
    if cq.dtype != torch.float32 or ct.dtype != torch.float32:
        raise TypeError("lddt_batch: coordinates must be float32")
    if valid.dtype != torch.bool or ncols.dtype != torch.int32:
        raise TypeError("lddt_batch: valid bool, ncols int32")
    b, m, three = cq.shape
    if (three != 3 or ct.shape != cq.shape or valid.shape != (b, m)
            or ncols.shape != (b,)):
        raise ValueError("lddt_batch: bad shapes")
    if m > MAX_LDDT_LONG_COLS:
        raise ValueError(f"lddt_batch: M {m} > {MAX_LDDT_LONG_COLS}")
    if not 0 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"lddt_batch: cluster {cluster} not in 0..8")
    _cuda_inputs("lddt_batch", cq, ct, valid, ncols)
    dev = cq.device
    out = torch.empty(b, dtype=torch.float32, device=dev)
    risky = torch.zeros(b, dtype=torch.bool, device=dev)
    if b > 0:
        args = (kernels.ptr(cq), kernels.ptr(ct), kernels.ptr(valid),
                kernels.ptr(ncols), kernels.ptr(out), kernels.ptr(risky))
        if lddt_uses_global(m):
            # per column: preserved (low 32 bits) and considered counts;
            # the tiles' ticket, then each pair's risky flag
            counts = torch.zeros((b, m), dtype=torch.int64, device=dev)
            work = torch.zeros(1 + b, dtype=torch.int64, device=dev)
            kernels.launch(lddt_long, "lddt_long", cq, *args,
                           kernels.ptr(counts), kernels.ptr(work), b, m,
                           int(with_risky),
                           lddt_long_blocks(b, m, _sm_count(dev)))
        else:
            kernels.launch(lddt_batch, "lddt", cq, *args, b, m,
                           int(with_risky),
                           cluster or lddt_cluster(b, m, _sm_count(dev)))
    return (out, risky) if with_risky else out


def _dist2(c: torch.Tensor) -> torch.Tensor:
    """[B, M, 3] -> [B, M, M] squared distances, (dx*dx + dy*dy) + dz*dz
    with every product and sum rounded (no FMA)."""
    d = c[:, :, None, :] - c[:, None, :, :]
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return x * x + y * y + z * z


def lddt_batch_ref(cq: torch.Tensor, ct: torch.Tensor, valid: torch.Tensor,
                   ncols: torch.Tensor, with_risky: bool = True):
    """Plain version of postalign_jax.lddt_batch: column-pair counts over
    the [M, M] matrices, then the per-column scores added left to right in
    float32.  Columns past the last valid one score 0 and add nothing, so
    M is cut there; pairs go in chunks to bound the [B, M, M] temporaries."""
    b = cq.shape[0]
    dev = cq.device
    cols = valid.any(0).nonzero()
    m = int(cols[-1]) + 1 if len(cols) else 0
    out = torch.zeros(b, dtype=torch.float32, device=dev)
    risky = torch.zeros(b, dtype=torch.bool, device=dev)
    r0 = float(R0_SQ)
    upper = torch.ones((m, m), dtype=torch.bool, device=dev).triu(1)
    chunk = max(1, (1 << 21) // max(m * m, 1))
    for c0 in range(0, b, chunk):
        c1 = min(b, c0 + chunk)
        v = valid[c0:c1, :m]
        a1 = _dist2(cq[c0:c1, :m])
        a2 = _dist2(ct[c0:c1, :m])
        pair_valid = v[:, :, None] & v[:, None, :] & upper
        consider = ~((a1 > r0) & (a2 > r0)) & pair_valid
        dd = (a1.sqrt() - a2.sqrt()).abs()
        npres = sum((dd <= t).to(torch.int32) for t in THRESHOLDS)
        npres = torch.where(consider, npres, 0)
        cons4 = torch.where(consider, 4, 0)
        if with_risky:
            near_t = torch.zeros_like(consider)
            for t in THRESHOLDS:
                near_t |= (dd - t).abs() < 3e-5
            near_r0 = ((a1 - r0).abs() < 1e-3) | ((a2 - r0).abs() < 1e-3)
            anyp = (near_t & consider) | (near_r0 & pair_valid)
            risky[c0:c1] = anyp.flatten(1).any(1)
        preserved = npres.sum(2) + npres.sum(1)
        considered = cons4.sum(2) + cons4.sum(1)
        scores = torch.where(considered > 0,
                             preserved.float() / considered.float(), 0.0)
        scores = torch.where(v, scores, 0.0)
        total = torch.zeros(c1 - c0, dtype=torch.float32, device=dev)
        for k in range(m):      # sequential float32 sum, reference order
            total = total + scores[:, k]
        out[c0:c1] = total / ncols[c0:c1].clamp_min(1).float()
    return (out, risky) if with_risky else out
