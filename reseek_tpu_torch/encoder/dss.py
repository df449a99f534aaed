"""DSS encoder: per-residue discrete structure-state features from C-alpha
geometry, numerically faithful to the reference (src/dss.cpp, src/myss.cpp,
src/getss.cpp, src/valuetoint.cpp).

This is the exact (bit-parity) host encoder, vectorized with numpy.  Distance
math is float32 (the reference's PDBChain::GetDist), feature accumulation is
float64 (the reference uses double), windowed sums use cumulative sums so the
sequential left-to-right addition order of the C++ loops is preserved exactly.

All windowed features only look at |i-j| <= 100, so geometry is represented
as a banded distance matrix [L, 201] instead of the full [L, L].
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np

from reseek_tpu_torch.chain import Chain
from reseek_tpu_torch.constants import (ALPHA_SIZES, AMINO_ALPHABET, DSSParams,
                                  WILDCARD)
from reseek_tpu_torch.data.tables import BIN_THRESHOLDS, CONF_PAIRS, get_tables

# DSS window parameters (src/dss.h:25-38)
DENSITY_W, DENSITY_w = 50, 3
SSDENSITY_W, SSDENSITY_w = 50, 8
DENSITY_RADIUS = 20.0
NU_ND_RADIUS = 20.0
NEN_W, NEN_w = 100, 12
NUDX_W = 50
DEFAULT_NENDIST = 10.0
SSDENSITY_EPS = 1.0
SSE_MIN_LENGTH = 8
SSE_MARGIN = 8
PM_DELTA = 8

BAND_W = 100  # max |offset| any feature needs

_UNDEF = -1  # index sentinel for "no neighbor" (reference UINT_MAX)

_AA_LETTER = np.full(256, 255, np.uint8)
for _i, _c in enumerate(AMINO_ALPHABET):
    _AA_LETTER[ord(_c)] = _i
    _AA_LETTER[ord(_c.lower())] = _i

# SS char codes used internally: h=0, s=1, t=2, ~=3
_SS_CHARS = np.frombuffer(b"hst~", np.uint8)


def _seq_to_aa_letters(seq: str) -> np.ndarray:
    return _AA_LETTER[np.frombuffer(seq.encode("latin-1"), np.uint8)]


def _banded_distances(coords: np.ndarray, W: int) -> np.ndarray:
    """dist(i, i+o) as float32 [L, 2W+1]; +inf where i+o out of range.

    Column k corresponds to offset o = k - W; float32 arithmetic matches
    PDBChain::GetDist (src/pdbchain.cpp:310, src/abcxyz.h:116-126).
    """
    L = coords.shape[0]
    out = np.full((L, 2 * W + 1), np.inf, np.float32)
    out[:, W] = 0.0
    for o in range(1, W + 1):  # fill positive offsets, then mirror
        if o >= L:
            break
        d = coords[o:] - coords[:-o]
        # explicit left-associative f32: (dx*dx + dy*dy) + dz*dz
        d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        v = np.sqrt(d2)
        out[: L - o, W + o] = v
        out[o:, W - o] = v
    return out


def _seq_sum(terms: np.ndarray) -> np.ndarray:
    """Sequential (left-to-right) float64 row sums via cumsum.

    Zero entries are exact no-ops under IEEE addition, so masking with 0
    preserves the C++ loop's accumulation order and rounding.
    """
    return np.cumsum(terms, axis=1, dtype=np.float64)[:, -1]


@dataclasses.dataclass
class DSSEncoding:
    """All computed per-residue features for one chain."""

    chain: Chain
    features: Dict[str, np.ndarray]  # name -> uint8 [L] feature letters
    nen: np.ndarray                  # int32 [L], -1 = undefined
    ren: np.ndarray
    ss: np.ndarray                   # uint8 [L]: h=0 s=1 t=2 ~=3

    @property
    def mu_letters(self) -> np.ndarray:
        """uint8 [L] Mu letters (undefined -> 0, src/dss.cpp:700-714)."""
        return self.features["Mu"]

    def profile(self, params: DSSParams) -> np.ndarray:
        """uint8 [F, L] integer profile in params feature order
        (src/dss.cpp:716-741)."""
        return np.stack([self.features[f] for f in params.features])

    @property
    def ss_string(self) -> str:
        return "".join("hst~"[v] for v in self.ss)


def mu_kmers(mu_letters: np.ndarray, pattern: str = "111") -> np.ndarray:
    """Spaced-seed k-mers over Mu letters (src/dss.cpp:659-682).

    Kmer at pos p = sum over pattern '1' positions j of letter[p+j], base-36,
    most-significant first.  Returns int64 [max(L-len(pattern)+1, 0)].
    """
    L = len(mu_letters)
    n = len(pattern)
    if L < n:
        return np.zeros(0, np.int64)
    lets = mu_letters.astype(np.int64)
    kmers = np.zeros(L - n + 1, np.int64)
    for j, c in enumerate(pattern):
        if c == "1":
            kmers = kmers * 36 + lets[j: L - n + 1 + j]
    return kmers


def compute_ss(coords: np.ndarray, dband: np.ndarray) -> np.ndarray:
    """TM-align-style secondary structure (src/getss.cpp:6-60).
    Returns uint8 [L] with h=0 s=1 t=2 ~=3."""
    L = coords.shape[0]
    ss = np.full(L, 3, np.uint8)  # '~'
    if L < 5:
        return ss
    W = BAND_W
    p = np.arange(2, L - 2)
    d13 = dband[p - 2, W + 2].astype(np.float64)
    d14 = dband[p - 2, W + 3].astype(np.float64)
    d15 = dband[p - 2, W + 4].astype(np.float64)
    d24 = dband[p - 1, W + 2].astype(np.float64)
    d25 = dband[p - 1, W + 3].astype(np.float64)
    d35 = dband[p, W + 2].astype(np.float64)

    DH, DS = 2.1, 1.42
    helix = ((np.abs(d15 - 6.37) < DH) & (np.abs(d14 - 5.18) < DH)
             & (np.abs(d25 - 5.18) < DH) & (np.abs(d13 - 5.45) < DH)
             & (np.abs(d24 - 5.45) < DH) & (np.abs(d35 - 5.45) < DH))
    strand = ((np.abs(d15 - 13) < DS) & (np.abs(d14 - 10.4) < DS)
              & (np.abs(d25 - 10.4) < DS) & (np.abs(d13 - 6.1) < DS)
              & (np.abs(d24 - 6.1) < DS) & (np.abs(d35 - 6.1) < DS))
    turn = d15 < 8.2
    mid = np.where(helix, 0, np.where(strand, 1, np.where(turn, 2, 3)))
    ss[2: L - 2] = mid.astype(np.uint8)
    return ss


def compute_nen_ren(dband: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Nearest-in-space neighbor (NEN) and opposite-side neighbor (REN)
    among residues with 12 < |i-j| <= 100 (src/dss.cpp:374-470)."""
    L = dband.shape[0]
    W = BAND_W
    offs = np.arange(-W, W + 1)
    valid = np.abs(offs) > NEN_w  # exclude |delta| <= 12

    d = np.where(valid[None, :], dband, np.inf)
    k = np.argmin(d, axis=1)  # first minimum = smallest offset = reference scan
    minv = d[np.arange(L), k]
    nen = np.where(minv < 999.0, np.arange(L) + (k - W), _UNDEF)

    # REN: search only the side of i opposite to... actually the side
    # NOT containing NEN: NEN > i -> search [i-100, i-1], else [i+1, i+100]
    # (src/dss.cpp:374-415); the |delta|<=12 exclusion also applies.
    nen_right = nen > np.arange(L)
    side_valid = np.where(nen_right[:, None], offs[None, :] < 0,
                          offs[None, :] > 0)
    d2 = np.where(side_valid & valid[None, :], dband, np.inf)
    k2 = np.argmin(d2, axis=1)
    minv2 = d2[np.arange(L), k2]
    ren = np.where((nen != _UNDEF) & (minv2 < 999.0),
                   np.arange(L) + (k2 - W), _UNDEF)
    return nen.astype(np.int32), ren.astype(np.int32)


def compute_density(dband: np.ndarray) -> np.ndarray:
    """Raw contact density: sum exp(-d/20) over |o|<=50, |o|>3
    (src/dss.cpp:217-244).  Ends (pos 0, L-1) = +inf (reference DBL_MAX)."""
    L = dband.shape[0]
    W = BAND_W
    offs = np.arange(-W, W + 1)
    sel = (np.abs(offs) <= DENSITY_W) & (np.abs(offs) > DENSITY_w)
    dsub = dband[:, sel].astype(np.float64)
    terms = np.where(np.isfinite(dsub), np.exp(-dsub / DENSITY_RADIUS), 0.0)
    dens = _seq_sum(terms)
    dens[0] = np.inf
    if L > 1:
        dens[-1] = np.inf
    return dens


def scale_density(dens: np.ndarray) -> np.ndarray:
    """Per-chain min-max scaling of defined values (src/dss.cpp:179-215)."""
    fin = np.isfinite(dens)
    if not fin.any():
        return dens.copy()
    mn = dens[fin].min()
    mx = dens[fin].max()
    rng = mx - mn
    if rng < 1:
        rng = 1.0
    out = np.where(fin, (dens - mn) / rng, np.inf)
    return out


def compute_ss_density(dband: np.ndarray, ss: np.ndarray,
                       ss_code: int) -> np.ndarray:
    """Class-conditional density ratio Dc/(D+1) over |o|<=50, |o|>8
    (src/dss.cpp:339-372).  Ends = +inf."""
    L = dband.shape[0]
    W = BAND_W
    offs = np.arange(-W, W + 1)
    sel = (np.abs(offs) <= SSDENSITY_W) & (np.abs(offs) > SSDENSITY_w)
    dsub = dband[:, sel].astype(np.float64)
    fin = np.isfinite(dsub)
    terms = np.where(fin, np.exp(-dsub / DENSITY_RADIUS), 0.0)

    # ss letter of the neighbor at each selected offset
    sel_offs = offs[sel]
    idx = np.arange(L)[:, None] + sel_offs[None, :]
    idx_c = np.clip(idx, 0, L - 1)
    same = (ss[idx_c] == ss_code) & fin
    d_all = _seq_sum(terms)
    d_same = _seq_sum(np.where(same, terms, 0.0))
    r = d_same / (d_all + SSDENSITY_EPS)
    r[0] = np.inf
    if L > 1:
        r[-1] = np.inf
    return r


def compute_nx(coords: np.ndarray, dband: np.ndarray) -> np.ndarray:
    """NX = NU + ND: up/down half-space weighted neighbor counts
    (src/dss.cpp:246-325).  Ends = +inf."""
    L = coords.shape[0]
    if L < 3:
        return np.full(L, np.inf)
    W = BAND_W
    c64 = coords.astype(np.float64)
    # VecPAB = normalize((CA-prev) + (CA-next)), double (src/dss.cpp:259-274)
    pab = np.zeros_like(c64)
    pab[1:-1] = (c64[1:-1] - c64[:-2]) + (c64[1:-1] - c64[2:])
    norm = np.sqrt(np.einsum("ij,ij->i", pab, pab))
    with np.errstate(invalid="ignore", divide="ignore"):
        pab = pab / np.where(norm > 0, norm, 1.0)[:, None]

    offs = np.arange(-W, W + 1)
    sel = (np.abs(offs) <= NUDX_W) & (np.abs(offs) > 3)
    sel_offs = offs[sel]
    dsub = dband[:, sel].astype(np.float64)
    fin = np.isfinite(dsub)
    factors = np.where(fin, np.exp(-dsub / NU_ND_RADIUS), 0.0)

    idx = np.arange(L)[:, None] + sel_offs[None, :]
    idx_c = np.clip(idx, 0, L - 1)
    vec12 = c64[idx_c] - c64[:, None, :]  # [L, S, 3]
    dot = np.einsum("lsk,lk->ls", vec12, pab)
    mod12 = np.sqrt(np.einsum("lsk,lsk->ls", vec12, vec12))
    modp = np.sqrt(np.einsum("lk,lk->l", pab, pab))
    modprod = modp[:, None] * mod12
    with np.errstate(invalid="ignore", divide="ignore"):
        cos_t = np.clip(dot / np.where(modprod != 0, modprod, 1.0), -1.0, 1.0)
    theta = np.arccos(cos_t)
    deg = np.degrees(theta)
    # GetTheta3D: |mod_i*mod_j| < 1e-6 -> theta 0 (src/abcxyz.h:210-211)
    up = (np.abs(modprod) < 1e-6) | (deg < 90.0)
    nu = _seq_sum(np.where(up & fin, factors, 0.0))
    nd = _seq_sum(np.where((~up) & fin, factors, 0.0))
    nx = nu + nd
    nx[0] = np.inf
    nx[-1] = np.inf
    return nx


def compute_conf(dband: np.ndarray) -> np.ndarray:
    """Conf letter: nearest of 16 k-means centroids over 9 intra-window CA
    distances; positions within 3 of either end are WILDCARD
    (src/myss.cpp:127-170)."""
    L = dband.shape[0]
    W = BAND_W
    conf = np.full(L, WILDCARD, np.uint8)
    if L < 7:
        return conf
    p = np.arange(3, L - 3)
    v = np.empty((len(p), 9), np.float64)
    for m, (i, j) in enumerate(CONF_PAIRS):
        v[:, m] = dband[p + i, W + (j - i)]
    cent = get_tables().conf_centroids  # [16, 9] float64
    diff = v[:, None, :] - cent[None, :, :]
    d2 = np.einsum("pkm,pkm->pk", diff, diff)
    # sqrt is monotonic; argmin keeps first min like the k==0-init scan
    conf[3: L - 3] = np.argmin(d2, axis=1).astype(np.uint8)
    return conf


def compute_sse_mids(ss: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """SSE runs of h/s with length >= 8; returns (mids, is_helix)
    (src/dss.cpp:78-155)."""
    L = len(ss)
    mids: List[int] = []
    chars: List[bool] = []
    if L == 0:
        return np.zeros(0, np.int64), np.zeros(0, bool)
    boundaries = np.flatnonzero(np.diff(ss)) + 1
    starts = np.concatenate(([0], boundaries))
    ends = np.concatenate((boundaries, [L]))
    for s, e in zip(starts, ends):
        run_len = e - s
        c = ss[s]
        if run_len >= SSE_MIN_LENGTH and c in (0, 1):  # h or s
            mids.append(s + run_len // 2)
            chars.append(c == 0)
    return np.asarray(mids, np.int64), np.asarray(chars, bool)


def _dist_pairs(coords: np.ndarray, i: np.ndarray, j: np.ndarray
                ) -> np.ndarray:
    """float32 distances for arbitrary index pairs."""
    d = coords[i] - coords[j]
    d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    return np.sqrt(d2)


def compute_dst_nxt_hlx(coords: np.ndarray, mids: np.ndarray,
                        is_helix: np.ndarray) -> np.ndarray:
    """Distance to mid of next helix SSE with mid > pos+8, else 0
    (src/dss.cpp:866-881)."""
    L = coords.shape[0]
    out = np.zeros(L, np.float64)
    h_mids = mids[is_helix]
    if len(h_mids) == 0:
        return out
    pos = np.arange(L)
    # first helix mid with mid > pos + margin  <=>  mid >= pos + margin + 1
    idx = np.searchsorted(h_mids, pos + SSE_MARGIN, side="right")
    has = idx < len(h_mids)
    tgt = h_mids[np.where(has, idx, 0)]
    d = _dist_pairs(coords, pos, tgt).astype(np.float64)
    out[has] = d[has]
    return out


def compute_dst_prv_hlx(coords: np.ndarray, mids: np.ndarray,
                        is_helix: np.ndarray) -> np.ndarray:
    """Distance to a previous helix mid — reproduces the reference's
    index-mirrored candidate test exactly (src/dss.cpp:849-864: the character
    check uses cs[N-1-i] while the mid uses Mids[i])."""
    L = coords.shape[0]
    out = np.zeros(L, np.float64)
    n = len(mids)
    if n == 0:
        return out
    cand = np.flatnonzero(is_helix[::-1])  # i such that cs[N-1-i] == 'h'
    if len(cand) == 0:
        return out
    pos = np.arange(L)
    # scan candidates in ascending i; mids ascending, so the first candidate
    # whose mid satisfies mid + 8 < pos wins, and smaller i = smaller mid:
    # the first (smallest-mid) candidate decides if any does... except that a
    # later candidate could satisfy when the first doesn't only if its mid is
    # smaller — impossible.  So: take the smallest-mid candidate.
    first_mid = mids[cand[0]]
    ok = first_mid + SSE_MARGIN < pos
    d = _dist_pairs(coords, pos, np.full(L, first_mid)).astype(np.float64)
    out[ok] = d[ok]
    return out


def _bin(feature: str, values: np.ndarray) -> np.ndarray:
    ts = np.asarray(BIN_THRESHOLDS[feature], np.float64)
    return np.searchsorted(ts, values, side="right").astype(np.uint8)


_SS3_MAP = np.array([0, 1, 2, 2], np.uint8)   # h s t ~  -> 3-letter
_AA3 = np.full(256, WILDCARD, np.uint8)
_AA4 = np.full(256, WILDCARD, np.uint8)
for _c in "G":
    _AA3[ord(_c)] = 0
    _AA4[ord(_c)] = 0
for _c in "ADEHKNPQRST":
    _AA3[ord(_c)] = 1
for _c in "CFILMVWY":
    _AA3[ord(_c)] = 2
    _AA4[ord(_c)] = 2
for _c in "AHPST":
    _AA4[ord(_c)] = 1
for _c in "DEKNQR":
    _AA4[ord(_c)] = 3


def encode_chain(chain: Chain, use_native: bool = True) -> DSSEncoding:
    """Compute all DSS features for one chain.

    Uses the native C++ encoder (native/dss_encoder.cpp, ~10x faster,
    verified bit-identical) when available; the numpy path below is the
    reference implementation and fallback."""
    if use_native:
        from reseek_tpu_torch.encoder import native
        feats = native.encode_features(chain)
        if feats is not None:
            L = len(chain)
            return DSSEncoding(chain=chain, features=feats,
                               nen=np.full(L, -1, np.int32),
                               ren=np.full(L, -1, np.int32),
                               ss=feats["SS"])
    return _encode_chain_numpy(chain)


def _encode_chain_numpy(chain: Chain) -> DSSEncoding:
    """Reference numpy encoder (exact)."""
    L = len(chain)
    coords = chain.coords
    dband = _banded_distances(coords, BAND_W)
    W = BAND_W
    pos = np.arange(L)

    ss = compute_ss(coords, dband)
    nen, ren = compute_nen_ren(dband)
    conf = compute_conf(dband)

    feats: Dict[str, np.ndarray] = {}

    aa = _seq_to_aa_letters(chain.seq)
    feats["AA"] = np.where(aa >= 20, WILDCARD, aa).astype(np.uint8)
    seq_bytes = np.frombuffer(chain.seq.encode("latin-1"), np.uint8)
    feats["AA3"] = _AA3[seq_bytes]
    feats["AA4"] = _AA4[seq_bytes]

    feats["SS"] = ss
    feats["SS3"] = _SS3_MAP[ss]
    feats["Conf"] = conf

    def neighbor_feature(nbr: np.ndarray, values: np.ndarray,
                         undef_val: int) -> np.ndarray:
        safe = np.where(nbr >= 0, nbr, 0)
        v = values[safe]
        return np.where(nbr >= 0, v, undef_val).astype(np.uint8)

    feats["NENSS"] = neighbor_feature(nen, ss, 3)      # undefined -> '~'
    feats["RENSS"] = neighbor_feature(ren, ss, 3)
    feats["NENSS3"] = neighbor_feature(nen, _SS3_MAP[ss], WILDCARD)
    feats["RENSS3"] = neighbor_feature(ren, _SS3_MAP[ss], WILDCARD)
    feats["NENConf"] = neighbor_feature(nen, conf, WILDCARD)
    feats["RENConf"] = neighbor_feature(ren, conf, WILDCARD)

    # NENDist / RENDist: distance to neighbor, 10.0 default
    def nbr_dist(nbr: np.ndarray) -> np.ndarray:
        safe = np.where(nbr >= 0, nbr, 0)
        off = np.clip(safe - pos, -W, W)
        d = dband[pos, W + off].astype(np.float64)
        return np.where(nbr >= 0, d, DEFAULT_NENDIST)

    nendist = nbr_dist(nen)
    rendist = nbr_dist(ren)
    feats["NENDist"] = _bin("NENDist", nendist)
    feats["RENDist"] = _bin("RENDist", rendist)
    feats["NENDist4"] = (feats["NENDist"] // 4).astype(np.uint8)
    feats["RENDist4"] = (feats["RENDist"] // 4).astype(np.uint8)

    dens = scale_density(compute_density(dband))
    feats["NormDens"] = _bin("NormDens", dens)
    feats["NormDens4"] = (feats["NormDens"] // 4).astype(np.uint8)

    feats["HelixDens"] = _bin("HelixDens", compute_ss_density(dband, ss, 0))
    feats["StrandDens"] = _bin("StrandDens", compute_ss_density(dband, ss, 1))

    mids, is_helix = compute_sse_mids(ss)
    feats["DstNxtHlx"] = _bin("DstNxtHlx",
                              compute_dst_nxt_hlx(coords, mids, is_helix))
    feats["DstPrvHlx"] = _bin("DstPrvHlx",
                              compute_dst_prv_hlx(coords, mids, is_helix))

    feats["NX"] = _bin("NX", compute_nx(coords, dband))

    if L >= 8:
        p1 = np.maximum(pos - PM_DELTA, 0)
        p2 = np.minimum(pos + PM_DELTA, L - 1)
        pmd = _dist_pairs(coords, p1, p2).astype(np.float64)
    else:
        pmd = np.zeros(L, np.float64)
    feats["PMDist"] = _bin("PMDist", pmd)

    # Mu: little-endian mixed radix over (SS3, NENSS3, RENDist4)
    # (src/dss.cpp:629-644)
    feats["Mu"] = (feats["SS3"] + 3 * feats["NENSS3"]
                   + 9 * feats["RENDist4"]).astype(np.uint8)

    return DSSEncoding(chain=chain, features=feats, nen=nen, ren=ren, ss=ss)


def float_feature_values(chain: Chain, feature: str) -> np.ndarray:
    """Raw (pre-binning) float feature values per position, double
    precision; undefined = +inf (the reference's DBL_MAX from
    DSS::GetFloatFeature, src/dss.cpp:825-838).  Used by the
    float-feature-bins training command."""
    L = len(chain)
    coords = chain.coords
    dband = _banded_distances(coords, BAND_W)
    pos = np.arange(L)
    W = BAND_W
    if feature == "NormDens":
        return scale_density(compute_density(dband))
    if feature in ("HelixDens", "StrandDens"):
        ss = compute_ss(coords, dband)
        return compute_ss_density(dband, ss,
                                  0 if feature == "HelixDens" else 1)
    if feature == "NX":
        return compute_nx(coords, dband)
    if feature in ("NENDist", "RENDist"):
        nen, ren = compute_nen_ren(dband)
        nbr = nen if feature == "NENDist" else ren
        safe = np.where(nbr >= 0, nbr, 0)
        off = np.clip(safe - pos, -W, W)
        d = dband[pos, W + off].astype(np.float64)
        return np.where(nbr >= 0, d, DEFAULT_NENDIST)
    if feature in ("DstNxtHlx", "DstPrvHlx"):
        ss = compute_ss(coords, dband)
        mids, is_helix = compute_sse_mids(ss)
        f = (compute_dst_nxt_hlx if feature == "DstNxtHlx"
             else compute_dst_prv_hlx)
        return f(coords, mids, is_helix)
    if feature == "PMDist":
        if L >= 8:
            p1 = np.maximum(pos - PM_DELTA, 0)
            p2 = np.minimum(pos + PM_DELTA, L - 1)
            return _dist_pairs(coords, p1, p2).astype(np.float64)
        return np.zeros(L, np.float64)
    raise ValueError(f"not a float feature: {feature}")


def feature_string(enc: DSSEncoding, feature: str) -> str:
    """Feature letters as chars, like -feature_fasta output
    (src/pdbchain.cpp:70-125: 0-25 -> A-Z, 26-35 -> a-j)."""
    vals = enc.features[feature]
    out = []
    for v in vals:
        out.append(chr(ord("A") + v) if v < 26 else chr(ord("a") + v - 26))
    return "".join(out)
