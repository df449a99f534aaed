# Frozen copy of reseek_tpu_torch/constants.py (commit f533a72), the benchmark's plain
# reference: imports renamed, nothing else changed.
"""Search parameters and statistical-significance model.

Mirrors the reference's DSSParams defaults and mode presets
(reference: src/namedparams.cpp:32-53, src/dssparams.cpp:44-111) and the
fitted two-piece log-linear P-value model (src/statsig.cpp:27-50).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

# ---------------------------------------------------------------------------
# Feature registry.  Order matters: it is the FEATURE enum order of the
# reference (src/featurelist.h: AA first, then intfeatures.h, floatfeatures.h).
# ---------------------------------------------------------------------------

INT_FEATURES = [
    "SS", "SS3", "NENSS", "NENConf", "NENSS3", "Conf", "RENSS", "RENSS3",
    "RENConf", "NormDens4", "NENDist4", "RENDist4", "Mu", "AA3", "AA4",
]
FLOAT_FEATURES = [
    "NormDens", "NENDist", "HelixDens", "StrandDens", "DstNxtHlx",
    "DstPrvHlx", "NX", "RENDist", "PMDist",
]
ALL_FEATURES = ["AA"] + INT_FEATURES + FLOAT_FEATURES

# Alphabet sizes (src/dss.cpp:755-796)
ALPHA_SIZES = {
    "AA": 20,
    "SS": 4, "NENSS": 4, "RENSS": 4, "NormDens4": 4, "NENDist4": 4,
    "RENDist4": 4, "AA4": 4,
    "SS3": 3, "NENSS3": 3, "RENSS3": 3, "AA3": 3,
    "Conf": 16, "NENConf": 16, "RENConf": 16, "NormDens": 16, "NENDist": 16,
    "RENDist": 16, "HelixDens": 16, "StrandDens": 16, "DstNxtHlx": 16,
    "DstPrvHlx": 16, "NX": 16, "PMDist": 16,
    "Mu": 36,
}

WILDCARD = 0  # src/dss.h:9 — undefined int-feature values map to letter 0

# Mu = mixed-radix combination of SS3 (3) x NENSS3 (3) x RENDist4 (4)
# little-endian: Mu = SS3 + 3*NENSS3 + 9*RENDist4  (src/dssparams.cpp:7-14)
MU_FEATURES = ("SS3", "NENSS3", "RENDist4")
MU_ALPHA_SIZES = (3, 3, 4)
MU_ALPHA_SIZE = 36

# Default feature set + trained weights (src/namedparams.cpp:36-43)
DEFAULT_FEATURES: List[Tuple[str, float]] = [
    ("AA", 0.398145),
    ("NENDist", 0.129367),
    ("Conf", 0.202354),
    ("NENConf", 0.149383),
    ("RENDist", 0.0937677),
    ("DstNxtHlx", 0.00475462),
    ("StrandDens", 0.0183853),
    ("NormDens", 0.00384384),
]

# Amino alphabet, letter order of the reference (src/alpha.cpp:531-551)
AMINO_ALPHABET = "ACDEFGHIKLMNPQRSTVWY"

SCOP40C_DBSIZE = 8340  # E = P * SCOP40c_DBSIZE (src/statsig.h:3)


@dataclasses.dataclass
class DSSParams:
    """All search parameters (reference src/dssparams.h:27-118)."""

    features: Tuple[str, ...] = tuple(f for f, _ in DEFAULT_FEATURES)
    weights: Tuple[float, ...] = tuple(w for _, w in DEFAULT_FEATURES)

    gap_open: float = -0.685533   # namedparams.cpp:45
    gap_ext: float = -0.051881
    fwd_match_score: float = 0.1
    min_fwd_score: float = 7.0
    omega: float = 29.0
    omega_fwd: float = 29.0
    mkf_pattern: str = "111"
    mu_pref_pattern: str = "1110011"

    use_para: bool = True
    para_mu_gap_open: int = 2     # positive penalty convention
    para_mu_gap_ext: int = 1

    mkfl: int = 2**31 - 1         # chain length that triggers seeded x-drop path
    mkf_x1: int = 2**31 - 1
    mkf_x2: int = 2**31 - 1
    mkf_min_hsp_score: int = 2**31 - 1
    mkf_min_mega_hsp_score: float = float("inf")

    evalue_a: float = 4.0
    evalue_b: float = -43.0
    aa_only: bool = False
    mode: str = "sensitive"       # preset name this instance came from

    @staticmethod
    def create(mode: str = "sensitive") -> "DSSParams":
        """Mode presets (src/dssparams.cpp:50-85)."""
        p = DSSParams()
        if mode == "fast":
            p = dataclasses.replace(
                p, omega=22, omega_fwd=50, mkfl=500,
                mkf_x1=8, mkf_x2=8, mkf_min_hsp_score=50,
                mkf_min_mega_hsp_score=-4.0)
        elif mode == "sensitive":
            p = dataclasses.replace(
                p, omega=12, omega_fwd=20, mkfl=600,
                mkf_x1=8, mkf_x2=8, mkf_min_hsp_score=50,
                mkf_min_mega_hsp_score=-4.0)
        elif mode == "verysensitive":
            p = dataclasses.replace(
                p, omega=0, omega_fwd=0, mkfl=99999,
                mkf_x1=99999, mkf_x2=99999, mkf_min_hsp_score=0,
                mkf_min_mega_hsp_score=-99999.0, min_fwd_score=0.0)
        else:
            raise ValueError(f"unknown mode {mode!r}")
        return dataclasses.replace(p, mode=mode)

    # -- reference config-file surfaces --------------------------------

    _SCALARS = {  # src/scalarparams.h names -> dataclass fields
        "GapOpen": "gap_open", "GapExt": "gap_ext",
        "FwdMatchScore": "fwd_match_score", "MinFwdScore": "min_fwd_score",
        "Omega": "omega",
    }

    def set_param(self, name: str, value: float,
                  append_if_weight: bool = True) -> None:
        """SetParam (src/dssparams.cpp:191-216): scalar name or feature
        weight."""
        if name in self._SCALARS:
            setattr(self, self._SCALARS[name], float(value))
            return
        if name not in ALPHA_SIZES:
            raise ValueError(f"SetParam({name})")
        feats, ws = list(self.features), list(self.weights)
        if append_if_weight:
            feats.append(name)
            ws.append(float(value))
        else:
            ws[feats.index(name)] = float(value)
        self.features, self.weights = tuple(feats), tuple(ws)

    @staticmethod
    def from_tsv(path: str) -> "DSSParams":
        """-params FILE (FromTsv, src/dssparams.cpp:113-128): one
        `Name<TAB>value` per line; feature names append weighted
        features, scalar names set scalars."""
        p = DSSParams(features=(), weights=())
        with open(path) as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                name, value = line.split("\t")
                p.set_param(name, float(value), append_if_weight=True)
        return p

    @staticmethod
    def from_param_str(s: str) -> "DSSParams":
        """Underscore syntax `AA:0.4_Conf:0.2_...` (FromParamStr,
        src/namedparams.cpp:4-30; note its distinct scalar defaults)."""
        p = DSSParams(features=(), weights=(), gap_open=-1.5,
                      gap_ext=-0.42, fwd_match_score=0.0,
                      min_fwd_score=0.0, omega=0.0)
        for field in s.split("_"):
            name, w = field.split(":")
            p.set_param(name, float(w), append_if_weight=True)
        return p


class StatSig:
    """Fitted two-piece log-linear P-value model (src/statsig.cpp:27-50)."""

    X1 = 0.11
    M0, C0 = -80.0, -0.58
    M, C = -52.0, -3.7

    @staticmethod
    def pvalue(ts: float) -> float:
        if ts < StatSig.X1:
            log10p = StatSig.M0 * ts + StatSig.C0
        else:
            log10p = StatSig.M * ts + StatSig.C
        p = math.pow(10.0, log10p)
        return min(p, 1.0)

    @staticmethod
    def evalue(ts: float) -> float:
        return StatSig.pvalue(ts) * SCOP40C_DBSIZE

    @staticmethod
    def qual(ts: float) -> float:
        """AQ alignment-quality heuristic (src/statsig.h:8-23)."""
        log_e = 5.0 - 40.0 * ts
        if log_e < -20:
            return 1.0
        return 1.0 / (1.0 + math.pow(10.0, log_e / 10.0) / 2.0)


# Test-statistic combination weights (src/dssaligner.cpp:883-889):
#   TS = 0.13*LDDT + (1.7*FwdScore - 2.0*RevDPScore) / ((LA+LB)/2 + 250)
TS_LDDT_WEIGHT = 0.13
TS_DP_WEIGHT = 1.7
TS_REV_WEIGHT = 2.0
TS_L_ADD = 250.0
