# Frozen copy of reseek_tpu_torch/align/output.py (commit f533a72), the benchmark's plain
# reference: imports renamed, nothing else changed.
"""Hit-row formatting: the reference's user fields and printf conventions
(src/userfields.cpp, src/userfieldnames.h).  Field values are formatted
bit-compatibly (%.4g/%.3g/%.1f, float32 storage, 1-based coordinates)."""

from __future__ import annotations

from typing import List

import numpy as np

from portbench.reference.align.cigar import path_to_cigar
from portbench.reference.align.pipeline import AlignResult, EncodedChain

DEFAULT_COLUMNS = ["query", "target", "qlo", "qhi", "ql", "tlo", "thi", "tl",
                   "pctid", "pvalue"]  # src/dssaligner.cpp:100-112

KNOWN_COLUMNS = DEFAULT_COLUMNS + [
    "evalue", "cigar", "qrow", "trow", "qrowg", "trowg", "ts", "newts",
    "dpscore", "lddt", "ids", "gaps", "aq", "raw", "qcovpct", "tcovpct",
    "muscore", "muhsp", "muchain", "gscore",
]


def _evalue_str(e: float) -> str:
    if e > 10:
        e = 99
    if e > 1:
        return "%.1f" % e
    if e > 0.001:
        return "%.4f" % e
    return "%.3g" % e


def _pct_id(res: AlignResult, q: EncodedChain, t: EncodedChain) -> float:
    """Identity % over M columns, vectorized (called per emitted row)."""
    codes = np.frombuffer(res.path.encode("ascii"), np.uint8)
    adv_a = codes != ord("I")
    adv_b = codes != ord("D")
    pos_a = res.lo_a + np.cumsum(adv_a) - adv_a
    pos_b = res.lo_b + np.cumsum(adv_b) - adv_b
    is_m = codes == ord("M")
    if not is_m.any():
        return 0.0
    sa = np.frombuffer(q.chain.seq.encode("ascii"), np.uint8)
    sb = np.frombuffer(t.chain.seq.encode("ascii"), np.uint8)
    m = int((sa[pos_a[is_m]] == sb[pos_b[is_m]]).sum())
    return (m * 100.0) / int(is_m.sum())


def _row_strings(res: AlignResult, q: EncodedChain, t: EncodedChain,
                 up: bool, global_rows: bool):
    """Aligned row strings (GetRow_A/GetRow_B, src/dssaligner.cpp:1161-1280)."""
    seq_a, seq_b = q.chain.seq, t.chain.seq
    row_a, row_b = [], []
    a, b = res.lo_a, res.lo_b
    if global_rows:
        for _ in range(res.lo_a, res.lo_b):
            row_a.append(".")
        for i in range(res.lo_a):
            row_a.append(seq_a[i].lower())
        for _ in range(res.lo_b, res.lo_a):
            row_b.append(".")
        for i in range(res.lo_b):
            row_b.append(seq_b[i].lower())
    for c in res.path:
        if c == "M":
            row_a.append(seq_a[a])
            row_b.append(seq_b[b])
            a += 1
            b += 1
        elif c == "D":
            row_a.append(seq_a[a])
            row_b.append("-")
            a += 1
        else:
            row_a.append("-")
            row_b.append(seq_b[b])
            b += 1
    if global_rows:
        la, lb = len(seq_a), len(seq_b)
        pa, pb = a, b
        while pa < la:
            row_a.append(seq_a[pa].lower())
            pa += 1
            pb += 1
        while pb < lb:
            row_a.append(".")
            pb += 1
        pa, pb = a, b
        while pb < lb:
            row_b.append(seq_b[pb].lower())
            pb += 1
            pa += 1
        while pa < la:
            row_b.append(".")
            pa += 1
    ra, rb = "".join(row_a), "".join(row_b)
    return (ra, rb) if up else (rb, ra)


def format_row(columns: List[str], res: AlignResult, q: EncodedChain,
               t: EncodedChain, up: bool) -> str:
    """One TSV row; `up` selects query=A orientation like BaseOnAln."""
    lo_q, hi_q, lo_t, hi_t = ((res.lo_a, res.hi_a, res.lo_b, res.hi_b) if up
                              else (res.lo_b, res.hi_b, res.lo_a, res.hi_a))
    ql, tl = (len(q), len(t)) if up else (len(t), len(q))
    qlabel, tlabel = (q.label, t.label) if up else (t.label, q.label)
    out = []
    for col in columns:
        if col == "query":
            out.append(qlabel)
        elif col == "target":
            out.append(tlabel)
        elif col == "qlo":
            out.append(str(lo_q + 1))
        elif col == "qhi":
            out.append(str(hi_q + 1))
        elif col == "tlo":
            out.append(str(lo_t + 1))
        elif col == "thi":
            out.append(str(hi_t + 1))
        elif col == "ql":
            out.append(str(ql))
        elif col == "tl":
            out.append(str(tl))
        elif col == "pctid":
            out.append("%.1f" % _pct_id(res, q, t))
        elif col == "pvalue":
            out.append("%.3g" % np.float32(res.pvalue))
        elif col == "evalue":
            out.append(_evalue_str(float(np.float32(res.evalue))))
        elif col == "newts":
            out.append("%.3g" % np.float32(res.ts))
        elif col == "ts":
            # the reference's `ts` is the OLD test statistic, which the
            # normal pipeline never sets (-FLT_MAX after ClearAlign,
            # src/dssaligner.cpp:907-928 + userfields.cpp:66); `newts`
            # carries the fitted TS
            out.append("%.3g" % np.float32(res.old_ts))
        elif col in ("dpscore", "raw"):
            fmt = "%.4g" if col == "dpscore" else "%.3g"
            out.append(fmt % np.float32(res.fwd_score))
        elif col == "lddt":
            out.append("%.4g" % np.float32(res.lddt))
        elif col == "ids":
            out.append(str(res.ids))
        elif col == "gaps":
            out.append(str(res.gaps))
        elif col == "aq":
            out.append("%.4f" % res.qual)
        elif col == "muscore":
            out.append("%.3g" % np.float32(res.mu_score))
        elif col == "muhsp":
            out.append("%d" % res.best_hsp_score)
        elif col == "muchain":
            out.append("%d" % res.best_chain_score)
        elif col == "gscore":
            out.append("%.1f" % res.global_score)
        elif col == "cigar":
            out.append(path_to_cigar(res.path, flip_di=not up))
        elif col == "qrow":
            out.append(_row_strings(res, q, t, up, False)[0])
        elif col == "trow":
            out.append(_row_strings(res, q, t, up, False)[1])
        elif col == "qrowg":
            out.append(_row_strings(res, q, t, up, True)[0])
        elif col == "trowg":
            out.append(_row_strings(res, q, t, up, True)[1])
        elif col == "qcovpct":
            pct = min(100.0, 100.0 * (hi_q - lo_q + 1) / ql) if ql else 0.0
            out.append("%.1f" % pct)
        elif col == "tcovpct":
            pct = min(100.0, 100.0 * (hi_t - lo_t + 1) / tl) if tl else 0.0
            out.append("%.1f" % pct)
        else:
            raise ValueError(f"unknown column {col!r}")
    return "\t".join(out)


def parse_columns(spec: str) -> List[str]:
    cols: List[str] = []
    for f in spec.split("+"):
        if f == "std":
            cols.extend(DEFAULT_COLUMNS)
        else:
            cols.append(f)
    return cols
