"""SCOP40 benchmark evaluation: sensitivity at errors-per-query (SEPQ) and
ROC area, matching the reference's scorer semantics
(src/scop40bench.cpp:49-91, 587-611; test_scripts/scop40.py).

SCOP ids are cls.fold.sf.fam; truth at the default 'sf2' level: same
superfamily = TP, different = FP (no ignores).  Sensitivity denominators
use the possible-TP counts for the full SCOP40c set when evaluating the
standard benchmark, or are computed from the truth table otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple


def _sf(scopid: str) -> str:
    f = scopid.split(".")
    return ".".join(f[:3])


def _fold(scopid: str) -> str:
    f = scopid.split(".")
    return ".".join(f[:2])


def read_dom_scopid(path: str) -> Dict[str, str]:
    out = {}
    with open(path) as f:
        for line in f:
            dom, scopid = line.rstrip("\n").split("\t")
            out[dom] = scopid
    return out


@dataclasses.dataclass
class Scop40Result:
    sepq0_1: float
    sepq1: float
    sepq10: float
    sens_first_fp: float
    n_first_fp: int
    area: float
    ntp: int
    nfp: int

    def summary(self) -> str:
        return (f"SEPQ0.1={self.sepq0_1:.4f} SEPQ1={self.sepq1:.4f} "
                f"SEPQ10={self.sepq10:.4f} S1FP={self.sens_first_fp:.4f} "
                f"N1FP={self.n_first_fp} area={self.area:.3g}")


class Scop40Eval:
    """Evaluator for (query, target, score-or-evalue) hit lists."""

    # standard SCOP40c counts (test_scripts/scop40.py: level sf2)
    STD_NRDOMS = 11211
    STD_NT_SF2 = 454766

    def __init__(self, dom2scopid: Dict[str, str], level: str = "sf2",
                 scores_are_evalues: bool = True):
        self.dom2scopid = dom2scopid
        self.level = level
        self.evalues = scores_are_evalues
        self.dom2sf = {d: _sf(s) for d, s in dom2scopid.items()}
        self.dom2fold = {d: _fold(s) for d, s in dom2scopid.items()}
        self.nrdoms = len(dom2scopid)
        if self.nrdoms == self.STD_NRDOMS and level == "sf2":
            self.nt = self.STD_NT_SF2
        else:
            from collections import Counter
            c = Counter(self.dom2sf.values())
            self.nt = sum(n * (n - 1) for n in c.values())

    def is_tp(self, q: str, t: str) -> int:
        """1=TP, 0=FP, -1=ignore (sf2: no ignores)."""
        q = q.split("/")[0]
        t = t.split("/")[0]
        qsf = self.dom2sf.get(q)
        tsf = self.dom2sf.get(t)
        if qsf is None or tsf is None:
            return -1
        return 1 if qsf == tsf else 0

    def evaluate(self, hits: Iterable[Tuple[str, str, float]]
                 ) -> Scop40Result:
        """hits: (query, target, score).  Self-hits are dropped; hits are
        sorted best-first (ascending for E-values)."""
        rows = [(q, t, s) for q, t, s in hits if q != t]
        rows.sort(key=lambda r: r[2], reverse=not self.evalues)

        better = ((lambda a, b: a < b) if self.evalues
                  else (lambda a, b: a > b))

        ntp = nfp = 0
        sepq = {0.1: None, 1.0: None, 10.0: None}
        first_fp: Dict[str, float] = {}
        tps: List[int] = []
        plot_tprs: List[float] = []
        plot_epqs: List[float] = []
        tprt = 0.01
        tpr = 0.0
        for q, t, s in rows:
            v = self.is_tp(q, t)
            tps.append(v)
            if v == 1:
                ntp += 1
            elif v == 0:
                nfp += 1
                qd = q.split("/")[0]
                if qd not in first_fp or better(s, first_fp[qd]):
                    first_fp[qd] = s
            tpr = ntp / self.nt
            epq = nfp / self.nrdoms
            for thr in sepq:
                if epq >= thr and sepq[thr] is None:
                    sepq[thr] = tpr
            if tpr >= tprt:
                plot_tprs.append(tprt)
                plot_epqs.append(epq)
                tprt += 0.01
        for thr in sepq:
            if sepq[thr] is None:
                sepq[thr] = tpr

        n1fp = 0
        for (q, t, s), v in zip(rows, tps):
            qd = q.split("/")[0]
            if v == 1 and (qd not in first_fp or better(s, first_fp[qd])):
                n1fp += 1

        area = sum(tpr_i for tpr_i, epq_i in zip(plot_tprs, plot_epqs)
                   if 0.01 <= epq_i <= 10)

        return Scop40Result(
            sepq0_1=sepq[0.1], sepq1=sepq[1.0], sepq10=sepq[10.0],
            sens_first_fp=n1fp / self.nt, n_first_fp=n1fp, area=area,
            ntp=ntp, nfp=nfp)

    def evaluate_tsv(self, path: str, qcol: int = 0, tcol: int = 1,
                     scol: int = 2) -> Scop40Result:
        def gen():
            with open(path) as f:
                for line in f:
                    fl = line.rstrip("\n").split("\t")
                    yield fl[qcol], fl[tcol], float(fl[scol])
        return self.evaluate(gen())


# ---------------------------------------------------------------------------
# .bit hit dumps (SCOP40Bench::WriteBit/ReadBit, src/scop40bench.cpp:543-585):
# uint32 DomCount, uint32 HitCount, uint32 dom1[Hits], uint32 dom2[Hits],
# float32 score[Hits].  Dom indexing follows the lookup file's row order.

def write_bit(path: str, n_doms: int, dom1, dom2, scores) -> None:
    import numpy as np
    with open(path, "wb") as f:
        np.asarray([n_doms, len(dom1)], np.uint32).tofile(f)
        np.asarray(dom1, np.uint32).tofile(f)
        np.asarray(dom2, np.uint32).tofile(f)
        np.asarray(scores, np.float32).tofile(f)


def read_bit(path: str):
    """Returns (n_doms, dom1 uint32[], dom2 uint32[], scores f32[])."""
    import numpy as np
    with open(path, "rb") as f:
        hdr = np.fromfile(f, np.uint32, 2)
        n_doms, n_hits = int(hdr[0]), int(hdr[1])
        d1 = np.fromfile(f, np.uint32, n_hits)
        d2 = np.fromfile(f, np.uint32, n_hits)
        sc = np.fromfile(f, np.float32, n_hits)
    if len(d1) != n_hits or len(sc) != n_hits:
        raise ValueError(f"{path}: truncated .bit file")
    return n_doms, d1, d2, sc


def read_lookup_doms(path: str) -> List[str]:
    """Dom names in lookup-file row order (the .bit dom index space,
    SCOP40Bench::ReadLookup + AddDom)."""
    doms = []
    with open(path) as f:
        for line in f:
            doms.append(line.rstrip("\n").split("\t")[0])
    return doms


def read_hits_tsv(path: str, score_field: int = 2):
    """Parse a hits file (query, target, score at `score_field`; spaces
    treated as tabs, short lines skipped — SCOP40Bench::ReadHits,
    src/readhits.cpp:53-110).  Labels truncate at '/'.  Returns
    (dom1 list, dom2 list, score list)."""
    d1, d2, sc = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").replace(" ", "\t").split("\t")
            parts = [p for p in parts if p != ""]
            if len(parts) <= score_field:
                continue
            d1.append(parts[0].split("/")[0])
            d2.append(parts[1].split("/")[0])
            sc.append(float(parts[score_field]))
    return d1, d2, sc
