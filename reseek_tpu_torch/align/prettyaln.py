"""Human-readable alignment blocks: the -aln output.

Format of DSSAligner::PrettyAln (src/prettyaln.cpp:27-99) +
WriteLocalAln (src/writelocalaln.cpp:63-97): 80-column blocks of
A-row / annotation / B-row with 1-based start and end positions, then the
range/length footer and the AQ/cols/gaps/ids/P-value summary line.
"""

from __future__ import annotations

from typing import TextIO

from reseek_tpu_torch.align.pipeline import AlignResult, EncodedChain

RULE = "_" * 109


def write_local_aln(f: TextIO, label_a: str, seq_a: str, label_b: str,
                    seq_b: str, lo_a: int, lo_b: int, path: str,
                    rowlen: int = 80) -> None:
    """WriteLocalAln (src/writelocalaln.cpp:63-97)."""
    pos_a, pos_b = lo_a, lo_b
    for col_from in range(0, len(path), rowlen):
        block = path[col_from: col_from + rowlen]
        i0, j0 = pos_a, pos_b
        # A row
        row = []
        i = pos_a
        for c in block:
            if c in "MD":
                row.append(seq_a[i])
                i += 1
            else:
                row.append("-")
        f.write("%5u %s %u  %s\n" % (pos_a + 1, "".join(row), i, label_a))
        pos_a = i
        # annotation row
        row = []
        i, j = i0, j0
        for c in block:
            if c == "M":
                row.append("|" if seq_a[i].upper() == seq_b[j].upper()
                           else " ")
                i += 1
                j += 1
            else:
                if c == "D":
                    i += 1
                else:
                    j += 1
                row.append(" ")
        f.write("%5.5s %s\n" % ("", "".join(row)))
        # B row
        row = []
        j = pos_b
        for c in block:
            if c in "MI":
                row.append(seq_b[j])
                j += 1
            else:
                row.append("-")
        f.write("%5u %s %u  %s\n" % (pos_b + 1, "".join(row), j, label_b))
        pos_b = j
        f.write("\n")


def pretty_aln(f: TextIO, res: AlignResult, q: EncodedChain,
               t: EncodedChain, up: bool = True) -> None:
    """DSSAligner::PrettyAln (src/prettyaln.cpp:27-99); `up` swaps the
    A/B roles like BaseOnAln's orientation flip."""
    if up:
        label_a, seq_a, lo_a = q.label, q.chain.seq, res.lo_a
        label_b, seq_b, lo_b = t.label, t.chain.seq, res.lo_b
        path = res.path
    else:
        label_a, seq_a, lo_a = t.label, t.chain.seq, res.lo_b
        label_b, seq_b, lo_b = q.label, q.chain.seq, res.lo_a
        path = res.path.translate(str.maketrans("DI", "ID"))
    n_cols = len(path)
    pos_a, pos_b, ids, gaps = lo_a, lo_b, 0, 0
    for c in path:
        if c == "M":
            if seq_a[pos_a] == seq_b[pos_b]:
                ids += 1
            pos_a += 1
            pos_b += 1
        elif c == "D":
            pos_a += 1
            gaps += 1
        else:
            pos_b += 1
            gaps += 1
    f.write("\n%s\n" % RULE)
    write_local_aln(f, label_a, seq_a, label_b, seq_b, lo_a, lo_b, path)
    f.write("%s %u-%u length %u\n" % (label_a, lo_a + 1, pos_a, len(seq_a)))
    f.write("%s %u-%u length %u\n" % (label_b, lo_b + 1, pos_b, len(seq_b)))
    pct_ids = 100.0 * ids / n_cols if n_cols else 0.0
    pct_gaps = 100.0 * gaps / n_cols if n_cols else 0.0
    f.write("AQ %.4f, cols %u, gaps %u (%.1f%%), ids %u (%.1f%%)"
            % (res.qual, n_cols, gaps, pct_gaps, ids, pct_ids))
    import numpy as np
    FLT_MAX = float(np.finfo(np.float32).max)
    if res.pvalue != FLT_MAX:
        f.write(", P-value %.3g" % np.float32(res.pvalue))
    f.write("\n")
