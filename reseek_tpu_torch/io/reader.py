"""Multi-format chain reading: dispatch on file extension like ChainReader2
(src/chainreader2.cpp:49-88), plus directory/.files scanning like
PDBFileScanner (src/pdbfilescanner.cpp)."""

from __future__ import annotations

import os
from typing import Iterator, List

from reseek_tpu_torch.chain import Chain
from reseek_tpu_torch.io import bca, cal, cif, pdb

_STRUCT_EXTS = (".cal", ".bca", ".pdb", ".pdb.gz", ".ent", ".ent.gz",
                ".cif", ".cif.gz", ".mmcif", ".mmcif.gz")


def _ext_kind(path: str) -> str:
    low = path.lower()
    if low.endswith(".cal"):
        return "cal"
    if low.endswith(".bca"):
        return "bca"
    if any(low.endswith(e) for e in (".pdb", ".pdb.gz", ".ent", ".ent.gz")):
        return "pdb"
    if any(low.endswith(e) for e in
           (".cif", ".cif.gz", ".mmcif", ".mmcif.gz")):
        return "cif"
    raise ValueError(f"unknown structure file extension: {path}")


def scan_structure_files(path: str) -> List[str]:
    """Expand a path into structure files: single file, .files list, or a
    directory scanned recursively with an extension whitelist."""
    if os.path.isdir(path):
        out = []
        for root, _dirs, files in os.walk(path):
            for fn in sorted(files):
                if any(fn.lower().endswith(e) for e in _STRUCT_EXTS):
                    out.append(os.path.join(root, fn))
        return out
    if path.lower().endswith(".files"):
        with open(path) as f:
            return [l.strip() for l in f if l.strip()]
    return [path]


# running count of files that failed to parse, counted-not-fatal like
# ChainReader2::m_CRGlobalFormatErrors (src/chainreader2.h:48,
# src/convert.cpp:102-104): a bad file in a directory scan is reported
# and skipped, not a crash.  Single-file inputs still raise.
format_errors = 0


def iter_chains(path: str, save_lines: bool = False) -> Iterator[Chain]:
    global format_errors
    files = scan_structure_files(path)
    multi = len(files) > 1
    for fn in files:
        try:
            kind = _ext_kind(fn)
            if kind == "cal":
                yield from cal.iter_cal(fn)
            elif kind == "bca":
                with bca.BCAReader(fn) as r:
                    for i in range(len(r)):
                        yield r.read_chain(i)
            elif kind == "pdb":
                yield from pdb.read_pdb(fn, save_lines=save_lines)
            elif kind == "cif":
                yield from cif.read_cif(fn)
        except Exception:
            if not multi:
                raise
            format_errors += 1
            from reseek_tpu_torch.utils.logger import get_logger
            get_logger().progress_log(
                f"format error in {fn} (total {format_errors})\n")


def read_chains(path: str, save_lines: bool = False) -> List[Chain]:
    # drop empty chains like ChainReader2::GetNext (src/chainreader2.cpp:104)
    return [c for c in iter_chains(path, save_lines) if len(c) > 0]
