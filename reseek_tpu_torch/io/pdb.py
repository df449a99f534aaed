"""Legacy PDB format: CA-only parsing with the reference's chain-splitting
and labeling rules (src/pdb.cpp, src/pdbchain.cpp:231-263)."""

from __future__ import annotations

import gzip
import os
from typing import List, Optional

import numpy as np

from reseek_tpu_torch.chain import Chain

THREE_TO_ONE = {
    "ALA": "A", "ARG": "R", "ASN": "N", "ASP": "D", "ASX": "B", "CYS": "C",
    "GLN": "Q", "GLU": "E", "GLX": "Z", "GLY": "G", "HIS": "H", "ILE": "I",
    "LEU": "L", "LYS": "K", "MET": "M", "PHE": "F", "PRO": "P", "SER": "S",
    "THR": "T", "TRP": "W", "TYR": "Y", "UNK": "X", "VAL": "V",
}
ONE_TO_THREE = {v: k for k, v in THREE_TO_ONE.items()
                if k not in ("ASX", "GLX", "UNK")}


def one_from_three(aaa: str) -> str:
    return THREE_TO_ONE.get(aaa, "X")


def _read_lines(path: str) -> List[str]:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt", errors="replace") as f:
        return [l.rstrip("\n").rstrip("\r") for l in f]


def is_atom_line(line: str) -> bool:
    return len(line) >= 27 and line.startswith("ATOM  ")


def _is_chain_end(line: str) -> bool:
    return line.startswith("TER ") or line.startswith("ENDMDL")


def parse_atom_line(line: str):
    """Returns (aa, x, y, z) for a CA record, else None.
    Altloc filter: keep ' ', 'A', '1' (src/pdbchain.cpp:242-244)."""
    if line[12:16].strip() != "CA":
        return None
    if line[16] not in (" ", "A", "1"):
        return None
    aa = one_from_three(line[17:20])
    x = np.float32(float(line[30:38]))
    y = np.float32(float(line[38:46]))
    z = np.float32(float(line[46:54]))
    return aa, x, y, z


def _label_already_has_chain(label: str, chain_str: str) -> bool:
    if len(chain_str) != 1 or len(label) < 6:
        return False
    if label[-1].lower() != chain_str[-1].lower():
        return False
    return label[-2] in "_:."


def chainize_label(label: str, chain_str: str, sep: str = "_") -> str:
    """Append chain char to the label (src/pdb.cpp:21-32)."""
    cs = chain_str if chain_str not in ("", " ") else "_"
    if _label_already_has_chain(label, chain_str):
        return label
    return label + sep + cs


def fallback_label_from_filename(path: str) -> str:
    """Stem name; pdbXXXX.ent downloads become upper-cased XXXX
    (src/chainreader2.cpp:186-202)."""
    base = os.path.basename(path)
    for ext in (".gz", ".pdb", ".ent", ".cif", ".mmcif", ".cal", ".bca"):
        if base.lower().endswith(ext):
            base = base[: -len(ext)]
    lower = os.path.basename(path).lower()
    if any(lower.endswith(e) for e in (".pdb", ".ent", ".pdb.gz", ".ent.gz")):
        if len(base) == 7 and base[:3] == "pdb":
            base = base[3:].upper()
    return base


def _chain_from_lines(label: str, lines: List[str],
                      save_lines: bool) -> Optional[Chain]:
    """PDBChain::FromPDBLines (src/pdb.cpp:34-78): first model only."""
    seq, coords = [], []
    chain_str = ""
    for line in lines:
        if _is_chain_end(line):
            break
        if chain_str == "":
            chain_str = line[21]
        rec = parse_atom_line(line)
        if rec is None:
            continue
        aa, x, y, z = rec
        seq.append(aa)
        coords.append((x, y, z))
    if not coords:
        return None
    return Chain(chainize_label(label, chain_str), "".join(seq),
                 np.array(coords, np.float32),
                 lines=list(lines) if save_lines else None)


def chains_from_pdb_lines(lines: List[str], label: str,
                          save_lines: bool = False) -> List[Chain]:
    """Split a PDB file into chains on chain-ID change, honoring TER/ENDMDL
    (src/pdb.cpp:80-130)."""
    chains: List[Chain] = []
    chain_lines: List[str] = []
    curr_chain_char: Optional[str] = None
    any_atoms = False
    end_found = False
    for line in lines:
        if _is_chain_end(line):
            end_found = True
        if is_atom_line(line):
            if len(line) < 54:
                continue
            cc = line[21]
            if cc != curr_chain_char:
                if any_atoms and chain_lines:
                    c = _chain_from_lines(label, chain_lines, save_lines)
                    if c is not None:
                        chains.append(c)
                    chain_lines = []
                    end_found = False
                    any_atoms = False
                curr_chain_char = cc
            if not end_found:
                chain_lines.append(line)
            any_atoms = True
    if chain_lines and any_atoms:
        c = _chain_from_lines(label, chain_lines, save_lines)
        if c is not None:
            chains.append(c)
    return chains


def read_pdb(path: str, save_lines: bool = False) -> List[Chain]:
    lines = _read_lines(path)
    label = fallback_label_from_filename(path)
    return chains_from_pdb_lines(lines, label, save_lines)


def write_pdb(chain: Chain, f, truncate_at_z: bool = False) -> None:
    """CA-only PDB writer."""
    for i in range(len(chain)):
        aaa = ONE_TO_THREE.get(chain.seq[i], "UNK")
        x, y, z = (float(v) for v in chain.coords[i])
        f.write(
            f"ATOM  {i + 1:5d}  CA  {aaa} A{i + 1:4d}    "
            f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00           C  \n")
    f.write("TER\n")
