"""mmCIF parser: _atom_site loop, CA-only, first model, chain split on
auth_asym_id change (src/cif.cpp:125-298)."""

from __future__ import annotations

import gzip
from typing import List, Optional

import numpy as np

from reseek_tpu_torch.chain import Chain
from reseek_tpu_torch.io.pdb import (chainize_label, fallback_label_from_filename,
                               one_from_three)


def _read_lines(path: str) -> List[str]:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt", errors="replace") as f:
        return [l.rstrip("\n").rstrip("\r") for l in f]


def chains_from_cif_lines(lines: List[str],
                          fallback_label: str) -> List[Chain]:
    base_label = fallback_label
    if lines and lines[0].startswith("data_"):
        fields = lines[0].split("_")
        if len(fields) == 2 and fields[1]:
            base_label = fields[1]

    # state machine: find loop_ followed by _atom_site. field list, then rows
    field_list: List[str] = []
    atom_lines: List[str] = []
    state = "waiting"
    for line in lines:
        if line.startswith("#"):
            continue
        if state == "waiting":
            if line == "loop_":
                state = "at_loop"
        elif state == "at_loop":
            if line.startswith("_atom_site."):
                state = "in_fields"
                field_list.append(line.strip())
            else:
                state = "waiting"
        elif state == "in_fields":
            if line.startswith("_atom_site."):
                field_list.append(line.strip())
            elif line == "loop_":
                field_list = []
                state = "at_loop"
            elif line.startswith("ATOM ") or line.startswith("HETATM"):
                state = "in_atoms"
                atom_lines.append(line)
        elif state == "in_atoms":
            if line.startswith("ATOM ") or line.startswith("HETATM"):
                atom_lines.append(line)
            else:
                break

    idx = {name: i for i, name in enumerate(field_list)}

    def fi(name: str) -> Optional[int]:
        return idx.get("_atom_site." + name)

    chain_i, ca_i = fi("auth_asym_id"), fi("label_atom_id")
    x_i, y_i, z_i = fi("Cartn_x"), fi("Cartn_y"), fi("Cartn_z")
    aa_i, model_i = fi("label_comp_id"), fi("pdbx_PDB_model_num")
    if None in (chain_i, ca_i, x_i, y_i, z_i, aa_i):
        return []

    chains: List[Chain] = []
    cur_chain_str = None
    cur_label = None
    seq: List[str] = []
    coords: List[tuple] = []
    cur_model = None

    def flush():
        if cur_label is not None and coords:
            chains.append(Chain(cur_label, "".join(seq),
                                np.array(coords, np.float32)))

    nfields = len(field_list)
    for line in atom_lines:
        fields = line.split()
        if len(fields) != nfields:
            return chains  # format error: reference aborts the file
        if fields[ca_i] != "CA":
            continue
        if model_i is not None:
            model = int(fields[model_i]) if fields[model_i].isdigit() else 0
            if cur_model is not None and model != cur_model:
                break
            cur_model = model
        cs = fields[chain_i] or "__"
        if cs != cur_chain_str:
            flush()
            seq, coords = [], []
            cur_chain_str = cs
            cur_label = chainize_label(base_label, cs)
        aaa = fields[aa_i]
        if len(aaa) != 3:
            continue
        seq.append(one_from_three(aaa))
        coords.append((np.float32(float(fields[x_i])),
                       np.float32(float(fields[y_i])),
                       np.float32(float(fields[z_i]))))
    flush()
    return chains


def read_cif(path: str) -> List[Chain]:
    return chains_from_cif_lines(_read_lines(path),
                                 fallback_label_from_filename(path))
