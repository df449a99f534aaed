"""Foldseek/MMseqs2 database interop.

Byte-level replica of the reference's converters:
  create: src/create_foldseekdb.cpp:17-170 — write a Foldseek DB
          (aa seqs, labels `_h`, 3Di `_ss`, packed C-alpha `_ca`,
          .dbtype/.index/.lookup/.source sidecars)
  read:   src/convert_foldseekdb.cpp:140-267 — parse a Foldseek DB back
          to labels / aa / 3Di / coordinates
Coordinate codec: src/foldseek_utils.cpp:66-165 — per axis, int32
start (x*1000 truncated) then int16 deltas; falls back to raw float32
when a delta overflows int16.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from reseek_tpu_torch.chain import Chain

DBTYPE_AA = 0x0
DBTYPE_HDR = 0xC
DBTYPE_CA = 0x65


def coords_to_mem(coords: np.ndarray) -> Optional[bytes]:
    """CoordsToMem (src/foldseek_utils.cpp:115-147): axis-major int32
    start (x*1000, truncated toward zero) + int16 deltas; None on int16
    overflow (caller stores raw floats)."""
    L = coords.shape[0]
    out = bytearray()
    for axis in range(3):
        # float32 multiply then C truncation toward zero, exactly like
        # `(int32_t)(coords[i] * 1000)` on float coords
        v = (coords[:, axis].astype(np.float32)
             * np.float32(1000.0)).astype(np.int32)
        out += struct.pack("<i", int(v[0]))
        if L > 1:
            d32 = np.diff(v.astype(np.int64))
            d16 = d32.astype(np.int16)
            if not np.array_equal(d16.astype(np.int64), d32):
                return None
            out += d16.astype("<i2").tobytes()
    return bytes(out)


def coords_from_mem(mem: bytes, length: int) -> np.ndarray:
    """GetCoordsFromMem (src/foldseek_utils.cpp:66-113): returns [L, 3]
    float32.  A raw-float entry (len >= 12*L) is read directly."""
    if len(mem) >= length * 3 * 4:
        flat = np.frombuffer(mem[: length * 12], "<f4")
        return np.stack([flat[:length], flat[length: 2 * length],
                         flat[2 * length:]], axis=1)
    out = np.empty((length, 3), np.float32)
    off = 0
    for axis in range(3):
        (start,) = struct.unpack_from("<i", mem, off)
        off += 4
        vals = np.empty(length, np.int64)
        vals[0] = start
        if length > 1:
            diffs = np.frombuffer(mem, "<i2", count=length - 1,
                                  offset=off)
            off += 2 * (length - 1)
            # reference accumulates into int32 diffSum
            vals[1:] = start + np.cumsum(
                diffs.astype(np.int32), dtype=np.int64)
        out[:, axis] = (vals / 1000.0).astype(np.float32)
    return out


def write_foldseek_db(chains: List[Chain], seqs_3di: Dict[str, str],
                      prefix: str, dupes: int = 1) -> int:
    """cmd_create_foldseekdb (src/create_foldseekdb.cpp:17-170).
    Returns the number of entries written."""
    def dbtype(suffix: str, value: int) -> None:
        with open(prefix + suffix + ".dbtype", "wb") as f:
            f.write(struct.pack("<I", value))

    dbtype("", DBTYPE_AA)
    dbtype("_h", DBTYPE_HDR)
    dbtype("_ca", DBTYPE_CA)
    dbtype("_ss", DBTYPE_AA)

    nl0 = b"\n\x00"
    idx = 0
    seq_off = label_off = ca_off = 0
    with open(prefix, "wb") as f_seq, \
            open(prefix + "_h", "wb") as f_lab, \
            open(prefix + ".source", "w") as f_src, \
            open(prefix + "_ca", "wb") as f_ca, \
            open(prefix + "_ss", "wb") as f_ss, \
            open(prefix + ".lookup", "w") as f_lk, \
            open(prefix + ".index", "w") as f_ix, \
            open(prefix + "_ss.index", "w") as f_ssix, \
            open(prefix + "_h.index", "w") as f_labix, \
            open(prefix + "_ca.index", "w") as f_caix:
        for c in chains:
            raw_label = c.label.split()[0]
            if raw_label not in seqs_3di:
                raise ValueError(f"Missing 3Di sequence >{raw_label}")
            s3di = seqs_3di[raw_label]
            if len(s3di) != len(c):
                raise ValueError(
                    f"Sequence length mismatch, aa={len(c)} "
                    f"3Di={len(s3di)} >{raw_label}")
            mem = coords_to_mem(c.coords)
            for dupe in range(dupes):
                label = raw_label if dupe == 0 \
                    else f"DUPE{dupe}_{raw_label}"
                f_lab.write(label.encode() + nl0)
                f_seq.write(c.seq.encode() + nl0)
                f_ss.write(s3di.encode() + nl0)
                f_lk.write(f"{idx}\t{label}\t{idx}\n")
                f_src.write(f"{idx}\t{label}\n")
                f_ix.write(f"{idx}\t{seq_off}\t{len(c) + 2}\n")
                f_ssix.write(f"{idx}\t{seq_off}\t{len(c) + 2}\n")
                f_labix.write(f"{idx}\t{label_off}\t{len(label) + 2}\n")
                seq_off += len(c) + 2
                label_off += len(label) + 2
                if mem is None:
                    raw = np.ascontiguousarray(
                        c.coords.T, "<f4").tobytes()
                    f_caix.write(f"{idx}\t{ca_off}\t{len(raw) + 2}\n")
                    f_ca.write(raw + nl0)
                    ca_off += len(raw) + 2
                else:
                    f_caix.write(f"{idx}\t{ca_off}\t{len(mem) + 2}\n")
                    f_ca.write(mem + nl0)
                    ca_off += len(mem) + 2
                idx += 1
    return idx


def _read_nul_seqs(path: str) -> List[str]:
    """ReadNulTerminatedSeqs (src/convert_foldseekdb.cpp:45-69)."""
    with open(path, "rb") as f:
        data = f.read()
    out = []
    cur = []
    for b in data:
        if b == 0:
            out.append(bytes(cur).decode("latin-1"))
            cur = []
        elif b in (0x0A, 0x0D):
            continue
        else:
            cur.append(b)
    return out


def read_foldseek_db(prefix: str
                     ) -> List[Tuple[str, str, str, np.ndarray]]:
    """cmd_convert_foldseekdb's reader (src/convert_foldseekdb.cpp):
    returns [(label, aa_seq, 3di_seq, coords [L, 3] f32)]."""
    labels = _read_nul_seqs(prefix + "_h")
    seqs = _read_nul_seqs(prefix)
    seqs3di = _read_nul_seqs(prefix + "_ss")
    if not (len(labels) == len(seqs) == len(seqs3di)):
        raise ValueError("foldseek DB: inconsistent entry counts")
    with open(prefix + "_ca", "rb") as f:
        ca = f.read()
    offs, lens = [], []
    with open(prefix + "_ca.index") as f:
        for line in f:
            _i, o, n = line.split("\t")
            offs.append(int(o))
            lens.append(int(n))
    out = []
    for k, (label, seq, s3) in enumerate(zip(labels, seqs, seqs3di)):
        if len(seq) != len(s3):
            raise ValueError(
                f"aa/3Di sequence mismatch {len(seq)}, {len(s3)} "
                f">{label}")
        mem = ca[offs[k]: offs[k] + lens[k] - 2]  # strip \n\0
        coords = coords_from_mem(mem, len(seq))
        out.append((label.split()[0] if label else label, seq, s3,
                    coords))
    return out
