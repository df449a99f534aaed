"""Persistent encoded-DB artifact (.rsdx): profiles, Mu letters, integer
coords and per-mode self-reversal scores, precomputed once so repeat
searches skip all DSS work.

TPU-native counterpart of the reference's persistent stage artifacts
(SURVEY §5): .bca DBs + `-dbmu` Mu FASTA (src/search.cpp:96-99 lets the
prefilter skip re-encoding the DB).  This artifact goes further — it also
stores the integer feature profiles and the self-reversal scores (which
depend only on the chain + mode), the two expensive parts of
ProfileLoader (src/profileloader.cpp:50-60).

Format: a single .npz with ragged arrays stored as (concat, offsets):
  labels        object array [N]
  seqs          concatenated chain AA sequences (bytes) + offsets
  ics           uint16 [sumL, 3] integer coords (exact .bca round-trip)
  profile       uint8 [NF, sumL]  integer feature profiles
  mu            uint8 [sumL]      Mu letters
  features      object array of feature names (layout check)
  selfrev_<mode> float32 [N]      per-mode self-reversal scores
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from reseek_tpu_torch.chain import Chain
from reseek_tpu_torch.constants import DSSParams

MAGIC = "rsdx-v1"
FLT_MAX = float(np.finfo(np.float32).max)


def write_artifact(path: str, chains: Sequence[Chain],
                   modes: Sequence[str] = ("fast", "sensitive"),
                   progress=None) -> None:
    """Encode all chains and write the artifact.  `modes` selects which
    self-rev score sets to precompute (GetSelfRevScore,
    src/alignpair.cpp:7-25, depends on gap params + MKF routing)."""
    from reseek_tpu_torch.align.pipeline import encode_for_search, self_rev_score
    from reseek_tpu_torch.encoder.dss import encode_chain

    params0 = DSSParams.create(modes[0] if modes else "sensitive")
    n = len(chains)
    offsets = np.zeros(n + 1, np.int64)
    for i, c in enumerate(chains):
        offsets[i + 1] = offsets[i] + len(c)
    total = int(offsets[-1])
    nf = len(params0.features)
    profile = np.zeros((nf, total), np.uint8)
    mu = np.zeros(total, np.uint8)
    ics = np.zeros((total, 3), np.uint16)
    seqs = []
    selfrev = {m: np.full(n, FLT_MAX, np.float32) for m in modes}
    mode_params = {m: DSSParams.create(m) for m in modes}
    for i, c in enumerate(chains):
        lo, hi = offsets[i], offsets[i + 1]
        enc = encode_chain(c)
        profile[:, lo:hi] = enc.profile(params0)
        mu[lo:hi] = enc.mu_letters
        from reseek_tpu_torch.chain import coord_to_ic
        ics[lo:hi] = coord_to_ic(c.coords)
        seqs.append(c.seq)
        for m in modes:
            ec = encode_for_search(c, mode_params[m], with_self_rev=False)
            selfrev[m][i] = self_rev_score(ec, mode_params[m])
        if progress is not None and (i + 1) % 100 == 0:
            progress(i + 1, n)
    out = {
        "magic": np.array(MAGIC),
        "labels": np.array([c.label for c in chains], object),
        "seqs": np.array("".join(seqs)),
        "offsets": offsets,
        "ics": ics,
        "profile": profile,
        "mu": mu,
        "features": np.array(list(params0.features), object),
    }
    for m in modes:
        out[f"selfrev_{m}"] = selfrev[m]
    with open(path, "wb") as f:   # keep the exact filename (.rsdx)
        np.savez_compressed(f, **out)


def load_artifact(path: str, params: DSSParams,
                  mode: Optional[str] = None) -> List["EncodedChain"]:
    """Load EncodedChains; zero DSS work.  Self-rev scores are filled when
    the artifact carries the requested mode, else left FLT_MAX for the
    caller to compute."""
    from reseek_tpu_torch.align.pipeline import EncodedChain, mu_kmers
    from reseek_tpu_torch.chain import ic_to_coord

    z = np.load(path, allow_pickle=True)
    if str(z["magic"]) != MAGIC:
        raise ValueError(f"{path}: not a {MAGIC} artifact")
    feats = [str(f) for f in z["features"]]
    if feats != list(params.features):
        raise ValueError(
            f"{path}: artifact features {feats} != params "
            f"{list(params.features)}")
    labels = z["labels"]
    seqs = str(z["seqs"])
    offsets = z["offsets"]
    profile = z["profile"]
    mu = z["mu"]
    ics = z["ics"]
    sr_key = f"selfrev_{mode}" if mode else None
    selfrev = z[sr_key] if sr_key and sr_key in z else None
    out = []
    for i in range(len(labels)):
        lo, hi = int(offsets[i]), int(offsets[i + 1])
        chain = Chain(str(labels[i]), seqs[lo:hi],
                      ic_to_coord(ics[lo:hi]))
        letters = mu[lo:hi]
        ec = EncodedChain(
            chain=chain, enc=None,
            profile=np.ascontiguousarray(profile[:, lo:hi]),
            mu_letters=letters,
            mu_kmers=mu_kmers(letters, params.mkf_pattern))
        if selfrev is not None:
            ec.self_rev_score = float(selfrev[i])
        out.append(ec)
    return out


def is_artifact(path: str) -> bool:
    return path.lower().endswith((".rsdx", ".rsdx.npz"))
