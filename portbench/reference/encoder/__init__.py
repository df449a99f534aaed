# Frozen copy of reseek_tpu_torch/encoder/__init__.py (commit f533a72), the benchmark's plain
# reference: imports renamed, nothing else changed.
from portbench.reference.encoder.dss import DSSEncoding, encode_chain, mu_kmers

__all__ = ["DSSEncoding", "encode_chain", "mu_kmers"]
