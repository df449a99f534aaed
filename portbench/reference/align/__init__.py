# Frozen copy of reseek_tpu_torch/align/__init__.py (commit f533a72), the benchmark's plain
# reference: imports renamed, nothing else changed.
from portbench.reference.align.pipeline import PairAligner, AlignResult
from portbench.reference.align.cigar import path_to_cigar, cigar_to_path

__all__ = ["PairAligner", "AlignResult", "path_to_cigar", "cigar_to_path"]
