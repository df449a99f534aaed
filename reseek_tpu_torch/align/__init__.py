from reseek_tpu_torch.align.pipeline import PairAligner, AlignResult
from reseek_tpu_torch.align.cigar import path_to_cigar, cigar_to_path

__all__ = ["PairAligner", "AlignResult", "path_to_cigar", "cigar_to_path"]
