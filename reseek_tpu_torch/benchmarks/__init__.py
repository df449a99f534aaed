"""The port's copy of reseek_tpu's benchmark evaluators (numpy only): the
SCOP40 SEPQ/ROC evaluator and .bit dumps (scop40.py), the P-value
calibration fits (calibrate.py), the MSA structure scorers (msa.py) and
the feature training (train.py)."""

from reseek_tpu_torch.benchmarks.msa import score_msa
from reseek_tpu_torch.benchmarks.scop40 import Scop40Eval
from reseek_tpu_torch.benchmarks.train import train_features

__all__ = ["Scop40Eval", "score_msa", "train_features"]
