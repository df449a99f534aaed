"""The port's copy of reseek_tpu's benchmark evaluators (numpy only): the
SCOP40 SEPQ/ROC evaluator and .bit dumps (scop40.py), the P-value
calibration fits (calibrate.py)."""

from reseek_tpu_torch.benchmarks.scop40 import Scop40Eval

__all__ = ["Scop40Eval"]
