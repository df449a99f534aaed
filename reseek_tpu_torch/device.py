"""Device resolution for the port: an explicit ``torch.device``, never a
silent substitute; and the host cores the process may use.

Asking for ``"cuda"`` without a card raises; on a card, float32 matmuls
and convolutions must run in full float32 (TF32 keeps ~3 decimal digits,
far outside the parity bands the search relies on).  PyTorch enables
cuDNN TF32 by default, so entry points call ``disable_tf32()`` first."""

from __future__ import annotations

import os
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def disable_tf32() -> None:
    """Full-float32 matmuls and convolutions (process-wide torch flags)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve(device: DeviceLike = None) -> torch.device:
    """``"cuda"`` (the default), ``"cpu"`` or a ``torch.device`` ->
    ``torch.device``.  Raises if CUDA is asked for but unavailable, or if
    TF32 is enabled on CUDA."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() "
                "is False")
        if (torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32):
            raise RuntimeError(
                "TF32 is enabled; call reseek_tpu_torch.device."
                "disable_tf32() before running on CUDA")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def host_cores() -> int:
    """The cores this process may run on (its CPU affinity, which a
    rank of a multi-process run narrows to its share of the host)."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:          # no affinity call on this platform
        return os.cpu_count() or 2
