"""Device ops of the port.  Each kernel wrapper counts its launches in
plain attributes, ``launches`` and ``by_device`` ({device: launches}),
raised by ``kernels.launch``; ``kernel_wrappers`` lists them by kernel."""

from __future__ import annotations


def kernel_wrappers():
    """{kernel name: wrapper} for every CUDA kernel of the port."""
    from reseek_tpu_torch.ops.postalign import (lddt_batch,
                                                walk_traceback_batch)
    from reseek_tpu_torch.ops.sw_align import sw_align
    from reseek_tpu_torch.ops.sw_sweep import mu_sw_scores, sw_score_sweep
    from reseek_tpu_torch.ops.sw_wavefront import sw_score
    return {"mu_sweep": mu_sw_scores, "sw_score_sweep": sw_score_sweep,
            "sw_traceback": sw_align, "sw_score": sw_score,
            "walk_traceback": walk_traceback_batch, "lddt": lddt_batch}
