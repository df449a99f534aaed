"""Device ops of the port.  Each kernel wrapper counts its launches in
plain attributes, ``launches`` and ``by_device`` ({device: launches}),
raised by ``kernels.launch`` (a long-column variant's on its own
counter); ``kernel_wrappers`` lists them by kernel."""

from __future__ import annotations


def kernel_wrappers():
    """{kernel name: wrapper} for every CUDA kernel of the port, then the
    launch counts of the long-column variants that four of the wrappers
    pick past their shared-memory limits (``kernels.variant``)."""
    from reseek_tpu_torch.ops.postalign import (lddt_batch, lddt_long,
                                                walk_traceback_batch)
    from reseek_tpu_torch.ops.sw_align import (sw_align, sw_align_long,
                                               sw_score_long,
                                               sw_score_profiles)
    from reseek_tpu_torch.ops.sw_sweep import (mu_sw_scores, mu_sweep_long,
                                               sw_score_sweep)
    return {"mu_sweep": mu_sw_scores, "sw_score_sweep": sw_score_sweep,
            "sw_align": sw_align, "sw_score": sw_score_profiles,
            "walk_traceback": walk_traceback_batch, "lddt": lddt_batch,
            "mu_sweep_long": mu_sweep_long, "sw_align_long": sw_align_long,
            "sw_score_long": sw_score_long, "lddt_long": lddt_long}
