"""The port's graft entry points (reseek_tpu_torch/graft_entry.py) on the
CPU: ``entry``'s exact score of profile pairs against the JAX entry's
gather-sum + lax.scan wavefront (``__graft_entry__.entry``) on the same
seeded codes, bit for bit, and ``dryrun_multichip`` over a mesh of two CPU
positions."""

import numpy as np
import pytest
import torch

import __graft_entry__ as tpu_entry
from reseek_tpu_torch import graft_entry
from reseek_tpu_torch.constants import DSSParams
from reseek_tpu_torch.ops.smx import flat_layout
from reseek_tpu_torch.ops.sw_align import sw_score_profiles_ref

torch.set_num_threads(1)


def test_entry_matches_the_jax_entry():
    fn, args = graft_entry.entry(device="cpu")
    prof_a, prof_b, table = args
    assert prof_a.dtype == torch.uint8 and prof_a.shape == (4, 8, 96)
    jfn, (codes_a, codes_b, w) = tpu_entry.entry()
    # the same seeded letters: the JAX entry's flat codes less the
    # feature offsets, and the same weighted table
    offsets = table.offsets.numpy()[None, :, None]
    assert np.array_equal(prof_a.numpy() + offsets, np.asarray(codes_a))
    assert np.array_equal(prof_b.numpy() + offsets, np.asarray(codes_b))
    assert np.array_equal(table.w.numpy(), np.asarray(w))
    got = fn(*args).numpy()
    assert got.dtype == np.float32 and got.shape == (4,)
    assert np.array_equal(got, np.asarray(jfn(codes_a, codes_b, w)))
    pairs = torch.arange(4)
    p = DSSParams.create("sensitive")
    ref = sw_score_profiles_ref(prof_a, prof_b, pairs, pairs, table, 96, 96,
                                p.gap_open, p.gap_ext)
    assert np.array_equal(got, ref.numpy()) and (got > 0).all()


def test_entry_table_is_the_sensitive_layout():
    p = DSSParams.create("sensitive")
    offsets, _, w = flat_layout(p.features, p.weights)
    _, (_, _, table) = graft_entry.entry(device="cpu")
    assert np.array_equal(table.offsets.numpy(), offsets)
    assert np.array_equal(table.w.numpy(), w)


def test_no_fallback_to_the_cpu():
    """Asked for the card where there is none, entry raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((AssertionError, RuntimeError)):
        graft_entry.entry(device="cuda")


def test_dryrun_multichip_on_the_cpu():
    """Self-search, query-vs-DB, the sharded top-B prefilter and the
    one-rank distributed -fast search over ("cpu", "cpu"), each against
    one device (the asserts inside)."""
    assert graft_entry.mesh_of(2, "cpu") == ("cpu", "cpu")
    graft_entry.dryrun_multichip(2, device="cpu")
