"""The reference (portbench/reference, a frozen copy of the port's host
layer) against the port's host engine, byte for byte, on a few chains of
each configuration."""

import io

import numpy as np
import pytest

from portbench import generate, harness
from portbench.kinds import fast_search as fast_kind
from portbench.kinds import self_search as self_kind

COLUMNS = "query+target+qlo+qhi+tlo+thi+evalue+cigar"


def reference_self_search(s, mode):
    from portbench.reference.chain import Chain
    from portbench.reference.constants import DSSParams
    from portbench.reference.search import host
    params = DSSParams.create(mode)
    ecs = host._encode_all(s.chains(Chain), params, with_self_rev=True)
    out = io.StringIO()
    drv = host.SearchDriver(params, self_kind.options_for(mode, COLUMNS,
                                                          host), out)
    for a, b in host.self_search_pairs(ecs):
        host.emit_pair(drv, ecs, a, b, drv.aligner.align(ecs[a], ecs[b]))
    return out.getvalue()


@pytest.mark.parametrize("mode", ["sensitive", "fast", "verysensitive"])
def test_self_search_equals_the_port_host_engine(mode):
    from reseek_tpu_torch.chain import Chain
    from reseek_tpu_torch.constants import DSSParams
    from reseek_tpu_torch.search import host
    sepq = generate.read_cal(generate.data_path(
        "portbench/data/sepq_set.cal"))
    keep = np.flatnonzero(sepq.lengths < 500)[:10]
    s = generate.cycled(generate.subset(sepq, keep), 14, 0.25,
                        generate.rng_for(7, 0))
    out = io.StringIO()
    host.self_search(s.chains(Chain), DSSParams.create(mode),
                     self_kind.options_for(mode, COLUMNS, host), out)
    want = out.getvalue()
    assert want and reference_self_search(s, mode) == want


def test_fast_search_equals_the_port_host_engine(tiny_root):
    from reseek_tpu_torch.chain import Chain
    from reseek_tpu_torch.constants import DSSParams
    from reseek_tpu_torch.search import host
    cell = harness.Bench(tiny_root).cell("pdb90.fast")
    wl = fast_kind.Workload(cell["config"], cell["traffic"], 3, "cpu",
                            root=tiny_root)
    try:
        batch = wl.next_call()
        ref = io.StringIO()
        wl.reference_fast(batch, ref)
        out = io.StringIO()
        host.fast_search(batch.chains(Chain), wl.db.chains(Chain),
                         DSSParams.create("fast"),
                         fast_kind.options_for(COLUMNS, host), out,
                         dbmu=wl.dbmu)
    finally:
        wl.close()
    assert out.getvalue() and ref.getvalue() == out.getvalue()
