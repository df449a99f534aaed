"""The port's searches dealt over a device mesh, on the CPU (plain versions
of the kernels): byte for byte equal to the one-device runs and to
reseek_tpu's host engine, for the self-search, query-vs-DB, the E-bound
stage-2 prepass and -fast; and the current-device rule of every kernel
launch."""

import io

import numpy as np
import pytest
import torch

from reseek_tpu.constants import DSSParams
from reseek_tpu.io.reader import read_chains
from reseek_tpu.search import driver as tpu_driver
from reseek_tpu.search.driver import _encode_all
from reseek_tpu_torch import kernels
from reseek_tpu_torch.parallel.mesh import (Mesh, _mesh_shard_ranges,
                                            as_mesh, host_shard_bounds)
from reseek_tpu_torch.search import driver as torch_driver
from reseek_tpu_torch.search.engine import DeviceSelfSearch

from test_torch_query import _opts
from test_torch_search import Q100, SUBSET, _search

# two and three positions on one device; three positions over two
# devices ("cpu" and "cpu:0" are distinct torch devices, so the second
# gets its own replica of the engine state)
MESHES = {"cpu2": ("cpu", "cpu"), "cpu3": ("cpu", "cpu:0", "cpu"),
          "cpu3_one_device": ("cpu", "cpu", "cpu")}
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def chains():
    return read_chains(Q100)


@pytest.fixture(scope="module")
def subset(chains):
    return [chains[i] for i in SUBSET]


@pytest.fixture(scope="module")
def self_single(subset):
    got, _ = _search(torch_driver.self_search, subset, engine="device",
                     device="cpu")
    host, _ = _search(tpu_driver.self_search, subset, engine="host")
    assert got == host and len(got.splitlines()) == 90
    return got


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_self_search_mesh_matches_single_and_host(subset, self_single, mesh):
    got, drv = _search(torch_driver.self_search, subset, mesh=MESHES[mesh])
    assert got == self_single
    assert {"encode_s", "stage1_s", "stage3_s", "finish_s"} <= (
        drv.device_stats.keys())
    assert drv.device_stats["survivors"] > 0


def _query(chains, **kw):
    out = io.StringIO()
    fn = (tpu_driver.query_search if kw.get("engine") == "host"
          else torch_driver.query_search)
    # 3 queries x 13 chains of the subset, the queries among them
    fn([chains[i] for i in SUBSET[:3]], [chains[i] for i in SUBSET[:13]],
       DSSParams.create("sensitive"), _opts("sensitive"), out, **kw)
    assert out.getvalue().count("\n") > 3
    return out.getvalue()


@pytest.mark.parametrize("prepass", [False, True])
def test_query_search_mesh_matches_single_and_host(chains, monkeypatch,
                                                   prepass):
    """3 queries x 13 chains; with RESEEK_E_PREPASS_MIN=1 the E-bound
    prepass runs the sharded stage2_scores."""
    if prepass:
        monkeypatch.setenv("RESEEK_E_PREPASS_MIN", "1")
    host = _query(chains, engine="host")
    assert _query(chains, engine="device", device="cpu") == host
    assert _query(chains, mesh=MESHES["cpu3"]) == host


def test_fast_search_mesh_matches_single_and_host(chains):
    def run(fn, **kw):
        out = io.StringIO()
        fn([chains[i] for i in (18, 40)], chains[:60],
           DSSParams.create("fast"), _opts("fast"), out, **kw)
        return out.getvalue()

    host = run(tpu_driver.fast_search, engine="host")
    assert host.count("\n") > 3
    assert run(torch_driver.fast_search, engine="device",
               device="cpu") == host
    assert run(torch_driver.fast_search, engine="device",
               mesh=MESHES["cpu2"]) == host


def test_engine_mesh_scores_match_single(chains):
    """The sharded stage-1 scores, stage-2 sweep and exact self-reversal
    scores equal the one-device engine's, value for value."""
    params = DSSParams.create("sensitive")
    ecs = _encode_all([chains[i] for i in SUBSET[:8]], params,
                      with_self_rev=False)
    one = DeviceSelfSearch(ecs, params, device="cpu")
    many = DeviceSelfSearch(ecs, params, mesh=MESHES["cpu3"])
    pairs = np.array([(i, j) for i in range(8) for j in range(i, 8)])
    np.testing.assert_array_equal(many.stage1_scores(pairs),
                                  one.stage1_scores(pairs))
    np.testing.assert_array_equal(many.stage2_scores(pairs[:12]),
                                  one.stage2_scores(pairs[:12]))
    np.testing.assert_array_equal(many.self_rev_scores_device(),
                                  one.self_rev_scores_device())
    assert [v.device for v in many._views] == [
        torch.device(d) for d in MESHES["cpu3"]]
    assert many._views[0] is many._views[2] is many
    assert many._views[1].prof_rev is not None
    assert set(many.seconds) == {"stage1", "stage2"}


@pytest.mark.parametrize("engine", ["host", "global"])
def test_mesh_ignored_on_host_paths(subset, engine):
    """reseek_tpu's warning, and the host output, when the run takes the
    host or -global path."""
    from reseek_tpu.align.output import parse_columns
    from reseek_tpu.search.driver import SearchOptions
    cols = "query+target+qlo+qhi+tlo+thi+cigar"
    outs = []
    for fn, kw in ((torch_driver.self_search,
                    {"engine": "host" if engine == "host" else "device",
                     "mesh": MESHES["cpu2"]}),
                   (tpu_driver.self_search, {"engine": "host"})):
        out = io.StringIO()
        opts = SearchOptions(columns=parse_columns(cols), mode="sensitive",
                             global_aln=engine == "global",
                             scores_are_not_evalues=True)
        if fn is torch_driver.self_search:
            with pytest.warns(UserWarning, match="mesh is ignored"):
                fn(subset[:5], DSSParams.create("sensitive"), opts, out,
                   **kw)
        else:
            fn(subset[:5], DSSParams.create("sensitive"), opts, out, **kw)
        outs.append(out.getvalue())
    assert outs[0] == outs[1] and outs[0]


def test_mesh_shapes():
    """Meshes of device names; shard bounds tile the targets in ascending
    contiguous ranges, as reseek_tpu's."""
    from reseek_tpu.parallel.multihost import host_shard_bounds as jax_hsb
    m = as_mesh(["cpu", "cpu"])
    assert m == Mesh((torch.device("cpu"),) * 2, (0, 0)) and m.size == 2
    assert as_mesh(m) == m and as_mesh(None) is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):       # resolved: cuda needs a card
            as_mesh(Mesh((torch.device("cuda", 0),), (0,)))
    with pytest.raises(TypeError):
        as_mesh("cpu")
    with pytest.raises(ValueError):
        as_mesh([])
    for n, parts in ((100, 1), (101, 4), (7, 3), (3, 8)):
        got = [host_shard_bounds(n, i, parts) for i in range(parts)]
        assert got == [jax_hsb(n, i, parts) for i in range(parts)]
        assert got[0][0] == 0 and got[-1][1] == n
        assert all(got[i][1] == got[i + 1][0] for i in range(parts - 1))
    two = Mesh((torch.device("cpu"),) * 4, (0, 0, 1, 1))
    allr, local = _mesh_shard_ranges(two, 10, rank=1)
    assert allr[0][1] == 0 and allr[-1][2] == 10 and local == allr[2:]
    assert two.local(1) == (torch.device("cpu"),) * 2


def test_launch_makes_the_tensor_device_current(monkeypatch):
    """Every C entry is called with its tensor's device current (and its
    stream), and the launch is counted on that device."""
    entered = []

    class Ctx:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            entered.append(("enter", self.dev))

        def __exit__(self, *exc):
            entered.append(("exit", self.dev))

    class Lib:
        @staticmethod
        def entry(*args):
            entered.append(("call", args))
            return 0

    def wrapper():
        pass

    monkeypatch.setattr(kernels.torch.cuda, "device", Ctx)
    monkeypatch.setattr(kernels, "lib", lambda: Lib)
    monkeypatch.setattr(kernels, "stream_of", lambda t: "stream")
    kernels.counted(wrapper)
    t = torch.zeros(1)
    kernels.launch(wrapper, "entry", t, 1, 2)
    assert entered == [("enter", t.device), ("call", (1, 2, "stream")),
                       ("exit", t.device)]
    assert wrapper.launches == 1 and wrapper.by_device == {"cpu": 1}
