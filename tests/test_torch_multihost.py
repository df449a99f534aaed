"""The port's multi-process -fast search (reseek_tpu_torch/parallel/
multihost.py) with real process boundaries on the CPU: Gloo rank
processes on localhost, which import torch and the port and never JAX.
Rank 0's merged rows are held against the port's one-process fast_search
and reseek_tpu's host fast_search, byte for byte; then the resume
fingerprint, the world-size guard and the command line."""

import io
import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from reseek_tpu.align.output import parse_columns
from reseek_tpu.constants import DSSParams
from reseek_tpu.io.bca import BCAWriter
from reseek_tpu.io.cal import write_cal
from reseek_tpu.io.reader import read_chains
from reseek_tpu.search import driver as tpu_driver
from reseek_tpu.search.driver import SearchOptions
from reseek_tpu_torch.parallel import multihost
from reseek_tpu_torch.search import driver as torch_driver

from test_torch_search import COLUMNS, Q100, ROOT

QUERIES = [18, 21, 40, 94]
RANK_TIMEOUT = 240
torch.set_num_threads(1)

# one rank: distributed_fast_search after init_distributed; rank 0 writes
# the merged rows to <scratch>/merged.tsv
WORKER = """
import sys
sys.modules["jax"] = None
from reseek_tpu.align.output import parse_columns
from reseek_tpu.io.reader import read_chains
from reseek_tpu.search.driver import SearchOptions
from reseek_tpu_torch.parallel.multihost import (distributed_fast_search,
                                                 global_mesh,
                                                 init_distributed)
rank, nprocs, port, scratch, top_b, engine, queries, db, cols = (
    sys.argv[1:10])
rank, nprocs = int(rank), int(nprocs)
if nprocs > 1:
    init_distributed(f"localhost:{port}", nprocs, rank)
options = SearchOptions(columns=parse_columns(cols), mode="fast")
out = open(scratch + "/merged.tsv", "w") if rank == 0 else None
drv = distributed_fast_search(read_chains(queries), db, options, out,
                              scratch_dir=scratch, top_b=int(top_b),
                              engine=engine, mesh=global_mesh("cpu"))
if out is not None:
    out.close()
assert "jax" not in sys.modules or sys.modules["jax"] is None
print("hits", drv.hit_count, drv.fast_stats)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT), GLOO_SOCKET_IFNAME="lo",
                OMP_NUM_THREADS="1")


def _wait(procs):
    """Wait for every rank, each within RANK_TIMEOUT; kill the rest when
    one fails or hangs."""
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, f"rank failed ({p.returncode}):\n{o}\n{e}"
    return [o for o, _ in outs]


def _ranks(nprocs, scratch, files, top_b=1500, engine="host"):
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(nprocs), str(port),
         str(scratch), str(top_b), engine, files["queries"], files["db"],
         COLUMNS],
        cwd=scratch, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(nprocs)]
    logs = _wait(procs)
    return (scratch / "merged.tsv").read_text(), logs


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Four q100 queries as .cal, the 100 q100 chains as .bca."""
    d = tmp_path_factory.mktemp("mh")
    chains = read_chains(Q100)
    with open(d / "q4.cal", "w") as f:
        write_cal([chains[i] for i in QUERIES], f)
    with BCAWriter(str(d / "db.bca")) as w:
        for c in chains:
            w.write_chain(c)
    return {"queries": str(d / "q4.cal"), "db": str(d / "db.bca")}


def _options():
    return SearchOptions(columns=parse_columns(COLUMNS), mode="fast")


def _fast(fn, files, **kw):
    out = io.StringIO()
    fn(read_chains(files["queries"]), files["db"], DSSParams.create("fast"),
       _options(), out, **kw)
    return out.getvalue()


def test_two_ranks_match_one_process_and_host(files, tmp_path):
    """Two ranks, stage 2 on the port's device engine (its CPU plain
    versions): rank 0's rows equal the port's one-process fast_search and
    reseek_tpu's host fast_search."""
    two, logs = _ranks(2, tmp_path, files, engine="device")
    host = _fast(tpu_driver.fast_search, files, engine="host")
    assert two == host and host.count("\n") > 10
    assert two == _fast(torch_driver.fast_search, files, engine="device",
                        device="cpu")
    hits = [int(log.split()[1]) for log in logs]
    assert sum(hits) == host.count("\n") and min(hits) > 0


def test_two_ranks_truncated_top_b_match_one_rank(files, tmp_path):
    """At top-B 4 the global cut crosses the rank boundary: the merge over
    two processes selects as one process does."""
    (tmp_path / "two").mkdir()
    (tmp_path / "one").mkdir()
    two, _ = _ranks(2, tmp_path / "two", files, top_b=4)
    one, _ = _ranks(1, tmp_path / "one", files, top_b=4)
    assert two == one and two.count("\n") > 0


def test_resume_reuses_only_a_matching_fingerprint(files, tmp_path):
    """A finished row file is reused, with its hit count, when the stored
    fingerprint matches the run; a stale fingerprint (another top-B, or
    the DB rewritten in place at the same size), or none, means the rows
    are computed again."""
    queries = read_chains(files["queries"])
    db = tmp_path / "db.bca"
    db.write_bytes(open(files["db"], "rb").read())

    def run(resume, top_b=1500):
        buf = io.StringIO()
        drv = multihost.distributed_fast_search(
            queries, str(db), _options(), buf, scratch_dir=str(tmp_path),
            top_b=top_b, resume=resume, mesh=["cpu"])
        return buf.getvalue(), drv

    first, drv = run(False)
    assert first.count("\n") == drv.hit_count > 0
    fp = json.loads((tmp_path / "rows.0.json").read_text())
    assert fp["fingerprint"]["top_b"] == 1500 and fp["hits"] == drv.hit_count
    sentinel = "SENTINEL\tROW\n"
    (tmp_path / "rows.0").write_text(sentinel)
    got, drv = run(True)
    assert got == sentinel and drv.hit_count == fp["hits"]
    assert drv.fast_stats["reused"]
    # another top-B: the stored fingerprint is stale
    got, drv = run(True, top_b=1000)
    assert got == first and not drv.fast_stats["reused"]
    (tmp_path / "rows.0").write_text(sentinel)
    st = db.stat()
    os.utime(db, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    got, drv = run(True, top_b=1000)
    assert got == first and not drv.fast_stats["reused"]
    (tmp_path / "rows.0").write_text(sentinel)
    (tmp_path / "rows.0.json").unlink()
    got, _ = run(True)
    assert got == first


def test_world_size_guard_raises(tmp_path):
    """A process group of another size than asked for, or a rank that is
    not given, raises."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{_free_port()}", rank=0,
        world_size=1)
    try:
        with pytest.raises(RuntimeError, match="rank 0 of 2"):
            multihost.init_distributed("localhost:1", 2, 0)
    finally:
        dist.destroy_process_group()
    for kw, env in (({"procid": None, "coord": "h:1"}, {}),
                    ({"procid": 0, "coord": None}, {"MASTER_ADDR": "h"}),
                    ({"procid": 0, "coord": "h:1"}, {"WORLD_SIZE": "3"}),
                    ({"procid": 2, "coord": "h:1"}, {})):
        with pytest.raises(ValueError):
            multihost.rank_from_env(2, env=env, **kw)
    assert multihost.rank_from_env(2, None, None, {
        "RANK": "1", "MASTER_ADDR": "h", "MASTER_PORT": "9",
        "WORLD_SIZE": "2"}) == ("h:9", 1)


def test_two_rank_cli(files, tmp_path):
    """search --fast --nprocs 2: rank 0's -o and --aln equal the
    one-process command's; rank 1 leaves its -o as it was."""
    common = [sys.executable, "-m", "reseek_tpu_torch", "search",
              files["queries"], "--fast", "--db", files["db"], "--columns",
              COLUMNS, "--engine", "host", "--device", "cpu"]
    single = subprocess.run(
        common + ["-o", str(tmp_path / "one.tsv"), "--aln",
                  str(tmp_path / "one.aln")], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=RANK_TIMEOUT)
    assert single.returncode == 0, single.stderr
    (tmp_path / "keep.tsv").write_text("KEEP\n")
    port = _free_port()
    procs = [subprocess.Popen(
        common + ["-o", str(tmp_path / ("two.tsv" if r == 0
                                        else "keep.tsv")),
                  "--aln", str(tmp_path / f"two{r}.aln"),
                  "--nprocs", "2", "--procid", str(r), "--coord",
                  f"localhost:{port}", "--scratch", str(tmp_path)],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    _wait(procs)
    one = (tmp_path / "one.tsv").read_text()
    assert (tmp_path / "two.tsv").read_text() == one and one.count("\n") > 5
    assert (tmp_path / "two0.aln").read_text() == (
        tmp_path / "one.aln").read_text()
    assert (tmp_path / "keep.tsv").read_text() == "KEEP\n"
    assert not (tmp_path / "two1.aln").exists()
