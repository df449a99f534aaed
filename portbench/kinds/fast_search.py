"""Traffic kind ``fast_search``: back-to-back -fast query batches against a
big DB.

The configuration gives the DB (its structures cycled to ``db_chains``
with Gaussian coordinate noise from the seed, held in host memory as flat
arrays, a chain made when the program reads it) and its Mu-letter FASTA
(the -dbmu artifact), made at set-up with the reference's encoder and
written to a temporary directory under $TMPDIR.  Each call is one batch of the traffic's ``queries`` (the
same chains on every seed, in the seed's order, with fresh noise a batch),
run through ``reseek_tpu_torch.search.driver.fast_search`` on the device
engine with the CLI's defaults otherwise (prefilter mode by query count).

The check runs the reference's -fast search (its prefilter over the same
FASTA, then its host stage 2) on every query of a sample of batches drawn
from the seed, and compares the rows, as text, and the prefilter's
candidate count.
"""

from __future__ import annotations

import collections
import io
import os
import shutil
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from portbench import generate

WORK = "queries"


def options_for(columns: str, module):
    """The CLI's SearchOptions of `search --fast --db` (-evalue 10)."""
    return module.SearchOptions(columns=columns.split("+"), max_evalue=10.0,
                                mode="fast")


class LazyChains:
    """DB members as chains of ``cls``, made when indexed: both sides read
    only the prefilter's survivors."""

    def __init__(self, s: generate.Structures, cls):
        self.s, self.cls = s, cls

    def __len__(self) -> int:
        return len(self.s)

    def __getitem__(self, k):
        return self.s.chain(self.cls, k)


class Workload:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str,
                 program: str = "port", root=None):
        from portbench.reference.chain import Chain as RefChain
        from portbench.reference.encoder.dss import encode_chain
        self.config, self.traffic = config, traffic
        self.seed, self.device, self.program = seed, device, program
        self.columns = config["columns"]
        noise = float(config["noise_A"])
        base = generate.read_cal(generate.data_path(config["db_structures"],
                                                    root))
        rng = generate.rng_for(seed, generate.STREAM_DATA)
        self.db = generate.cycled(base, int(config["db_chains"]), noise, rng)
        qset = generate.read_cal(generate.data_path(
            config["query_structures"], root))
        pick = [qset.labels.index(label) for label in traffic["queries"]]
        self.queries = generate.subset(qset, pick)
        self.noise = noise
        self.calls_rng = generate.rng_for(seed, generate.STREAM_CALLS)
        self.n_calls = 0
        # the DB's Mu letters (the reference's encoder, on a thread pool:
        # the native encoder releases the GIL) as a -dbmu FASTA
        with ThreadPoolExecutor(max_workers=os.cpu_count()) as tp:
            mus = list(tp.map(
                lambda k: encode_chain(self.db.chain(RefChain, k)).mu_letters,
                range(len(self.db)), chunksize=512))
        self.tmp = tempfile.mkdtemp(prefix="portbench-")
        self.dbmu = os.path.join(self.tmp, "db.mu.fa")
        with open(self.dbmu, "wb") as f:
            f.write(generate.mu_fasta(self.db.labels, mus))
        del mus
        # the port reads the DB's survivors as its chains, made when read
        # (as a .bca reader makes them), so that no DB-sized heap of chain
        # objects sits in the program's process
        from reseek_tpu_torch.chain import Chain
        self.db_port = LazyChains(self.db, Chain)

    def close(self) -> None:
        shutil.rmtree(self.tmp, ignore_errors=True)

    def next_call(self) -> generate.Structures:
        """The next batch: the traffic's queries in the seed's order, each
        with fresh noise, tagged q<batch>."""
        k = self.n_calls
        self.n_calls += 1
        order = self.calls_rng.permutation(len(self.queries))
        return generate.replicate(self.queries, order,
                                  [f"q{k}"] * len(order), self.noise,
                                  self.calls_rng)

    def run(self, batch: generate.Structures) -> dict:
        out = io.StringIO()
        if self.program == "control":
            from portbench import control
            stats = control.fast_search(self, batch, out)
        else:
            stats = self._port(batch, out)
        return {"batch": batch, "text": out.getvalue(), "stats": stats,
                "work": {WORK: len(batch)}, "lengths": batch.lengths}

    def _port(self, batch, out) -> dict:
        import torch

        from reseek_tpu_torch.chain import Chain
        from reseek_tpu_torch.constants import DSSParams
        from reseek_tpu_torch.search import driver, host
        drv = driver.fast_search(batch.chains(Chain), self.db_port,
                                 DSSParams.create("fast"),
                                 options_for(self.columns, host), out,
                                 dbmu=self.dbmu, engine="device",
                                 device=self.device)
        if self.device.startswith("cuda"):
            torch.cuda.synchronize()
        return dict(drv.fast_stats)

    def reference_fast(self, batch, out) -> int:
        """The reference's -fast search of ``batch`` (host.fast_search of
        reseek_tpu_torch with ``dbmu``, as frozen under portbench/
        reference): rows to ``out``; returns the prefilter's candidate
        pairs."""
        from portbench.reference.chain import Chain
        from portbench.reference.constants import DSSParams
        from portbench.reference.search import host
        from portbench.reference.search.prefilter import (prefilter_search,
                                                          read_mu_fasta)
        sens = DSSParams.create("sensitive")
        q_ecs = host._encode_all(batch.chains(Chain), sens,
                                 with_self_rev=False)
        _labels, mus = read_mu_fasta(self.dbmu)
        pf = prefilter_search([ec.mu_letters for ec in q_ecs],
                              enumerate(mus))
        del mus
        t2q = pf.target_to_queries()
        db = LazyChains(self.db, Chain)
        drv = host.SearchDriver(sens, options_for(self.columns, host), out)
        host._fast_align_host(drv, q_ecs, ((t, db[t]) for t in sorted(t2q)),
                              t2q, sens)
        return sum(len(v) for v in t2q.values())

    def check(self, records: list) -> dict:
        rng = generate.rng_for(self.seed, generate.STREAM_CHECK)
        n = min(int(self.traffic["check"]["batches"]), len(records))
        compared = rows_bad = cand_bad = 0
        for j in np.sort(rng.choice(len(records), n, replace=False)):
            rec = records[j]
            ref = io.StringIO()
            cands = self.reference_fast(rec["batch"], ref)
            want = collections.Counter(ref.getvalue().splitlines())
            got = collections.Counter(rec["text"].splitlines())
            compared += sum(want.values())
            rows_bad += sum(((want - got) + (got - want)).values())
            cand_bad += abs(int(rec["stats"].get("candidates", -1)) - cands)
        return {"numbers": {"rows_differing": (rows_bad, 0),
                            "candidates_differing": (cand_bad, 0)},
                "info": {"rows_compared": compared, "batches_checked": n}}

