"""Traffic kind ``self_search``: back-to-back all-vs-all jobs.

The configuration gives a pool of chains (its structures below its
``max_length``, cycled to ``pool_domains`` with Gaussian coordinate noise
from the seed); each call is one all-vs-all job of ``domains_per_search``
chains drawn from the pool (``generate.job_members``: the same lengths on
every seed), run through ``reseek_tpu_torch.search.driver.self_search`` on
the device engine, with the CLI's options for the traffic's ``mode``.

The check recomputes, with the reference (portbench/reference), every pair
of a sample of chains drawn from the seed in a sample of the window's jobs,
and compares their rows with the program's, as text.
"""

from __future__ import annotations

import collections
import io
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from portbench import generate

WORK = "pairs"


def options_for(mode: str, columns: str, module):
    """The CLI's SearchOptions for ``mode`` (cmd_search: -evalue 10, or no
    E-value limit under --verysensitive), from ``module`` (the port's or
    the reference's host search)."""
    max_e = float("inf") if mode == "verysensitive" else 10.0
    return module.SearchOptions(columns=columns.split("+"), max_evalue=max_e,
                                mode=mode)


class Workload:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str,
                 program: str = "port", root=None):
        self.config, self.traffic = config, traffic
        self.seed, self.device, self.program = seed, device, program
        self.mode = traffic["mode"]
        self.columns = config["columns"]
        self.job_size = int(traffic.get("domains_per_search",
                                        config["domains_per_search"]))
        base = generate.read_cal(generate.data_path(config["structures"],
                                                    root))
        keep = np.flatnonzero(base.lengths < config["max_length"])
        self.base = generate.subset(base, keep)
        self.pool = generate.cycled(self.base, int(config["pool_domains"]),
                                    float(config["noise_A"]),
                                    generate.rng_for(seed,
                                                     generate.STREAM_DATA))
        self.calls_rng = generate.rng_for(seed, generate.STREAM_CALLS)

    def next_call(self) -> np.ndarray:
        """The pool indices of the next job."""
        return generate.job_members(len(self.base), len(self.pool),
                                    self.base.lengths, self.job_size,
                                    self.calls_rng)

    def run(self, members: np.ndarray) -> dict:
        """One job through the program; its output rows, stage walls and
        work."""
        out = io.StringIO()
        n = len(members)
        lengths = self.pool.lengths[members]
        if self.program == "control":
            from portbench import control
            stats = control.self_search(self.pool, members, self.mode,
                                        self.columns, out)
        else:
            stats = self._port(members, out)
        return {"members": members, "text": out.getvalue(),
                "stats": stats, "work": {WORK: n * (n + 1) // 2},
                "lengths": lengths}

    def _port(self, members, out) -> dict:
        import torch

        from reseek_tpu_torch.chain import Chain
        from reseek_tpu_torch.constants import DSSParams
        from reseek_tpu_torch.search import driver, host
        chains = self.pool.chains(Chain, members)
        drv = driver.self_search(chains, DSSParams.create(self.mode),
                                 options_for(self.mode, self.columns, host),
                                 out, engine="device", device=self.device)
        if self.device.startswith("cuda"):
            torch.cuda.synchronize()
        return dict(drv.device_stats)

    def check(self, records: list) -> dict:
        """The reference against the program's rows: every pair of a
        sample of chains of a sample of jobs, both drawn from the seed."""
        from portbench.reference.align.pipeline import PairAligner
        from portbench.reference.chain import Chain
        from portbench.reference.constants import DSSParams
        from portbench.reference.search import host
        rng = generate.rng_for(self.seed, generate.STREAM_CHECK)
        spec = self.traffic["check"]
        params = DSSParams.create(self.mode)
        options = options_for(self.mode, self.columns, host)
        jobs = np.sort(rng.choice(len(records), min(int(spec["jobs"]),
                                                    len(records)),
                                  replace=False))
        compared = differing = 0
        for j in jobs:
            rec = records[j]
            ecs = host._encode_all(self.pool.chains(Chain, rec["members"]),
                                   params, with_self_rev=True)
            n = len(ecs)
            k = min(int(spec["chains_per_job"]), n)
            # the job's longest chain and a draw of the others
            longest = int(np.argmax(rec["lengths"]))
            others = np.setdiff1d(np.arange(n), [longest])
            sample = [longest, *rng.choice(others, k - 1, replace=False)]
            pairs = sorted({(min(x, y), max(x, y)) for x in sample
                            for y in range(n)})
            local = threading.local()

            def align(pair):
                if not hasattr(local, "aligner"):
                    local.aligner = PairAligner(params)
                return local.aligner.align(ecs[pair[0]], ecs[pair[1]])

            with ThreadPoolExecutor(max_workers=os.cpu_count()) as tp:
                results = list(tp.map(align, pairs))
            ref = io.StringIO()
            drv = host.SearchDriver(params, options, ref)
            for (a, b), res in zip(pairs, results):
                host.emit_pair(drv, ecs, a, b, res)
            want = ref.getvalue().splitlines()
            labels = {ecs[x].label for x in sample}
            got = [line for line in rec["text"].splitlines()
                   if set(line.split("\t", 2)[:2]) & labels]
            w, g = collections.Counter(want), collections.Counter(got)
            compared += len(want)
            differing += sum(((w - g) + (g - w)).values())
        return {"numbers": {"rows_differing": (differing, 0)},
                "info": {"rows_compared": compared,
                         "jobs_checked": len(jobs)}}
