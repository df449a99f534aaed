"""One run of one cell: set-up, the measured window, the output check, and
the result line.

    python3 -m portbench --workload NAME --seed N --seconds S --trace 0|1

Set-up (``setup_s``, from the process's start to the window's start)
imports the port, makes the cell's data from the seed, and runs one call
of the cell's own traffic, which builds or loads the kernels.  The window
then runs calls back to back from its start until ``--seconds`` have
passed; the last call runs to its end, and the rates are the work of all
the calls over the time from the first call's start to the last one's
end.  With ``--trace 1`` the same window runs under torch.profiler and the
run reports the cell's per-layer metrics instead of its end-to-end ones.
Once the window has closed and the device's peak memory is read, the
reference checks a sample of the window's outputs drawn from the seed;
each number compared is printed beside its limit, last on standard error
and under ``check`` last in the result line, the run's last line on
standard output.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import sys
import time
import traceback
from pathlib import Path

from portbench import generate, nojax

MANIFEST = "BENCHMARK.json"


class Bench:
    """BENCHMARK.json and the files it names, under ``root`` (the
    checkout)."""

    def __init__(self, root=None):
        self.root = Path(root or generate.ROOT)
        self.manifest = json.loads((self.root / MANIFEST).read_text())

    def cell(self, name: str) -> dict:
        """The workload ``name``: its entry, configuration and traffic
        files, and the metrics of each list that apply to it."""
        m = self.manifest
        by_name = {w["name"]: w for w in m["workloads"]}
        if name not in by_name:
            raise SystemExit(f"portbench: no workload {name!r} in "
                             f"{MANIFEST}")
        w = by_name[name]
        cfg = next(c for c in m["configs"] if c["name"] == w["config"])
        config = json.loads((self.root / cfg["file"]).read_text())
        traffic = json.loads(self.file("traffic", f"{w['config']}."
                                       f"{w['traffic']}.json").read_text())

        def applies(metric):
            return name in metric.get("workloads", [name])
        return {"workload": w, "config": config, "traffic": traffic,
                "end_to_end": [x for x in m["end_to_end"] if applies(x)],
                "per_layer": [x for x in m["per_layer"] if applies(x)]}

    def file(self, kind: str, name: str) -> Path:
        return self.root / "portbench" / kind / name

    def reader(self, metric: str):
        """The ``read(run)`` of portbench/metrics/<metric>.py."""
        path = self.file("metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location(
            f"portbench_metric_{len(sys.modules)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def kind_module(traffic: dict):
    return importlib.import_module(f"portbench.kinds.{traffic['kind']}")


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", program: str = "port", root=None,
        t0: float = None, warmup: bool = True) -> dict:
    """Set up the cell, run its window and check it.  Returns the run's
    record: setup and window seconds, every call's record, the trace's
    summary (or None), the device's peak memory, and the check.
    ``warmup`` False skips the warm-up call (the control's runs, which
    build no kernel)."""
    t0 = time.perf_counter() if t0 is None else t0
    bench = Bench(root)
    cell = bench.cell(workload)
    kind = kind_module(cell["traffic"])
    if device.startswith("cuda"):
        import torch

        from reseek_tpu_torch.device import disable_tf32
        disable_tf32()      # as the CLI's search does
    wl = kind.Workload(cell["config"], cell["traffic"], seed, device,
                       program=program, root=bench.root)
    data_s = time.perf_counter() - t0
    try:
        if warmup:
            wl.run(wl.next_call())      # one call of the cell's own size
        if device.startswith("cuda"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t0
        calls, failed = [], 0
        prof = None
        if trace:
            from torch.profiler import record_function

            from portbench import trace as tr
            prof = tr.profiler()
        with prof if prof is not None else contextlib.nullcontext():
            start = time.perf_counter()
            while True:
                # a call's time covers making its inputs and running it
                t = time.perf_counter() if calls else start
                inputs = wl.next_call()
                name = f"{cell['traffic']['kind']}#{len(calls)}"
                try:
                    with (record_function(name) if trace
                          else contextlib.nullcontext()):
                        rec = wl.run(inputs)
                except Exception:   # the call failed: count it, and stop
                    traceback.print_exc()
                    failed += 1
                    rec = {"work": {}, "stats": {}, "failed": True}
                rec.update(name=name, start=t, end=time.perf_counter())
                calls.append(rec)
                if failed or rec["end"] - start >= seconds:
                    break
        window_s = calls[-1]["end"] - start
        peak = (torch.cuda.max_memory_allocated()
                if device.startswith("cuda") else 0)
        summary = None
        if trace:
            summary = tr.summarize(prof, {c["name"] for c in calls})
            del prof
        if device.startswith("cuda"):
            torch.cuda.empty_cache()
        t = time.perf_counter()
        check = (wl.check([c for c in calls if not c.get("failed")])
                 if not failed else {"numbers": {}, "info": {}})
        check["info"].update(data_s=data_s, warmup_s=setup_s - data_s,
                             check_s=time.perf_counter() - t)
    finally:
        close = getattr(wl, "close", None)
        if close is not None:
            close()
    return {"cell": cell, "setup_s": setup_s, "window_s": window_s,
            "calls": calls, "failed": failed, "trace": summary,
            "memory_peak_bytes": int(peak), "check": check}


def is_correct(rec: dict) -> bool:
    """No call failed, and every number compared is within its limit."""
    numbers = rec["check"]["numbers"]
    return (not rec["failed"] and bool(numbers)
            and all(v <= lim for v, lim in numbers.values()))


def result_line(bench: Bench, rec: dict, trace: bool) -> dict:
    """The contract's result object: the cell's end-to-end metrics (or,
    traced, its per-layer ones) by their readers, whichever read a
    value."""
    cell = rec["cell"]
    metrics = {}
    for m in cell["per_layer" if trace else "end_to_end"]:
        value = bench.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    numbers = rec["check"]["numbers"]
    import torch
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["workload"]["chips"],
              "memory_peak_bytes": rec["memory_peak_bytes"]}
    out = {"correct": is_correct(rec), "attempted": len(rec["calls"]),
           "failed": rec["failed"], "metrics": metrics, "device": device}
    if trace:
        t = rec["trace"]
        device.update(busy_s=t["busy_s"], window_s=t["window_s"])
        out["breakdown"] = {"device_ops": [list(x) for x in t["device_ops"]],
                            "idle_gaps": [list(x) for x in t["idle_gaps"]]}
    out["check"] = {k: {"value": v, "limit": lim}
                    for k, (v, lim) in numbers.items()}
    return out


def main(argv=None, t0: float = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if nojax.loaded():
        print(f"portbench: loaded at start: {nojax.loaded()}",
              file=sys.stderr)
        return 3
    bench = Bench()
    chips = bench.cell(args.workload)["workload"]["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    rec = run(args.workload, args.seed, args.seconds, bool(args.trace),
              t0=t0)
    line = result_line(bench, rec, bool(args.trace))
    # after the window, the check and the metric readers: whatever any of
    # them loaded
    if nojax.loaded():
        print(f"portbench: JAX or the JAX package loaded: "
              f"{nojax.loaded()}", file=sys.stderr)
        return 3
    calls = rec["calls"]
    print(json.dumps({"calls": len(calls),
                      "work": [c["work"] for c in calls],
                      "seconds": [round(c["end"] - c["start"], 4)
                                  for c in calls],
                      "stats": [c["stats"] for c in calls],
                      "rows": [c.get("text", "").count("\n") for c in calls],
                      "check_info": rec["check"]["info"]}, default=float),
          flush=True)
    for k, v in line["check"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
