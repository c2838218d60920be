"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

The traffic mix names its driver (`drivers/<driver>.py` beside this file),
which owns what is particular to a kind of work: making the inputs, one
job of the window, and the comparison with the reference. The metrics are
read from the run's record by `metrics/<name>.py`.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import math
import sys
import time
import traceback

from . import checks
from .manifest import Manifest
from .record import Record
from .trace import Tracer, summarize


def parse(argv):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(manifest: Manifest, workload: str, seed: int, seconds: float,
             trace: bool, device: str, t_start: float, patch=None) -> dict:
    """Run `workload` and return the result object. `patch(driver_module,
    ctx)`, when given, runs after set-up (the fault tests break the timed
    path with it)."""
    cell = manifest.cell(workload)
    config = manifest.config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    metrics = manifest.metrics_of(workload, trace)
    readers = {m["name"]: manifest.reader(m["name"]) for m in metrics}
    driver = importlib.import_module(
        f"{__package__}.drivers.{traffic['driver']}")

    import torch

    dev = torch.device(device)
    rec = Record()
    ctx = driver.setup(config, traffic, seed, dev, rec, trace)
    driver.run_job(ctx, rec)          # the warm job
    if patch is not None:
        patch(driver, ctx)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    rec.setup_s = time.perf_counter() - t_start

    tracer = Tracer(dev) if trace and dev.type == "cuda" else None
    if tracer:
        tracer.__enter__()
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < seconds:
        rec.job = rec.jobs
        try:
            driver.run_job(ctx, rec)
        except Exception:  # a failed job counts; the window goes on
            if not rec.counters.get("failed"):
                traceback.print_exc()
            rec.count("failed", 1)
        rec.jobs += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    rec.window = (w0, time.perf_counter())
    rec.job = -1
    if tracer:
        tracer.__exit__(None, None, None)
        rec.trace = summarize(tracer.device_events(), tracer.marker_host,
                              rec.window, rec.spans)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    values = {}
    for m in metrics:
        v = readers[m["name"]](rec)
        if v is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {m['name']} read "
                                   "nothing")
            continue
        if not math.isfinite(v):
            raise RuntimeError(f"metric {m['name']} is {v}")
        values[m["name"]] = {"value": v, "unit": m["unit"]}

    driver.release(ctx)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    compared = driver.check(ctx, rec)
    correct = (rec.counters.get("failed", 0) == 0
               and all(v <= lim for _n, v, lim in compared))
    result = {"correct": correct, "attempted": rec.jobs,
              "failed": int(rec.counters.get("failed", 0)),
              "metrics": values,
              "device": checks.device_info(dev, peak)}
    if rec.trace is not None:
        result["device"].update(busy_s=rec.trace.busy_s,
                                window_s=rec.trace.window_s)
        ops = sorted(rec.trace.kernel_s.items(), key=lambda kv: -kv[1])
        if rec.trace.transfer_s:
            ops.append(("memcpy and memset", rec.trace.transfer_s))
            ops.sort(key=lambda kv: -kv[1])
        result["breakdown"] = {
            "device_ops": [[n[:200], s] for n, s in ops[:10]],
            "idle_gaps": [[n, s] for n, s in rec.trace.idle_gaps]}
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in compared}
    return result


def main(argv, t_start: float) -> int:
    args = parse(argv)
    manifest = Manifest()
    cell = manifest.cell(args.workload)
    err = checks.card_error(cell["chips"])
    if err:
        print(err, file=sys.stderr)
        return 2
    print(f"card: {checks.card_line()}", file=sys.stderr)
    result = run_cell(manifest, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", t_start)
    found = checks.forbidden_modules(sys.modules)
    if found:
        print("modules of JAX or of the JAX package are loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
