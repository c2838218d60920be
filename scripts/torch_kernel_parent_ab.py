"""Time the K4, K5 and UPEM climb calls of two trees of floria_tpu_torch
on the same inputs, on one CUDA card.

    python3 chip_smoke.py --ab-inputs build/ab_inputs.pt
    git archive <commit> | tar -x -C build/parent
    python3 scripts/torch_kernel_parent_ab.py --parent build/parent \
        --inputs build/ab_inputs.pt [--out PATH]

The calls are those the main path makes, with their wrappers:
`kernels.upem_batch.apply_moves(assign, diff, num_reads)`, the UPEM move
function, once per UPEM iteration (in a tree where K4 takes the whole
function it is one launch; in an earlier one it is the candidates and
their sort in PyTorch ops, then the walk kernel), and
`kernels.realign.nw_best(q_packed, si, nal, ref_tab, al_tab, a_max)`, the
realignment NW (K5), and `kernels.upem_batch.upem_optimize_device(alleles,
weights, assign0, num_reads, epsilon, P, A, device=...)`, the whole UPEM
hill-climb of a dispatch (one launch of K6's climb kernel in a tree that
has it; K6 and K4 launches, 42 per climb, in an earlier one). The inputs
are the cases `chip_smoke.py --ab-inputs` saved, the ones it timed those
calls on.

Both trees hold a package of the same name, so each runs in a process of
its own (`--tree DIR --worker`), in the order parent, this tree, this
tree, parent, and each builds its own kernels under its own `build/`.
Every process times each case as the median of `--reps` calls after one
warm call, each call synchronized (host clock, as chip_smoke.py times),
takes the card's busy time per call over all of the call's kernels and
copies from torch.profiler's CUDA activity (a trace may miss launches, so
this can read low) and the time per call between two CUDA events around
`--reps` calls enqueued back to back, and reports the SHA-256 of
each result: the two trees must agree. The last line is a JSON summary
with the card's `nvidia-smi` name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def result_sha256(res) -> str:
    """SHA-256 of a result tensor, or of a tuple of them in order."""
    h = hashlib.sha256()
    for x in res if isinstance(res, tuple) else (res,):
        h.update(x.cpu().numpy().tobytes())
    return h.hexdigest()


def worker(tree: str, inputs: str, reps: int) -> dict:
    """Times the tree at `tree` on every saved case."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    from floria_tpu_torch.kernels import _build, realign, upem_batch

    for mod in (realign, upem_batch):
        if not mod.__file__.startswith(tree + os.sep):
            raise RuntimeError(f"imported {mod.__file__}, not the tree at "
                               f"{tree}")
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_parent_ab: no CUDA card")
    dev = torch.device("cuda")
    t0 = time.time()
    _build.get_lib()
    build_s = time.time() - t0

    def climb(*args):
        return upem_batch.upem_optimize_device(*args, device=dev)

    calls = {"upem_moves": upem_batch.apply_moves, "nw_best": realign.nw_best,
             "upem_optimize_device": climb}
    out = {}
    for kernel, cases in torch.load(inputs).items():
        for label, host in cases.items():
            args = [x.to(dev) if torch.is_tensor(x) else x for x in host]
            fn = lambda: calls[kernel](*args)  # noqa: E731
            res = fn()
            torch.cuda.synchronize()
            ts = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t)
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            busy_us = sum(e.time_range.end - e.time_range.start
                          for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA)
            out[f"{kernel}: {label}"] = {
                "ms": float(np.median(ts)) * 1e3, "min_ms": min(ts) * 1e3,
                "device_ms": busy_us / reps * 1e-3,
                "event_ms": start.elapsed_time(end) / reps,
                "sha256": result_sha256(res)}
    return {"tree": tree, "build_s": build_s, "reps": reps, "cases": out}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--inputs", required=True,
                    help="cases saved by chip_smoke.py --ab-inputs")
    ap.add_argument("--parent", help="the earlier tree (a git archive)")
    ap.add_argument("--tree", help="with --worker: the tree to time")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", help="also write the summary here")
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.tree, args.inputs, args.reps)),
              flush=True)
        return
    if not args.parent:
        ap.error("--parent is required")
    parent = os.path.abspath(args.parent)
    runs = []
    for tree in (parent, REPO, REPO, parent):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             "--tree", tree, "--inputs", os.path.abspath(args.inputs),
             "--reps", str(args.reps)],
            capture_output=True, text=True, cwd=tree)
        if proc.returncode != 0:
            raise SystemExit(f"worker for {tree} failed "
                             f"({proc.returncode}):\n{proc.stderr[-4000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    summary = {}
    for label in runs[0]["cases"]:
        if len({r["cases"][label]["sha256"] for r in runs}) != 1:
            raise AssertionError(f"{label}: the two trees' results differ")
        summary[label] = {
            f"{side}_{key}": [runs[i]["cases"][label][key] for i in idx]
            for side, idx in (("parent", (0, 3)), ("change", (1, 2)))
            for key in ("ms", "device_ms", "event_ms")}
    result = {"parent_ab": summary, "parent": parent, "card": card_line()}
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
