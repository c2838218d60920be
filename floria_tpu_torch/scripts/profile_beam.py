"""Per-step cost of the port's mixed-ploidy beam dispatch (K1 on a
card) across batch size G, sites S and window (the port of
scripts/profile_beam.py; the JAX script's `impl` axis is gone: the port
has one exact state).

Each point phases make_workload(G, R, S) in one dispatch at ploidies 2,
3, 4 and 5 (a quarter of the blocks each, as phase_instances mixes
them), beam width 10, inputs on the device; one first call (it builds
the kernels if they are not built), then 3 timed calls, each ending in
the pull of the scores. The default grid: G 32 and 128 at S = 256; G 32
without dedup; S 512 and 1024, each at full width and at a window of
S/2 + 128 columns, the least that holds make_workload's reads (S/2 long,
128-aligned starts): the JAX grid's 512-column window at S = 1024 cuts
them, and K1 takes no window that cuts a read.

    python -m floria_tpu_torch.scripts.profile_beam [--device cuda|cpu]
        [--point G,S,WINDOW[,nodedup]] ...

One JSON line per point (with the card's nvidia-smi name and power
limit on a card): ms per sweep, ms per scan step (sweep / R), reads/s.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import bench
from ..device import resolve_device
from ..kernels import beam

R = 256
# (G, S, window, dedup)
GRID = ((32, 256, 0, True), (128, 256, 0, True), (32, 256, 0, False),
        (32, 512, 0, True), (32, 512, 384, True), (32, 1024, 0, True),
        (32, 1024, 640, True))


def run_case(G, R, S, window, iters=3, dedup=True, *, device, card=None):
    """One grid point on `device`: returns (and prints) its record."""
    dev = resolve_device(device)
    alleles, weights, num_reads, eps = bench.make_workload(G, R, S)
    nparts = np.full(G, 5, dtype=np.int32)
    nparts[: G // 4] = 2
    nparts[G // 4: G // 2] = 3
    nparts[G // 2: 3 * G // 4] = 4
    inputs = [torch.from_numpy(a).to(dev)
              for a in (alleles, weights, num_reads, eps, nparts)]

    def sweep():
        out = beam.beam_search_batch_mixed(*inputs, 5, bench.BEAM_WIDTH,
                                           window=window, dedup=dedup,
                                           device=dev)
        out.scores.cpu()

    t0 = time.perf_counter()
    sweep()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        sweep()
    per = (time.perf_counter() - t0) / iters
    rec = {"G": G, "R": R, "S": S, "window": window, "dedup": dedup,
           "device": str(dev), "first_call_s": first_s,
           "ms_per_sweep": per * 1e3, "ms_per_step": per / R * 1e3,
           "reads_per_sec": G * R / per}
    if card is not None:
        rec["card"] = card
    print(json.dumps(rec), flush=True)
    return rec


def _point(text):
    f = text.split(",")
    if len(f) not in (3, 4) or (len(f) == 4 and f[3] != "nodedup"):
        raise argparse.ArgumentTypeError("G,S,WINDOW[,nodedup]")
    return int(f[0]), int(f[1]), int(f[2]), len(f) == 3


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m floria_tpu_torch.scripts.profile_beam")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain path)")
    ap.add_argument("--point", type=_point, action="append",
                    help="G,S,WINDOW[,nodedup] (repeatable; default: the "
                    "grid in the module docstring)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = bench.nvidia_smi_line() if dev.type == "cuda" else None
    return [run_case(G, R, S, window, dedup=dedup, device=dev, card=card)
            for G, S, window, dedup in (args.point or GRID)]


if __name__ == "__main__":
    main()
