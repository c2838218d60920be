"""Block-shard scaling of the port: blocks/s of the beam dispatch at 1,
2, 4 and 8 shards, with efficiency against 1 shard (the port of
scripts/scaling_bench.py).

The workload is `make_workload(32, 128, 256)` at ploidy 3, beam width
10, through `parallel/mesh.py` `beam_search_sharded` (each shard's scan
and traceback on its device, one host thread per shard; host arrays in,
host arrays out, as the JAX script passes them). Shard k runs on card k
modulo the cards this process sees: on a one-card host every shard is
a shard of that card. --device cpu gives shards of the CPU, the JAX
script's virtual CPU mesh.

    python -m floria_tpu_torch.scripts.scaling_bench [--device cuda|cpu]
        [--shards 1,2,4,8]

One JSON line per shard count (with the card's nvidia-smi name and
power limit on a card): blocks/s over 3 calls after one warm call.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import bench
from ..device import resolve_device
from ..parallel.mesh import beam_search_sharded


def shard_mesh(n: int, dev: torch.device):
    """n shards: on a card, card k % (the process's cards) for shard k;
    on the CPU, n shards of the CPU."""
    if dev.type != "cuda":
        return [dev] * n
    cards = torch.cuda.device_count()
    return [torch.device("cuda", k % cards) for k in range(n)]


def measure(G, R, S, shards, *, device, card=None):
    """Blocks/s of make_workload(G, R, S) at P = 3 through
    beam_search_sharded at each shard count of `shards` on `device`,
    with efficiency against the first count when it is 1; one JSON line
    per count."""
    dev = resolve_device(device)
    alleles, weights, num_reads, eps = bench.make_workload(G, R, S)
    nparts = np.full(G, 3, dtype=np.int32)
    rows, base = [], None
    for n in shards:
        mesh = shard_mesh(n, dev)

        def run():
            return beam_search_sharded(mesh, alleles, weights, num_reads,
                                       eps, nparts, 3, bench.BEAM_WIDTH)

        run()
        iters = 3
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        per = (time.perf_counter() - t0) / iters
        blocks_per_s = G / per
        if n == 1:
            base = blocks_per_s
        row = {"shards": n, "cards_used": len(set(mesh)),
               "G": G, "R": R, "S": S, "call_s": per,
               "blocks_per_sec": blocks_per_s,
               "efficiency": (None if base is None
                              else blocks_per_s / (base * n)),
               "device": str(dev)}
        if card is not None:
            row["card"] = card
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m floria_tpu_torch.scripts.scaling_bench")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain path)")
    ap.add_argument("--shards", default="1,2,4,8")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = bench.nvidia_smi_line() if dev.type == "cuda" else None
    print(json.dumps({"device": str(dev), "cards": (
        torch.cuda.device_count() if dev.type == "cuda" else 0),
        "card": card}), flush=True)
    return measure(32, 128, 256, [int(x) for x in args.shards.split(",")],
                   device=dev, card=card)


if __name__ == "__main__":
    main()
