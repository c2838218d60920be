"""Roofline accounting for K1 (`csrc/beam_scan.cu`, the mixed-ploidy
beam dispatch of `floria_tpu_torch.bench`): the port of scripts/mfu.py.

It prints a model table (per block phased at ploidies 2..5: the
operations and bytes below, from `make_workload`'s shapes), then
measures the mixed dispatch at several batch sizes G: G in {32, 64,
128} at R = S = 256 and G in {8, 16, 32} at R = 320, S = 2048, one
warm call and 3 timed calls, each ending in the pull of the scores.
Each row gives seconds per sweep, reads/s, operations/s and bytes/s,
and on a card their share of the H100's published peaks (3.35 TB/s of
HBM; 67 T/s, its f32 rate outside the tensor cores, for the scalar
integer operations) beside the card's nvidia-smi name and power limit.

Two operation counts stand side by side; which one a benchmark's
roofline uses is not settled here.

  * The bound (`floria_tpu_torch.bench.k1_cost`, the count chip_smoke.py
    states K1's `bound_ms` with): per (active part, covered column) of
    each real read one comparison and one addition against ONE slot,
    i.e. 2 * sum over reads of covered columns * parts. Its share is
    `bound_share` = bound_ms / measured ms, where bound_ms is the larger
    of bytes / 3.35 TB/s and these operations / 67 T/s.
  * The work (`k1_work`): what the beam algorithm does per scan step
    over scripts/mfu.py's step structure (T1 = 25: P * W live slots in
    and out for the first T1 reads, P * W in and W out at read T1, then
    W in and out). For a step with B slots in, `out` slots out, P parts
    and c covered columns of the read (n = B * P candidates):
      scoring   2 * n * c   (each slot x part x covered column: compare
                             the read's allele, add its weight)
      prune     4 * n       (the binomial tail's compare, the log-sum-exp
                             posterior's exp and add, the cutoff compare)
      dedup     3 * n       (two fingerprint mixes, one compare)
      select    n * ceil(log2(out))  (rank-select of the out best)
      update    out * c     (the chosen part's counts += the read)
    Its rate is `work_ops_per_sec` and its share of 67 T/s
    `work_share_of_scalar_peak`.
  Bytes, for both: each input read once and each output written once
  (`k1_cost`): alleles (1 B) and weights (4 B) over each read's covered
  span, 24 B per instance, the parent / part records, scores, live flags
  and assignments.

The JAX script's cost model counted the TPU planes implementation (a
one-hot permutation matmul per step and re-reads of the count planes);
K1 keeps one int64 count state and does neither, so that model does not
apply to the port.

    python -m floria_tpu_torch.scripts.mfu [--model] [--device cuda|cpu]

--model prints the table only; --device cpu runs the plain path and
reports no peak share.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np

from .. import bench
from ..device import resolve_device

T1 = 25
CONFIGS = ((256, 256, (32, 64, 128)), (320, 2048, (8, 16, 32)))


def step_ops(B: int, P: int, c, out: int):
    """The work of one scan step (module docstring): B slots in, `out`
    slots out, P parts, c covered columns of the read (a number or an
    array of them)."""
    n = B * P
    return (2 * n * c + 4 * n + 3 * n + n * math.ceil(math.log2(out))
            + out * c)


def k1_work(al, nr, npt, W: int) -> int:
    """The beam algorithm's operations over a dispatch (module
    docstring): alleles [G, R, S], num_reads [G] and num_parts [G]
    tensors, beam width W; reads past num_reads do nothing."""
    cov = (al >= 0).sum(-1).cpu().numpy().astype(np.int64)
    total = 0
    for g, (n_g, P) in enumerate(zip(nr.tolist(), npt.tolist())):
        c = cov[g, :n_g]
        warm = min(T1, n_g)
        total += int(step_ops(P * W, P, c[:warm], P * W).sum())
        if n_g > T1:
            total += int(step_ops(P * W, P, c[T1:T1 + 1], W).sum())
            total += int(step_ops(W, P, c[T1 + 1:], W).sum())
    return total


def dispatch_costs(args, device):
    """(the mixed dispatch's inputs on `device`, its bytes, bound ops,
    work ops) for make_workload's `args`."""
    inputs = bench.kernel_inputs(args, device)
    al, _wt, nr, _ep, npt = inputs
    nbytes, ops = bench.k1_cost(al, nr, npt, max(bench.PLOIDIES),
                                bench.BEAM_WIDTH)
    return inputs, nbytes, ops, k1_work(al, nr, npt, bench.BEAM_WIDTH)


def model_table():
    """Per (R, S) of CONFIGS, one block phased at ploidies 2..5: work
    and bound operations, bytes and work per byte."""
    rows = []
    for R, S, _gl in CONFIGS:
        _inp, nbytes, ops, work = dispatch_costs(
            bench.make_workload(1, R, S), "cpu")
        rows.append({"R": R, "S": S,
                     "sweep_work_gops_per_block": work / 1e9,
                     "sweep_bound_gops_per_block": ops / 1e9,
                     "sweep_mb_per_block": nbytes / 1e6,
                     "work_ops_per_byte": work / nbytes})
    return rows


def measure(G_list, R, S, *, device, card=None):
    """Seconds per mixed dispatch at each G of `G_list` (make_workload(G,
    R, S), ploidies 2..5 in one dispatch) on `device`, with its rates;
    one JSON line per row. Peak shares only on a card."""
    dev = resolve_device(device)
    out = []
    for G in G_list:
        inputs, nbytes, ops, work = dispatch_costs(
            bench.make_workload(G, R, S), dev)

        def sweep():
            bench.kernel_dispatch(inputs, device=dev).scores.cpu()

        sweep()
        iters = 3
        t0 = time.perf_counter()
        for _ in range(iters):
            sweep()
        dt = (time.perf_counter() - t0) / iters
        row = {"G": G, "R": R, "S": S, "device": str(dev),
               "sweep_s": dt,
               "reads_per_sec": G * R * len(bench.PLOIDIES) / dt,
               "bytes": nbytes, "bound_ops": ops, "work_ops": work,
               "bytes_per_sec": nbytes / dt,
               "bound_ops_per_sec": ops / dt,
               "work_ops_per_sec": work / dt}
        if dev.type == "cuda":
            bound_ms, bound_by = bench.bound(nbytes, ops)
            row.update(
                bound_ms=bound_ms, bound_by=bound_by,
                bound_share=bound_ms / (dt * 1e3),
                hbm_share=nbytes / dt / bench.HBM_BYTES_PER_S,
                work_share_of_scalar_peak=(work / dt
                                           / bench.SCALAR_OPS_PER_S),
                card=card)
        out.append(row)
        print(json.dumps(row), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m floria_tpu_torch.scripts.mfu")
    ap.add_argument("--model", action="store_true",
                    help="print the model table only")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain path)")
    args = ap.parse_args(argv)
    print(json.dumps({"model": model_table()}), flush=True)
    if args.model:
        return []
    dev = resolve_device(args.device)
    card = bench.nvidia_smi_line() if dev.type == "cuda" else None
    rows = []
    for R, S, gl in CONFIGS:
        rows += measure(gl, R, S, device=dev, card=card)
    return rows


if __name__ == "__main__":
    main()
