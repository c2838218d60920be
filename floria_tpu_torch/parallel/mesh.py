"""Block meshes and sharded block phasing on torch (port of
floria_tpu/parallel/mesh.py).

SNP-block instances are independent until the hap-graph join, so a batch
of them splits into contiguous shards, one per device of a "mesh": an
ordered list of torch devices, repeats allowed. Each shard runs its
whole chain on its device, on its own host thread, so every device is
busy before any result is pulled. The only cross-shard step is the
join's: gathering the per-block assignments and summing the best
scores, which in one process are a concatenation and a sum in shard
order (the reference's all_gather and psum over the mesh).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import constants
from ..device import resolve_device
from ..kernels import beam as beam_kernel


def make_block_mesh(num_devices: Optional[int] = None, *, device
                    ) -> List[torch.device]:
    """The devices block batches shard over, in shard order.

    `device` "cuda" (no card named) gives this process's cards
    cuda:0..n-1 with n = min(torch.cuda.device_count(), num_devices or
    all), as the reference clamps to the local devices; when n is 1 the
    mesh is `device` itself. A device that names its card ("cuda:1") is
    a mesh of that card alone. "cpu" gives `num_devices` (default 1)
    shards of the one CPU device, the analog of XLA's virtual host
    devices. A list of devices is a mesh already (repeats put several
    shards on one card) and is cut to its first `num_devices`."""
    if isinstance(device, (list, tuple)):
        mesh = [resolve_device(d) for d in device]
        return mesh if num_devices is None else mesh[:max(1, num_devices)]
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * max(1, num_devices or 1)
    if dev.index is not None:
        return [dev]
    n = torch.cuda.device_count()
    if num_devices is not None:
        n = min(n, num_devices)
    if n <= 1:
        return [dev]
    return [torch.device("cuda", i) for i in range(n)]


def shard_bounds(G: int, n: int) -> List[Tuple[int, int]]:
    """[lo, hi) of each of n contiguous shards of G instances: the split
    shard_map makes of a batch padded to a multiple of n, without the
    padding (trailing shards may be empty)."""
    per = -(-G // n)
    return [(min(k * per, G), min((k + 1) * per, G)) for k in range(n)]


def run_on_shards(fn, items: Sequence) -> list:
    """[fn(item) for item in items], one host thread per item, results in
    item order; an exception of any item is raised here."""
    if len(items) <= 1:
        return [fn(it) for it in items]
    with ThreadPoolExecutor(max_workers=len(items)) as pool:
        futures = [pool.submit(fn, it) for it in items]
        return [f.result() for f in futures]


def _shards(mesh, G: int):
    return [(dev, lo, hi) for dev, (lo, hi)
            in zip(mesh, shard_bounds(G, len(mesh))) if hi > lo]


def beam_search_sharded(mesh, alleles, weights, num_reads, epsilon,
                        num_parts, max_ploidy: int, beam_width: int,
                        window: int = 0, max_alleles: Optional[int] = None
                        ) -> Tuple[beam_kernel.BeamResult, np.ndarray]:
    """Beam-search a batch of block instances sharded over `mesh`.

    The batch axis splits into len(mesh) contiguous shards; each shard
    runs the beam scan and traceback (K1 on a card) on its device. Returns
    the host results in batch order: a BeamResult of numpy arrays (the
    reference's six outputs) and the [G, R] traceback assignments.

    The twin of the reference's API; the port's sweep does not call it:
    phase/local.py `_sweep_launch` splits each dispatch over the mesh
    itself and keeps the beam result on each shard's device for UPEM."""
    if max_alleles is None:
        max_alleles = constants.MAX_ALLELES

    def one(shard):
        dev, lo, hi = shard
        return beam_kernel.beam_search_traceback(
            alleles[lo:hi], weights[lo:hi], num_reads[lo:hi],
            epsilon[lo:hi], num_parts[lo:hi], max_ploidy, beam_width,
            max_alleles, window, device=dev)

    outs = run_on_shards(one, _shards(mesh, alleles.shape[0]))
    result = beam_kernel.BeamResult(*(
        torch.cat([res[i].cpu() for res, _a in outs]).numpy()
        for i in range(len(beam_kernel.BeamResult._fields))))
    return result, torch.cat([a.cpu() for _r, a in outs]).numpy()


def training_step_sharded(mesh, ploidy: int, beam_width: int):
    """The sharded phasing step: each shard phases its block instances
    and traces back each block's best beam on its device; then the
    per-block assignments are gathered and the best scores summed over
    the mesh (the data the hap-graph join consumes).

    Returns fn(alleles, weights, num_reads, epsilon) -> (assignments
    [G, R] int32 numpy, total of the best final scores as a float)."""

    def one(shard, alleles, weights, num_reads, epsilon):
        dev, lo, hi = shard
        nparts = np.full(hi - lo, ploidy, np.int32)
        res, assign = beam_kernel.beam_search_traceback(
            alleles[lo:hi], weights[lo:hi], num_reads[lo:hi],
            epsilon[lo:hi], nparts, ploidy, beam_width, device=dev)
        best = torch.where(res.live, res.scores, float("inf")).min(
            dim=1).values
        best = torch.where(torch.isfinite(best), best, 0.0)
        return assign.to(torch.int32), best.sum()

    def step(alleles, weights, num_reads, epsilon):
        outs = run_on_shards(
            lambda s: one(s, alleles, weights, num_reads, epsilon),
            _shards(mesh, alleles.shape[0]))
        assigns = torch.cat([a.cpu() for a, _s in outs]).numpy()
        return assigns, sum(float(s) for _a, s in outs)

    return step
