"""Harness entry points of the port (twins of the repository's
__graft_entry__.py): a one-device forward step of the beam kernel and a
multi-device dry run of the production phasing dispatch.

Both take their device explicitly: a device, or a block mesh (a list of
devices, repeats allowed, so the dry run also runs on one card with
several shards)."""

from __future__ import annotations

import numpy as np

from .frag import phred_weight
from .kernels import beam as beam_kernel
from .kernels.blocktensor import BlockTensor
from .options import Options
from .parallel.mesh import make_block_mesh, training_step_sharded
from .phase.local import adaptive_sweep


def entry(*, device):
    """(fn, example_args): one batched beam-search phasing pass over
    block instances on `device`; fn(*example_args) is the BeamResult."""
    G, R, S = 4, 32, 64
    ploidy, beam_width = 3, 10
    rng = np.random.default_rng(0)
    alleles = rng.integers(-1, 2, (G, R, S)).astype(np.int8)
    weights = np.where(alleles >= 0, 0.99, 0.0).astype(np.float32)
    num_reads = np.full(G, R, dtype=np.int32)
    epsilon = np.full(G, 0.02, dtype=np.float32)
    num_parts = np.full(G, ploidy, dtype=np.int32)

    def fn(alleles, weights, num_reads, epsilon):
        return beam_kernel.beam_search_batch_mixed(
            alleles, weights, num_reads, epsilon, num_parts, ploidy,
            beam_width, device=device)

    return fn, (alleles, weights, num_reads, epsilon)


def _synth_blocks(n_blocks, R, S, max_ploidy, seed=1):
    """Realistic-shape synthetic BlockTensors: per-block random strain
    count (1..max_ploidy), half-block read spans, phred-20 quals."""
    rng = np.random.default_rng(seed)
    blocks = []
    for j in range(n_blocks):
        k = int(rng.integers(1, max_ploidy + 1))
        strains = rng.integers(0, 2, (k, S))
        nr = int(rng.integers(R // 2, R + 1))
        span = S // 2
        alleles = np.full((R, S), -1, dtype=np.int8)
        quals = np.zeros((R, S), dtype=np.uint8)
        starts = np.sort(rng.integers(0, S - span, nr))
        for r in range(nr):
            s0 = starts[r]
            hap = strains[rng.integers(0, k), s0:s0 + span].copy()
            err = rng.random(span) < 0.02
            hap[err] = 1 - hap[err]
            alleles[r, s0:s0 + span] = hap.astype(np.int8)
            quals[r, s0:s0 + span] = 20
        blocks.append((j, BlockTensor(
            frag_ids=np.arange(nr, dtype=np.int64), lo=1, num_sites=S,
            num_reads=nr, alleles=alleles,
            weights=phred_weight(quals), snp_range=(1, S),
            quals=quals)))
    return blocks


def dryrun_multichip(n_devices: int, *, device) -> None:
    """Run the production phasing dispatch over an n_devices-shard block
    mesh at a real block shape: the adaptive mixed-ploidy sweep (each
    level's dispatches split over the shards, every shard's beam -> UPEM
    chain on its device), then the sharded step's gathered assignments
    and summed scores. Raises on any inconsistency."""
    mesh = make_block_mesh(n_devices, device=device)
    if len(mesh) < n_devices:
        raise ValueError(f"wanted {n_devices} shards, the mesh has "
                         f"{len(mesh)}: {mesh}")

    # A mid-size long-read block bucket (real ones span R 64..320, S
    # 512..2048).
    R, S = 128, 768
    max_p = 3
    blocks = _synth_blocks(2 * n_devices, R, S, max_p)
    options = Options(epsilon=0.02, max_ploidy=max_p)
    chosen, mec_vec, _exp = adaptive_sweep(blocks, options, device=mesh)
    if len(chosen) != len(blocks):
        raise AssertionError(f"{len(chosen)} of {len(blocks)} blocks "
                             "decided")
    for j, bt in blocks:
        best, assign = chosen[j]
        if not (1 <= best <= max_p and assign.shape == (bt.num_reads,)
                and 0 <= int(assign.min()) and int(assign.max()) < best
                and np.isfinite(mec_vec[j][:best]).all()):
            raise AssertionError(f"block {j}: ploidy {best}, assignment "
                                 f"{assign.shape}, MEC {mec_vec[j]}")

    ploidy, beam_width = 2, 4
    G, R2, S2 = 2 * n_devices, 8, 64
    rng = np.random.default_rng(1)
    alleles = rng.integers(-1, 2, (G, R2, S2)).astype(np.int8)
    weights = np.where(alleles >= 0, 0.99, 0.0).astype(np.float32)
    num_reads = np.full(G, R2, dtype=np.int32)
    epsilon = np.full(G, 0.02, dtype=np.float32)
    step = training_step_sharded(mesh, ploidy, beam_width)
    assigns, total = step(alleles, weights, num_reads, epsilon)
    if assigns.shape != (G, R2) or not np.isfinite(total):
        raise AssertionError(f"sharded step: assignments {assigns.shape}, "
                             f"total {total}")
