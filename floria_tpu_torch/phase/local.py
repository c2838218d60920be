"""Local phasing engine: the adaptive per-block ploidy sweep on torch.

Port of floria_tpu/phase/local.py's main path (phase_contigs_blocks ->
adaptive_sweep -> _sweep_launch/_sweep_pull). Every (block, ploidy)
instance of a contig group runs as shape-bucketed batches on one device,
or split over the shards of a block mesh (parallel/mesh.py); each sweep
level is one chain per bucket: gather -> weights -> beam scan +
traceback (K1) -> UPEM hill-climb (K6 and K4) -> unit-weight MEC stats
(K6). On a card a level's chains are enqueued without a host wait
(`_sweep_launch`: uploads from pinned memory, windows checked on the
host) and pulled once per level and device (`_sweep_pull`), as the
reference launches each level's jitted chains asynchronously and waits
in its pull. The stopping rules replay on the host, level by level, so
the chosen ploidies and partitions equal the reference's sequential
early exit (graph_processing.rs:198-252).

The pure helpers below are copies of the reference's (which cannot be
imported: its module pulls in jax).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import constants, state, timing
from ..device import check_no_tf32, resolve_device, to_host, upload
from ..kernels import beam as beam_kernel
from ..kernels.blocktensor import BlockTensor, pack_block, round_up
from ..kernels.upem_batch import upem_eval, upem_optimize_device
from ..options import Options
from ..parallel.mesh import make_block_mesh, run_on_shards, shard_bounds
from .blocks import (find_reads_in_interval, get_range_with_lengths,
                     interval_bounds)

log = logging.getLogger("floria_tpu")

# Per-dispatch batch budget in read-site cells. K1 runs one CTA per
# instance, so the batch must be wide enough to fill the card's 132
# SMs: 1 << 26 cells is G = 102 at the real R = 320, S = 2048 bucket.
# FLORIA_SWEEP_CAP_CELLS > --sweep-cap N > this default. Chunking is
# output-invariant (tests/test_torch_sweep.py).
_SWEEP_CAP_CELLS = 1 << 26


@dataclasses.dataclass
class LocalBlockResult:
    """Chosen partition of one block."""
    block_index: int
    snp_range: Tuple[int, int]
    best_ploidy: int
    part_frag_ids: List[np.ndarray]
    mec_vector: np.ndarray


def mec_threshold(ploidy: int, epsilon: float, sensitivity: int) -> float:
    """MEC-ratio stopping threshold (graph_processing.rs:205-222)."""
    if sensitivity == 1:
        denom = 1.0 + 1.0 / (ploidy ** 0.5 + 1.0)
    elif sensitivity == 2:
        denom = 1.0 + 1.0 / (ploidy ** 1.0 + 1.0 / 3.0)
    else:
        denom = 1.0 + 1.0 / (ploidy ** 1.0 + 1.0)
    return 1.0 / (1.0 - epsilon) / denom


def pick_best_ploidy(mec_vector: np.ndarray, expected_errors: np.ndarray,
                     options: Options) -> int:
    """Replay of the sweep's stopping logic (graph_processing.rs:198-252)."""
    max_ploidy = len(mec_vector)
    best = 1
    for ploidy in range(1, max_ploidy + 1):
        best = ploidy
        m = mec_vector[ploidy - 1]
        if ploidy > 1:
            prev = mec_vector[ploidy - 2]
            with np.errstate(divide="ignore", invalid="ignore"):
                ratio = m / prev  # inf or nan on zero, like Rust f64
            threshold = mec_threshold(ploidy, options.epsilon,
                                      options.ploidy_sensitivity)
            if not (ratio < threshold):  # nan compares False, like Rust
                if options.stopping_heuristic:
                    best = ploidy - 1
                    break
        if m < expected_errors[ploidy - 1]:
            break
    return best


def _sweep_decide(mec_vector: np.ndarray, expected_errors: np.ndarray,
                  ploidy: int, options: Options) -> Tuple[bool, int]:
    """One level of pick_best_ploidy's walk: (decided, best)."""
    max_ploidy = len(mec_vector)
    m = mec_vector[ploidy - 1]
    if ploidy > 1:
        prev = mec_vector[ploidy - 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = m / prev
        threshold = mec_threshold(ploidy, options.epsilon,
                                  options.ploidy_sensitivity)
        if not (ratio < threshold):
            if options.stopping_heuristic:
                return True, ploidy - 1
    if m < expected_errors[ploidy - 1]:
        return True, ploidy
    if ploidy == max_ploidy:
        return True, ploidy
    return False, ploidy


def _sweep_cap_cells(options: Optional[Options] = None) -> int:
    v = os.environ.get("FLORIA_SWEEP_CAP_CELLS")
    if v and v.strip():
        try:
            return int(v)
        except ValueError:
            raise ValueError(
                f"FLORIA_SWEEP_CAP_CELLS must be an integer "
                f"(read-site cells per dispatch), got {v!r}") from None
    cap = getattr(options, "sweep_cap", "auto") if options else "auto"
    if cap != "auto":
        return int(cap)
    return _SWEEP_CAP_CELLS


def _bucket_reads(r: int) -> int:
    """Power-of-two below 128, then 64-multiples."""
    if r <= 128:
        return max(16, 1 << (r - 1).bit_length())
    return round_up(r, 64)


def _bucket_sites(s: int) -> int:
    """Coarse site buckets."""
    s = max(s, 64)
    if s <= 256:
        return round_up(s, 128)
    if s <= 1024:
        return round_up(s, 256)
    return round_up(s, 512)


def phase_contigs_blocks(per_contig, options: Options, *, device
                         ) -> Dict[object, List[LocalBlockResult]]:
    """Phase the SNP blocks of many contigs in shared device batches.

    per_contig: [(contig_key, sorted frozen frags, snp_to_genome_pos,
    debug_dir or None)]."""
    blocks: List[Tuple[Tuple[int, int], BlockTensor]] = []
    contig_frags = {}
    for ci, (ckey, frags, snp_to_genome_pos, _dbg) in enumerate(
            per_contig):
        contig_frags[ci] = frags
        ranges = get_range_with_lengths(
            snp_to_genome_pos, options.block_length,
            options.block_length // 3, options.snp_density)
        bounds = interval_bounds(frags)
        for j, rng in enumerate(ranges):
            reads = find_reads_in_interval(rng[0], rng[1], frags,
                                           bounds=bounds)
            bt = pack_block(reads, rng)
            if bt is not None:
                blocks.append(((ci, j), bt))
    out: Dict[object, List[LocalBlockResult]] = {
        ckey: [] for ckey, *_rest in per_contig}
    if not blocks:
        return out

    chosen, mec_vec, _exp_vec = adaptive_sweep(blocks, options,
                                               device=device)

    for (ci, j), bt in blocks:
        ckey = per_contig[ci][0]
        debug_dir = per_contig[ci][3]
        best_ploidy, assignment = chosen[(ci, j)]
        part_ids = [bt.frag_ids[assignment == p]
                    for p in range(best_ploidy)]
        out[ckey].append(LocalBlockResult(
            block_index=j, snp_range=bt.snp_range,
            best_ploidy=best_ploidy, part_frag_ids=part_ids,
            mec_vector=mec_vec[(ci, j)]))
        if debug_dir is not None:
            _dump_local_parts(debug_dir, j, bt, part_ids, best_ploidy,
                              contig_frags[ci])
    return out


def adaptive_sweep(blocks, options: Options,
                   cache: Optional["BlockDeviceCache"] = None, *,
                   device):
    """The production ploidy sweep over [(key, BlockTensor)]: level-wise
    chained beam -> UPEM waves with host-side stopping-rule replay.
    Levels 1 and 2 run as one fused wave (level 1 is a near-free MEC
    evaluation and almost every block proceeds to 2); the replay still
    walks level by level, so decisions and outputs equal the sequential
    schedule's.

    `device` is a device or a block mesh (parallel/mesh.py
    make_block_mesh, which also reads options.num_devices). Each device
    of the mesh holds its own BlockDeviceCache (`cache`, when given, is
    the one of its device); shards on one device share it, as it is only
    read.

    Returns ({key: (best_ploidy, assignment)}, {key: mec_vector},
    {key: expected_errors})."""
    sweep_t = time.time()
    mesh = make_block_mesh(options.num_devices, device=device)
    caches = {} if cache is None else {cache.device: cache}
    for dev in mesh:
        if dev not in caches:
            caches[dev] = BlockDeviceCache(blocks, device=dev)
    max_p = options.max_ploidy
    mec_vec = {key: np.zeros(max_p) for key, _bt in blocks}
    exp_vec = {key: np.zeros(max_p) for key, _bt in blocks}
    chosen: Dict[object, Tuple[int, np.ndarray]] = {}
    prev_assign: Dict[object, np.ndarray] = {}
    active = blocks
    if max_p >= 2:
        schedule = [(1, 2)] + list(range(3, max_p + 1))
    else:
        schedule = list(range(1, max_p + 1))
    for entry in schedule:
        if not active:
            break
        lvl_t = time.time()
        pending = _sweep_launch(active, options, mesh, caches, [entry])
        levels = entry if isinstance(entry, tuple) else (entry,)
        launch_s = time.time() - lvl_t
        refined_p, stats_p = _sweep_pull(pending)
        log.debug("sweep level %s: %d blocks, launch %.2fs, "
                  "exec+pull %.2fs", entry, len(active), launch_s,
                  time.time() - lvl_t - launch_s)
        next_active = []
        for key, bt in active:
            undecided = True
            for ploidy in levels:
                good, bad = stats_p[(key, ploidy)]
                mec_vec[key][ploidy - 1] = bad
                exp_vec[key][ploidy - 1] = (good + bad) * options.epsilon
                decided, best = _sweep_decide(mec_vec[key], exp_vec[key],
                                              ploidy, options)
                if decided:
                    a = (refined_p[(key, ploidy)] if best == ploidy
                         else prev_assign[key])
                    chosen[key] = (best, a)
                    undecided = False
                    break
                prev_assign[key] = refined_p[(key, ploidy)]
            if undecided:
                next_active.append((key, bt))
        active = next_active
    log.info("Beam search: %d blocks, adaptive chained sweep <= %d in "
             "%.2fs", len(blocks), max_p, time.time() - sweep_t)
    return chosen, mec_vec, exp_vec


def _dump_local_parts(debug_dir: str, j: int, bt: BlockTensor, part_ids,
                      best_ploidy: int, frags) -> None:
    """Per-block partition dump at debug level
    (graph_processing.rs:289-300)."""
    os.makedirs(debug_dir, exist_ok=True)
    name = f"{j}-0-{bt.snp_range[0]}-{best_ploidy}"
    with open(os.path.join(debug_dir, name), "w") as f:
        for p, ids in enumerate(part_ids):
            f.write(f"#{p}\n")
            for fid in ids:
                fr = frags[int(fid)]
                f.write(f"{fr.id}\t{fr.first_position}\t"
                        f"{fr.last_position}\n")


class BlockDeviceCache:
    """Unique block tensors resident on the device, bucketed by padded
    shape: int8 alleles + uint8 quals (2 B/cell), uploaded once per
    contig group; weights are rebuilt per dispatch by table lookup."""

    def __init__(self, blocks: List[Tuple[object, BlockTensor]], *,
                 device):
        self.device = resolve_device(device)
        up_t = time.time()
        buckets: Dict[Tuple[int, int],
                      List[Tuple[object, BlockTensor]]] = {}
        for j, bt in blocks:
            key = (_bucket_reads(bt.num_reads),
                   _bucket_sites(bt.num_sites))
            buckets.setdefault(key, []).append((j, bt))
        self.rows: Dict[object, int] = {}
        self.dev: Dict[Tuple[int, int], Tuple[torch.Tensor,
                                              torch.Tensor]] = {}
        # Actual allele-value width per bucket (2 on biallelic data):
        # absent alleles' count planes are identically zero.
        self.amax: Dict[Tuple[int, int], int] = {}
        self.phred = torch.from_numpy(state.phred_table()).to(self.device)
        for (r_pad, s_pad), members in buckets.items():
            B = len(members)
            alleles = np.full((B, r_pad, s_pad), -1, dtype=np.int8)
            quals = np.zeros((B, r_pad, s_pad), dtype=np.uint8)
            for b, (j, bt) in enumerate(members):
                r, s = bt.alleles.shape
                alleles[b, :r, :s] = bt.alleles
                quals[b, :r, :s] = bt.quals
                self.rows[j] = b
            self.amax[(r_pad, s_pad)] = min(
                constants.MAX_ALLELES, max(2, int(alleles.max()) + 1))
            self.dev[(r_pad, s_pad)] = (
                torch.from_numpy(alleles).to(self.device),
                torch.from_numpy(quals).to(self.device))
        timing.add("beam.cache_upload", time.time() - up_t)

    def gather(self, key: Tuple[int, int], block_ids: List[object]):
        """[G, r_pad, s_pad] (alleles, weights) for the given blocks, in
        order (duplicates fine)."""
        dev_a, dev_q = self.dev[key]
        idx = upload(np.array([self.rows[j] for j in block_ids], np.int64),
                     self.device)
        return (dev_a.index_select(0, idx).contiguous(),
                beam_kernel.quals_to_weights(dev_q.index_select(0, idx),
                                             self.phred).contiguous())


def _sweep_chain(cache: BlockDeviceCache, key, ids, nreads, eps,
                 ploidy: int, beam_width: int, window: int,
                 max_alleles: int, fused12: bool = False):
    """One sweep level for one dispatch: gather -> weights -> beam +
    traceback -> UPEM -> MEC. Level 1 reduces exactly to the MEC stats
    of the everything-in-part-0 partition (UPEM needs >= 2 parts to
    move). fused12 (ploidy 2) also returns level 1's stats. On a card it
    only enqueues: its windows were checked on the host
    (`_sweep_launch`)."""
    dev = cache.device
    alleles, weights = cache.gather(key, ids)
    nr = upload(nreads, dev)
    ep = upload(eps, dev)
    zeros = torch.zeros(alleles.shape[:2], dtype=torch.int32, device=dev)
    if ploidy == 1:
        return zeros, upem_eval("mec", alleles, weights, zeros, ep, 1,
                                max_alleles)
    nparts = torch.full((alleles.shape[0],), ploidy, dtype=torch.int32,
                        device=dev)
    _result, assigns = beam_kernel.beam_search_traceback(
        alleles, weights, nr, ep, nparts, ploidy, beam_width,
        max_alleles=max_alleles, window=window, device=dev,
        check_windows=False)
    best, mec, _diff = upem_optimize_device(
        alleles, weights, assigns.to(torch.int32), nr, ep, ploidy,
        max_alleles=max_alleles, device=dev)
    if fused12:
        return best, (upem_eval("mec", alleles, weights, zeros, ep, 1,
                                max_alleles), mec)
    return best, mec


def _dispatch_window(chunk, s_pad: int) -> int:
    """The sliding compute window of one dispatch of `chunk`'s blocks at
    s_pad columns, the reference's policy: round_up(span + 128, 256) for
    the chunk's longest read span (BlockTensor.max_read_span), only for
    a >= 4x shrink of the site axis, else 0 (full width). A window is
    checked on the host, block by block, to hold every read, as K1
    requires (`beam_kernel.check_windows_host`)."""
    cols = [beam_kernel.read_columns(bt.alleles, bt.num_reads)
            for _j, bt in chunk]
    span = max(int((last - first)[last >= 0].max(initial=0)) + 1
               for first, last in cols)
    window = round_up(span + 128, 256)
    if window * 4 > s_pad:
        return 0
    for first, last in cols:
        beam_kernel.check_windows_host(first, last, s_pad, window)
    return window


def _sweep_launch(blocks, options: Options, mesh: List[torch.device],
                  caches: Dict[torch.device, BlockDeviceCache],
                  ploidies) -> list:
    """Enqueue one wave of chained beam -> UPEM dispatches for every
    (block, ploidy in ploidies) instance, per shape bucket, in chunks of
    the dispatch cap. On a card nothing here waits for it: the results
    stay on the device until _sweep_pull, and `phase.launch` times the
    enqueueing only. Each dispatch's windows are checked on the host,
    from its blocks, before anything is enqueued.

    Over a mesh of more than one shard, each dispatch's batch splits into
    len(mesh) contiguous shards (parallel/mesh.py shard_bounds) and each
    shard's whole chain runs on its device, all shards' chains on their
    own host threads at once. The reference pulls the sharded beam to the
    host and runs UPEM on the default device; instances are independent,
    so the outputs are the same (tests/test_torch_parallel.py)."""
    check_no_tf32()
    groups: Dict[Tuple[int, int], List[Tuple[object, BlockTensor]]] = {}
    for j, bt in blocks:
        key = (_bucket_reads(bt.num_reads), _bucket_sites(bt.num_sites))
        groups.setdefault(key, []).append((j, bt))
    cap_cells = _sweep_cap_cells(options)
    if len(mesh) > 1:
        # The fused (1, 2) wave is single-device only, as in the
        # reference: over a mesh levels 1 and 2 are separate dispatches
        # of one wave.
        ploidies = [q for p in ploidies
                    for q in (p if isinstance(p, tuple) else (p,))]
    jobs: List[list] = [[] for _ in mesh]
    for ploidy in ploidies:
        for key, members in groups.items():
            g_cap = max(1, cap_cells // (key[0] * key[1]))
            for lo in range(0, len(members), g_cap):
                chunk = members[lo:lo + g_cap]
                window = _dispatch_window(chunk, key[1])
                for k, (a, b) in enumerate(shard_bounds(len(chunk),
                                                        len(mesh))):
                    if b > a:
                        jobs[k].append((ploidy, key, chunk[a:b], window))

    def run_shard(k):
        cache = caches[mesh[k]]
        pending = []
        for ploidy, key, members, window in jobs[k]:
            nreads = np.array([bt.num_reads for _j, bt in members],
                              dtype=np.int32)
            eps = np.full(len(members), options.epsilon, dtype=np.float32)
            fused = ploidy == (1, 2)
            best, mec = _sweep_chain(
                cache, key, [j for j, _bt in members], nreads, eps,
                2 if fused else ploidy, options.max_number_solns, window,
                cache.amax[key], fused12=fused)
            pending.append((members, ploidy, best, mec))
        return pending

    launch_t = time.time()
    shards = run_on_shards(run_shard,
                           [k for k in range(len(mesh)) if jobs[k]])
    timing.add("phase.launch", time.time() - launch_t)
    return [p for pending in shards for p in pending]


def _sweep_pull(pending: list):
    """Download one wave's refined assignments and MEC stats: every
    result is copied into pinned host memory without a wait, then the
    host waits once per device, on an event recorded after the copies."""
    pull_t = time.time()
    hosts, events = [], {}
    for _members, _ploidy, best, mec in pending:
        mecs = mec if isinstance(mec, tuple) else (mec,)
        hosts.append([to_host(x) for x in (best, *mecs)])
        if best.device.type == "cuda":
            events[best.device] = None
    for dev in events:
        events[dev] = torch.cuda.Event()
        events[dev].record(torch.cuda.current_stream(dev))
    for ev in events.values():
        ev.synchronize()
    refined: Dict[Tuple[object, int], np.ndarray] = {}
    stats: Dict[Tuple[object, int], Tuple[float, float]] = {}
    for (members, ploidy, _best, _mec), host in zip(pending, hosts):
        best, *mecs = (x.numpy() for x in host)
        if ploidy == (1, 2):
            mec1, mec2 = mecs
            for g, (j, bt) in enumerate(members):
                refined[(j, 1)] = np.zeros(bt.num_reads, np.int32)
                stats[(j, 1)] = (float(mec1[g, 0]), float(mec1[g, 1]))
                refined[(j, 2)] = best[g, :bt.num_reads]
                stats[(j, 2)] = (float(mec2[g, 0]), float(mec2[g, 1]))
            continue
        mec = mecs[0]
        for g, (j, bt) in enumerate(members):
            refined[(j, ploidy)] = best[g, :bt.num_reads]
            stats[(j, ploidy)] = (float(mec[g, 0]), float(mec[g, 1]))
    timing.add("phase.wait", time.time() - pull_t)
    return refined, stats
