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

The reference's instance API is here too: `phase_instances` (the beam
of every (block, ploidy) instance, mixed ploidies in one K1 dispatch per
shape bucket), `refine_instances` (the climb and unit MEC of every
(block, ploidy), ploidy 1 included) and `phase_contig_blocks` (one
contig). Like the sweep they split each bucket into dispatches of the
dispatch cap, never pad the batch, enqueue every dispatch and pull once;
`phase_instances` also splits each dispatch over a block mesh, as the
sweep does, and `refine_instances` runs on one device, as the
reference's does.

The pure helpers below are copies of the reference's (which cannot be
imported: its module pulls in jax).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import constants, state, timing
from ..device import (check_no_tf32, pull, resolve_device, same_card,
                      upload)
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


def phase_contig_blocks(frags, snp_to_genome_pos: np.ndarray,
                        options: Options, debug_dir: Optional[str] = None,
                        *, device) -> List[LocalBlockResult]:
    """Phase every SNP block of one contig on `device`: one result per
    non-empty block, in block order (empty blocks are dropped, like the
    None return at graph_processing.rs:129-131)."""
    return phase_contigs_blocks(
        [("__single__", frags, snp_to_genome_pos, debug_dir)], options,
        device=device)["__single__"]


def phase_contigs_blocks(per_contig, options: Options, *, device
                         ) -> Dict[object, List[LocalBlockResult]]:
    """Phase the SNP blocks of many contigs in shared device batches.

    per_contig: [(contig_key, sorted frozen frags, snp_to_genome_pos,
    debug_dir or None)]."""
    blocks: List[Tuple[Tuple[int, int], BlockTensor]] = []
    contig_frags = {}
    with timing.span("phase.pack"):
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


@timing.span("adaptive_sweep")
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
    mesh = make_block_mesh(options.num_devices, device=device)
    caches = _mesh_caches(blocks, cache, mesh)
    max_p = options.max_ploidy
    mec_vec = {key: np.zeros(max_p) for key, _bt in blocks}
    exp_vec = {key: np.zeros(max_p) for key, _bt in blocks}
    chosen: Dict[object, Tuple[int, np.ndarray]] = {}
    prev_assign: Dict[object, np.ndarray] = {}
    spans: dict = {}                # read_columns by key, for this call
    active = blocks
    if max_p >= 2:
        schedule = [(1, 2)] + list(range(3, max_p + 1))
    else:
        schedule = list(range(1, max_p + 1))
    for entry in schedule:
        if not active:
            break
        pending = _sweep_launch(active, options, caches, [entry], spans)
        levels = entry if isinstance(entry, tuple) else (entry,)
        refined_p, stats_p = _sweep_pull(pending)
        log.debug("sweep level %s: %d blocks", entry, len(active))
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
             "%.2fs", len(blocks), max_p, timing.current().seconds())
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

    @timing.span("beam.cache_upload")
    def __init__(self, blocks: List[Tuple[object, BlockTensor]], *,
                 device):
        self.device = resolve_device(device)
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
            timing.count("h2d_bytes", alleles.nbytes + quals.nbytes)

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


@timing.span("dispatch.window")
def _dispatch_window(chunk, s_pad: int, spans: dict) -> int:
    """The sliding compute window of one dispatch of `chunk`'s blocks at
    s_pad columns, the reference's policy: round_up(span + 128, 256) for
    the chunk's longest read span (BlockTensor.max_read_span), only for
    a >= 4x shrink of the site axis, else 0 (full width). A window is
    checked on the host, block by block, to hold every read, as K1
    requires (`beam_kernel.check_windows_host`).

    `spans` is the caller's table of each block's `read_columns` by
    block key, filled here as blocks are first read, and kept for one
    call of the caller only. The blocks are read in order until one read
    rules a window out: on long reads the first block decides. Counts
    the blocks read (`window_blocks`)."""
    # The longest span a window allows: round_up(span + 128, 256) * 4 <=
    # s_pad. Every span is at least 1, so below 1 no block need be read.
    limit = s_pad // 1024 * 256 - 128
    span, read = 1, 0
    for j, bt in chunk:
        if span > limit:
            break
        if j not in spans:
            spans[j] = beam_kernel.read_columns(bt.alleles, bt.num_reads)
            read += 1
        first, last = spans[j]
        span = max(span, int((last - first)[last >= 0].max(initial=0)) + 1)
    timing.count("window_blocks", read)
    if span > limit:
        return 0
    window = round_up(span + 128, 256)
    for j, _bt in chunk:
        beam_kernel.check_windows_host(*spans[j], s_pad, window)
    return window


def _sweep_launch(blocks, options: Options,
                  caches: List[BlockDeviceCache], ploidies,
                  spans: Optional[dict] = None) -> list:
    """Enqueue one wave of chained beam -> UPEM dispatches for every
    (block, ploidy in ploidies) instance, per shape bucket, in chunks of
    the dispatch cap. On a card nothing here waits for it: the results
    stay on the device until _sweep_pull, and `phase.launch` times the
    enqueueing only. Each dispatch's windows are checked on the host,
    from its blocks, before anything is enqueued; `spans` is the
    caller's table of the blocks' read columns (`_dispatch_window`), a
    new one when not given.

    Over a mesh of more than one shard (`caches`, one per shard), each
    dispatch splits as `_launch_sharded` splits it, and each shard's
    whole chain runs on its device. The reference pulls the sharded beam
    to the host and runs UPEM on the default device; instances are
    independent, so the outputs are the same
    (tests/test_torch_parallel.py)."""
    check_no_tf32()
    groups: Dict[Tuple[int, int], List[Tuple[object, BlockTensor]]] = {}
    for j, bt in blocks:
        key = (_bucket_reads(bt.num_reads), _bucket_sites(bt.num_sites))
        groups.setdefault(key, []).append((j, bt))
    if len(caches) > 1:
        # The fused (1, 2) wave is single-device only, as in the
        # reference: over a mesh levels 1 and 2 are separate dispatches
        # of one wave.
        ploidies = [q for p in ploidies
                    for q in (p if isinstance(p, tuple) else (p,))]
    spans = {} if spans is None else spans
    dispatches = [(chunk, ploidy, key, _dispatch_window(chunk, key[1],
                                                        spans))
                  for ploidy in ploidies
                  for key, members in groups.items()
                  for chunk in _chunks(members, key, options)]

    def launch(cache, members, ploidy, key, window):
        nreads = np.array([bt.num_reads for _j, bt in members],
                          dtype=np.int32)
        eps = np.full(len(members), options.epsilon, dtype=np.float32)
        fused = ploidy == (1, 2)
        best, mec = _sweep_chain(
            cache, key, [j for j, _bt in members], nreads, eps,
            2 if fused else ploidy, options.max_number_solns, window,
            cache.amax[key], fused12=fused)
        return members, ploidy, best, mec

    with timing.span("phase.launch"):
        return _launch_sharded(caches, dispatches, launch)


def _launch_sharded(caches: List[BlockDeviceCache], dispatches, launch
                    ) -> list:
    """[launch(cache, members, *rest)] for every dispatch (members,
    *rest), over the mesh of `caches` (one per shard): each dispatch's
    members split into len(caches) contiguous shards (parallel/mesh.py
    shard_bounds, empty shards skipped), and each shard's dispatches run
    in order on its cache's device, on its own host thread, all shards
    at once. Results in shard order, each shard's in dispatch order."""
    jobs: List[list] = [[] for _ in caches]
    for members, *rest in dispatches:
        for k, (a, b) in enumerate(shard_bounds(len(members),
                                                len(caches))):
            if b > a:
                jobs[k].append((members[a:b], *rest))
    shards = run_on_shards(
        lambda k: [launch(caches[k], *job) for job in jobs[k]],
        [k for k in range(len(caches)) if jobs[k]])
    return [p for pending in shards for p in pending]


@timing.span("phase.wait")
def _sweep_pull(pending: list):
    """Download one wave's refined assignments and MEC stats: every
    result is copied into pinned host memory without a wait, then the
    host waits once per device, on an event recorded after the copies."""
    flat = [x for _members, _ploidy, best, mec in pending
            for x in (best, *(mec if isinstance(mec, tuple) else (mec,)))]
    hosts = iter(pull(flat))
    refined: Dict[Tuple[object, int], np.ndarray] = {}
    stats: Dict[Tuple[object, int], Tuple[float, float]] = {}
    for members, ploidy, _best, _mec in pending:
        best = next(hosts)
        if ploidy == (1, 2):
            mec1, mec2 = next(hosts), next(hosts)
            for g, (j, bt) in enumerate(members):
                refined[(j, 1)] = np.zeros(bt.num_reads, np.int32)
                stats[(j, 1)] = (float(mec1[g, 0]), float(mec1[g, 1]))
                refined[(j, 2)] = best[g, :bt.num_reads]
                stats[(j, 2)] = (float(mec2[g, 0]), float(mec2[g, 1]))
            continue
        mec = next(hosts)
        for g, (j, bt) in enumerate(members):
            refined[(j, ploidy)] = best[g, :bt.num_reads]
            stats[(j, ploidy)] = (float(mec[g, 0]), float(mec[g, 1]))
    return refined, stats


def _chunks(members: list, key: Tuple[int, int],
            options: Optional[Options]):
    """`members` of the shape bucket key = (r_pad, s_pad) in dispatches
    of at most the dispatch cap's read-site cells (`_sweep_cap_cells`).
    Instances are independent, so the split changes no result."""
    g_cap = max(1, _sweep_cap_cells(options) // (key[0] * key[1]))
    return [members[lo:lo + g_cap] for lo in range(0, len(members), g_cap)]


def _mesh_caches(blocks, cache: Optional[BlockDeviceCache],
                 mesh: List[torch.device]) -> List[BlockDeviceCache]:
    """The BlockDeviceCache of each shard of `mesh`, in shard order:
    `cache` on its own card, which must be one of the mesh's (compared
    by `same_card`), and a new one of `blocks` on every other card.
    Shards on one card share its cache, as it is only read."""
    cards = [same_card(dev) for dev in mesh]
    by_card = {}
    if cache is not None:
        if same_card(cache.device) not in cards:
            raise ValueError(f"the cache lives on {cache.device}, not on "
                             f"{', '.join(map(str, dict.fromkeys(cards)))}")
        by_card[same_card(cache.device)] = cache
    for dev, card in zip(mesh, cards):
        if card not in by_card:
            by_card[card] = BlockDeviceCache(blocks, device=dev)
    return [by_card[card] for card in cards]


@timing.span("phase_instances")
def phase_instances(blocks: List[Tuple[object, BlockTensor]],
                    options: Options, ploidies,
                    cache: Optional[BlockDeviceCache] = None, *, device
                    ) -> Dict[Tuple[object, int], np.ndarray]:
    """The beam scan and traceback (K1 on a card) of every (block,
    ploidy) instance, batched by (padded reads, padded sites) shape
    bucket with mixed ploidies in one dispatch at the largest ploidy
    (inactive parts masked; a block's result does not depend on its
    batch), in chunks of the dispatch cap. `device` is a device or a
    block mesh, as adaptive_sweep takes it: over a mesh of more than one
    shard each dispatch splits over the shards (`_launch_sharded`), as
    the reference's `_dispatch_beam` shards it. `cache`, when given, is
    the one of its card. Every dispatch is enqueued before the results
    are pulled once (`beam.pull`).

    Returns {(block key, ploidy): assignment [num_reads] int32}."""
    check_no_tf32()
    ploidies = list(ploidies)
    caches = _mesh_caches(
        blocks, cache, make_block_mesh(options.num_devices, device=device))
    groups: Dict[Tuple[int, int],
                 List[Tuple[int, object, BlockTensor]]] = {}
    for ploidy in ploidies:
        for j, bt in blocks:
            key = (_bucket_reads(bt.num_reads), _bucket_sites(bt.num_sites))
            groups.setdefault(key, []).append((ploidy, j, bt))
    max_ploidy = max(ploidies) if ploidies else 1
    spans: dict = {}
    dispatches = [(chunk, key, _dispatch_window(
        [(j, bt) for _p, j, bt in chunk], key[1], spans))
        for key, members in groups.items()
        for chunk in _chunks(members, key, options)]

    def launch(cache, chunk, key, window):
        dev = cache.device
        nreads = np.array([bt.num_reads for _p, _j, bt in chunk], np.int32)
        nparts = np.array([p for p, _j, _bt in chunk], np.int32)
        eps = np.full(len(chunk), options.epsilon, np.float32)
        alleles, weights = cache.gather(key, [j for _p, j, _bt in chunk])
        _result, assigns = beam_kernel.beam_search_traceback(
            alleles, weights, upload(nreads, dev), upload(eps, dev),
            upload(nparts, dev), max_ploidy, options.max_number_solns,
            max_alleles=cache.amax[key], window=window, device=dev,
            check_windows=False)
        log.debug("beam group r_pad=%d s_pad=%d G=%d window=%d on %s",
                  key[0], key[1], len(chunk), window, dev)
        return chunk, assigns

    with timing.span("beam.launch"):
        pending = _launch_sharded(caches, dispatches, launch)
    with timing.span("beam.pull"):
        hosts = pull([assigns for _chunk, assigns in pending])
    with timing.span("beam.unpack"):
        out: Dict[Tuple[object, int], np.ndarray] = {}
        for (chunk, _assigns), host in zip(pending, hosts):
            for g, (ploidy, j, bt) in enumerate(chunk):
                out[(j, ploidy)] = host[g, :bt.num_reads].astype(np.int32)
    return out


@timing.span("refine_instances")
def refine_instances(blocks: List[Tuple[object, BlockTensor]],
                     assignments: Dict[Tuple[object, int], np.ndarray],
                     options: Options,
                     cache: Optional[BlockDeviceCache] = None,
                     ploidies=None, *, device) -> Tuple[
                         Dict[Tuple[object, int], np.ndarray],
                         Dict[Tuple[object, int], Tuple[float, float]]]:
    """The UPEM climb and unit-weight MEC stats of every (block, ploidy)
    instance (ploidies default 1..options.max_ploidy) on the one device
    `device`, as the reference runs it on its default device, from
    `assignments[(block key, ploidy)]` (ploidy 1 starts from all zeros),
    batched by (ploidy, padded reads, padded sites) in chunks of the
    dispatch cap: one climb kernel launch per chunk on a card, all
    enqueued (`upem.launch`) before the results are pulled once
    (`upem.pull`).

    Returns ({(block key, ploidy): refined assignment [num_reads]
    int32}, {(block key, ploidy): (bases, errors)})."""
    check_no_tf32()
    cache, = _mesh_caches(blocks, cache, [resolve_device(device)])
    dev = cache.device
    if ploidies is None:
        ploidies = range(1, options.max_ploidy + 1)
    groups: Dict[Tuple[int, int, int],
                 List[Tuple[object, BlockTensor]]] = {}
    for ploidy in ploidies:
        for j, bt in blocks:
            key = (ploidy, _bucket_reads(bt.num_reads),
                   _bucket_sites(bt.num_sites))
            groups.setdefault(key, []).append((j, bt))
    pending = []
    with timing.span("upem.launch"):
        for (ploidy, *shape), members in groups.items():
            key = tuple(shape)
            for chunk in _chunks(members, key, options):
                assigns = np.zeros((len(chunk), key[0]), np.int32)
                nreads = np.array([bt.num_reads for _j, bt in chunk],
                                  np.int32)
                if ploidy > 1:
                    for g, (j, bt) in enumerate(chunk):
                        assigns[g, :bt.num_reads] = assignments[(j, ploidy)]
                eps = np.full(len(chunk), options.epsilon, np.float32)
                alleles, weights = cache.gather(key,
                                                [j for j, _bt in chunk])
                best, mec, _diff = upem_optimize_device(
                    alleles, weights, upload(assigns, dev),
                    upload(nreads, dev), upload(eps, dev), ploidy,
                    max_alleles=cache.amax[key], device=dev)
                pending.append((chunk, ploidy, best, mec))
    with timing.span("upem.pull"):
        hosts = iter(pull([x for _c, _p, best, mec in pending
                           for x in (best, mec)]))
    refined: Dict[Tuple[object, int], np.ndarray] = {}
    stats: Dict[Tuple[object, int], Tuple[float, float]] = {}
    for chunk, ploidy, _best, _mec in pending:
        best, mec = next(hosts), next(hosts)
        for g, (j, bt) in enumerate(chunk):
            refined[(j, ploidy)] = best[g, :bt.num_reads]
            stats[(j, ploidy)] = (float(mec[g, 0]), float(mec[g, 1]))
    return refined, stats
