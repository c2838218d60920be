"""Local phasing engine: the adaptive per-block ploidy sweep on torch.

Port of floria_tpu/phase/local.py's main path (phase_contigs_blocks ->
adaptive_sweep) and of its instance API (`phase_instances`,
`refine_instances`, `phase_contig_blocks`). Both run every (block,
ploidy) instance on one dispatch path: `_plan` groups the instances by
shape bucket (`_bucket`) into dispatches of the dispatch cap, each with
its window worked out on the host; `_launch_sharded` enqueues each
dispatch on its device, or split over the shards of a block mesh
(parallel/mesh.py), through a stage: `_beam` (gather -> weights -> beam
scan + traceback, K1), `_climb` (UPEM hill-climb, K6 with K4's body
inside, and unit-weight MEC stats) or the sweep's `_chain` of the two;
`_pull` waits once per device and unpacks. On a card nothing before the
pull waits (uploads from pinned memory), as the reference launches its
jitted chains asynchronously and waits in its pull. The sweep's stopping
rules replay on the host, level by level (`_sweep_decide`), so the
chosen ploidies and partitions equal the reference's sequential early
exit (graph_processing.rs:198-252).

The pure helpers below are copies of the reference's (which cannot be
imported: its module pulls in jax).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import constants, state, timing
from ..device import (check_no_tf32, pull, resolve_device, same_card,
                      upload)
from ..kernels import beam as beam_kernel
from ..kernels import block_pad
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
    """Replay of the sweep's stopping logic (graph_processing.rs:198-252):
    `_sweep_decide`'s walk up to the first decided level."""
    for ploidy in range(1, len(mec_vector) + 1):
        decided, best = _sweep_decide(mec_vector, expected_errors, ploidy,
                                      options)
        if decided:
            return best
    return 1


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


def _bucket(bt: BlockTensor) -> Tuple[int, int]:
    """A block's shape bucket (padded reads, padded sites): the rows of
    BlockDeviceCache it lives in and the dispatches it joins."""
    return _bucket_reads(bt.num_reads), _bucket_sites(bt.num_sites)


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
    caches = _mesh_caches(blocks, cache, make_block_mesh(
        options.num_devices, device=device))
    max_p = options.max_ploidy
    mec_vec = {key: np.zeros(max_p) for key, _bt in blocks}
    exp_vec = {key: np.zeros(max_p) for key, _bt in blocks}
    chosen: Dict[object, Tuple[int, np.ndarray]] = {}
    prev_assign: Dict[object, np.ndarray] = {}
    spans: dict = {}                # read_columns by key, for this call
    # Each wave is a list of the levels of its dispatches. The fused
    # (1, 2) dispatch is single-device only, as in the reference: over a
    # mesh levels 1 and 2 are separate dispatches of one wave.
    waves = [[(p,)] for p in range(3 if max_p >= 2 else 1, max_p + 1)]
    if max_p >= 2:
        waves.insert(0, [(1, 2)] if len(caches) == 1 else [(1,), (2,)])
    active = blocks
    for wave in waves:
        if not active:
            break
        plan = _plan([(j, bt, levels) for levels in wave for j, bt in active],
                     options, spans)
        with timing.span("phase.launch"):
            pending = _launch_sharded(caches, plan,
                                      functools.partial(_chain, options))
        with timing.span("phase.wait"):
            refined, stats = _pull(pending)
        levels = [p for lv in wave for p in lv]
        log.debug("sweep levels %s: %d blocks", levels, len(active))
        next_active = []
        for key, bt in active:
            for ploidy in levels:
                good, bad = stats[(key, ploidy)]
                mec_vec[key][ploidy - 1] = bad
                exp_vec[key][ploidy - 1] = (good + bad) * options.epsilon
                decided, best = _sweep_decide(mec_vec[key], exp_vec[key],
                                              ploidy, options)
                if decided:
                    chosen[key] = (best, refined[(key, ploidy)]
                                   if best == ploidy else prev_assign[key])
                    break
                prev_assign[key] = refined[(key, ploidy)]
            else:
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
    contig group; weights are rebuilt per dispatch by table lookup.

    Per bucket only the blocks' own cells cross to the device: staged
    once on the host (`beam.cache_stage`, kernels/block_pad.py `stage`,
    pinned on a card), then shipped and padded there (`beam.cache_pad`,
    `block_pad`: one non_blocking copy and one kernel launch on the
    device's current stream). On a card nothing here waits for it; the
    dispatches that read the cache run later on that same stream."""

    @timing.span("beam.cache_upload")
    def __init__(self, blocks: List[Tuple[object, BlockTensor]], *,
                 device):
        self.device = resolve_device(device)
        buckets: Dict[Tuple[int, int],
                      List[Tuple[object, BlockTensor]]] = {}
        for j, bt in blocks:
            buckets.setdefault(_bucket(bt), []).append((j, bt))
        self.rows: Dict[object, int] = {}
        self.dev: Dict[Tuple[int, int], Tuple[torch.Tensor,
                                              torch.Tensor]] = {}
        # Actual allele-value width per bucket (2 on biallelic data):
        # absent alleles' count planes are identically zero.
        self.amax: Dict[Tuple[int, int], int] = {}
        self.phred = upload(state.phred_table(), self.device)
        for key, members in buckets.items():
            with timing.span("beam.cache_stage"):
                staged, table, top = block_pad.stage(
                    [bt for _j, bt in members],
                    pin=self.device.type == "cuda")
            with timing.span("beam.cache_pad"):
                self.dev[key] = block_pad.block_pad(staged, table, *key,
                                                    self.device)
            self.amax[key] = min(constants.MAX_ALLELES, max(2, top + 1))
            for b, (j, _bt) in enumerate(members):
                self.rows[j] = b

    def gather(self, key: Tuple[int, int], block_ids: List[object]):
        """[G, r_pad, s_pad] (alleles, weights) for the given blocks, in
        order (duplicates fine)."""
        dev_a, dev_q = self.dev[key]
        idx = upload(np.array([self.rows[j] for j in block_ids], np.int64),
                     self.device)
        return (dev_a.index_select(0, idx).contiguous(),
                beam_kernel.quals_to_weights(dev_q.index_select(0, idx),
                                             self.phred).contiguous())


def _plan(instances, options: Options, spans: Optional[dict] = None,
          mixed: bool = False) -> list:
    """The dispatches of `instances` [(block key, BlockTensor, levels)],
    in order: grouped by shape bucket (`_bucket`) and, unless `mixed`
    (one beam over instances of any level), by levels, each group in
    chunks of at most the dispatch cap's read-site cells
    (`_sweep_cap_cells`). A dispatch is (members, bucket, window): its
    window from `_dispatch_window` with the caller's table `spans` of the
    blocks' read columns, 0 without one. Instances are independent, so
    the split changes no result."""
    groups: Dict[tuple, list] = {}
    for j, bt, levels in instances:
        groups.setdefault((None if mixed else levels, _bucket(bt)),
                          []).append((j, bt, levels))
    plan = []
    for (_levels, key), members in groups.items():
        cap = max(1, _sweep_cap_cells(options) // (key[0] * key[1]))
        for lo in range(0, len(members), cap):
            chunk = members[lo:lo + cap]
            plan.append((chunk, key, 0 if spans is None
                         else _dispatch_window(chunk, key[1], spans)))
    return plan


@timing.span("dispatch.window")
def _dispatch_window(chunk, s_pad: int, spans: dict) -> int:
    """The sliding compute window of one dispatch of `chunk`'s blocks
    [(block key, BlockTensor, ...)] at s_pad columns, the reference's
    policy: round_up(span + 128, 256) for the chunk's longest read span
    (BlockTensor.max_read_span), only for a >= 4x shrink of the site
    axis, else 0 (full width). A window is checked on the host, block by
    block, to hold every read, as K1 requires
    (`beam_kernel.check_windows_host`).

    `spans` is the caller's table of each block's `read_columns` by
    block key, filled here as blocks are first read, and kept for one
    call of the caller only. The blocks are read in order until one read
    rules a window out: on long reads the first block decides. Counts
    the blocks read (`window_blocks`)."""
    # The longest span a window allows: round_up(span + 128, 256) * 4 <=
    # s_pad. Every span is at least 1, so below 1 no block need be read.
    limit = s_pad // 1024 * 256 - 128
    span, read = 1, 0
    for j, bt, *_rest in chunk:
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
    for j, *_rest in chunk:
        beam_kernel.check_windows_host(*spans[j], s_pad, window)
    return window


def _launch_sharded(caches: List[BlockDeviceCache], dispatches, stage
                    ) -> list:
    """[(members, stage(cache, members, *rest))] for every dispatch
    (members, *rest), over the mesh of `caches` (one per shard): each
    dispatch's members split into len(caches) contiguous shards
    (parallel/mesh.py shard_bounds, empty shards skipped), and each
    shard's dispatches run in order on its cache's device, on its own
    host thread, all shards at once (inline for one shard). Results in
    shard order, each shard's in dispatch order. On a card nothing here
    waits for it: the results stay on the device until `_pull`."""
    check_no_tf32()
    jobs: List[list] = [[] for _ in caches]
    for members, *rest in dispatches:
        for k, (a, b) in enumerate(shard_bounds(len(members),
                                                len(caches))):
            if b > a:
                jobs[k].append((members[a:b], *rest))
    shards = run_on_shards(
        lambda k: [(job[0], stage(caches[k], *job)) for job in jobs[k]],
        [k for k in range(len(caches)) if jobs[k]])
    return [p for pending in shards for p in pending]


def _inputs(options: Options, cache: BlockDeviceCache, members, key):
    """One dispatch's inputs on its cache's device: the members'
    (alleles, weights) [G, r_pad, s_pad] gathered from the cache, their
    num_reads and epsilon [G]."""
    alleles, weights = cache.gather(key, [j for j, _bt, _lv in members])
    nreads = np.array([bt.num_reads for _j, bt, _lv in members], np.int32)
    eps = np.full(len(members), options.epsilon, np.float32)
    return (alleles, weights, upload(nreads, cache.device),
            upload(eps, cache.device))


def _beam(cache: BlockDeviceCache, key, x, nparts, ploidy: int,
          beam_width: int, window: int) -> torch.Tensor:
    """The beam scan and traceback (K1 on a card) of one dispatch of the
    bucket `key` on its inputs `x` (`_inputs`), at `ploidy` with each
    member at its own part count (`nparts` [G] int32 on the device): the
    best beam's assignments [G, r_pad]. The window was checked on the
    host (`_plan`)."""
    alleles, weights, nr, ep = x
    _result, assigns = beam_kernel.beam_search_traceback(
        alleles, weights, nr, ep, nparts, ploidy, beam_width,
        max_alleles=cache.amax[key], window=window, device=cache.device,
        check_windows=False)
    log.debug("beam group r_pad=%d s_pad=%d G=%d window=%d on %s",
              key[0], key[1], alleles.shape[0], window, cache.device)
    return assigns


def _climb(cache: BlockDeviceCache, key, x, start, ploidy: int):
    """The UPEM climb (K6's climb kernel on a card, K4's body inside) of
    one dispatch of the bucket `key` on its inputs `x` (`_inputs`) from
    `start` [G, r_pad] int32 on the device, and the unit-weight MEC
    stats of the result: (refined [G, r_pad] int32, (bases, errors)
    [G, 2] f64)."""
    alleles, weights, nr, ep = x
    best, mec, _diff = upem_optimize_device(
        alleles, weights, start, nr, ep, ploidy,
        max_alleles=cache.amax[key], device=cache.device)
    return best, mec


def _chain(options: Options, cache: BlockDeviceCache, members, key,
           window: int) -> list:
    """One sweep dispatch at its members' levels (one, or 1 and 2
    fused): `_beam` then `_climb` at the top level, and at level 1 the
    unit-weight MEC of the everything-in-part-0 partition (UPEM needs
    >= 2 parts to move). Returns [(level, refined or None for all
    zeros, (bases, errors))]."""
    levels = members[0][2]
    top = levels[-1]
    x = alleles, weights, _nr, ep = _inputs(options, cache, members, key)
    out = []
    if top > 1:
        nparts = torch.full((len(members),), top, dtype=torch.int32,
                            device=cache.device)
        assigns = _beam(cache, key, x, nparts, top,
                        options.max_number_solns, window)
        out.append((top, *_climb(cache, key, x, assigns.to(torch.int32),
                                 top)))
    if levels[0] == 1:
        zeros = torch.zeros(alleles.shape[:2], dtype=torch.int32,
                            device=cache.device)
        out.append((1, None, upem_eval("mec", alleles, weights, zeros, ep,
                                       1, cache.amax[key])))
    return out


def _span(name: Optional[str]):
    return timing.span(name) if name else contextlib.nullcontext()


def _pull(pending: list, wait: Optional[str] = None,
          unpack: Optional[str] = None):
    """Download every pending result (each stage's [(level, assignments,
    mec)]) with one wait per device (`device.pull`) and unpack it. A
    result's level None is each member's own; its assignments None are
    all zeros; its mec None gives no stats. `wait` and `unpack` name the
    spans of the two steps, if any.

    Returns ({(block key, ploidy): assignment [num_reads] int32},
    {(block key, ploidy): (bases, errors)})."""
    results = [(members, r) for members, rs in pending for r in rs]
    with _span(wait):
        hosts = iter(pull([t for _m, (_level, *ts) in results
                           for t in ts if t is not None]))
    refined: Dict[Tuple[object, int], np.ndarray] = {}
    stats: Dict[Tuple[object, int], Tuple[float, float]] = {}
    with _span(unpack):
        for members, (level, best, mec) in results:
            best = None if best is None else next(hosts).astype(
                np.int32, copy=False)
            mec = None if mec is None else next(hosts)
            for g, (j, bt, levels) in enumerate(members):
                key = (j, level or levels[-1])
                refined[key] = (np.zeros(bt.num_reads, np.int32)
                                if best is None else best[g, :bt.num_reads])
                if mec is not None:
                    stats[key] = (float(mec[g, 0]), float(mec[g, 1]))
    return refined, stats


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
    ploidies = list(ploidies)
    caches = _mesh_caches(
        blocks, cache, make_block_mesh(options.num_devices, device=device))
    top = max(ploidies) if ploidies else 1
    plan = _plan([(j, bt, (p,)) for p in ploidies for j, bt in blocks],
                 options, {}, mixed=True)

    def stage(cache, members, key, window):
        x = _inputs(options, cache, members, key)
        nparts = np.array([lv[-1] for _j, _bt, lv in members], np.int32)
        return [(None, _beam(cache, key, x, upload(nparts, cache.device),
                             top, options.max_number_solns, window), None)]

    with timing.span("beam.launch"):
        pending = _launch_sharded(caches, plan, stage)
    return _pull(pending, "beam.pull", "beam.unpack")[0]


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
    caches = _mesh_caches(blocks, cache, [resolve_device(device)])
    if ploidies is None:
        ploidies = range(1, options.max_ploidy + 1)
    plan = _plan([(j, bt, (p,)) for p in ploidies for j, bt in blocks],
                 options)

    def stage(cache, members, key, _window):
        x = _inputs(options, cache, members, key)
        (ploidy,) = members[0][2]
        start = np.zeros((len(members), key[0]), np.int32)
        if ploidy > 1:
            for g, (j, bt, _lv) in enumerate(members):
                start[g, :bt.num_reads] = assignments[(j, ploidy)]
        return [(ploidy, *_climb(cache, key, x,
                                 upload(start, cache.device), ploidy))]

    with timing.span("upem.launch"):
        pending = _launch_sharded(caches, plan, stage)
    return _pull(pending, "upem.pull")
