"""Final haplogroup massage: unique read assignment, broken-group
separation, canonical ordering.

Mirrors part_block_manip.rs:27-288. Reads appearing in several haplogroups
(block overlap) are first removed everywhere, then re-added one at a time
to the argmin-(diff+1, part id) candidate against the *current* depleted
consensus — the re-add order in the reference follows hashmap iteration;
we fix ascending read id for determinism. Haplogroups with internal
zero-coverage SNP gaps are split at the gaps.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

from .. import constants
from ..frag import Frag
from ..graph.paths import Haplogroup
from ..options import Options
from .hapq import fids_array


class _PartState:
    """Haplogroup consensus counts supporting remove/re-add
    (utils_frags.rs:465-490 add/remove_read_from_block). Each part's
    counts are a dense [span, A] window over the part's own SNP range
    (grown on demand), not the whole contig — per-part full-contig
    arrays cost O(parts * num_snps) memory, gigabytes on deep
    multi-haplogroup contigs."""

    def __init__(self, frags: Sequence[Frag], parts: List[Set[int]],
                 csr=None):
        self.frags = frags
        self.csr = csr
        self.counts: List[np.ndarray] = []
        self.lo: List[int] = []
        for ids in parts:
            if csr is not None:
                fids = fids_array(ids)
                lo, hi = csr.span(fids)
                if lo is None:
                    lo, hi = 0, -1
                    c = np.zeros((0, constants.MAX_ALLELES))
                else:
                    c = csr.window_counts(fids, lo, hi, weighted=True)
                self.counts.append(c)
                self.lo.append(lo)
                continue
            lo = None
            hi = None
            for fid in ids:
                f = frags[fid]
                if len(f.snps):
                    flo, fhi = int(f.snps[0]), int(f.snps[-1])
                    lo = flo if lo is None else min(lo, flo)
                    hi = fhi if hi is None else max(hi, fhi)
            if lo is None:
                lo, hi = 0, -1
            c = np.zeros((hi - lo + 1, constants.MAX_ALLELES))
            for fid in ids:
                f = frags[fid]
                c[f.snps - lo, f.alleles] += f.weights
            self.counts.append(c)
            self.lo.append(lo)

    def _ensure(self, part: int, flo: int, fhi: int) -> None:
        lo = self.lo[part]
        hi = lo + len(self.counts[part]) - 1
        if flo >= lo and fhi <= hi:
            return
        new_lo = min(lo, flo)
        new_hi = max(hi, fhi)
        c = np.zeros((new_hi - new_lo + 1, constants.MAX_ALLELES))
        c[lo - new_lo:lo - new_lo + len(self.counts[part])] = \
            self.counts[part]
        self.counts[part] = c
        self.lo[part] = new_lo

    def remove(self, fid: int, part: int) -> None:
        f = self.frags[fid]
        if not len(f.snps):
            return
        self._ensure(part, int(f.snps[0]), int(f.snps[-1]))
        c = self.counts[part]
        idx = f.snps - self.lo[part]
        cur = c[idx, f.alleles]
        # site_counter -= w only when nonzero; clamp at zero
        # (utils_frags.rs:476-490).
        new = np.where(cur != 0.0, cur - f.weights, cur)
        c[idx, f.alleles] = np.maximum(new, 0.0)

    def add(self, fid: int, part: int) -> None:
        f = self.frags[fid]
        if not len(f.snps):
            return
        self._ensure(part, int(f.snps[0]), int(f.snps[-1]))
        # A frag has one site per SNP, so the fancy-index add is exact
        # (no colliding indices) and ~20x cheaper than np.add.at.
        self.counts[part][f.snps - self.lo[part], f.alleles] += f.weights

    def _fold_many(self, fids, part: int, add: bool) -> None:
        """Batched remove/add of many reads into one part, in list
        order — identical arithmetic sequence to the per-read calls
        (the native fold walks reads then sites exactly as remove/add
        do). Falls back to the per-read path without CSR/native."""
        if not fids:
            return
        from .. import native

        if self.csr is not None:
            # Order-preserving id array (fids_array would sort, changing
            # the sequential fold order).
            arr = np.fromiter(fids, dtype=np.int64, count=len(fids))
            lo, hi = self.csr.span(arr)
            if lo is not None:
                self._ensure(part, lo, hi)
                if native.counts_fold(
                        self.csr.snps, self.csr.alleles,
                        self.csr.weights, self.csr.off, arr,
                        self.lo[part], self.counts[part], add):
                    return
        op = self.add if add else self.remove
        for fid in fids:
            op(fid, part)

    def remove_many(self, fids, part: int) -> None:
        self._fold_many(fids, part, add=False)

    def add_many(self, fids, part: int) -> None:
        self._fold_many(fids, part, add=True)

    def distance(self, fid: int, part: int,
                 epsilon: float) -> Tuple[float, float]:
        """(same, diff) with the epsilon-empty rules
        (utils_frags.rs:32-75)."""
        f = self.frags[fid]
        if not len(f.snps):
            return 0.0, 0.0
        self._ensure(part, int(f.snps[0]), int(f.snps[-1]))
        c = self.counts[part]
        sites = c[f.snps - self.lo[part]]       # [n, A]
        maxc = sites.max(axis=1)
        at = sites[np.arange(len(f.snps)), f.alleles]
        empty = maxc == 0.0
        # f64 sums: exact on the 2^-26 weight grid (see stats.py
        # distance_matrix_eps).
        w64 = f.weights.astype(np.float64)
        same = float(w64[(~empty) & (at == maxc)].sum())
        diff = float(w64[(~empty) & (at < maxc)].sum()
                     + epsilon * empty.sum())
        return same, diff


def process_reads_for_final_parts(
        haplogroups: List[Haplogroup], frags: Sequence[Frag],
        short_frags: Sequence[Frag], options: Options,
        csr=None) -> Tuple[
            List[Set[int]], List[Tuple[int, int]]]:
    """part_block_manip.rs:174-274. Returns (parts as read-id sets, SNP
    ranges), sorted by range."""
    parts: List[Set[int]] = [set(int(i) for i in h.frag_ids)
                             for h in haplogroups]
    ranges: List[Tuple[int, int]] = [h.snp_range for h in haplogroups]
    state = _PartState(frags, parts, csr=csr)

    read_to_parts: Dict[int, List[int]] = {}
    for i, ids in enumerate(parts):
        for fid in ids:
            read_to_parts.setdefault(fid, []).append(i)

    # Remove EVERY read from every part it appears in (the reference
    # does the same before re-assigning, part_block_manip.rs:195-200).
    # Batched per part: removals of different parts touch different
    # count windows, so per-part batches in encounter order replay the
    # exact interleaved per-read sequence.
    removals: Dict[int, List[int]] = {}
    for fid, part_ids in read_to_parts.items():
        for i in part_ids:
            parts[i].discard(fid)
            removals.setdefault(i, []).append(fid)
    for i, fids in removals.items():
        state.remove_many(fids, i)

    # Re-add in ascending read id. Adds are batched per part and
    # flushed lazily: a multi-candidate read's distance against part i
    # only depends on part i's adds by smaller read ids, which the
    # flush lands first; adds into other parts commute (disjoint count
    # windows).
    pending: Dict[int, List[int]] = {}

    def _flush(i: int) -> None:
        fids = pending.pop(i, None)
        if fids:
            state.add_many(fids, i)

    for fid in sorted(read_to_parts):
        part_ids = read_to_parts[fid]
        if len(part_ids) == 1:
            # Single-candidate reads (the vast majority) re-join their
            # part unconditionally: distance() has no side effects, so
            # the argmin over one candidate never needs computing.
            best = part_ids[0]
        else:
            best = None
            best_key = None
            for i in sorted(part_ids):
                _flush(i)
                same, diff = state.distance(fid, i, options.epsilon)
                key = (diff + 1.0, i, same)
                if best_key is None or key < best_key:
                    best_key = key
                    best = i
        parts[best].add(fid)
        pending.setdefault(best, []).append(fid)
    for i in list(pending):
        _flush(i)

    if constants.MERGE_SIMILAR_HAPLOGROUPS:
        merge_overlapping_haplogroups(parts, ranges, frags,
                                      options.epsilon)
    if constants.SEPARATE_BROKEN_HAPLOGROUPS:
        separate_broken_haplogroups(parts, ranges, frags)

    if options.reassign_short and short_frags:
        _reassign_short(parts, ranges, state, short_frags, options)

    order = sorted(range(len(parts)), key=lambda i: ranges[i])
    return [parts[i] for i in order], [ranges[i] for i in order]


def merge_overlapping_haplogroups(parts: List[Set[int]],
                                  ranges: List[Tuple[int, int]],
                                  frags: Sequence[Frag],
                                  epsilon: float) -> None:
    """Union-find merge of heavily-overlapping, consensus-compatible
    haplogroups (part_block_manip.rs:99-172; disabled by default via
    MERGE_SIMILAR_HAPLOGROUPS, kept for feature parity).

    For each haplogroup, overlap candidates above MERGE_CUTOFF interval
    overlap whose consensus disagreement rate (over shared or in-range
    sites with coverage above DIST_COV_CUTOFF) is below epsilon are merge
    candidates; the widest-span candidate wins."""
    from ..post.hapq import overlap_percent

    n = len(parts)
    consensus = []
    for ids in parts:
        acc: Dict[int, np.ndarray] = {}
        for fid in ids:
            f = frags[fid]
            for p, a, w in zip(f.snps, f.alleles, f.weights):
                site = acc.get(int(p))
                if site is None:
                    site = np.zeros(constants.MAX_ALLELES)
                    acc[int(p)] = site
                site[a] += w
        consensus.append(acc)

    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i in range(n):
        candidates = []
        for j in range(n):
            if i == j:
                continue
            s1, e1 = ranges[i]
            s2, e2 = ranges[j]
            if not (s2 < e1 and e2 > s1):
                continue
            ol = overlap_percent(s1, e1, s2, e2)
            if ol <= constants.MERGE_CUTOFF:
                continue
            lo = min(s1, s2)
            hi = max(e1, e2)
            same = diff = 0.0
            for p, c1 in consensus[i].items():
                c2 = consensus[j].get(p)
                if c2 is None:
                    continue
                if ((c1.sum() > constants.DIST_COV_CUTOFF
                     and c2.sum() > constants.DIST_COV_CUTOFF)
                        or lo <= p <= hi):
                    if int(c1.argmax()) == int(c2.argmax()):
                        same += 1.0
                    else:
                        diff += 1.0
            if same + diff > 0 and diff / (same + diff) < epsilon:
                candidates.append((j, hi - lo))
        if candidates:
            best = max(candidates, key=lambda c: c[1])[0]
            ri, rj = find(i), find(best)
            if ri != rj:
                parent[rj] = ri

    groups: Dict[int, List[int]] = {}
    for i in range(n):
        groups.setdefault(find(i), []).append(i)
    for rep, members in groups.items():
        if len(members) <= 1:
            continue
        lo = min(ranges[m][0] for m in members)
        hi = max(ranges[m][1] for m in members)
        for m in members:
            if m != rep:
                parts[rep] |= parts[m]
                parts[m] = set()
        ranges[rep] = (lo, hi)


def separate_broken_haplogroups(parts: List[Set[int]],
                                ranges: List[Tuple[int, int]],
                                frags: Sequence[Frag]) -> None:
    """Split haplogroups at internal zero-coverage SNP gaps
    (part_block_manip.rs:27-98). Originals are emptied in place (their
    range rows kept), splits appended."""
    # Scan order: first_position with read id as the tie-break. The
    # reference sorts only by first position (part_block_manip.rs:36-38)
    # so ties keep hashmap order — nondeterministic there; a total key
    # is required here because which read CLOSES a segment (and is
    # dropped) depends on scan order when first positions tie. Keep in
    # sync with floria_tpu_torch/oracle/pipeline.py:_separate_broken.
    def _scan_key(fid):
        return (frags[fid].first_position, fid)

    all_breaks = []
    for i in range(len(ranges)):
        ordered = sorted(parts[i], key=_scan_key)
        latest = 0
        breaks = []
        for fid in ordered:
            f = frags[fid]
            if latest != 0 and f.first_position > latest:
                if ranges[i][0] <= latest < ranges[i][1]:
                    breaks.append(latest)
            if f.last_position > latest:
                latest = f.last_position
        if breaks:
            all_breaks.append((i, breaks))

    new_parts: List[Set[int]] = []
    new_ranges: List[Tuple[int, int]] = []
    for i, breaks in all_breaks:
        ordered = sorted(parts[i], key=_scan_key)
        spot_index = 0
        break_start = ranges[i][0]
        end_spot = breaks[0]
        current: Set[int] = set()
        for fid in ordered:
            if frags[fid].last_position <= end_spot:
                current.add(fid)
            else:
                # Close the segment; the closing read itself is dropped,
                # matching the reference (part_block_manip.rs:68-84).
                new_parts.append(current)
                new_ranges.append((break_start, end_spot))
                break_start = end_spot + 1
                spot_index += 1
                end_spot = (breaks[spot_index]
                            if spot_index != len(breaks)
                            else np.iinfo(np.int64).max)
                current = set()
        new_parts.append(current)
        new_ranges.append((break_start, ranges[i][1]))

    for i, _breaks in all_breaks:
        parts[i] = set()
    parts.extend(new_parts)
    ranges.extend(new_ranges)


def _reassign_short(parts, ranges, state: _PartState, short_frags,
                    options: Options) -> None:
    """Hybrid-mode short read re-attachment
    (part_block_manip.rs:235-270): a short fragment joins every candidate
    haplogroup tied at the best quantized (diff, same) score.

    Precondition: short fragments must be renumbered into the same
    counter-id space as `state.frags` (the pipeline appends them after the
    long fragments).

    Only the ORIGINAL parts (pre broken-group separation) are candidates:
    the reference iterates `all_parts_block.blocks`
    (part_block_manip.rs:240-241), which separate_broken_haplogroups never
    extends, with the original index's range — so short reads score
    against the pre-split consensus and can resurrect a cleared original
    part. state.counts keeps exactly that original length. Equal-ratio
    score ties pick the key first seen in ascending part order (the
    reference's min_by over FxHashMap keys is iteration-order
    dependent)."""
    for f in short_frags:
        candidates: Dict[Tuple[int, int], List[int]] = {}
        for i in range(len(state.counts)):
            a, b = ranges[i]
            inter = (a <= f.first_position <= b) or (
                a <= f.last_position <= b)
            if not inter:
                continue
            same, diff = state.distance(f.counter_id, i, options.epsilon)
            key = (int(diff * 10.0 + 1.0), int(same * 10.0 + 1.0))
            candidates.setdefault(key, []).append(i)
        if not candidates:
            continue
        best_key = min(candidates, key=lambda k: k[0] / k[1])
        for i in candidates[best_key]:
            parts[i].add(f.counter_id)
