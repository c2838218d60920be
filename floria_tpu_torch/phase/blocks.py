"""Contig decomposition into overlapping SNP blocks.

This is the sequence-scaling axis of the whole framework: the contig's SNP
axis is cut into blocks of ~block_length genomic bases with ~1/3 overlap and
a minimum SNP density, each phased independently (and, on device, in
parallel across the batch/mesh), then rejoined through the hap-graph.
Semantics mirror utils_frags.rs:405-463 exactly, including the lookahead
left-endpoint advance and the density filter.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def get_range_with_lengths(snp_to_genome_pos: np.ndarray, block_length: int,
                           overlap_len: int,
                           minimal_density: float) -> List[Tuple[int, int]]:
    """Overlapping (start, end) 1-based inclusive SNP-counter intervals.

    Walks SNPs accumulating genomic distance; a block closes after
    block_length bases (if its SNP density clears minimal_density), and the
    next block starts at the SNP where block_length - overlap_len bases had
    accumulated — unless that SNP is followed by a gap larger than
    block_length, in which case it starts one later
    (utils_frags.rs:448-456).
    """
    pos = np.asarray(snp_to_genome_pos, dtype=np.int64)
    n = len(pos)
    if n == 0:
        return []
    out: List[Tuple[int, int]] = []
    cum = 0
    last_pos = int(pos[0])
    left = 0
    new_left = 0
    hit_new_left = False
    for i in range(n):
        if i == n - 1:
            out.append((left, i))
            break
        p = int(pos[i])
        if p < last_pos:
            raise ValueError(
                f"VCF malformed: positions not increasing {last_pos} {p}")
        cum += p - last_pos
        last_pos = p
        if cum > block_length - overlap_len and not hit_new_left:
            new_left = i
            hit_new_left = True
        if cum > block_length:
            cum = 0
            density = (i - left) / block_length
            if density > minimal_density:
                out.append((left, i - 1))
            if pos[new_left] + block_length < pos[new_left + 1]:
                left = new_left
            else:
                left = new_left + 1
            last_pos = int(pos[left])
            hit_new_left = False
    return [(a + 1, b + 1) for a, b in out]  # to 1-based SNP counters


def find_reads_in_interval(start: int, end: int, frags,
                           max_span: int = 10000,
                           bounds=None) -> list:
    """Fragments overlapping [start, end] (inclusive, 1-based), in sorted
    fragment order; spans > max_span SNPs are circularity artifacts and are
    skipped (local_clustering.rs:12-59). `frags` must be sorted by
    first_position. Pass bounds=interval_bounds(frags) when calling for
    many intervals — the selection then vectorizes instead of re-walking
    the fragment list per block."""
    if bounds is not None:
        firsts, lasts = bounds
        hi = int(np.searchsorted(firsts, end, side="right"))
        sel = np.flatnonzero((lasts[:hi] >= start)
                             & (lasts[:hi] - firsts[:hi] <= max_span))
        return [frags[int(i)] for i in sel]
    out = []
    for frag in frags:
        if frag.last_position < start:
            continue
        if frag.first_position > end:
            break
        if frag.last_position - frag.first_position > max_span:
            continue
        out.append(frag)
    return out


def interval_bounds(frags):
    """(firsts, lasts) position arrays for find_reads_in_interval's
    vectorized path."""
    firsts = np.fromiter((f.first_position for f in frags),
                         dtype=np.int64, count=len(frags))
    lasts = np.fromiter((f.last_position for f in frags),
                        dtype=np.int64, count=len(frags))
    return firsts, lasts
