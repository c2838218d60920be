"""Reads falling in SNP-less gaps between haplogroups.

part_block_manip.rs:622-675: collect fragments (both SNP-less ones and
final fragments) whose genomic interval overlaps no haplogroup interval;
haplogroup intervals are padded by one block length in paired mode because
paired reads are not trimmed.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..frag import Frag


def frags_in_snpless_gaps(ranges: List[Tuple[int, int]],
                          snp_to_genome_pos: np.ndarray,
                          snpless_frags: Sequence[Frag],
                          block_len: int,
                          final_frags: Sequence[Frag]) -> List[Frag]:
    paired = any(f.is_paired for f in snpless_frags)
    intervals = []
    for (lo, hi) in ranges:
        start = int(snp_to_genome_pos[lo - 1])
        if paired and start > block_len:
            start -= block_len
        end = int(snp_to_genome_pos[hi - 1]) + 1
        if paired:
            end += block_len
        intervals.append((start, end))

    def overlaps(first: int, last: int) -> bool:
        # rust-lapper count() on half-open [first, last)
        for (s, e) in intervals:
            if s < last and e > first:
                return True
        return False

    out = []
    for frag in snpless_frags:
        if not overlaps(frag.first_pos_base, frag.last_pos_base):
            out.append(frag)
    for frag in final_frags:
        if not overlaps(frag.first_pos_base, frag.last_pos_base):
            out.append(frag)
    return out
