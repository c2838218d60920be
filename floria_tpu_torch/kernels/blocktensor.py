"""Dense tensor packing for SNP blocks.

A block's fragments become a read x site allele matrix (int8, -1 =
uncovered) plus a phred-weight matrix (float32, 0 = uncovered). The site
axis covers the full span of the block's reads — reads keep all their SNPs,
including those outside the nominal block interval, exactly as the
reference's beam search scores full fragments (global_clustering.rs:76-88
uses frag.seq_dict unrestricted).

Padding: sites to a lane multiple, reads to bucket sizes, so instances can
be stacked into device batches with few compile shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from .. import constants


@dataclasses.dataclass
class BlockTensor:
    """One block instance ready for device phasing."""
    frag_ids: np.ndarray            # [R] counter ids, canonical frag order
    lo: int                         # 1-based SNP of local column 0
    num_sites: int                  # live site count (before padding)
    num_reads: int                  # live read count (before padding)
    alleles: np.ndarray             # [R_pad, S_pad] int8, -1 = uncovered
    weights: np.ndarray             # [R_pad, S_pad] f32
    snp_range: Tuple[int, int]      # nominal block interval (1-based, incl.)
    # Raw phred quals (uint8, 0 at uncovered): what actually ships to the
    # device — 1 byte/cell vs 4 for weights; the device reconstructs
    # weights bitwise via the shared 256-entry table (kernels/beam
    # _PHRED_TABLE). quals==0 maps to weight 0.0, matching the zeroed
    # padding of `weights`.
    quals: Optional[np.ndarray] = None

    @property
    def covered(self) -> np.ndarray:
        return self.alleles >= 0

    def max_read_span(self) -> int:
        """Maximum per-read covered column span (first..last, incl.)."""
        cov = self.alleles[:self.num_reads] >= 0
        if not cov.any():
            return 1
        first = cov.argmax(axis=1)
        last = self.alleles.shape[1] - 1 - cov[:, ::-1].argmax(axis=1)
        has = cov.any(axis=1)
        return int((last - first + 1)[has].max())


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pack_block(frags: Sequence, snp_range: Tuple[int, int],
               site_align: int = 8, read_align: int = 8) -> Optional[
                   BlockTensor]:
    """Pack sorted fragments overlapping a block into dense matrices."""
    if not frags:
        return None
    lo = min(f.first_position for f in frags)
    hi = max(f.last_position for f in frags)
    num_sites = hi - lo + 1
    num_reads = len(frags)
    s_pad = round_up(num_sites, site_align)
    r_pad = round_up(num_reads, read_align)
    alleles = np.full((r_pad, s_pad), -1, dtype=np.int8)
    weights = np.zeros((r_pad, s_pad), dtype=np.float32)
    quals = np.zeros((r_pad, s_pad), dtype=np.uint8)
    frag_ids = np.empty(num_reads, dtype=np.int64)
    for r, frag in enumerate(frags):
        frag_ids[r] = frag.counter_id
        cols = frag.snps - lo
        alleles[r, cols] = frag.alleles
        weights[r, cols] = frag.weights
        quals[r, cols] = frag.quals
    return BlockTensor(frag_ids=frag_ids, lo=lo, num_sites=num_sites,
                       num_reads=num_reads, alleles=alleles,
                       weights=weights, snp_range=snp_range,
                       quals=quals)


def partition_counts(block: BlockTensor, assignment: np.ndarray,
                     ploidy: int, weighted: bool = True) -> np.ndarray:
    """counts[P, S, A]: per-part phred-weighted (or unit) allele counts.

    assignment[r] in [0, ploidy) or -1 for unassigned; equals
    hap_block_from_partition (utils_frags.rs:160-184) in tensor form.
    """
    R, S = block.alleles.shape
    A = constants.MAX_ALLELES
    counts = np.zeros((ploidy, S, A), dtype=np.float64)
    w = block.weights if weighted else block.covered.astype(np.float32)
    for p in range(ploidy):
        rows = np.flatnonzero(assignment == p)
        if len(rows) == 0:
            continue
        al = block.alleles[rows]
        ww = w[rows]
        cov = al >= 0
        np.add.at(counts[p],
                  (np.broadcast_to(np.arange(S), al.shape)[cov],
                   al[cov]), ww[cov])
    return counts


def partition_cover(block: BlockTensor, assignment: np.ndarray,
                    ploidy: int) -> np.ndarray:
    """cover[P, S, A] int32: number of reads covering (site, allele) per
    part — entry-existence counts, needed where the reference distinguishes
    present-but-zero-weight hashmap entries from absent ones."""
    R, S = block.alleles.shape
    A = constants.MAX_ALLELES
    cover = np.zeros((ploidy, S, A), dtype=np.int32)
    for p in range(ploidy):
        rows = np.flatnonzero(assignment == p)
        if len(rows) == 0:
            continue
        al = block.alleles[rows]
        cov = al >= 0
        np.add.at(cover[p],
                  (np.broadcast_to(np.arange(S), al.shape)[cov],
                   al[cov]), 1)
    return cover
