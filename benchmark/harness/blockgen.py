"""Synthetic SNP blocks for the instance-API traffic, made from the seed.

After the repository's block workload generator (bench.py
`make_workload`), with the blocks shaped as a community's sweep cuts
them: G blocks of R reads each, every read overlapping the block's
`block_sites` SNP columns. A read is `read_length` ± `read_length_sd` bp
long (normal, at least 200 bp, as the simulator draws it) and covers that
many bp times `snps_per_bp` contiguous columns, starting uniformly where
it overlaps the block; the block's columns are every column some read
covers, so a block is wider than its own columns by the reads that stick
out on each side. Each block has `num_strains` random biallelic
haplotypes; each read comes from one strain drawn with equal abundance,
carries substitution errors at `error_rate`, and has phred qualities
drawn uniformly from [qual_lo, qual_hi]. Reads are sorted by start
(stable), the order the program and the reference phase them in.

The reads' lengths and starts come from `sizes_seed`, so every seed gives
the same blocks' sizes, in another order; the seed draws that order and
the content.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def block_sizes(spec: dict) -> List[Tuple[np.ndarray, np.ndarray]]:
    """[(starts, spans)] of each block's reads, in columns, sorted by
    start, the first start 0."""
    G, R, C = spec["num_blocks"], spec["reads_per_block"], \
        spec["block_sites"]
    rng = np.random.default_rng([int(spec["sizes_seed"]), 0x5153])
    bp = np.maximum(rng.normal(spec["read_length"], spec["read_length_sd"],
                               (G, R)), 200)
    span = np.maximum(np.rint(bp * spec["snps_per_bp"]), 1).astype(np.int64)
    # Uniform over the starts at which a read overlaps columns [0, C).
    start = (np.floor(rng.random((G, R)) * (C + span - 1)).astype(np.int64)
             - (span - 1))
    out = []
    for g in range(G):
        order = np.argsort(start[g], kind="stable")
        st = start[g][order]
        out.append((st - st[0], span[g][order]))
    return out


def make_blocks(spec: dict, seed: int) -> List[Tuple[np.ndarray,
                                                     np.ndarray]]:
    """[(alleles int8 [R, S] (-1 = uncovered), quals uint8 [R, S] (0 =
    uncovered))] for the `blocks` section `spec` of a configuration."""
    sizes = block_sizes(spec)
    K = spec["num_strains"]
    rng = np.random.default_rng([int(seed), 0xB10C])
    out = []
    for g in rng.permutation(len(sizes)):
        st, sp = sizes[g]
        R, S = len(st), int((st + sp).max())
        cols = np.arange(S)
        cov = (cols >= st[:, None]) & (cols < (st + sp)[:, None])
        strains = rng.integers(0, 2, (K, S)).astype(np.int8)
        hap = strains[rng.integers(0, K, R)][cov]
        n = len(hap)
        err = rng.random(n) < spec["error_rate"]
        alleles = np.full((R, S), -1, np.int8)
        qual = np.zeros((R, S), np.uint8)
        alleles[cov] = np.where(err, 1 - hap, hap)
        qual[cov] = rng.integers(spec["qual_lo"], spec["qual_hi"] + 1, n)
        out.append((alleles, qual))
    return out
