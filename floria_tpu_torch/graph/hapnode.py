"""Haplotype graph nodes.

A HapNode is one part of one block's chosen partition: its read set, its
consensus allele-count map restricted to the block's SNP interval, and a
2/3-quantile coverage (types_structs.rs:155-214). Nodes of adjacent blocks
are linked by unambiguous shared-read counts (graph_processing.rs:22-100).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from .. import constants
from ..frag import Frag


@dataclasses.dataclass
class HapNode:
    column: int                      # block index in graph order
    row: int                         # part index within the block
    node_id: int                     # global id (assigned in column order)
    frag_ids: np.ndarray             # sorted counter ids of member reads
    snp_endpoints: Tuple[int, int]   # 1-based inclusive SNP interval
    # Restricted consensus state over [lo, hi]: weighted counts and
    # entry-existence counts, both [S_node, A].
    counts: np.ndarray
    exist: np.ndarray
    cov: float
    out_edges: List[Tuple[int, float]] = dataclasses.field(
        default_factory=list)  # (row in next column, weight)
    in_edges: List[Tuple[int, float]] = dataclasses.field(
        default_factory=list)
    out_flows: List[Tuple[int, float]] = dataclasses.field(
        default_factory=list)

    @property
    def frag_id_set(self) -> set:
        return set(int(i) for i in self.frag_ids)


class FragCsr:
    """Concatenated (snps, alleles, weights) arrays over a frag list
    (indexed by counter id), enabling loop-free multi-frag gathers for
    the hap-graph join. Semantically equivalent to iterating the frags:
    gathered entries come back in (frag order, ascending SNP) order, so
    sequential accumulations see the same addition sequence."""

    def __init__(self, frags: Sequence[Frag]):
        n = len(frags)
        self.off = np.zeros(n + 1, dtype=np.int64)
        for i, f in enumerate(frags):
            self.off[i + 1] = self.off[i] + len(f.snps)
        if n:
            self.snps = np.concatenate([f.snps for f in frags])
            # int8 storage (allele values < MAX_ALLELES): an int64
            # upcast would cost 8x the memory and, on VMs where fresh
            # pages fault at ~30 MB/s, whole seconds per contig.
            self.alleles = np.concatenate([f.alleles for f in frags])
            self.weights = np.concatenate([f.weights for f in frags])
        else:
            self.snps = np.zeros(0, np.int64)
            self.alleles = np.zeros(0, np.int8)
            self.weights = np.zeros(0, np.float32)

    def gather(self, fids: np.ndarray):
        """(snps, alleles, weights, frag_row) of every site of the given
        frags, concatenated in frag order."""
        fids = np.asarray(fids, dtype=np.int64)
        lens = self.off[fids + 1] - self.off[fids]
        total = int(lens.sum())
        ridx = np.repeat(np.arange(len(fids)), lens)
        if total == 0:
            z = np.zeros(0, np.int64)
            return z, z, np.zeros(0, np.float32), ridx
        shift = self.off[fids] - np.concatenate(
            ([0], np.cumsum(lens)[:-1]))
        idx = np.arange(total) + np.repeat(shift, lens)
        return (self.snps[idx], self.alleles[idx], self.weights[idx],
                ridx)

    def gather_range(self, fids: np.ndarray, lo: int, hi: int):
        """gather() restricted to SNPs in [lo, hi]: same rows in the
        same (frag order, ascending SNP) order, but the out-of-range
        sites are never materialized (native binary-search slice copy;
        numpy mask fallback)."""
        from .. import native

        fids = np.asarray(fids, dtype=np.int64)
        out = native.csr_gather_range(self.snps, self.alleles,
                                      self.weights, self.off, fids,
                                      int(lo), int(hi))
        if out is not None:
            return out
        snps, alleles, weights, ridx = self.gather(fids)
        sel = (snps >= lo) & (snps <= hi)
        return snps[sel], alleles[sel], weights[sel], ridx[sel]

    def counts_range(self, fids: np.ndarray, lo: int, hi: int,
                     weighted: bool, need_exist: bool = True):
        """(counts f64 [S, A], exist i32 [S, A] or None) consensus
        accumulation over [lo, hi] — native single pass (nothing
        materialized), with the gather+bincount path as the
        bit-identical fallback (both accumulate in (frag order,
        ascending SNP) element order). need_exist=False lets the
        fallback skip the second bincount for callers that discard it
        (the native pass tallies both for free)."""
        from .. import constants, native

        A = constants.MAX_ALLELES
        fids = np.asarray(fids, dtype=np.int64)
        out = native.csr_counts(self.snps, self.alleles, self.weights,
                                self.off, fids, int(lo), int(hi), A,
                                weighted)
        if out is not None:
            return out
        S = hi - lo + 1
        snps, alleles, weights, _r = self.gather_range(fids, lo, hi)
        flat = (snps - lo) * A + alleles
        if weighted:
            counts = np.bincount(flat, weights=weights,
                                 minlength=S * A)
        else:
            counts = np.bincount(flat, minlength=S * A).astype(np.float64)
        exist = (np.bincount(flat, minlength=S * A).astype(np.int32)
                 .reshape(S, A) if need_exist else None)
        return counts.reshape(S, A), exist

    def window_counts(self, fids: np.ndarray, lo: int, hi: int,
                      weighted: bool) -> np.ndarray:
        """[hi-lo+1, A] float64 allele counts over the given frags
        restricted to [lo, hi] — the common consensus accumulation
        (1 unit or phred weight per entry), addition order identical to
        the per-frag loops it replaces."""
        return self.counts_range(fids, lo, hi, weighted,
                                 need_exist=False)[0]

    def span(self, fids: np.ndarray):
        """(lo, hi) SNP range covered by the given frags, or (None, None)
        if none has sites."""
        fids = np.asarray(fids, dtype=np.int64)
        if len(fids) == 0:
            return None, None
        lens = self.off[fids + 1] - self.off[fids]
        nz = fids[lens > 0]
        if len(nz) == 0:
            return None, None
        first = self.snps[self.off[nz]]
        last = self.snps[self.off[nz + 1] - 1]
        return int(first.min()), int(last.max())


def build_hap_node(frags: Sequence[Frag], frag_ids: np.ndarray,
                   snp_endpoints: Tuple[int, int], column: int,
                   row: int, csr: FragCsr = None) -> HapNode:
    """HapNode::new (types_structs.rs:168-209): phred-weighted allele
    counts restricted to the SNP interval; coverage = the 2/3-quantile of
    the flattened per-(site, allele) count list."""
    lo, hi = snp_endpoints
    S = hi - lo + 1
    A = constants.MAX_ALLELES
    counts = np.zeros((S, A), dtype=np.float64)
    exist = np.zeros((S, A), dtype=np.int32)
    if csr is not None:
        # Accumulation order = (frag order, ascending SNP) — the same
        # sequence as the per-frag loop below, so floats are
        # bit-identical.
        counts, exist = csr.counts_range(frag_ids, lo, hi,
                                         weighted=True)
    else:
        for fid in frag_ids:
            f = frags[int(fid)]
            sel = (f.snps >= lo) & (f.snps <= hi)
            cols = f.snps[sel] - lo
            np.add.at(counts, (cols, f.alleles[sel]), f.weights[sel])
            np.add.at(exist, (cols, f.alleles[sel]), 1)
    vals = counts[exist > 0]
    if vals.size == 0:
        cov = 0.0
    else:
        vals = np.sort(vals)
        cov = float(vals[len(vals) * 2 // 3])
    return HapNode(column=column, row=row, node_id=-1,
                   frag_ids=np.sort(np.asarray(frag_ids, dtype=np.int64)),
                   snp_endpoints=snp_endpoints, counts=counts, exist=exist,
                   cov=cov)


def assign_ids(hap_graph: List[List[HapNode]]) -> None:
    """Column-major global ids (graph_processing.rs:306-323)."""
    counter = 0
    for column, block in enumerate(hap_graph):
        for node in block:
            node.column = column
            node.node_id = counter
            counter += 1
