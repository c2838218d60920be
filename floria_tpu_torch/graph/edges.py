"""Hap-graph edge construction: unambiguous shared-read counting.

For each node of block i, each of its reads votes for the node of block
i+1 that contains it — but only when the read's rounded distance to its
nearest block-(i+1) haplotype is strictly better than to the second
nearest (ambiguous reads abstain; crucial for short reads). Edges with at
least MIN_SHARED_READS_UNAMBIG votes are kept
(graph_processing.rs:22-100). This join is the only cross-block
synchronization in the whole pipeline.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .. import constants
from ..frag import Frag
from .hapnode import HapNode


def _read_node_diff(frag: Frag, node: HapNode) -> int:
    """Rounded phred diff of a read vs a node's restricted consensus
    (utils_frags.rs:77-108 semantics; ties add nothing)."""
    lo, hi = node.snp_endpoints
    sel = (frag.snps >= lo) & (frag.snps <= hi)
    if not sel.any():
        return 0
    cols = frag.snps[sel] - lo
    alleles = frag.alleles[sel].astype(np.int64)
    weights = frag.weights[sel]
    has_key = node.exist[cols].sum(axis=-1) > 0
    at = node.counts[cols, alleles]
    at_exists = node.exist[cols, alleles] > 0
    maxc = node.counts[cols].max(axis=-1)
    # diff: covered-by-map sites where the read's allele neither is a
    # maximal existing entry nor exists at all at max weight
    diff_mask = has_key & ~(at_exists & (at == maxc))
    # f64 sum: exact on the 2^-26 weight grid, so the round() matches
    # the reference's f64 arithmetic (see stats.py distance_matrix_eps).
    return int(round(float(weights[diff_mask].astype(np.float64).sum())))


def update_hap_graph(hap_graph: List[List[HapNode]],
                     frags: Sequence[Frag],
                     csr: "FragCsr" = None) -> None:
    """Attach out/in edges between adjacent blocks in place.

    With a FragCsr the per-(read, node2) diffs of a block pair are
    computed in one vectorized pass (gather all shared reads' sites
    once, per-read segment sums via bincount); without one, the scalar
    per-read walk runs. Both orders additions identically (ascending
    SNP per read), matching dist_rounded's sequential sum."""
    for i in range(len(hap_graph) - 1):
        block1 = hap_graph[i]
        block2 = hap_graph[i + 1]
        if csr is not None:
            _link_blocks_vectorized(block1, block2, csr)
        else:
            _link_blocks_scalar(block1, block2, frags)
        # Mirror in_edges on the receiving side
        for j, node1 in enumerate(block1):
            for (l, w) in node1.out_edges:
                block2[l].in_edges.append((j, w))


def _link_blocks_vectorized(block1: List[HapNode],
                            block2: List[HapNode], csr) -> None:
    n2 = len(block2)
    fids = np.unique(np.concatenate(
        [n.frag_ids for n in block1])) if block1 else np.zeros(0,
                                                               np.int64)
    if len(fids) == 0:
        return
    lo, hi = block2[0].snp_endpoints
    snps, al, w, ridx = csr.gather_range(fids, lo, hi)
    cols = snps - lo
    F = len(fids)
    # One pass over all block2 nodes (they share snp_endpoints, so the
    # count windows stack): [n2, n_sites] masks, then a single flat
    # bincount. Bin accumulation order per (node, read) matches the
    # per-node loop it replaces, so sums are bit-identical.
    counts2 = np.stack([n.counts for n in block2])   # [n2, S2, A]
    exist2 = np.stack([n.exist for n in block2])
    from .. import native
    sums = native.link_diffs(counts2, exist2, cols, al, w, ridx, F)
    if sums is None:
        # Numpy fallback (the spec the native pass is bit-identical
        # to). Per-SITE stats reduce once over [n2, S2, A] and are then
        # gathered per read-site — identical values to reducing the
        # gathered rows, at ~1/coverage of the reduction work.
        has_any = exist2.sum(axis=-1) > 0            # [n2, S2]
        maxc_all = counts2.max(axis=-1)              # [n2, S2]
        has_key = has_any[:, cols]                   # [n2, n]
        at = counts2[:, cols, al]
        at_exists = exist2[:, cols, al] > 0
        maxc = maxc_all[:, cols]
        dm = has_key & ~(at_exists & (at == maxc))
        contrib = np.where(dm, w.astype(np.float64)[None, :], 0.0)
        flat = (np.arange(n2, dtype=np.int64)[:, None] * F
                + ridx[None, :]).ravel()
        sums = np.bincount(flat, weights=contrib.ravel(),
                           minlength=n2 * F).reshape(n2, F)
    diffs = np.round(sums).astype(np.int64).T
    if n2 > 1:
        top2 = np.partition(diffs, 1, axis=1)[:, :2]
        unambig = top2[:, 0] != top2[:, 1]
    else:
        unambig = np.ones(len(fids), dtype=bool)
    mem = np.full(len(fids), -1, dtype=np.int64)
    for l, node2 in enumerate(block2):
        mem[np.isin(fids, node2.frag_ids)] = l
    votes = unambig & (mem >= 0)
    for node1 in block1:
        rows = np.searchsorted(fids, node1.frag_ids)
        v = votes[rows]
        out_weights = np.bincount(mem[rows[v]], minlength=n2).astype(
            np.float64)
        for l in range(n2):
            if out_weights[l] >= constants.MIN_SHARED_READS_UNAMBIG:
                node1.out_edges.append((l, float(out_weights[l])))


def _link_blocks_scalar(block1: List[HapNode], block2: List[HapNode],
                        frags: Sequence[Frag]) -> None:
    membership = {}
    for l, node2 in enumerate(block2):
        for fid in node2.frag_ids:
            membership[int(fid)] = l
    # Cache read-vs-node2 diffs: reads shared across block1 nodes.
    diff_cache = {}
    for node1 in block1:
        out_weights = np.zeros(len(block2))
        for fid in node1.frag_ids:
            fid = int(fid)
            if fid not in diff_cache:
                frag = frags[fid]
                diff_cache[fid] = [
                    _read_node_diff(frag, node2) for node2 in block2]
            diffs = diff_cache[fid]
            hap_id_in = membership.get(fid)
            if len(diffs) > 1:
                top2 = sorted(diffs)[:2]
                if top2[0] != top2[1]:
                    if hap_id_in is not None:
                        out_weights[hap_id_in] += 1.0
            else:
                if hap_id_in is not None:
                    out_weights[hap_id_in] += 1.0
        for l in range(len(block2)):
            if out_weights[l] >= constants.MIN_SHARED_READS_UNAMBIG:
                node1.out_edges.append((l, float(out_weights[l])))
