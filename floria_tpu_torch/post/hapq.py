"""Haplogroup quality scoring (HAPQ) and coverage/error statistics.

part_block_manip.rs:454-620 and utils_frags.rs:596-700. HAPQ combines an
overlap-similarity penalty (how much a haplogroup resembles overlapping
ones), a read-count factor, and a log length factor, capped at 60.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

from .. import constants
from ..frag import Frag


def fids_array(frag_ids) -> np.ndarray:
    """Canonical (sorted int64) id array from a set/list/array."""
    a = np.fromiter(frag_ids, dtype=np.int64, count=len(frag_ids))
    a.sort()
    return a


def errors_cov_from_frags(frags: Sequence[Frag], frag_ids,
                          left_snp: int, right_snp: int,
                          csr=None) -> Tuple[
                              float, float, float, float]:
    """(cov, err, total_err, total_support) over [left_snp, right_snp].

    Unweighted allele counts; cov = mean support over nonzero sites; err =
    (support - consensus) / support (utils_frags.rs:596-657). The
    reference's max tracking is iteration-order dependent
    (utils_frags.rs:620-623 compares against the running sum); we compute
    the intended per-site maximum. Counts are integral, so the vectorized
    (csr) and per-frag accumulations are exactly equal.
    """
    if csr is not None:
        counts = csr.window_counts(fids_array(frag_ids), left_snp,
                                   right_snp, weighted=False)
    else:
        S = right_snp - left_snp + 1
        counts = np.zeros((S, constants.MAX_ALLELES))
        for fid in frag_ids:
            f = frags[int(fid)]
            sel = (f.snps >= left_snp) & (f.snps <= right_snp)
            np.add.at(counts,
                      (f.snps[sel] - left_snp, f.alleles[sel]), 1.0)
    support = counts.sum(axis=-1)
    maxc = counts.max(axis=-1)
    nonzero = support > 0
    total_support = float(support.sum())
    total_err = float((support - maxc).sum())
    n_nonzero = int(nonzero.sum())
    cov = total_support / n_nonzero if n_nonzero else 0.0
    err = total_err / total_support if total_support else float("nan")
    return cov, err, total_err, total_support


def _consensus_arrays(frags: Sequence[Frag], frag_ids, csr=None):
    """(lo, consensus alleles [S], covered [S], counts [S, A])
    phred-weighted over the part's own SNP span, or None without sites.
    Array form of the reference's per-part consensus map — the pairwise
    comparisons below intersect windows instead of walking dicts
    (identical same/diff counts: they are set cardinalities)."""
    if csr is not None:
        fids = fids_array(frag_ids)
        lo, hi = csr.span(fids)
        if lo is None:
            return None
        # Native single-pass accumulation (== np.add.at bit-for-bit:
        # both walk entries in element order).
        acc, exist = csr.counts_range(fids, lo, hi, weighted=True)
        covered = exist.sum(axis=1) > 0
        return lo, acc.argmax(axis=1), covered, acc
    lo = None
    hi = None
    for fid in frag_ids:
        f = frags[int(fid)]
        if len(f.snps):
            flo, fhi = int(f.snps[0]), int(f.snps[-1])
            lo = flo if lo is None else min(lo, flo)
            hi = fhi if hi is None else max(hi, fhi)
    if lo is None:
        return None
    acc = np.zeros((hi - lo + 1, constants.MAX_ALLELES))
    covered = np.zeros(hi - lo + 1, dtype=bool)
    for fid in frag_ids:
        f = frags[int(fid)]
        # one site per SNP per frag -> fancy-index add is exact
        acc[f.snps - lo, f.alleles] += f.weights
        covered[f.snps - lo] = True
    return lo, acc.argmax(axis=1), covered, acc


def _consensus_map(frags: Sequence[Frag], frag_ids,
                   csr=None) -> Dict[int, Tuple[int, np.ndarray]]:
    """snp -> (consensus allele, counts[A]) phred-weighted; accumulator
    spans only the part's own SNP range (O(part span), not O(contig))."""
    out = _consensus_arrays(frags, frag_ids, csr)
    if out is None:
        return {}
    lo, cons, covered, acc = out
    return {int(p) + lo: (int(cons[p]), acc[p])
            for p in np.flatnonzero(covered)}


def overlap_percent(x1: int, x2: int, y1: int, y2: int) -> float:
    inter = max(min(x2 - y1 + 1, y2 - x1 + 1), 0)
    p = inter / (x2 - x1 + 1)
    return min(p, 1.0)


def find_overlapping(ranges: List[Tuple[int, int]],
                     ol_cutoff: float) -> Dict[int, List[Tuple[int,
                                                               float]]]:
    """index -> [(other index, overlap fraction)] for interval pairs that
    intersect (half-open [start, stop) like rust-lapper) with fraction
    above the cutoff (part_block_manip.rs:454-515)."""
    out: Dict[int, List[Tuple[int, float]]] = {}
    for i, (s1, e1) in enumerate(ranges):
        for j, (s2, e2) in enumerate(ranges):
            if i == j:
                continue
            if s2 < e1 and e2 > s1:  # lapper intersect on [start, stop)
                p = overlap_percent(s1, e1, s2, e2)
                if p > ol_cutoff:
                    out.setdefault(i, []).append((j, p))
    return out


def get_hapq(parts: List[Set[int]], ranges: List[Tuple[int, int]],
             frags: Sequence[Frag], snp_to_genome_pos: np.ndarray,
             block_length: int, csr=None) -> Tuple[List[int],
                                                   List[float], float]:
    """(hapqs, relative errors, avg_err) — part_block_manip.rs:517-620."""
    total_covs = []
    errs = []
    weight = 0.0
    error = 0.0
    for i, ids in enumerate(parts):
        _cov, err, total_err, total_cov = errors_cov_from_frags(
            frags, ids, ranges[i][0], ranges[i][1], csr=csr)
        weight += total_cov
        error += total_err
        total_covs.append(total_cov)
        errs.append(err)
    avg_err = error / weight if weight else float("nan")

    consensus = [_consensus_arrays(frags, ids, csr=csr) for ids in parts]
    overlaps = find_overlapping(ranges, 0.05)
    hapqs: List[int] = []
    purities: List[float] = []
    for i in range(len(parts)):
        max_penalty = 0.0
        for (j, ol) in overlaps.get(i, []):
            same = diff = 0.0
            a, b = consensus[i], consensus[j]
            if a is not None and b is not None:
                lo_a, cons_a, cov_a, _ = a
                lo_b, cons_b, cov_b, _ = b
                lo = max(lo_a, lo_b)
                hi = min(lo_a + len(cons_a), lo_b + len(cons_b)) - 1
                if hi >= lo:
                    ca = cons_a[lo - lo_a:hi - lo_a + 1]
                    cb = cons_b[lo - lo_b:hi - lo_b + 1]
                    m = (cov_a[lo - lo_a:hi - lo_a + 1]
                         & cov_b[lo - lo_b:hi - lo_b + 1])
                    same = float((m & (ca == cb)).sum())
                    diff = float(m.sum()) - same
            dist = diff / (same + diff) if (same + diff) else 1.0
            if ol * (1.0 - dist) > max_penalty:
                max_penalty = ol * (1.0 - dist)
        if parts[i]:
            base_range = (int(snp_to_genome_pos[ranges[i][1] - 1])
                          - int(snp_to_genome_pos[ranges[i][0] - 1]))
        else:
            base_range = 0
        t1 = constants.HAPQ_CONSTANT * (1.0 - max_penalty)
        t2 = min(1.0, len(parts[i]) / 3.0)
        t3 = max(0.0, math.log(base_range / block_length + 1.0))
        hapq = int(t1 * t2 * t3)
        if len(parts[i]) == 1:
            hapq = 0
        hapqs.append(min(hapq, 60))
        purities.append(errs[i] / avg_err if avg_err else float("nan"))
    return hapqs, purities, avg_err
