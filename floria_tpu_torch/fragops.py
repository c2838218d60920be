"""Fragment-level preprocessing operations.

- remove_monomorphic_allele (utils_frags.rs:713-772): drop SNPs whose
  minor allele weight is below error * major.
- hybrid_correction (utils_frags.rs:492-574): polish long-read SNP calls
  with covering short-read consensus.
- length helpers (utils_frags.rs:186-203).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import constants
from .frag import Frag, sort_and_renumber


def get_avg_length(frags: Sequence[Frag], quantile: float) -> int:
    lengths = sorted(f.last_position - f.first_position for f in frags)
    return lengths[int(len(lengths) * quantile)]


def get_length_gn(frags: Sequence[Frag]) -> int:
    return max((f.last_position for f in frags), default=0)


def remove_monomorphic_allele(frags: List[Frag],
                              error: float) -> List[Frag]:
    """Drop monomorphic/near-monomorphic SNPs and re-freeze fragments."""
    acc: Dict[int, np.ndarray] = {}
    seen: Dict[int, np.ndarray] = {}
    for f in frags:
        for p, a, w in zip(f.snps, f.alleles, f.weights):
            p = int(p)
            site = acc.get(p)
            if site is None:
                site = np.zeros(constants.MAX_ALLELES)
                acc[p] = site
                seen[p] = np.zeros(constants.MAX_ALLELES, dtype=bool)
            site[a] += w
            seen[p][a] = True

    mono = set()
    for p, site in acc.items():
        present = seen[p]
        if present.sum() <= 1:
            mono.add(p)
        else:
            vals = np.sort(site[present])[::-1]
            if vals[0] * error > vals[1]:
                mono.add(p)

    out: List[Frag] = []
    for f in frags:
        keep = np.array([int(p) not in mono for p in f.snps], dtype=bool)
        if not keep.any():
            continue
        f.snps = f.snps[keep]
        f.alleles = f.alleles[keep]
        f.quals = f.quals[keep]
        f.weights = f.weights[keep]
        f.seq_dict = {int(p): int(a) for p, a in zip(f.snps, f.alleles)}
        f.qual_dict = {int(p): int(q) for p, q in zip(f.snps, f.quals)}
        for p in list(f.snp_pos_to_seq_pos):
            if p in mono:
                del f.snp_pos_to_seq_pos[p]
        f.first_position = int(f.snps[0])
        f.last_position = int(f.snps[-1])
        out.append(f)
    return sort_and_renumber(out)


def _distance(f1: Frag, f2: Frag) -> Tuple[int, int]:
    """Rounded phred-product distance between two fragments
    (utils_frags.rs:17-30)."""
    shared, i1, i2 = np.intersect1d(f1.snps, f2.snps,
                                    return_indices=True)
    if len(shared) == 0:
        return 0, 0
    agree = f1.alleles[i1] == f2.alleles[i2]
    prod = np.round(f1.weights[i1] * f2.weights[i2]).astype(int)
    return int(prod[agree].sum()), int(prod[~agree].sum())


def hybrid_correction(frags: List[Frag]) -> Tuple[List[Frag], List[Frag]]:
    """(corrected long frags, short frags) — utils_frags.rs:492-574.

    For each long fragment, greedily pick, at each yet-uncovered SNP, the
    covering short fragment most concordant with the long read (score
    same*10/(diff+1); ties resolve to the smallest read id where the
    reference follows set order), then overwrite the long read's alleles
    wherever the picked short set is unanimous.
    """
    pos_to_short: Dict[int, List[Frag]] = {}
    long_frags = []
    short_frags = []
    for f in frags:
        if f.is_paired:
            short_frags.append(f)
            for p in f.snps:
                pos_to_short.setdefault(int(p), []).append(f)
        else:
            long_frags.append(f)

    corrected = []
    for lf in long_frags:
        covered = set()
        covering: Dict[int, Frag] = {}
        for p in lf.snps:
            p = int(p)
            if p in covered:
                continue
            cands = pos_to_short.get(p)
            if not cands:
                continue
            best = max(
                cands,
                key=lambda sf: ((lambda s, d: (s * 10) // (d + 1))(
                    *_distance(sf, lf)), -sf.counter_id))
            for q in best.snps:
                covered.add(int(q))
            covering[best.counter_id] = best
        # unanimous short-read consensus per position
        site_alleles: Dict[int, set] = {}
        for sf in covering.values():
            for p, a in zip(sf.snps, sf.alleles):
                site_alleles.setdefault(int(p), set()).add(int(a))
        new = lf
        changed = {}
        for idx, p in enumerate(new.snps):
            p = int(p)
            if p in site_alleles and len(site_alleles[p]) == 1:
                changed[idx] = next(iter(site_alleles[p]))
        if changed:
            alleles = new.alleles.copy()
            for idx, a in changed.items():
                alleles[idx] = a
            new.alleles = alleles
            new.seq_dict = {int(p): int(a)
                            for p, a in zip(new.snps, new.alleles)}
        corrected.append(new)
    return corrected, short_frags
