"""Exact-semantics host oracle for the local phasing algorithms (the
port's copy of the JAX package's tests/oracle.py, on the port's
constants).

Direct dict/heap realization of the algorithm described by the reference
(global_clustering.rs, local_clustering.rs, utils_frags.rs), including
haplotype truncation and duplicate-block dedup, used as the ground truth
the batched device kernels are validated against. Deliberately slow and
simple.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

from .. import constants

Read = Dict[int, Tuple[int, float]]  # snp -> (allele, weight)
Hap = Dict[int, Dict[int, float]]    # snp -> allele -> weight


def binom_tail(n: float, k: float, p: float, div: float) -> float:
    n = math.floor(n)
    k = math.floor(k)
    if n == 0:
        return 0.0
    a = k / n
    if a == 1.0:
        a = 0.9999999
    if a == 0.0:
        a = 0.0000001
    rel_ent = a * math.log(a / p) + (1 - a) * math.log((1 - a) / (1 - p))
    if a < p:
        rel_ent = -rel_ent
    return -n / div * rel_ent


def dist_eps(read: Read, hap: Hap, eps: float) -> Tuple[float, float]:
    same = diff = 0.0
    for pos, (allele, w) in read.items():
        entries = hap.get(pos)
        if not entries or all(v == 0.0 for v in entries.values()):
            diff += eps
            continue
        maxc = max(entries.values())
        if entries.get(allele) == maxc:
            same += w
        else:
            diff += w
    return same, diff


def strip_zero_entries(counts: List[Hap]) -> List[Hap]:
    """Normalize a block for dedup equality: drop (site, allele)
    entries whose accumulated weight is exactly 0 (possible only via
    phred-0 bases), then sites left empty.

    DELIBERATE DEVIATION from the reference: its HapBlock equality
    (global_clustering.rs:122-127 over types_structs.rs:253 maps)
    distinguishes an explicit 0-weight entry from an absent one, while
    the kernel's linear fingerprints (kernels/beam.py _hash_consts)
    cannot — a presence indicator is not a linear function of per-read
    contributions, so NO exact linear fingerprint exists for the
    reference's equality. Scoring already treats the two identically
    (the all-zero test in dist_eps mirrors utils_frags.rs:696-700), so
    the normalized equality deduplicates a superset of the reference's
    duplicates: chains differing only in zero-weight entries are
    score-equivalent forever and merging them frees a beam slot for a
    genuinely distinct chain. Pinned by tests/test_phred0_dedup.py."""
    return [{pos: {a: w for a, w in site.items() if w != 0.0}
             for pos, site in hap.items()
             if any(w != 0.0 for w in site.values())}
            for hap in counts]


def beam_search(reads: Sequence[Read], ploidy: int, eps: float,
                beam_width: int = 10,
                zero_strip: bool = True) -> List[int]:
    """Returns assignment[i] = part of reads[i] (reads pre-sorted).

    zero_strip=False reproduces the reference's raw dict equality for
    dedup (see strip_zero_entries); the kernels realize the default
    normalized equality."""
    # node: (score, uid, parent_node, part, counts)
    root = (0.0, 0, None, None, [dict() for _ in range(ploidy)])
    beam = [root]
    uid = 1
    for i, read in enumerate(reads):
        width = ploidy * beam_width if i < constants.BEAM_WARMUP_READS \
            else beam_width
        start = min(read.keys())
        cands = []
        for node in beam:
            score, _, _, _, counts = node
            pvals = []
            diffs = []
            for j in range(ploidy):
                s, d = dist_eps(read, counts[j], eps)
                pvals.append(binom_tail(s + d, d, eps,
                                        constants.DIV_FACTOR))
                diffs.append(d)
            m = max(pvals)
            lse = m + math.log(sum(math.exp(v - m) for v in pvals))
            for j in range(ploidy):
                if pvals[j] - lse > math.log(constants.PROB_CUTOFF):
                    # truncate left of current read start, then add read
                    new_counts = []
                    for q in range(ploidy):
                        hq = {p: dict(a) for p, a in counts[q].items()
                              if p >= start}
                        new_counts.append(hq)
                    for pos, (allele, w) in read.items():
                        site = new_counts[j].setdefault(pos, {})
                        site[allele] = site.get(allele, 0.0) + w
                    cands.append((score + diffs[j], uid, node, j,
                                  new_counts))
                    uid += 1
        # dedup identical blocks keeping the WORSE score
        # (global_clustering.rs:122-127 keeps the existing node when its
        # score >= the new one)
        norm = ((lambda b: strip_zero_entries(b)) if zero_strip
                else (lambda b: b))
        kept = []
        kept_norm = []
        for c in cands:
            c_norm = norm(c[4])
            dup = False
            for k, k_norm in zip(kept, kept_norm):
                if k_norm == c_norm and k[0] >= c[0]:
                    dup = True
                    break
            if not dup:
                kept.append(c)
                kept_norm.append(c_norm)
        kept.sort(key=lambda c: (c[0], c[1]))
        beam = kept[:width]
    best = min(beam, key=lambda c: (c[0], c[1]))
    assignment = [0] * len(reads)
    node = best
    t = len(reads) - 1
    while node[2] is not None:
        assignment[t] = node[3]
        node = node[2]
        t -= 1
    return assignment


def hap_from_partition(reads: Sequence[Read], assignment: Sequence[int],
                       ploidy: int, weighted: bool) -> List[Hap]:
    haps: List[Hap] = [dict() for _ in range(ploidy)]
    for read, part in zip(reads, assignment):
        for pos, (allele, w) in read.items():
            site = haps[part].setdefault(pos, {})
            site[allele] = site.get(allele, 0.0) + (w if weighted else 1.0)
    return haps


def mec_stats_epsilon(haps: List[Hap], eps: float) -> List[Tuple[float,
                                                                 float]]:
    out = []
    for hap in haps:
        bases = errors = 0.0
        for entries in hap.values():
            if not entries:
                continue
            vals = sorted(entries.values())
            cons = vals[-1]
            bases += cons
            errors += sum(vals[:-1])
            if cons <= 1.0:
                errors += eps
        out.append((bases, errors))
    return out


def upem_optimize(reads: Sequence[Read], assignment: List[int],
                  ploidy: int, eps: float) -> List[int]:
    def score_of(asg):
        haps = hap_from_partition(reads, asg, ploidy, weighted=True)
        return -sum(e for _b, e in mec_stats_epsilon(haps, eps))

    prev = score_of(assignment)
    best = list(assignment)
    for _ in range(constants.NUM_ITER_OPTIMIZE):
        new = opt_iterate(reads, best, ploidy, eps)
        ns = score_of(new)
        if ns > prev:
            prev, best = ns, new
        else:
            return best
    return best


def opt_iterate(reads: Sequence[Read], assignment: List[int], ploidy: int,
                eps: float) -> List[int]:
    haps = hap_from_partition(reads, assignment, ploidy, weighted=True)
    sizes = [assignment.count(p) for p in range(ploidy)]
    moves = []
    for r, read in enumerate(reads):
        i = assignment[r]
        if sizes[i] <= 1:
            continue
        _s, own = dist_eps(read, haps[i], eps)
        for j in range(ploidy):
            if j == i:
                continue
            _s2, other = dist_eps(read, haps[j], eps)
            if own - other > 0:
                moves.append((own - other, r, i, j))
    new = list(assignment)
    if not moves:
        return new
    moves.sort(key=lambda m: -m[0])
    n_moves = len(moves) // 10
    if n_moves == 0:
        n_moves = len(moves) // 3 + 1
    moved = set()
    cur = list(sizes)
    for mv_num, (_g, r, i, j) in enumerate(moves):
        if r in moved:
            continue
        if cur[i] == 1:
            continue
        new[r] = j
        cur[j] += 1
        cur[i] -= 1
        moved.add(r)
        if mv_num > n_moves:
            break
    return new


def frag_to_read(frag) -> Read:
    return {int(p): (int(a), float(w))
            for p, a, w in zip(frag.snps, frag.alleles, frag.weights)}
