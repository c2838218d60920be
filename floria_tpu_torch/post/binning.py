"""Coverage-based haplogroup binning (hidden --bin-by-cov flag).

part_block_manip.rs:290-452: agglomeratively merge haplogroups that do not
overlap, lie within 2 block lengths of each other, and have Poisson-
compatible coverages (negative log mean PMF below -ln(0.01)); only
unambiguous (single-candidate) merges are applied, best first.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from ..graph.paths import Haplogroup
from ..ingest.vcf import ContigVcf

_CUTOFF = -math.log(0.01)


def _poisson_pmf(k: int, lam: float) -> float:
    if lam <= 0:
        return 0.0
    return math.exp(-lam + k * math.log(lam) - math.lgamma(k + 1))


def _overlap(x1, x2, y1, y2) -> bool:
    if y1 < x2 < y2:
        return True
    if x1 < y2 < x2:
        return True
    if x1 >= y1 and x2 <= y2:
        return True
    if x1 <= y1 and x2 >= y2:
        return True
    return False


def _close_enough(x1, x2, y1, y2, block_len) -> bool:
    return (abs(x2 - y1) < 2 * block_len or abs(y2 - x1) < 2 * block_len)


def _dist(x: List[Tuple[int, int, float, int]],
          y: List[Tuple[int, int, float, int]], block_len: int) -> float:
    compat_ol = True
    compat_ce = False
    for (x1, x2, _cx, _i) in x:
        for (y1, y2, _cy, _j) in y:
            if _close_enough(x1, x2, y1, y2, block_len):
                compat_ce = True
            if _overlap(x1, x2, y1, y2):
                compat_ol = False
                break
        if not compat_ol:
            break
    if not compat_ol or not compat_ce:
        return float("inf")
    cov_x = sum(h[2] for h in x) / len(x)
    cov_y = sum(h[2] for h in y) / len(y)
    d = (_poisson_pmf(int(cov_y), cov_x)
         + _poisson_pmf(int(cov_x), cov_y))
    if d <= 0:
        return float("inf")
    return -math.log(d / 2.0)


def bin_haplogroups(haplogroups: List[Haplogroup], cv: ContigVcf,
                    block_len: int,
                    debug_path: str | None = None) -> List[Haplogroup]:
    clusters: List[List[Tuple[int, int, float, int]]] = []
    none_clusters: List[int] = []
    for i, h in enumerate(haplogroups):
        left_gn = cv.snp_to_gn(h.snp_range[0])
        right_gn = cv.snp_to_gn(h.snp_range[1])
        if h.cov is not None:
            clusters.append([(left_gn, right_gn, h.cov, i)])
        else:
            none_clusters.append(i)
    clusters.sort(key=lambda c: c[0][0])

    while True:
        best_moves = []
        h = 100
        for i in range(len(clusters)):
            moves_i = []
            lo = max(0, i - h)
            hi = min(len(clusters), i + h)
            for j in range(lo, hi):
                if i == j:
                    continue
                d = _dist(clusters[i], clusters[j], block_len)
                if d < _CUTOFF:
                    moves_i.append((i, j, d))
            if len(moves_i) == 1:  # only unambiguous merges
                best_moves.extend(moves_i)
        if not best_moves:
            break
        best_moves.sort(key=lambda m: m[2])
        i, j, _d = best_moves[0]
        hi_idx, lo_idx = max(i, j), min(i, j)
        removed = clusters.pop(hi_idx)
        clusters[lo_idx].extend(removed)

    if debug_path is not None:
        # The reference dumps the final cluster list
        # (part_block_manip.rs:420-421, Rust debug format, written to
        # the CWD; we keep it next to the contig outputs instead).
        with open(debug_path, "w") as fh:
            fh.write("[" + ", ".join(
                "[" + ", ".join(
                    f"({l}, {r}, {c}, {i})" for (l, r, c, i) in cluster)
                + "]" for cluster in clusters) + "]")

    out: List[Haplogroup] = []
    for cluster in clusters:
        ids = set()
        lo, hi = np.iinfo(np.int64).max, 0
        for (_l, _r, _c, idx) in cluster:
            hgroup = haplogroups[idx]
            ids.update(int(f) for f in hgroup.frag_ids)
            lo = min(lo, hgroup.snp_range[0])
            hi = max(hi, hgroup.snp_range[1])
        covs = [c for (_l, _r, c, _i) in cluster]
        out.append(Haplogroup(
            frag_ids=np.asarray(sorted(ids), dtype=np.int64),
            snp_range=(int(lo), int(hi)),
            cov=sum(covs) / len(covs) if covs else None))
    for idx in none_clusters:
        out.append(haplogroups[idx])
    return out
