"""Plain numpy reference of local block phasing: the beam search over read
partitions, its traceback, the UPEM hill-climb and the unit-weight MEC
statistics, with floria's semantics (global_clustering.rs,
local_clustering.rs, utils_frags.rs).

Written from the algorithm, not from the program: every phred weight and
the error rate are exact multiples of 2^-26, so counts, distances, scores
and MEC sums are held as int64 numbers of quanta and every sum is exact in
any order. Only the binomial tail and the log-sum-exp prune use float64
transcendental functions.

A block is `alleles` int8 [R, S] (-1 = uncovered; reads in the block's
canonical order) and `wq` int64 [R, S] (weight quanta, 0 where
uncovered). The control (`scale=1.0` with float32 weights and error
rate) runs the same steps in float32, the precision below the stated one.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

QUANTUM = 67108864  # 2^26
NUM_ITER_OPTIMIZE = 20
DIV_FACTOR = 0.25
PROB_CUTOFF = 0.01
BEAM_WARMUP_READS = 25
CUTOFF = math.log(PROB_CUTOFF)

def phred_weight(quals: np.ndarray) -> np.ndarray:
    """1 - 10^(-q/10) in float32, as the reference computes it
    (utils_frags.rs:702-711); 0 for phred 0."""
    q = np.asarray(quals).astype(np.float32)
    return (1.0 - np.power(np.float32(10.0), q / np.float32(-10.0))).astype(
        np.float32)


def weight_quanta(quals: np.ndarray) -> np.ndarray:
    """Weights of phred quals as int64 quanta of 2^-26 (exact)."""
    w = phred_weight(quals).astype(np.float64) * QUANTUM
    q = np.rint(w).astype(np.int64)
    if not np.array_equal(q.astype(np.float64), w):
        raise ValueError("a phred weight is off the 2^-26 grid")
    return q


def epsilon_quanta(epsilon: float) -> int:
    """The error rate on the 2^-26 grid, at least one quantum (the
    program's Options quantise it the same way before any use)."""
    return max(int(round(epsilon * QUANTUM)), 1)


def binom_tail(n, k, p):
    """floria's binomial tail (utils_frags.rs) on float64 arrays."""
    n = np.floor(n)
    k = np.floor(k)
    safe_n = np.where(n == 0.0, 1.0, n)
    a = np.minimum(np.maximum(k / safe_n, 1e-7), 0.9999999)
    rel = a * np.log(a / p) + (1.0 - a) * np.log((1.0 - a) / (1.0 - p))
    rel = np.where(a < p, -rel, rel)
    return np.where(n == 0.0, 0.0, (-n / DIV_FACTOR) * rel)


def _keys(P: int, S: int, A: int) -> np.ndarray:
    """Fixed random odd uint64 keys of a linear hash of a count state."""
    rng = np.random.default_rng(0x5EED)
    return rng.integers(0, 2**63, (P, S, A), dtype=np.int64
                        ).astype(np.uint64) * 2 + 1


def _read(alleles, wq, t):
    cols = np.flatnonzero(alleles[t] >= 0)
    return cols, alleles[t, cols].astype(np.int64), wq[t, cols]


def _exact(wq, epsq, scale):
    """Integer quanta as float64 (exact below 2^53); the float32 control
    as given."""
    if scale == QUANTUM:
        return wq.astype(np.float64), float(epsq)
    return wq, epsq


def _dist(E, a, w, cov, epsq):
    """(same, diff) of a read against count states E [N, P, L, A] over the
    read's span of L columns (a: its alleles, w: its weights, 0 and
    cov False where it has no call): an empty site costs epsilon; a site
    whose consensus weight the read's allele reaches counts as same, any
    other as diff. Dot products run in the states' type: exact on integer
    quanta held in float64 (every partial sum is below 2^53)."""
    maxc = E[..., 0]
    at = np.where(a == 0, E[..., 0], 0)
    for k in range(1, E.shape[-1]):
        maxc = np.maximum(maxc, E[..., k])
        at = np.where(a == k, E[..., k], at)
    empty = maxc == 0
    hit = at == maxc
    dt = E.dtype
    same = (hit & ~empty).astype(dt) @ w
    diff = ((~hit & ~empty).astype(dt) @ w
            + epsq * (empty & cov).sum(-1).astype(dt))
    return same, diff


def beam_search(alleles: np.ndarray, wq: np.ndarray, epsq, P: int,
                W: int, scale=QUANTUM) -> np.ndarray:
    """The beam search of one (block, ploidy) instance; returns the
    assignment [R] int32 of the best final partition (ties by creation
    order). Per read: each beam node scores the read against each part
    (binomial tail), parts whose posterior passes the cutoff make
    children (score + distance), the children's blocks are truncated
    left of the read's first site, a child whose truncated block equals
    an earlier child's that scores at least as high is dropped, and the
    best P * W (first 25 reads) or W children survive."""
    R, S = alleles.shape
    A = max(2, int(alleles.max()) + 1)
    eps = epsq / scale
    wq, epsq = _exact(wq, epsq, scale)
    keys = _keys(P, S, A)
    counts = np.zeros((1, P, S, A), wq.dtype)
    score = np.zeros(1, wq.dtype)
    uid = np.zeros(1, np.int64)
    next_uid = 1
    hi = 0  # columns >= hi are zero in every state
    history: List[Tuple[np.ndarray, np.ndarray]] = []
    for t in range(R):
        cols, a, w = _read(alleles, wq, t)
        start = int(cols[0])
        width = P * W if t < BEAM_WARMUP_READS else W
        c1 = int(cols[-1]) + 1
        span_a = alleles[t, start:c1]
        same_q, diff_q = _dist(counts[:, :, start:c1, :], span_a,
                               wq[t, start:c1], span_a >= 0, epsq)
        pval = binom_tail((same_q / scale) + (diff_q / scale),
                          diff_q / scale, eps)
        m = pval.max(axis=1)
        ssum = np.zeros(len(m))
        for q in range(P):
            ssum = ssum + np.exp(pval[:, q] - m)
        lse = m + np.log(ssum)
        cn, cj = np.nonzero(pval - lse[:, None] > CUTOFF)
        cscore = score[cn] + diff_q[cn, cj]
        cuid = next_uid + np.arange(len(cn), dtype=np.int64)
        next_uid += len(cn)
        # Linear hash of each child's truncated block, uint64 wrapping.
        top = max(hi, int(cols[-1]) + 1)
        tail = counts[:, :, start:top, :].astype(np.uint64)
        node_h = (tail * keys[None, :, start:top, :]).sum(axis=(1, 2, 3))
        read_h = (w.astype(np.uint64)[None, :]
                  * keys[:, cols, a]).sum(axis=1, dtype=np.uint64)
        cand_h = node_h[cn] + read_h[cj]

        def child(i):
            st = counts[cn[i]].copy()
            st[:, :start, :] = 0
            st[cj[i], cols, a] += w
            return st

        kept: List[int] = []
        by_hash = {}
        states = {}
        for i in range(len(cn)):
            h = int(cand_h[i])
            dup = False
            for k in by_hash.get(h, ()):
                if cscore[k] < cscore[i]:
                    continue
                if k not in states:
                    states[k] = child(k)
                if np.array_equal(states[k], child(i)):
                    dup = True
                    break
            if not dup:
                kept.append(i)
                by_hash.setdefault(h, []).append(i)
        kept = np.array(kept, dtype=np.int64)
        order = kept[np.lexsort((cuid[kept], cscore[kept]))][:width]
        new = counts[cn[order]]
        new[:, :, :start, :] = 0
        new[np.arange(len(order))[:, None], cj[order][:, None], cols[None, :],
            a[None, :]] += w[None, :]
        counts = new
        score = cscore[order]
        uid = cuid[order]
        history.append((cn[order], cj[order]))
        hi = top
    assignment = np.zeros(R, np.int32)
    node = 0  # the sorted beam's first: lowest score, then oldest
    for t in range(R - 1, -1, -1):
        parent, part = history[t]
        assignment[t] = part[node]
        node = parent[node]
    return assignment


def _part_counts(alleles, wq, assignment, P, A, unit=None):
    """counts [P, S, A] (weights, or `unit` per read, in their type) and
    cover [P, S] reads per part."""
    R, S = alleles.shape
    r, c = np.nonzero(alleles >= 0)
    p = assignment[r].astype(np.int64)
    w = np.full(len(r), unit) if unit is not None else wq[r, c]
    flat = (p * S + c) * A + alleles[r, c].astype(np.int64)
    if w.dtype == np.float64:  # integer quanta: exact in any order
        counts = np.bincount(flat, weights=w, minlength=P * S * A)
    else:
        counts = np.zeros(P * S * A, w.dtype)
        np.add.at(counts, flat, w)
    cover = np.bincount(p * S + c, minlength=P * S).reshape(P, S)
    return counts.reshape(P, S, A), cover


def _mec(counts, cover, epsq, scale):
    """(bases, errors) summed over parts: at each site a part's reads
    cover, the consensus weight, and the rest plus epsilon when the
    consensus weight is at most 1; in the counts' type."""
    dt = counts.dtype.type
    present = cover > 0
    mx = counts.max(-1)
    tot = counts.sum(-1)
    bases = mx[present].sum(dtype=dt)
    errors = ((tot - mx)[present].sum(dtype=dt)
              + dt(epsq) * dt(np.count_nonzero(present & (mx <= scale))))
    return bases, errors


def _read_dists(alleles, wq, counts, epsq) -> np.ndarray:
    """diff [R, P] of every read against every part's counts: the read's
    weight at each site where the part has reads and the read's allele
    falls short of the part's consensus weight, plus epsilon at each site
    the part lacks. Sums as matrix products in the counts' type (exact on
    integer quanta in float64)."""
    dt = counts.dtype
    cov = alleles >= 0
    mx = counts.max(-1)                                   # [P, S]
    empty = mx == 0
    out = (cov.astype(dt) @ empty.T.astype(dt)) * epsq
    for k in range(counts.shape[-1]):
        short = (counts[..., k] != mx) & ~empty           # [P, S]
        wk = np.where(alleles == k, wq, 0).astype(dt)      # [R, S]
        out = out + wk @ short.T.astype(dt)
    return out


def _opt_iterate(alleles, wq, assignment, P, A, epsq):
    counts, _cover = _part_counts(alleles, wq, assignment, P, A)
    sizes = np.bincount(assignment, minlength=P)
    D = _read_dists(alleles, wq, counts, epsq)
    R = len(assignment)
    own = D[np.arange(R), assignment]
    gain = own[:, None] - D
    ok = (sizes[assignment] > 1)[:, None] & (gain > 0)
    ok[np.arange(R), assignment] = False
    mr, mj = np.nonzero(ok)
    new = assignment.copy()
    if not len(mr):
        return new
    g = gain[mr, mj]
    order = np.argsort(-g, kind="stable")
    n_moves = len(mr) // 10
    if n_moves == 0:
        n_moves = len(mr) // 3 + 1
    moved = set()
    cur = sizes.copy()
    for mv_num, o in enumerate(order):
        r, j = int(mr[o]), int(mj[o])
        i = int(assignment[r])
        if r in moved or cur[i] == 1:
            continue
        new[r] = j
        cur[j] += 1
        cur[i] -= 1
        moved.add(r)
        if mv_num > n_moves:
            break
    return new


def upem_climb(alleles: np.ndarray, wq: np.ndarray, epsq,
               assignment: np.ndarray, P: int, scale=QUANTUM) -> np.ndarray:
    """The UPEM hill-climb: up to 20 rounds of greedy moves, each kept
    only while the weighted MEC errors fall."""
    A = max(2, int(alleles.max()) + 1)
    wq, epsq = _exact(wq, epsq, scale)
    best = np.asarray(assignment, np.int64).copy()

    def errors(asg):
        return _mec(*_part_counts(alleles, wq, asg, P, A), epsq, scale)[1]

    prev = errors(best)
    for _ in range(NUM_ITER_OPTIMIZE):
        new = _opt_iterate(alleles, wq, best, P, A, epsq)
        ns = errors(new)
        if ns < prev:
            prev, best = ns, new
        else:
            break
    return best.astype(np.int32)


def unit_mec(alleles: np.ndarray, epsq, assignment: np.ndarray,
             P: int, scale=QUANTUM) -> Tuple[float, float]:
    """(bases, errors) of the unit-weight MEC of a partition."""
    A = max(2, int(alleles.max()) + 1)
    unit, epsq = _exact(np.asarray(scale), epsq, scale)
    b, e = _mec(*_part_counts(alleles, None, np.asarray(assignment), P, A,
                              unit=unit), epsq, scale)
    return float(b) / float(scale), float(e) / float(scale)
