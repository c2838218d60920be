"""End-to-end reference-semantics oracle for the post-ingest pipeline
(the port's copy of the JAX package's tests/oracle_pipeline.py).

Naive dict/loop realization of the whole per-contig flow, written
directly from the reference sources: block decomposition
(utils_frags.rs:405-463), per-block ploidy sweep with both stopping
rules (graph_processing.rs:103-304), hap-graph nodes + unambiguous
shared-read edges (graph_processing.rs:22-100, types_structs.rs:155-214),
LP flow (solve_flow.rs:196-289), widest-path extraction with dropoff
cuts (graph_processing.rs:462-750), final read reassignment and broken-
group splitting (part_block_manip.rs:27-288), SNP-less gap reads
(part_block_manip.rs:622-675), HAPQ (part_block_manip.rs:517-620,
utils_frags.rs:596-700), and the vartig/haploset text formats
(file_writer.rs:699-993).

Where the reference's result depends on hashmap iteration order, this
oracle applies the same canonical rules the framework documents
(PARITY.md): consensus argmax ties -> smallest allele index; re-add and
traversal orders -> ascending read/node id; toposort -> smallest id
first; per-site maxima computed exactly (the reference's running-sum
max at utils_frags.rs:620-623 is iteration-order dependent).

The beam search itself runs the faithful C++ oracle (native/baseline.cpp
through the port's `native.baseline_sweep`, held read for read to
`reference.beam_search` by tests/test_torch_oracle.py) for speed; with
`use_native=False` it runs `reference.beam_search`. A native library
that cannot be built raises: the oracle never falls back to the Python
beam on its own, so a timed run cannot silently take the slow path.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

from .. import constants, native
from . import reference as oracle

Hap = Dict[int, Dict[int, float]]


# --- block decomposition (utils_frags.rs:405-463) -----------------------

def block_ranges(snp_to_genome_pos, block_length: int, overlap_len: int,
                 min_density: float) -> List[Tuple[int, int]]:
    n = len(snp_to_genome_pos)
    out: List[Tuple[int, int]] = []
    cum_pos = 0
    last_pos = int(snp_to_genome_pos[0])
    left_endpoint = 0
    new_left_end = 0
    hit_new_left = False
    for i in range(n):
        pos = int(snp_to_genome_pos[i])
        if i == n - 1:
            out.append((left_endpoint, i))
            break
        cum_pos += pos - last_pos
        last_pos = pos
        if cum_pos > block_length - overlap_len and not hit_new_left:
            new_left_end = i
            hit_new_left = True
        if cum_pos > block_length:
            cum_pos = 0
            density = (i - left_endpoint) / block_length
            if density > min_density:
                out.append((left_endpoint, i - 1))
            if (int(snp_to_genome_pos[new_left_end]) + block_length
                    < int(snp_to_genome_pos[new_left_end + 1])):
                left_endpoint = new_left_end
            else:
                left_endpoint = new_left_end + 1
            last_pos = int(snp_to_genome_pos[left_endpoint])
            hit_new_left = False
    return [(a + 1, b + 1) for a, b in out]


# --- local phasing sweep (graph_processing.rs:103-304) ------------------

def find_reads(start: int, end: int, frags) -> List:
    out = []
    for f in frags:
        if f.last_position < start:
            continue
        if f.first_position > end:
            break
        if f.last_position - f.first_position > 10000:
            continue
        out.append(f)
    return out


def _beam_assign(reads, oracle_reads, ploidy: int, eps: float,
                 beam_width: int, use_native: bool) -> List[int]:
    if not use_native:
        return oracle.beam_search(oracle_reads, ploidy, eps,
                                  beam_width=beam_width)
    lo = min(f.first_position for f in reads)
    hi = max(f.last_position for f in reads)
    S = hi - lo + 1
    R = len(reads)
    alleles = np.full((1, R, S), -1, dtype=np.int8)
    weights = np.zeros((1, R, S), dtype=np.float32)
    for r, f in enumerate(reads):
        cols = f.snps - lo
        alleles[0, r, cols] = f.alleles
        weights[0, r, cols] = f.weights
    asg = native.baseline_sweep(
        alleles, weights, [ploidy], beam_width, eps,
        max_alleles=constants.MAX_ALLELES, faithful=True,
        want_assign=True)
    return [int(a) for a in asg[0]]


def local_sweep(reads, options, use_native: bool = True) -> List[Set[int]]:
    """Per-block ploidy sweep with the reference's sequential early-exit
    stopping rules; returns the chosen partition as counter-id sets."""
    max_ploidy = options.max_ploidy
    eps = options.epsilon
    oracle_reads = [oracle.frag_to_read(f) for f in reads]
    mec_vector = [0.0] * max_ploidy
    expected: List[float] = []
    parts_vector: List[List[int]] = []
    best = 1
    for ploidy in range(1, max_ploidy + 1):
        best = ploidy
        if ploidy == 1:
            assignment = [0] * len(reads)
        else:
            assignment = _beam_assign(reads, oracle_reads, ploidy, eps,
                                      options.max_number_solns,
                                      use_native)
        assignment = oracle.upem_optimize(oracle_reads, list(assignment),
                                          ploidy, eps)
        haps_unw = oracle.hap_from_partition(oracle_reads, assignment,
                                             ploidy, weighted=False)
        stats = oracle.mec_stats_epsilon(haps_unw, eps)
        mec = sum(bad for _g, bad in stats)
        num_alleles = sum(g + b for g, b in stats)
        mec_vector[ploidy - 1] = mec
        expected.append(num_alleles * eps)
        parts_vector.append(assignment)
        if ploidy > 1:
            prev = mec_vector[ploidy - 2]
            if prev != 0.0:
                ratio = mec / prev
            else:
                ratio = math.inf if mec > 0 else math.nan
            if options.ploidy_sensitivity == 1:
                thr = 1.0 / (1.0 - eps) / (1.0 + 1.0 / (ploidy ** 0.5
                                                        + 1.0))
            elif options.ploidy_sensitivity == 2:
                thr = 1.0 / (1.0 - eps) / (1.0 + 1.0 / (ploidy
                                                        + 1.0 / 3.0))
            else:
                thr = 1.0 / (1.0 - eps) / (1.0 + 1.0 / (ploidy + 1.0))
            if ratio < thr:
                pass
            elif options.stopping_heuristic:
                best -= 1
                break
            if mec < expected[ploidy - 1]:
                break
        else:
            if mec < expected[0]:
                break
    assignment = parts_vector[best - 1]
    parts: List[Set[int]] = [set() for _ in range(best)]
    for f, p in zip(reads, assignment):
        parts[p].add(f.counter_id)
    return parts


# --- hap-graph (types_structs.rs:155-214, graph_processing.rs:22-100) ---

def hap_map_of(frags, ids, rng: Tuple[int, int]) -> Hap:
    lo, hi = rng
    hap: Hap = {}
    for fid in sorted(ids):
        f = frags[fid]
        for p, a, w in zip(f.snps, f.alleles, f.weights):
            p = int(p)
            if lo <= p <= hi:
                site = hap.setdefault(p, {})
                site[int(a)] = site.get(int(a), 0.0) + float(w)
    return hap


def full_hap_of(frags, ids) -> Hap:
    hap: Hap = {}
    for fid in sorted(ids):
        f = frags[fid]
        for p, a, w in zip(f.snps, f.alleles, f.weights):
            site = hap.setdefault(int(p), {})
            site[int(a)] = site.get(int(a), 0.0) + float(w)
    return hap


def _consensus(entries: Dict[int, float]) -> int:
    maxc = max(entries.values())
    return min(a for a, v in entries.items() if v == maxc)


def dist_rounded(read: Dict, hap: Hap) -> Tuple[int, int]:
    """distance_read_haplo (utils_frags.rs:77-108): phred-weighted,
    rounded; max-tie forgiveness; uncovered-by-map sites skipped."""
    same = diff = 0.0
    for pos, (allele, w) in read.items():
        entries = hap.get(pos)
        if not entries:
            continue
        maxc = max(entries.values())
        cons = _consensus(entries)
        if allele == cons:
            same += w
        elif allele in entries and entries[allele] == maxc:
            continue
        else:
            diff += w
    return int(math.floor(same + 0.5)), int(math.floor(diff + 0.5))


def build_edges(columns: List[List[Set[int]]],
                col_ranges: List[Tuple[int, int]], frags) -> List[List[
                    List[Tuple[int, float]]]]:
    """out_edges[column][row] = [(next row, weight)]
    (graph_processing.rs:22-100)."""
    hap_maps = [[hap_map_of(frags, ids, col_ranges[c])
                 for ids in block] for c, block in enumerate(columns)]
    reads_cache = {}

    def read_of(fid):
        if fid not in reads_cache:
            reads_cache[fid] = oracle.frag_to_read(frags[fid])
        return reads_cache[fid]

    out_edges = []
    for c in range(len(columns) - 1):
        block1 = columns[c]
        block2 = columns[c + 1]
        block_edges = []
        for ids1 in block1:
            out_weights = [0.0] * len(block2)
            for fid in sorted(ids1):
                hap_id_in = None
                sims = []
                for l, ids2 in enumerate(block2):
                    if fid in ids2:
                        hap_id_in = l
                    _s, d = dist_rounded(read_of(fid),
                                         hap_maps[c + 1][l])
                    sims.append((d, l))
                sims.sort()
                if len(sims) > 1:
                    if sims[0][0] != sims[1][0] and hap_id_in is not None:
                        out_weights[hap_id_in] += 1.0
                elif hap_id_in is not None:
                    out_weights[hap_id_in] += 1.0
            block_edges.append(
                [(l, w) for l, w in enumerate(out_weights)
                 if w >= constants.MIN_SHARED_READS_UNAMBIG])
        out_edges.append(block_edges)
    out_edges.append([[] for _ids in columns[-1]])
    return out_edges


# --- LP flow (solve_flow.rs:196-289) ------------------------------------

def solve_flows(columns, out_edges) -> List[Tuple[Tuple[int, int],
                                                  Tuple[int, int],
                                                  float]]:
    edges = []       # ((c1, r1), (c2, r2))
    weights = []
    for c, block_edges in enumerate(out_edges):
        for r, es in enumerate(block_edges):
            for (l, w) in es:
                edges.append(((c, r), (c + 1, l)))
                weights.append(w)
    if not edges:
        return []
    edge_index = {e: i for i, e in enumerate(edges)}
    in_edges: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for ((c1, r1), (c2, r2)) in edges:
        in_edges.setdefault((c2, r2), []).append((c1, r1))
    E = len(edges)
    rows = []
    for c in range(1, len(columns) - 1):
        for r in range(len(columns[c])):
            node = (c, r)
            outs = [e for e in edges if e[0] == node]
            ins = in_edges.get(node, [])
            if not ins or not outs:
                continue
            row = np.zeros(E)
            for src in ins:
                row[edge_index[(src, node)]] = 1.0
            for e in outs:
                row[edge_index[e]] = -1.0
            rows.append(row)

    from scipy import sparse
    from scipy.optimize import linprog

    ae = np.asarray(weights)
    c_vec = np.concatenate([np.zeros(E), np.ones(E)])
    eye = sparse.identity(E, format="csr")
    a_ub = sparse.vstack([sparse.hstack([-eye, -eye]),
                          sparse.hstack([eye, -eye])], format="csr")
    b_ub = np.concatenate([-ae, ae])
    if rows:
        C = sparse.csr_matrix(np.stack(rows))
        a_eq = sparse.hstack([C, sparse.csr_matrix((C.shape[0], E))],
                             format="csr")
        b_eq = np.zeros(C.shape[0])
    else:
        a_eq = b_eq = None
    res = linprog(c_vec, A_ub=a_ub, b_ub=b_ub, A_eq=a_eq, b_eq=b_eq,
                  bounds=(0, None), method="highs")
    assert res.success, res.message
    return [(e[0], e[1], float(res.x[i])) for i, e in enumerate(edges)]


# --- widest paths (graph_processing.rs:462-750) -------------------------

def widest_paths(columns, col_ranges, flow_vec, frags):
    """Returns [(frag_id_set, (snp_lo, snp_hi), mean_flow)]."""
    out_flows: Dict[Tuple[int, int], Dict[Tuple[int, int], float]] = {}
    for (n1, n2, flow) in flow_vec:
        if flow < constants.MIN_SHARED_READS_UNAMBIG:
            continue
        out_flows.setdefault(n1, {})[n2] = flow

    ids = {}
    nodes = []
    for c, block in enumerate(columns):
        for r in range(len(block)):
            ids[(c, r)] = len(nodes)
            nodes.append((c, r))
    out_e: Dict[int, Dict[int, float]] = {i: {} for i in range(len(nodes))}
    in_e: Dict[int, Set[int]] = {i: set() for i in range(len(nodes))}
    for n1, targets in out_flows.items():
        for n2, flow in targets.items():
            out_e[ids[n1]][ids[n2]] = flow
            in_e[ids[n2]].add(ids[n1])

    alive = set(range(len(nodes)))
    result = []
    while alive:
        score = {i: 0.0 for i in alive}
        prev: Dict[int, int] = {}
        is_source = {i: not in_e[i] for i in alive}
        is_sink = {i: not out_e[i] for i in alive}
        for i in alive:
            if is_source[i]:
                score[i] = math.inf
        # Kahn toposort, smallest id first (canonical).
        import heapq
        indeg = {i: len(in_e[i]) for i in alive}
        heap = [i for i in alive if indeg[i] == 0]
        heapq.heapify(heap)
        order = []
        while heap:
            u = heapq.heappop(heap)
            order.append(u)
            for v in out_e[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    heapq.heappush(heap, v)
        cuts = []
        for u in order:
            for v, flow in out_e[u].items():
                if min(score[u], flow) > score[v]:
                    if flow < score[u] * 0.33 and not is_source[u]:
                        if len(in_e[u]) == 1:
                            cuts.append((u, v))
                        if len(in_e[v]) == 1:
                            score[v] = math.inf
                            is_source[v] = True
                    else:
                        score[v] = min(score[u], flow)
                        prev[v] = u
        for (u, v) in cuts:
            out_e[u].pop(v, None)
            in_e[v].discard(u)
        best = None
        best_score = -math.inf
        for i in sorted(alive):
            if is_sink[i] and score[i] > best_score:
                best = i
                best_score = score[i]
        assert best is not None
        path = []
        frag_ids: Set[int] = set()
        lo, hi = 1 << 62, 0
        flows = []
        node = best
        while node is not None:
            path.append(node)
            flows.extend(out_e[node].values())
            c, r = nodes[node]
            lo = min(lo, col_ranges[c][0])
            hi = max(hi, col_ranges[c][1])
            frag_ids |= columns[c][r]
            node = prev.get(node)
        mean_flow = sum(flows) / len(flows) if flows else None
        result.append((frag_ids, (lo, hi), mean_flow))
        for i in path:
            alive.discard(i)
            for j in out_e[i]:
                in_e[j].discard(i)
            for j in list(in_e[i]):
                out_e[j].pop(i, None)
            out_e[i] = {}
            in_e[i] = set()
    return result


# --- final parts (part_block_manip.rs:27-288) ---------------------------

def dist_eps_hap(read: Dict, hap: Hap, eps: float) -> Tuple[float, float]:
    return oracle.dist_eps(read, hap, eps)


def reassign_short(parts, ranges, blocks, short_frags, options):
    """part_block_manip.rs:235-267: each short fragment joins EVERY
    candidate part tied at the best quantized
    (diff*10+1, same*10+1)-ratio score, scored against the pre-split
    consensus blocks. Only original part indices are candidates — the
    reference iterates all_parts_block.blocks, which
    separate_broken_haplogroups never extends — so a short read can
    resurrect a cleared original part. Equal-ratio ties pick the key
    first seen in ascending part order (canonical; the reference's
    min_by over FxHashMap keys is iteration-order dependent)."""
    for f in short_frags:
        read = oracle.frag_to_read(f)
        candidates: Dict[Tuple[int, int], List[int]] = {}
        for i in range(len(blocks)):
            a, b = ranges[i]
            if not (a <= f.first_position <= b
                    or a <= f.last_position <= b):
                continue
            same, diff = dist_eps_hap(read, blocks[i], options.epsilon)
            key = (int(diff * 10.0 + 1.0), int(same * 10.0 + 1.0))
            candidates.setdefault(key, []).append(i)
        if not candidates:
            continue
        best = min(candidates, key=lambda k: k[0] / k[1])
        for i in candidates[best]:
            parts[i].add(f.counter_id)


def final_parts(haplogroups, frags, options, short_frags=()):
    parts: List[Set[int]] = [set(h[0]) for h in haplogroups]
    ranges: List[Tuple[int, int]] = [h[1] for h in haplogroups]
    blocks = [full_hap_of(frags, ids) for ids in parts]

    def remove_read(hap: Hap, f) -> None:
        # utils_frags.rs:476-490: subtract only when nonzero, clamp at 0.
        for p, a, w in zip(f.snps, f.alleles, f.weights):
            site = hap.get(int(p))
            if site is None:
                continue
            cur = site.get(int(a))
            if cur is None or cur == 0.0:
                continue
            site[int(a)] = max(cur - float(w), 0.0)

    def add_read(hap: Hap, f) -> None:
        for p, a, w in zip(f.snps, f.alleles, f.weights):
            site = hap.setdefault(int(p), {})
            site[int(a)] = site.get(int(a), 0.0) + float(w)

    read_to_parts: Dict[int, List[int]] = {}
    for i, ids in enumerate(parts):
        for fid in ids:
            read_to_parts.setdefault(fid, []).append(i)
    for fid, pids in read_to_parts.items():
        for i in pids:
            parts[i].discard(fid)
            remove_read(blocks[i], frags[fid])
    for fid in sorted(read_to_parts):
        read = oracle.frag_to_read(frags[fid])
        best_key = None
        best = None
        for i in sorted(read_to_parts[fid]):
            same, diff = dist_eps_hap(read, blocks[i], options.epsilon)
            key = (diff + 1.0, i, same)
            if best_key is None or key < best_key:
                best_key = key
                best = i
        parts[best].add(fid)
        add_read(blocks[best], frags[fid])

    if constants.SEPARATE_BROKEN_HAPLOGROUPS:
        _separate_broken(parts, ranges, frags)

    if options.reassign_short and short_frags:
        reassign_short(parts, ranges, blocks, short_frags, options)

    order = sorted(range(len(parts)), key=lambda i: ranges[i])
    return [parts[i] for i in order], [ranges[i] for i in order]


def _separate_broken(parts, ranges, frags) -> None:
    # Canonical total scan key (first_position, id): the reference's
    # first_position-only sort leaves ties in hashmap order
    # (part_block_manip.rs:36-38) and the segment-closing read is
    # dropped, so tie order changes membership. Keep in sync with
    # floria_tpu_torch/post/finalize.py:separate_broken_haplogroups.
    def _scan_key(fid):
        return (frags[fid].first_position, fid)

    all_breaks = []
    for i in range(len(ranges)):
        ordered = sorted(parts[i], key=_scan_key)
        latest = 0
        breaks = []
        for fid in ordered:
            f = frags[fid]
            if latest != 0 and f.first_position > latest:
                if ranges[i][0] <= latest < ranges[i][1]:
                    breaks.append(latest)
            if f.last_position > latest:
                latest = f.last_position
        if breaks:
            all_breaks.append((i, breaks))
    new_parts = []
    new_ranges = []
    for i, breaks in all_breaks:
        ordered = sorted(parts[i], key=_scan_key)
        spot = 0
        start = ranges[i][0]
        end_spot = breaks[0]
        cur: Set[int] = set()
        for fid in ordered:
            if frags[fid].last_position <= end_spot:
                cur.add(fid)
            else:
                new_parts.append(cur)
                new_ranges.append((start, end_spot))
                start = end_spot + 1
                spot += 1
                end_spot = breaks[spot] if spot != len(breaks) else (
                    1 << 62)
                cur = set()
        new_parts.append(cur)
        new_ranges.append((start, ranges[i][1]))
    for i, _b in all_breaks:
        parts[i] = set()
    parts.extend(new_parts)
    ranges.extend(new_ranges)


# --- snpless (part_block_manip.rs:622-675) ------------------------------

def snpless_gap_frags(ranges, snp_to_genome_pos, snpless_frags,
                      block_len, final_frags):
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

    def overlaps(a, b):
        return any(s < b and e > a for (s, e) in intervals)

    out = [f for f in snpless_frags
           if not overlaps(f.first_pos_base, f.last_pos_base)]
    out += [f for f in final_frags
            if not overlaps(f.first_pos_base, f.last_pos_base)]
    return out


# --- HAPQ + stats (part_block_manip.rs:517-620) -------------------------

def errors_cov(frags, ids, left: int, right: int):
    """(cov, err, total_err, total_support), unweighted counts; per-site
    max computed exactly (canonical; see module docstring)."""
    counts: Dict[int, Dict[int, float]] = {}
    for fid in sorted(ids):
        f = frags[fid]
        for p, a in zip(f.snps, f.alleles):
            p = int(p)
            if left <= p <= right:
                site = counts.setdefault(p, {})
                site[int(a)] = site.get(int(a), 0.0) + 1.0
    total_support = errors = 0.0
    nonzero = 0
    for p in range(left, right + 1):
        site = counts.get(p)
        if not site:
            continue
        nonzero += 1
        support = sum(site.values())
        total_support += support
        errors += support - max(site.values())
    cov = total_support / nonzero if nonzero else 0.0
    err = errors / total_support if total_support else math.nan
    return cov, err, errors, total_support


def hapq_scores(parts, ranges, frags, snp_to_genome_pos, options):
    weight = error = 0.0
    errs = []
    for i, ids in enumerate(parts):
        _c, err, te, tc = errors_cov(frags, ids, ranges[i][0],
                                     ranges[i][1])
        weight += tc
        error += te
        errs.append(err)
    avg_err = error / weight if weight else math.nan

    blocks = [full_hap_of(frags, ids) for ids in parts]
    hapqs = []
    rel = []
    for i in range(len(parts)):
        max_penalty = 0.0
        s1, e1 = ranges[i]
        for j in range(len(parts)):
            if i == j:
                continue
            s2, e2 = ranges[j]
            if not (s2 < e1 and e2 > s1):
                continue
            inter = max(min(e1 - s2 + 1, e2 - s1 + 1), 0)
            ol = min(inter / (e1 - s1 + 1), 1.0)
            if ol <= 0.05:
                continue
            same = diff = 0.0
            for p, entries1 in blocks[i].items():
                entries2 = blocks[j].get(p)
                if entries2 is None:
                    continue
                if _consensus(entries1) == _consensus(entries2):
                    same += 1.0
                else:
                    diff += 1.0
            dist = diff / (same + diff) if (same + diff) else 1.0
            if ol * (1.0 - dist) > max_penalty:
                max_penalty = ol * (1.0 - dist)
        base_range = 0
        if parts[i]:
            base_range = (int(snp_to_genome_pos[ranges[i][1] - 1])
                          - int(snp_to_genome_pos[ranges[i][0] - 1]))
        t1 = constants.HAPQ_CONSTANT * (1.0 - max_penalty)
        t2 = min(1.0, len(parts[i]) / 3.0)
        t3 = max(0.0, math.log(base_range / options.block_length + 1.0))
        hq = int(t1 * t2 * t3)
        if len(parts[i]) == 1:
            hq = 0
        hapqs.append(min(hq, 60))
        rel.append(errs[i] / avg_err if avg_err else math.nan)
    return hapqs, rel, avg_err


# --- writers (file_writer.rs:699-993) -----------------------------------

def vartigs_text(parts, ranges, out_dir_name, contig, frags,
                 snp_to_genome_pos, hapqs, rel) -> str:
    lines = []
    for i, ids in enumerate(parts):
        if not ids:
            continue
        left, right = ranges[i]
        left_gn = int(snp_to_genome_pos[left - 1])
        right_gn = int(snp_to_genome_pos[right - 1])
        cov, err, _te, _tc = errors_cov(frags, ids, left, right)
        lines.append(
            f">HAP{i}.{out_dir_name}\tCONTIG:{contig}\t"
            f"SNPRANGE:{left}-{right}\t"
            f"BASERANGE:{left_gn + 1}-{right_gn + 1}\t"
            f"COV:{cov:.3f}\tERR:{err:.4f}\tHAPQ:{hapqs[i]}\t"
            f"REL_ERR:{rel[i]:.3f}")
        counts: Dict[int, Dict[int, float]] = {}
        for fid in sorted(ids):
            f = frags[fid]
            for p, a in zip(f.snps, f.alleles):
                p = int(p)
                if left <= p <= right:
                    site = counts.setdefault(p, {})
                    site[int(a)] = site.get(int(a), 0.0) + 1.0
        alleles = []
        for p in range(left, right + 1):
            site = counts.get(p)
            if not site:
                alleles.append(15)
            else:
                alleles.append(_consensus(site))
        lines.append("".join(chr(a + 48) for a in alleles))
    return "".join(line + "\n" for line in lines)


def vartig_info_text(parts, ranges, out_dir_name, frags,
                     snp_to_genome_pos) -> str:
    """vartig_info.txt (file_writer.rs:308-369): per-SNP consensus +
    unweighted allele counts per haplogroup."""
    out = []
    for i, ids in enumerate(parts):
        if not ids:
            continue
        left, right = ranges[i]
        out.append(f">HAP{i}.{out_dir_name}\tSNPRANGE:{left}-{right}\n")
        counts: Dict[int, Dict[int, float]] = {}
        for fid in sorted(ids):
            f = frags[fid]
            for p, a in zip(f.snps, f.alleles):
                p = int(p)
                if left <= p <= right:
                    site = counts.setdefault(p, {})
                    site[int(a)] = site.get(int(a), 0.0) + 1.0
        if not counts:
            continue
        for pos in range(left, right + 1):
            out.append(f"{pos}:{int(snp_to_genome_pos[pos - 1])}\t")
            site = counts.get(pos)
            if not site:
                out.append("?\tNA\t")
            else:
                out.append(f"{_consensus(site)}\t")
                entries = [f"{a}:{int(math.floor(site[a] + 0.5))}"
                           for a in sorted(site) if site[a] > 0]
                out.append("|".join(entries) + "\t")
            out.append("\n")
    return "".join(out)


def ploidy_row(parts, ranges, contig, frags, snp_to_genome_pos, hapqs,
               avg_err, contig_len) -> str:
    """One contig_ploidy_info.tsv row (file_writer.rs:841-915)."""
    num_snps = len(snp_to_genome_pos)
    covered = [0.0] * num_snps
    coverage = [0.0] * num_snps
    covered_q = {15: [0.0] * num_snps, 30: [0.0] * num_snps,
                 45: [0.0] * num_snps}
    total_bases = 0
    for i, ids in enumerate(parts):
        if not ids:
            continue
        left, right = ranges[i]
        total_bases += (int(snp_to_genome_pos[right - 1])
                        - int(snp_to_genome_pos[left - 1]))
        cov, _err, _te, _tc = errors_cov(frags, ids, left, right)
        for s in range(left - 1, right):
            covered[s] += 1.0
            coverage[s] += cov
            for q, arr in covered_q.items():
                if hapqs[i] >= q:
                    arr[s] += 1.0
    nonzero = sum(1 for c in covered if c > 0)
    avg_ploidy = sum(covered) / num_snps if num_snps else math.nan
    avg_q = {q: (sum(a) / num_snps if num_snps else math.nan)
             for q, a in covered_q.items()}
    rough = sum(coverage) / nonzero if nonzero else math.nan
    return (f"{contig}\t{avg_ploidy:.3f}\t"
            f"{total_bases / contig_len:.3f}\t{rough:.3f}\t{total_bases}"
            f"\t{avg_q[15]:.3f}\t{avg_q[30]:.3f}\t{avg_q[45]:.3f}\t"
            f"{avg_err:.4f}\n")


def haplosets_text(parts, ranges, out_dir_name, contig, frags,
                   snp_to_genome_pos, hapqs, rel) -> str:
    lines = []
    for i, ids in enumerate(parts):
        if not ids:
            continue
        left, right = ranges[i]
        cov, err, _te, _tc = errors_cov(frags, ids, left, right)
        lines.append(
            f">HAP{i}.{out_dir_name}\tCONTIG:{contig}\t"
            f"SNPRANGE:{left}-{right}\t"
            f"BASERANGE:{int(snp_to_genome_pos[left - 1]) + 1}-"
            f"{int(snp_to_genome_pos[right - 1]) + 1}\t"
            f"COV:{cov:.3f}\tERR:{err:.4f}\tHAPQ:{hapqs[i]}\t"
            f"REL_ERR:{rel[i]:.3f}")
        for fid in sorted(ids, key=lambda fid: frags[fid].sort_key()):
            f = frags[fid]
            lines.append(f"{f.id}\t{f.first_position}\t"
                         f"{f.last_position}")
    return "".join(line + "\n" for line in lines)


# --- whole contig -------------------------------------------------------

def phase_contig(frags, snp_to_genome_pos, options,
                 use_native: bool = True, short_frags=()):
    """(parts, ranges, hapqs, rel_err, avg_err): the post-ingest
    pipeline on one contig's sorted frozen fragments. Only the long
    `frags` are phased; `short_frags` (hybrid mode, counter_ids
    continuing after the long ones) enter at final_parts' reassignment
    and everything downstream runs on the combined id space, matching
    pipeline._finish_contig."""
    ranges_blocks = block_ranges(snp_to_genome_pos, options.block_length,
                                 options.block_length // 3,
                                 options.snp_density)
    columns = []
    col_ranges = []
    for rng in ranges_blocks:
        reads = find_reads(rng[0], rng[1], frags)
        if not reads:
            continue
        columns.append(local_sweep(reads, options, use_native))
        col_ranges.append(rng)
    if not columns:
        # No block has reads: the pipeline writes empty outputs, with
        # the HAPQ pass's figures for no parts (its avg_err is NaN).
        hapqs, rel, avg_err = hapq_scores([], [], frags, snp_to_genome_pos,
                                          options)
        return [], [], hapqs, rel, avg_err
    out_edges = build_edges(columns, col_ranges, frags)
    flow_vec = solve_flows(columns, out_edges)
    haplogroups = widest_paths(columns, col_ranges, flow_vec, frags)
    combined = list(frags) + list(short_frags)
    parts, ranges = final_parts(haplogroups, combined, options,
                                short_frags)
    hapqs, rel, avg_err = hapq_scores(parts, ranges, combined,
                                      snp_to_genome_pos, options)
    return parts, ranges, hapqs, rel, avg_err


# --- the CLI's files ----------------------------------------------------

# Stands for the contig's output directory, which the texts embed.
CDIR = "<cdir>"
# Each text's file under the run's output directory; "ploidy" is the
# contig's row of contig_ploidy_info.tsv there.
TEXT_FILES = {"vartigs": "{contig}/{contig}.vartigs",
              "haplosets": "{contig}/{contig}.haplosets",
              "info": "{contig}/vartig_info.txt",
              "ploidy": "contig_ploidy_info.tsv"}


def contig_texts(phased, frags, snp_to_genome_pos, contig: str,
                 contig_len: int) -> Dict[str, str]:
    """The four texts the CLI writes for one contig, from phase_contig's
    `phased` five-tuple over `frags` (the combined id space in hybrid
    mode), with the contig's output directory written as CDIR."""
    parts, ranges, hapqs, rel, avg_err = phased
    return {
        "vartigs": vartigs_text(parts, ranges, CDIR, contig, frags,
                                snp_to_genome_pos, hapqs, rel),
        "haplosets": haplosets_text(parts, ranges, CDIR, contig, frags,
                                    snp_to_genome_pos, hapqs, rel),
        "info": vartig_info_text(parts, ranges, CDIR, frags,
                                 snp_to_genome_pos),
        "ploidy": ploidy_row(parts, ranges, contig, frags,
                             snp_to_genome_pos, hapqs, avg_err,
                             contig_len)}


def read_texts(out_dir: str, contig: str) -> Dict[str, str]:
    """The four texts of `contig` from a run's output directory (the
    CLI's or write_texts'), the contig's directory written as CDIR; a
    missing file or row reads as None."""
    cdir = os.path.join(out_dir, contig)
    out = {}
    for key, name in TEXT_FILES.items():
        path = os.path.join(out_dir, name.format(contig=contig))
        text = None
        if os.path.exists(path):
            with open(path) as fh:
                text = fh.read()
            if key == "ploidy":
                rows = [ln + "\n" for ln in text.splitlines()
                        if ln.startswith(contig + "\t")]
                text = rows[-1] if rows else None
            else:
                text = text.replace(cdir, CDIR)
        out[key] = text
    return out


def write_texts(texts: Dict[str, str], out_dir: str, contig: str) -> None:
    """Writes contig_texts' texts in the CLI's layout under `out_dir`
    (CDIR back to the contig's directory there; the ploidy file holds
    the contig's row only)."""
    cdir = os.path.join(out_dir, contig)
    os.makedirs(cdir, exist_ok=True)
    for key, name in TEXT_FILES.items():
        with open(os.path.join(out_dir, name.format(contig=contig)),
                  "w") as fh:
            fh.write(texts[key].replace(CDIR, cdir))
