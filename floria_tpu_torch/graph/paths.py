"""Iterative widest-path strain extraction over the flow DAG.

Repeatedly finds the maximum-bottleneck (widest) source->sink path through
the LP-flow-annotated hap-graph, with a 0.33 drop-off rule that cuts edges
where flow collapses relative to the upstream bottleneck (indicating the
main strain diverges), then removes the path's nodes and repeats until the
graph is empty. Each extracted path is a haplogroup: the union of its
nodes' read sets plus a SNP range and a mean-flow coverage
(graph_processing.rs:462-750).

Host-side by design: tiny, branchy, and correctness-dense.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from .. import constants
from .flow import FlowUpVec
from .hapnode import HapNode

_INF = float("inf")


@dataclasses.dataclass
class Haplogroup:
    frag_ids: np.ndarray
    snp_range: Tuple[int, int]
    cov: Optional[float]             # mean flow along the path


def write_pet_graph_dot(hap_graph: List[List[HapNode]],
                        out_path: str) -> None:
    """Graphviz dump of the flow DAG, the debug artifact the reference
    writes at debug/trace level (graph_processing.rs:539-543)."""
    with open(out_path, "w") as f:
        f.write("digraph {\n")
        for block in hap_graph:
            for node in block:
                f.write(f'    {node.node_id} [ label = '
                        f'"({node.column}, {node.row})" ]\n')
        for block in hap_graph:
            for node in block:
                for (r2, flow) in node.out_flows:
                    other = hap_graph[node.column + 1][r2]
                    f.write(f'    {node.node_id} -> {other.node_id} '
                            f'[ label = "{flow}" ]\n')
        f.write("}\n")


def get_disjoint_paths(hap_graph: List[List[HapNode]],
                       flow_update_vec: FlowUpVec) -> List[Haplogroup]:
    # Attach LP flows >= the shared-read floor (graph_processing.rs:474-482)
    for (c1, r1), (c2, r2), flow in flow_update_vec:
        if flow < constants.MIN_SHARED_READS_UNAMBIG:
            continue
        hap_graph[c1][r1].out_flows.append((r2, flow))

    # Stable node indexing in column-major order.
    index_of: Dict[Tuple[int, int], int] = {}
    nodes: List[HapNode] = []
    for block in hap_graph:
        for node in block:
            index_of[(node.column, node.row)] = len(nodes)
            nodes.append(node)

    out_edges: Dict[int, Dict[int, float]] = {i: {} for i in
                                              range(len(nodes))}
    in_edges: Dict[int, Set[int]] = {i: set() for i in range(len(nodes))}
    for i, node in enumerate(nodes):
        for (r2, flow) in node.out_flows:
            j = index_of[(node.column + 1, r2)]
            out_edges[i][j] = flow
            in_edges[j].add(i)

    alive: Set[int] = set(range(len(nodes)))
    result: List[Haplogroup] = []

    while alive:
        score = {i: 0.0 for i in alive}
        prev: Dict[int, Optional[int]] = {i: None for i in alive}
        is_source = {i: not in_edges[i] for i in alive}
        is_sink = {i: not out_edges[i] for i in alive}
        for i in alive:
            if is_source[i]:
                score[i] = _INF

        cut: List[Tuple[int, int]] = []
        for u in _topo_order(alive, out_edges, in_edges):
            for v, flow in list(out_edges[u].items()):
                if min(score[u], flow) > score[v]:
                    if flow < score[u] * 0.33 and not is_source[u]:
                        # Drop-off: the downstream strain is not this
                        # node's main continuation
                        # (graph_processing.rs:599-631).
                        if len(in_edges[u]) == 1:
                            cut.append((u, v))
                        if len(in_edges[v]) == 1:
                            score[v] = _INF
                            is_source[v] = True
                    else:
                        score[v] = min(score[u], flow)
                        prev[v] = u

        for (u, v) in cut:
            out_edges[u].pop(v, None)
            in_edges[v].discard(u)

        best = None
        best_score = -_INF
        for i in sorted(alive):
            if is_sink[i] and score[i] > best_score:
                best = i
                best_score = score[i]
        if best is None:
            raise AssertionError("flow DAG has no sink")

        path = []
        frag_ids: Set[int] = set()
        snp_lo, snp_hi = np.iinfo(np.int64).max, 0
        flows: List[float] = []
        node_idx: Optional[int] = best
        while node_idx is not None:
            path.append(node_idx)
            flows.extend(out_edges[node_idx].values())
            node = nodes[node_idx]
            snp_lo = min(snp_lo, node.snp_endpoints[0])
            snp_hi = max(snp_hi, node.snp_endpoints[1])
            frag_ids.update(int(f) for f in node.frag_ids)
            node_idx = prev[node_idx]

        cov = (sum(flows) / len(flows)) if flows else None
        result.append(Haplogroup(
            frag_ids=np.asarray(sorted(frag_ids), dtype=np.int64),
            snp_range=(int(snp_lo), int(snp_hi)), cov=cov))

        for i in path:
            alive.discard(i)
            for j in out_edges[i]:
                in_edges[j].discard(i)
            for j in list(in_edges[i]):
                out_edges[j].pop(i, None)
            out_edges[i] = {}
            in_edges[i] = set()

    return result


def _topo_order(alive: Set[int], out_edges, in_edges) -> List[int]:
    """Kahn's algorithm, smallest index first (deterministic)."""
    import heapq
    indeg = {i: len(in_edges[i]) for i in alive}
    heap = [i for i in alive if indeg[i] == 0]
    heapq.heapify(heap)
    order = []
    while heap:
        u = heapq.heappop(heap)
        order.append(u)
        for v in out_edges[u]:
            indeg[v] -= 1
            if indeg[v] == 0:
                heapq.heappush(heap, v)
    return order
