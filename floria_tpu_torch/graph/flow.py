"""LP flow assignment over the hap-graph.

min sum(t_e)  s.t.  t_e >= |x_e - w_e|,  flow conservation at interior
nodes, x >= 0 — the reference solves the identical LP with HiGHS or minilp
(solve_flow.rs:8-193, 195-291). We use scipy's HiGHS binding (the same
solver family as the reference's `highs` feature); a dense-simplex C++
fallback lives in native/ for environments without scipy.

The LP is tiny (edges ~ blocks * ploidy^2) and runs per contig on host —
keeping it off-device is the right TPU design: it is branchy, sparse and
microseconds-scale.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .hapnode import HapNode

FlowUpVec = List[Tuple[Tuple[int, int], Tuple[int, int], float]]


def solve_lp_graph(hap_graph: List[List[HapNode]]) -> FlowUpVec:
    nodes = [n for block in hap_graph for n in block]
    id_to_node = {n.node_id: n for n in nodes}

    edges = []   # (id1, id2)
    weights = []
    for node in nodes:
        for (row2, w) in node.out_edges:
            id2 = hap_graph[node.column + 1][row2].node_id
            edges.append((node.node_id, id2))
            weights.append(w)
    E = len(edges)
    if E == 0:
        return []
    edge_index = {e: i for i, e in enumerate(edges)}
    ae = np.asarray(weights, dtype=np.float64)

    # Conservation rows for interior-column nodes with in and out edges
    # (solve_flow.rs:237-272).
    rows = []
    last_col = len(hap_graph) - 1
    for col, block in enumerate(hap_graph):
        if col == 0 or col == last_col:
            continue
        for node in block:
            if not node.in_edges or not node.out_edges:
                continue
            row = np.zeros(E)
            for (row1, _w) in node.in_edges:
                id1 = hap_graph[col - 1][row1].node_id
                row[edge_index[(id1, node.node_id)]] = 1.0
            for (row2, _w) in node.out_edges:
                id2 = hap_graph[col + 1][row2].node_id
                row[edge_index[(node.node_id, id2)]] = -1.0
            rows.append(row)

    flows = _solve(ae, rows)

    out: FlowUpVec = []
    for i, (id1, id2) in enumerate(edges):
        n1 = id_to_node[id1]
        n2 = id_to_node[id2]
        out.append(((n1.column, n1.row), (n2.column, n2.row),
                    float(flows[i])))
    return out


def _solve(ae: np.ndarray, conservation_rows: List[np.ndarray]) -> (
        np.ndarray):
    """Solve min 1.t ; t >= |x - ae| ; C x = 0 ; x,t >= 0."""
    try:
        from scipy import sparse
        from scipy.optimize import linprog
    except ImportError:
        return _solve_native(ae, conservation_rows)
    E = len(ae)
    c = np.concatenate([np.zeros(E), np.ones(E)])
    # -x - t <= -ae  and  x - t <= ae
    eye = sparse.identity(E, format="csr")
    a_ub = sparse.vstack([
        sparse.hstack([-eye, -eye]),
        sparse.hstack([eye, -eye]),
    ], format="csr")
    b_ub = np.concatenate([-ae, ae])
    if conservation_rows:
        C = sparse.csr_matrix(np.stack(conservation_rows))
        a_eq = sparse.hstack([C, sparse.csr_matrix((C.shape[0], E))],
                             format="csr")
        b_eq = np.zeros(C.shape[0])
    else:
        a_eq = None
        b_eq = None
    res = linprog(c, A_ub=a_ub, b_ub=b_ub, A_eq=a_eq, b_eq=b_eq,
                  bounds=(0, None), method="highs")
    if not res.success:
        raise RuntimeError(f"flow LP failed: {res.message}")
    return res.x[:E]


def _solve_native(ae, conservation_rows):
    from .. import native
    out = native.solve_flow(ae, conservation_rows)
    if out is None:
        raise RuntimeError("no LP solver available (scipy or native)")
    return out
