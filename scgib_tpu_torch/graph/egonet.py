"""k-hop ego-net extraction (NumPy), the ``dgl.khop_in_subgraph`` analog.

Counterpart of ``scgib_tpu/graph/egonet.py``: a vectorized CSR BFS over all
centers at once gives an [n, n] reachability matrix, from which node lists
and induced edge lists are sliced.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .batching import EgoNets, GraphData


def khop_reachability(senders: np.ndarray, receivers: np.ndarray,
                      num_nodes: int, k: int) -> np.ndarray:
    """Boolean [n, n] R with R[v, u] = True iff dist(v, u) <= k (in-hops)."""
    reach = np.eye(num_nodes, dtype=bool)
    if len(senders) == 0:
        return reach
    frontier = reach.copy()
    for _ in range(k):
        nxt = np.zeros_like(reach)
        np.logical_or.at(nxt.T, senders, frontier.T[receivers])
        nxt &= ~reach
        reach |= nxt
        if not nxt.any():
            break
        frontier = nxt
    return reach


def extract_egonets(graph: GraphData, k: int) -> EgoNets:
    """Per-node induced k-hop ego-nets: center first, then the other
    members ascending; edges are the graph's edges with both endpoints
    inside, in local ids."""
    n = graph.num_nodes
    reach = khop_reachability(graph.senders, graph.receivers, n, k)
    node_lists: List[np.ndarray] = []
    edge_lists: List[Tuple[np.ndarray, np.ndarray]] = []
    s, r = graph.senders, graph.receivers
    for v in range(n):
        members = np.flatnonzero(reach[v])
        members = np.concatenate(
            [[v], members[members != v]]).astype(np.int64)
        local = np.full(n, -1, dtype=np.int64)
        local[members] = np.arange(len(members))
        if len(s):
            keep = reach[v, s] & reach[v, r]
            es = local[s[keep]].astype(np.int32)
            er = local[r[keep]].astype(np.int32)
        else:
            es = np.zeros(0, dtype=np.int32)
            er = np.zeros(0, dtype=np.int32)
        node_lists.append(members.astype(np.int32))
        edge_lists.append((es, er))
    return EgoNets(node_lists=node_lists, edge_lists=edge_lists)


def egonet_sizes(graph: GraphData, k: int) -> Tuple[int, int]:
    """(total sub-nodes, total sub-edges) of one graph's flattened
    ego-nets, without extracting them: what a packer's capacity needs."""
    reach = khop_reachability(graph.senders, graph.receivers,
                              graph.num_nodes, k)
    sub_nodes = int(reach.sum())
    if len(graph.senders):
        keep = reach[:, graph.senders] & reach[:, graph.receivers]
        sub_edges = int(keep.sum())
    else:
        sub_edges = 0
    return sub_nodes, sub_edges
