"""Positional encodings — Laplacian eigenvector PE and Weisfeiler-Lehman
PE, the reference's graph-transformer utilities (molecules.py:135-193;
present in the reference for the ZINC/transformer path).

Host-side NumPy; outputs attach to ``GraphData.node_feat`` or ride as
separate arrays into a ``GraphBatch``.

The port's own copy of ``scgib_tpu/graph/pos_enc.py`` (NumPy only), held to
it by ``tests/test_torch_data.py``.
"""

from __future__ import annotations

import hashlib
from typing import Tuple

import numpy as np

from .batching import GraphData


def laplacian_pe(graph: GraphData, pos_enc_dim: int) -> np.ndarray:
    """First ``pos_enc_dim`` non-trivial eigenvectors of the symmetric
    normalized Laplacian L = I - D^-1/2 A D^-1/2, eigenvalues ascending
    (molecules.py:135-145).  Returns [n, pos_enc_dim] float32 (zero-padded
    when the graph has fewer eigenvectors)."""
    n = graph.num_nodes
    A = np.zeros((n, n), dtype=np.float64)
    A[graph.senders, graph.receivers] = 1.0
    deg = A.sum(axis=1).clip(1.0)
    d_inv_sqrt = deg ** -0.5
    L = np.eye(n) - (d_inv_sqrt[:, None] * A * d_inv_sqrt[None, :])
    eigval, eigvec = np.linalg.eig(L)
    idx = eigval.argsort()
    eigvec = np.real(eigvec[:, idx])
    out = np.zeros((n, pos_enc_dim), dtype=np.float32)
    avail = max(min(pos_enc_dim, n - 1), 0)
    out[:, :avail] = eigvec[:, 1:1 + avail]
    return out


def wl_pe(graph: GraphData, max_iter: int = 2) -> np.ndarray:
    """Weisfeiler-Lehman node colors after up to ``max_iter`` refinement
    rounds (md5-hashed multiset labels, molecules.py:147-193).  Returns
    [n] int64 color ids (1-based like the reference)."""
    n = graph.num_nodes
    neighbors = [set() for _ in range(n)]
    for u, v in zip(graph.senders, graph.receivers):
        if u != v:
            neighbors[int(u)].add(int(v))
            neighbors[int(v)].add(int(u))

    colors = {v: 1 for v in range(n)}
    iteration = 1
    while True:
        hashed = {}
        for v in range(n):
            parts = [str(colors[v])] + sorted(
                str(colors[u]) for u in neighbors[v])
            hashed[v] = hashlib.md5("_".join(parts).encode()).hexdigest()
        index = {h: i + 1 for i, h in enumerate(sorted(set(hashed.values())))}
        new_colors = {v: index[hashed[v]] for v in range(n)}
        # faithful exit: when the round counter hits max_iter the freshly
        # computed colors are DISCARDED (reference molecules.py:186-189
        # leaves node_color_dict un-updated in the exit branch), so
        # max_iter=2 yields one adopted refinement round
        if new_colors == colors or iteration == max_iter:
            break
        colors = new_colors
        iteration += 1
    return np.asarray([colors[v] for v in range(n)], dtype=np.int64)


def attach_laplacian_pe(graph: GraphData, pos_enc_dim: int) -> GraphData:
    """GraphData with the Laplacian PE concatenated onto node features."""
    pe = laplacian_pe(graph, pos_enc_dim)
    return GraphData(senders=graph.senders, receivers=graph.receivers,
                     node_feat=np.concatenate(
                         [graph.node_feat, pe], axis=1).astype(np.float32),
                     label=graph.label)


def make_full_graph(graph: GraphData) -> GraphData:
    """Complete-graph rewiring keeping node features/labels — the
    reference's full-graph transformer variant (molecules.py:115-131:
    ``nx.complete_graph`` edges, features carried over, edge features
    zeroed).  No self loops, both edge directions."""
    n = graph.num_nodes
    s, r = np.meshgrid(np.arange(n, dtype=np.int32),
                       np.arange(n, dtype=np.int32), indexing="ij")
    keep = s != r
    return GraphData(senders=s[keep].ravel(), receivers=r[keep].ravel(),
                     node_feat=graph.node_feat, label=graph.label)
