"""TUDataset raw-format reader (Mutagenicity / NCI1 / NCI109 / PROTEINS /
ENZYMES — the reference loads these through PyG's TUDataset download,
exp_tudataset.py; this reads the underlying published text format
directly, no torch-geometric needed).

Format (https://chrsmrrs.github.io/datasets/): a directory ``<name>/``
containing
  <name>_A.txt               edge list "row, col" (1-based, global ids)
  <name>_graph_indicator.txt graph id (1-based) per node
  <name>_graph_labels.txt    label per graph
  <name>_node_labels.txt     integer node label per node (optional)
  <name>_node_attributes.txt comma-separated float attrs (optional)

Node features follow PyG's TUDataset convention: one-hot of the node
label concatenated with the float attributes.

The port's own copy of ``scgib_tpu/data/tudataset.py`` (NumPy only), held to
it by ``tests/test_torch_data.py``.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..graph.batching import GraphData, symmetrize_edges


def _read_lines(path: str) -> Optional[np.ndarray]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        rows = [line.strip() for line in f if line.strip()]
    return np.asarray([[float(x) for x in row.split(",")]
                       for row in rows])


def load_tudataset(root: str, name: str) -> List[GraphData]:
    """Parse ``<root>/<name>/<name>_*.txt`` into GraphData (edges
    symmetrized + deduped, matching the packer's expectations)."""
    base = os.path.join(root, name, name)
    edges = _read_lines(base + "_A.txt")
    indicator = _read_lines(base + "_graph_indicator.txt")
    labels = _read_lines(base + "_graph_labels.txt")
    if edges is None or indicator is None or labels is None:
        raise FileNotFoundError(
            f"TUDataset files not found under {root}/{name}")
    node_labels = _read_lines(base + "_node_labels.txt")
    node_attrs = _read_lines(base + "_node_attributes.txt")

    indicator = indicator.astype(np.int64).ravel() - 1      # 0-based
    n_graphs = int(indicator.max()) + 1
    edges = edges.astype(np.int64) - 1                      # 0-based

    # node features: one-hot labels ++ attributes
    feats = []
    if node_labels is not None:
        nl = node_labels.astype(np.int64).ravel()
        nl = nl - nl.min()
        onehot = np.zeros((len(nl), int(nl.max()) + 1), np.float32)
        onehot[np.arange(len(nl)), nl] = 1.0
        feats.append(onehot)
    if node_attrs is not None:
        feats.append(node_attrs.astype(np.float32))
    if not feats:
        feats.append(np.ones((len(indicator), 1), np.float32))
    node_feat = np.concatenate(feats, axis=1)

    # per-graph node ranges (indicator is sorted by construction)
    node_off = np.zeros(n_graphs + 1, np.int64)
    np.add.at(node_off, indicator + 1, 1)
    node_off = np.cumsum(node_off)

    # graph labels -> 0-based classes
    y = labels.ravel()
    classes = np.unique(y)
    y = np.searchsorted(classes, y).astype(np.float32)

    graph_of_edge = indicator[edges[:, 0]]
    order = np.argsort(graph_of_edge, kind="stable")
    edges = edges[order]
    graph_of_edge = graph_of_edge[order]
    edge_off = np.searchsorted(graph_of_edge,
                               np.arange(n_graphs + 1))

    out: List[GraphData] = []
    for gi in range(n_graphs):
        n0, n1 = node_off[gi], node_off[gi + 1]
        e = edges[edge_off[gi]:edge_off[gi + 1]] - n0
        s, r = symmetrize_edges(e[:, 0], e[:, 1])
        out.append(GraphData(
            senders=s, receivers=r,
            node_feat=np.ascontiguousarray(node_feat[n0:n1]),
            label=np.asarray([y[gi]], np.float32)))
    return out
