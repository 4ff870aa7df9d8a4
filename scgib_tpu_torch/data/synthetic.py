"""Synthetic molecule-like graphs for tests, smoke runs and benchmarks.

Counterpart of ``scgib_tpu/data/synthetic.py::random_dataset``: the same
generator, drawing in the same order, so one seed gives the same graphs and
labels in both packages.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..graph.batching import GraphData, symmetrize_edges


def random_molecule(rng: np.random.Generator, min_nodes: int = 8,
                    max_nodes: int = 32, feat_dim: int = 9,
                    extra_edge_frac: float = 0.15,
                    num_tasks: Optional[int] = None,
                    label_nan_frac: float = 0.0) -> GraphData:
    """A random spanning tree plus a few ring-closing edges, bidirected and
    deduped, with integer features in [0, 10); with ``num_tasks``, a label
    of that many fair 0/1 draws, each NaN (missing) with probability
    ``label_nan_frac``."""
    n = int(rng.integers(min_nodes, max_nodes + 1))
    parents = np.array([rng.integers(0, i) for i in range(1, n)],
                       dtype=np.int64)
    s = np.arange(1, n, dtype=np.int64)
    r = parents
    n_extra = int(extra_edge_frac * n)
    if n_extra and n > 2:
        es = rng.integers(0, n, size=n_extra)
        er = rng.integers(0, n, size=n_extra)
        keep = es != er
        s = np.concatenate([s, es[keep]])
        r = np.concatenate([r, er[keep]])
    senders, receivers = symmetrize_edges(s, r)
    feat = rng.integers(0, 10, size=(n, feat_dim)).astype(np.float32)
    label = None
    if num_tasks is not None:
        label = (rng.random(num_tasks) < 0.5).astype(np.float32)
        if label_nan_frac > 0:
            nanm = rng.random(num_tasks) < label_nan_frac
            label = np.where(nanm, np.nan, label)
    return GraphData(senders=senders, receivers=receivers, node_feat=feat,
                     label=label)


def random_dataset(num_graphs: int, seed: int = 0, **kw) -> List[GraphData]:
    rng = np.random.default_rng(seed)
    return [random_molecule(rng, **kw) for _ in range(num_graphs)]
