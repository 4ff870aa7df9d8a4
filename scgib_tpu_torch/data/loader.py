"""Host-side data pipeline: dataset, capacity planning, batch iteration.

Counterpart of ``scgib_tpu/data/loader.py`` without the native packer, the
wire format and device prefetch: ego-nets come from the NumPy BFS
(``graph/egonet.py``) and batches from the per-graph packers.  With
``logm_k`` a batch carries the block-diagonal k-step transition targets of
the logM reconstruction loss (``graph/transition.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..graph.banded import gt_band_fits
from ..graph.batching import (BucketSpec, EgoNets, GraphData, pack_graphs,
                              pack_subgraphs)
from ..graph.container import GraphBatch, SubgraphBatch
from ..graph.egonet import extract_egonets
from ..graph.transition import (pack_logm_targets, transition_logm,
                                transition_logm_batched)


@dataclasses.dataclass
class GraphDataset:
    """Host graphs with their k-hop ego-nets (extracted on construction)."""

    graphs: List[GraphData]
    k: int = 1
    egonets: Optional[List[EgoNets]] = None

    def __post_init__(self):
        if self.egonets is None:
            self.egonets = [extract_egonets(g, self.k) for g in self.graphs]

    def __len__(self) -> int:
        return len(self.graphs)

    def logms(self, k: int) -> List[List[np.ndarray]]:
        """Each graph's [logM_1 .. logM_k], computed once for ``k`` and
        kept (the batched form from 32 graphs on, as in the JAX
        package)."""
        cache = getattr(self, "_logms", None)
        if cache is None or cache[0] != k:
            if len(self.graphs) >= 32:
                cache = (k, transition_logm_batched(self.graphs, k))
            else:
                cache = (k, [transition_logm(g, k) for g in self.graphs])
            self._logms = cache
        return cache[1]


@dataclasses.dataclass(frozen=True)
class Capacities:
    nodes: int
    edges: int
    graphs: int
    sub_nodes: int
    sub_edges: int


def _sizes(ds: GraphDataset):
    """Per-graph (nodes, edges, sub-nodes, sub-edges)."""
    n = np.array([g.num_nodes for g in ds.graphs], np.int64)
    e = np.array([g.num_edges for g in ds.graphs], np.int64)
    sn = np.array([sum(len(nl) for nl in ego.node_lists)
                   for ego in ds.egonets], np.int64)
    se = np.array([sum(len(el[0]) for el in ego.edge_lists)
                   for ego in ds.egonets], np.int64)
    return n, e, sn, se


def plan_capacities(ds: GraphDataset, batch_size: int,
                    bucket: BucketSpec = BucketSpec(),
                    safety: float = 1.1) -> Capacities:
    """Buffer sizes that fit a random ``batch_size`` sample: batch_size x
    mean + 3 sigma of the sum (sigma x sqrt(batch_size)), floored at the
    largest graph, times ``safety``, rounded to bucket multiples."""
    n, e, sn, se = _sizes(ds)

    def cap(arr):
        arr = arr.astype(np.float64)
        est = batch_size * arr.mean() + 3.0 * arr.std() * np.sqrt(batch_size)
        return int(max(est, arr.max()) * safety)

    return Capacities(
        nodes=bucket.nodes(cap(n)),
        edges=bucket.edges(cap(np.maximum(e, 1))),
        graphs=bucket.graphs(batch_size),
        sub_nodes=bucket.nodes(cap(sn)),
        sub_edges=bucket.edges(cap(np.maximum(se, 1))),
    )


def plan_batches(ds: GraphDataset, batch_size: int, caps: Capacities,
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False) -> List[np.ndarray]:
    """Index selections per batch, greedily shrunk to fit ``caps``."""
    order = np.arange(len(ds))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    n, e, sn, se = _sizes(ds)
    plans: List[np.ndarray] = []
    i = 0
    while i < len(order):
        take = min(batch_size, len(order) - i)
        if drop_last and take < batch_size:
            break
        while take > 1:
            sel = order[i:i + take]
            if (n[sel].sum() <= caps.nodes and e[sel].sum() <= caps.edges
                    and sn[sel].sum() <= caps.sub_nodes
                    and se[sel].sum() <= caps.sub_edges):
                break
            take -= 1
        plans.append(order[i:i + take])
        i += take
    return plans


def pack_batch(ds: GraphDataset, sel: Sequence[int], caps: Capacities,
               logm_k: Optional[int] = None
               ) -> Tuple[GraphBatch, SubgraphBatch]:
    """Pack the graphs ``sel`` of ``ds``.  ``gt_fits`` comes from the
    dataset's largest graph and ego-net (computed once, kept on ``ds``),
    so it is the same for every batch of the dataset; ``pool_fits`` is the
    batch's own.  ``logm_k``: attach the k-step logM targets and weights to
    the GraphBatch."""
    graphs = [ds.graphs[j] for j in sel]
    egos = [ds.egonets[j] for j in sel]
    maxima = getattr(ds, "_gt_maxima", None)
    if maxima is None:
        maxima = (max((g.num_nodes for g in ds.graphs), default=0),
                  max((len(nl) for ego in ds.egonets
                       for nl in ego.node_lists), default=0))
        ds._gt_maxima = maxima
    g = pack_graphs(graphs, caps.nodes, caps.edges, caps.graphs,
                    gt_fits=gt_band_fits(maxima[0], caps.nodes))
    sub = pack_subgraphs(graphs, egos, caps.sub_nodes, caps.sub_edges,
                         gt_fits=gt_band_fits(maxima[1], caps.sub_nodes),
                         num_centers=caps.nodes)
    if logm_k:
        logms = ds.logms(logm_k)
        T, W = pack_logm_targets(graphs, [logms[j] for j in sel], caps.nodes,
                                 logm_k)
        g = dataclasses.replace(g, logm_targets=T, logm_weights=W)
    return g, sub


def batch_iterator(ds: GraphDataset, batch_size: int, caps: Capacities,
                   shuffle: bool = True, seed: int = 0,
                   drop_last: bool = False, logm_k: Optional[int] = None
                   ) -> Iterator[Tuple[GraphBatch, SubgraphBatch]]:
    """Yield packed (GraphBatch, SubgraphBatch) pairs of NumPy arrays."""
    for sel in plan_batches(ds, batch_size, caps, shuffle, seed, drop_last):
        yield pack_batch(ds, sel, caps, logm_k)
