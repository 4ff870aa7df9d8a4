"""Host-side graph packing into fixed-capacity padded batches (NumPy).

Counterpart of ``scgib_tpu/graph/batching.py`` for what training needs:
``pack_graphs`` (with the graphs' labels, NaN-masked) and ``pack_subgraphs``
with the COO layout and the banded ``"device"`` mode (only the window offsets
are shipped; the model builds the blocks on the device).  The output batches
hold NumPy arrays; ``.to(device)`` moves them (``graph/container.py``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..ops.pool import window_fits
from .banded import banded_col_off, fits_band_masked, gt_band_fits
from .container import GraphBatch, SubgraphBatch


@dataclasses.dataclass(frozen=True)
class GraphData:
    """One host graph: symmetrized, deduped COO edges, node features and
    an optional label vector."""

    senders: np.ndarray        # [E] int32
    receivers: np.ndarray      # [E] int32
    node_feat: np.ndarray      # [n, F] float32
    label: Optional[np.ndarray] = None   # [T] float (may contain NaN)

    @property
    def num_nodes(self) -> int:
        return self.node_feat.shape[0]

    @property
    def num_edges(self) -> int:
        return self.senders.shape[0]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Capacities are rounded up to these multiples."""

    node_multiple: int = 256
    edge_multiple: int = 512
    graph_multiple: int = 8

    def nodes(self, n: int) -> int:
        return max(self.node_multiple, _round_up(n, self.node_multiple))

    def edges(self, e: int) -> int:
        return max(self.edge_multiple, _round_up(e, self.edge_multiple))

    def graphs(self, g: int) -> int:
        return max(self.graph_multiple, _round_up(g, self.graph_multiple))


def symmetrize_edges(senders: np.ndarray,
                     receivers: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Bidirectional, deduplicated edge list (``dgl.to_bidirected``)."""
    s = np.concatenate([senders, receivers]).astype(np.int64)
    r = np.concatenate([receivers, senders]).astype(np.int64)
    n = max(int(s.max(initial=-1)), int(r.max(initial=-1))) + 1 if len(s) else 0
    key = s * max(n, 1) + r
    _, idx = np.unique(key, return_index=True)
    return s[idx].astype(np.int32), r[idx].astype(np.int32)


def _band_col_off(senders, receivers, edge_mask, num_nodes,
                  tile: int = 128, band: int = 256):
    """The window offsets when every real edge fits the band, else None
    (the batch then takes the COO path)."""
    if not fits_band_masked(senders, receivers, edge_mask, num_nodes,
                            tile, band):
        return None
    return banded_col_off(num_nodes, tile, band)


def pack_graphs(graphs: Sequence[GraphData], num_nodes: int, num_edges: int,
                num_graphs: int, num_tasks: Optional[int] = None,
                banded: bool = True,
                gt_fits: Optional[bool] = None) -> GraphBatch:
    """Pack graphs into one padded GraphBatch; edges sorted by receiver.

    With labels (``num_tasks``, by default the longest label of the
    batch's graphs), ``labels`` [G, T] holds them with NaN as 0 and
    ``label_mask`` [G, T] is True where a label is present.
    ``banded=True`` attaches the window offsets when the batch fits the
    band (the JAX package's ``banded="device"``).  ``gt_fits`` defaults to
    this batch's own fact; callers with the dataset at hand pass the
    dataset's (``data/loader.py::pack_batch``), which cannot change from
    batch to batch."""
    total_n = sum(g.num_nodes for g in graphs)
    total_e = sum(g.num_edges for g in graphs)
    if total_n > num_nodes:
        raise ValueError(f"node capacity {num_nodes} < required {total_n}")
    if total_e > num_edges:
        raise ValueError(f"edge capacity {num_edges} < required {total_e}")
    if len(graphs) > num_graphs:
        raise ValueError(f"graph capacity {num_graphs} < {len(graphs)}")

    feat_dim = graphs[0].node_feat.shape[1]
    node_feat = np.zeros((num_nodes, feat_dim), dtype=np.float32)
    node_graph = np.zeros(num_nodes, dtype=np.int32)
    node_mask = np.zeros(num_nodes, dtype=bool)
    senders = np.zeros(num_edges, dtype=np.int32)
    receivers = np.zeros(num_edges, dtype=np.int32)
    edge_mask = np.zeros(num_edges, dtype=bool)
    graph_mask = np.zeros(num_graphs, dtype=bool)
    if num_tasks is None and any(g.label is not None for g in graphs):
        num_tasks = max(np.atleast_1d(g.label).shape[0]
                        for g in graphs if g.label is not None)
    labels = label_mask = None
    if num_tasks:
        labels = np.zeros((num_graphs, num_tasks), dtype=np.float32)
        label_mask = np.zeros((num_graphs, num_tasks), dtype=bool)

    n_off = 0
    e_off = 0
    for gi, g in enumerate(graphs):
        n, e = g.num_nodes, g.num_edges
        node_feat[n_off:n_off + n] = g.node_feat
        node_graph[n_off:n_off + n] = gi
        node_mask[n_off:n_off + n] = True
        senders[e_off:e_off + e] = g.senders + n_off
        receivers[e_off:e_off + e] = g.receivers + n_off
        edge_mask[e_off:e_off + e] = True
        graph_mask[gi] = True
        if labels is not None and g.label is not None:
            lab = np.atleast_1d(np.asarray(g.label, dtype=np.float32))
            labels[gi, :lab.shape[0]] = np.nan_to_num(lab, nan=0.0)
            label_mask[gi, :lab.shape[0]] = ~np.isnan(lab)
        n_off += n
        e_off += e

    # padding edges self-loop on the last padding node
    pad_node = num_nodes - 1 if n_off < num_nodes else 0
    senders[e_off:] = pad_node
    receivers[e_off:] = pad_node

    order = np.lexsort((senders, receivers))
    senders = senders[order]
    receivers = receivers[order]
    edge_mask = edge_mask[order]
    col_off = (_band_col_off(senders, receivers, edge_mask, num_nodes)
               if banded else None)
    if gt_fits is None:
        gt_fits = gt_band_fits(max((g.num_nodes for g in graphs), default=0),
                               num_nodes)
    return GraphBatch(node_feat=node_feat, node_graph=node_graph,
                      node_mask=node_mask, senders=senders,
                      receivers=receivers, edge_mask=edge_mask,
                      graph_mask=graph_mask, labels=labels,
                      label_mask=label_mask, band_col_off=col_off,
                      gt_fits=gt_fits)


@dataclasses.dataclass(frozen=True)
class EgoNets:
    """k-hop ego-nets of one graph (egonet.py): ``node_lists[v]`` holds the
    original node ids of v's ego-net (v first), ``edge_lists[v]`` its local
    COO edges."""

    node_lists: List[np.ndarray]
    edge_lists: List[Tuple[np.ndarray, np.ndarray]]

    def flat(self) -> "FlatEgoNets":
        """The concatenated view, computed once and cached."""
        cached = getattr(self, "_flat", None)
        if cached is None:
            n = len(self.node_lists)
            node_off = np.zeros(n + 1, np.int64)
            edge_off = np.zeros(n + 1, np.int64)
            for v, nl in enumerate(self.node_lists):
                node_off[v + 1] = node_off[v] + len(nl)
                edge_off[v + 1] = edge_off[v] + len(self.edge_lists[v][0])
            nodes = (np.concatenate(self.node_lists).astype(np.int32)
                     if n else np.zeros(0, np.int32))
            if n and edge_off[-1]:
                es = np.concatenate([el[0] for el in self.edge_lists])
                er = np.concatenate([el[1] for el in self.edge_lists])
                base = np.repeat(node_off[:-1], np.diff(edge_off))
                es = (es + base).astype(np.int32)
                er = (er + base).astype(np.int32)
            else:
                es = np.zeros(0, np.int32)
                er = np.zeros(0, np.int32)
            cached = FlatEgoNets(nodes=nodes, node_off=node_off,
                                 senders=es, receivers=er,
                                 edge_off=edge_off)
            object.__setattr__(self, "_flat", cached)
        return cached


@dataclasses.dataclass(frozen=True)
class FlatEgoNets:
    """Concatenated ego-nets of one graph, in center order."""

    nodes: np.ndarray
    node_off: np.ndarray
    senders: np.ndarray
    receivers: np.ndarray
    edge_off: np.ndarray


def pack_subgraphs(graphs: Sequence[GraphData], egonets: Sequence[EgoNets],
                   num_sub_nodes: int, num_sub_edges: int,
                   banded: bool = True,
                   gt_fits: Optional[bool] = None,
                   num_centers: Optional[int] = None) -> SubgraphBatch:
    """Flatten the ego-nets of a batch into one padded SubgraphBatch, in
    (graph, node) order, so ``node_center`` is the center's global id in
    the GraphBatch.  Sub-node features are left to the device gather
    ``g.node_feat[node_orig]``.  ``gt_fits`` as in ``pack_graphs``, from
    the largest ego-net.  ``num_centers``, the GraphBatch's node capacity:
    the batch's ``pool_fits`` is taken from it (None without it)."""
    flats = [e.flat() for e in egonets]
    total_s = int(sum(f.node_off[-1] for f in flats))
    total_q = int(sum(f.edge_off[-1] for f in flats))
    if total_s > num_sub_nodes:
        raise ValueError(f"sub-node capacity {num_sub_nodes} < {total_s}")
    if total_q > num_sub_edges:
        raise ValueError(f"sub-edge capacity {num_sub_edges} < {total_q}")

    node_center = np.zeros(num_sub_nodes, dtype=np.int32)
    node_orig = np.zeros(num_sub_nodes, dtype=np.int32)
    node_mask = np.zeros(num_sub_nodes, dtype=bool)
    senders = np.zeros(num_sub_edges, dtype=np.int32)
    receivers = np.zeros(num_sub_edges, dtype=np.int32)
    edge_mask = np.zeros(num_sub_edges, dtype=bool)

    s_off = 0
    q_off = 0
    n_off = 0
    for g, f in zip(graphs, flats):
        m = int(f.node_off[-1])
        q = int(f.edge_off[-1])
        node_center[s_off:s_off + m] = n_off + np.repeat(
            np.arange(g.num_nodes, dtype=np.int32), np.diff(f.node_off))
        node_orig[s_off:s_off + m] = n_off + f.nodes
        node_mask[s_off:s_off + m] = True
        senders[q_off:q_off + q] = f.senders + s_off
        receivers[q_off:q_off + q] = f.receivers + s_off
        edge_mask[q_off:q_off + q] = True
        s_off += m
        q_off += q
        n_off += g.num_nodes

    pad_node = num_sub_nodes - 1 if s_off < num_sub_nodes else 0
    senders[q_off:] = pad_node
    receivers[q_off:] = pad_node
    node_center[s_off:] = 0

    order = np.lexsort((senders, receivers))
    senders = senders[order]
    receivers = receivers[order]
    edge_mask = edge_mask[order]
    col_off = (_band_col_off(senders, receivers, edge_mask, num_sub_nodes)
               if banded else None)
    if gt_fits is None:
        gt_fits = gt_band_fits(
            max((int(np.diff(f.node_off).max(initial=0)) for f in flats),
                default=0), num_sub_nodes)
    pool_fits = (None if num_centers is None
                 else window_fits(node_center, node_mask, num_centers))
    return SubgraphBatch(node_feat=None, node_center=node_center,
                         node_orig=node_orig, node_mask=node_mask,
                         senders=senders, receivers=receivers,
                         edge_mask=edge_mask, band_col_off=col_off,
                         gt_fits=gt_fits, pool_fits=pool_fits)
