"""The flat dataset and the native batch packer.

Counterpart of ``scgib_tpu/data/flat.py``.  ``FlatDataset`` holds a whole
dataset as a few contiguous arrays (the layout of the ``data/cache.py``
``.npz``), so packing a batch is a handful of slice copies a graph, done by
the threaded C++ packer of ``native.py`` (``scgib_pack_batch``); the JAX
package's NumPy fallback is not kept, since ``batch_iterator(use_flat=
False)`` is the NumPy path (the per-graph packers, bit-equal).

Per-graph edge lists are sorted receiver-major when the view is built, and
packed graphs occupy disjoint ascending node ranges, so the concatenated
lists are sorted without a sort at batch time.

The band test is placement-independent.  The band is the dataset's, one
width for its graphs and one for its ego-nets (``graph/banded.py::
band_width`` of the largest of each: 256 up to 64 nodes, as in the JAX
package, wider past it); a batch's graphs take the banded layout when each
selected graph has at most (band - tile) / 2 nodes (an edge then stays in
its receiver tile's window wherever the graph lands) and the capacity is at
least the band, and its ego-nets the same by their own width, apart from
the graphs.  The per-graph packers test the batch's own edges at the same
widths, so the two agree on every batch.  ``gt_fits`` comes
from the dataset's largest graph and ego-net, and the batch's ``pool_fits``
from its own centers (``ops/pool.py::window_fits``), as the per-graph
packers set them; the JAX package's flat packer sets no ``pool_fits``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..graph.banded import (band_width, banded_col_off, component_fits,
                            gt_band_fits)
from ..graph.container import GraphBatch, SubgraphBatch
from ..native import pack_batch_native
from ..ops.pool import window_fits


@dataclasses.dataclass
class FlatDataset:
    """Graph g owns nodes [node_off[g], node_off[g+1]), edges
    [edge_off[g], ...), ego-net rows [ego_node_off[g], ...) and ego-net
    edges [ego_edge_off[g], ...).  Ids are graph-local; ego-net senders and
    receivers are local to the graph's concatenated ego-nets; edge lists
    are receiver-major."""

    node_off: np.ndarray       # [G+1] int64
    edge_off: np.ndarray       # [G+1] int64
    feat: np.ndarray           # [N_tot, F] float32
    senders: np.ndarray        # [E_tot] int32
    receivers: np.ndarray      # [E_tot] int32
    ego_node_off: np.ndarray   # [G+1] int64
    ego_edge_off: np.ndarray   # [G+1] int64
    ego_nodes: np.ndarray      # [S_tot] int32 (graph-local original node)
    ego_center: np.ndarray     # [S_tot] int32 (graph-local center node)
    ego_senders: np.ndarray    # [Q_tot] int32
    ego_receivers: np.ndarray  # [Q_tot] int32
    max_ego: np.ndarray        # [G] int32, each graph's largest ego-net
    labels: Optional[np.ndarray] = None   # [G, T] float32, NaN = missing

    @property
    def num_graphs(self) -> int:
        return len(self.node_off) - 1

    def graph_sizes(self):
        return (np.diff(self.node_off), np.diff(self.edge_off),
                np.diff(self.ego_node_off), np.diff(self.ego_edge_off))


def build_flat(ds) -> FlatDataset:
    """The flat view of a ``GraphDataset``, built once; each graph's edge
    lists sorted receiver-major here."""
    G = len(ds)
    node_off = np.zeros(G + 1, np.int64)
    edge_off = np.zeros(G + 1, np.int64)
    ego_node_off = np.zeros(G + 1, np.int64)
    ego_edge_off = np.zeros(G + 1, np.int64)
    feats, ss, rs = [], [], []
    enodes, ecenters, ess, ers = [], [], [], []
    max_ego = np.zeros(G, np.int32)
    labels: List[Optional[np.ndarray]] = []
    for i, (g, ego) in enumerate(zip(ds.graphs, ds.egonets)):
        node_off[i + 1] = node_off[i] + g.num_nodes
        edge_off[i + 1] = edge_off[i] + g.num_edges
        feats.append(np.asarray(g.node_feat, np.float32))
        order = np.lexsort((g.senders, g.receivers))
        ss.append(np.asarray(g.senders, np.int32)[order])
        rs.append(np.asarray(g.receivers, np.int32)[order])
        labels.append(None if g.label is None
                      else np.atleast_1d(np.asarray(g.label, np.float32)))
        f = ego.flat()
        sizes = np.diff(f.node_off)
        max_ego[i] = int(sizes.max(initial=0))
        ego_node_off[i + 1] = ego_node_off[i] + len(f.nodes)
        ego_edge_off[i + 1] = ego_edge_off[i] + len(f.senders)
        enodes.append(f.nodes)
        ecenters.append(np.repeat(np.arange(g.num_nodes, dtype=np.int32),
                                  sizes).astype(np.int32))
        order = np.lexsort((f.senders, f.receivers))
        ess.append(f.senders[order])
        ers.append(f.receivers[order])

    lab_arr = None
    if any(lab is not None for lab in labels):
        t = max(lab.shape[0] for lab in labels if lab is not None)
        lab_arr = np.full((G, t), np.nan, np.float32)
        for i, lab in enumerate(labels):
            if lab is not None:
                lab_arr[i, :lab.shape[0]] = lab

    def cat(xs, dt):
        return (np.ascontiguousarray(np.concatenate(xs), dtype=dt) if xs
                else np.zeros(0, dt))

    return FlatDataset(
        node_off=node_off, edge_off=edge_off,
        feat=np.ascontiguousarray(np.concatenate(feats), dtype=np.float32),
        senders=cat(ss, np.int32), receivers=cat(rs, np.int32),
        ego_node_off=ego_node_off, ego_edge_off=ego_edge_off,
        ego_nodes=cat(enodes, np.int32), ego_center=cat(ecenters, np.int32),
        ego_senders=cat(ess, np.int32), ego_receivers=cat(ers, np.int32),
        max_ego=max_ego, labels=lab_arr)


def pack_flat_batch(fd: FlatDataset, sel: Sequence[int], caps,
                    num_tasks: Optional[int] = None, banded: bool = True,
                    tile: int = 128
                    ) -> Tuple[GraphBatch, SubgraphBatch]:
    """Pack the graphs ``sel`` with the native packer: the arrays, edge
    order, flags and labels of ``data/loader.py::pack_batch``'s per-graph
    packers.  Raises where the batch exceeds ``caps``."""
    sel = np.asarray(sel, np.int64)
    if sel.size and (sel.min() < 0 or sel.max() >= fd.num_graphs):
        raise IndexError(f"graph index out of range [0, {fd.num_graphs})")
    n_sz, e_sz, sn_sz, se_sz = (arr[sel] for arr in fd.graph_sizes())
    if (n_sz.sum() > caps.nodes or e_sz.sum() > caps.edges
            or sn_sz.sum() > caps.sub_nodes
            or se_sz.sum() > caps.sub_edges):
        raise ValueError(
            f"batch exceeds capacities {caps}: needs nodes {n_sz.sum()}, "
            f"edges {e_sz.sum()}, sub_nodes {sn_sz.sum()}, "
            f"sub_edges {se_sz.sum()}")
    if len(sel) > caps.graphs:
        raise ValueError(f"graph capacity {caps.graphs} < {len(sel)}")
    (node_feat, node_graph, node_mask, senders, receivers, edge_mask,
     node_center, node_orig, sub_node_mask, sub_s, sub_r, sub_edge_mask,
     n_used, e_used, s_used, q_used) = pack_batch_native(fd, sel, caps)

    # padding edges self-loop on the last padding node (the packers' rule)
    if e_used < caps.edges:
        pad = caps.nodes - 1 if n_used < caps.nodes else 0
        senders[e_used:] = pad
        receivers[e_used:] = pad
    if q_used < caps.sub_edges:
        pad = caps.sub_nodes - 1 if s_used < caps.sub_nodes else 0
        sub_s[q_used:] = pad
        sub_r[q_used:] = pad

    labels = label_mask = None
    if fd.labels is not None:
        t = num_tasks or fd.labels.shape[1]
        labels = np.zeros((caps.graphs, t), np.float32)
        label_mask = np.zeros((caps.graphs, t), bool)
        lab = fd.labels[sel][:, :t]
        labels[:len(sel), :lab.shape[1]] = np.nan_to_num(lab, nan=0.0)
        label_mask[:len(sel), :lab.shape[1]] = ~np.isnan(lab)
    graph_mask = np.zeros(caps.graphs, bool)
    graph_mask[:len(sel)] = True

    ds_max_n = int(np.diff(fd.node_off).max(initial=0))
    ds_max_ego = int(fd.max_ego.max(initial=0))
    w_g, w_sub = band_width(ds_max_n, tile), band_width(ds_max_ego, tile)

    def col_off(cap: int, width: int, sizes: np.ndarray):
        ok = (banded and len(sel) > 0 and cap % tile == 0 and cap >= width
              and component_fits(sizes.max(initial=0), width, tile))
        return banded_col_off(cap, tile, width) if ok else None
    g = GraphBatch(
        node_feat=node_feat, node_graph=node_graph, node_mask=node_mask,
        senders=senders, receivers=receivers, edge_mask=edge_mask,
        graph_mask=graph_mask, labels=labels, label_mask=label_mask,
        band_col_off=col_off(caps.nodes, w_g, n_sz),
        gt_fits=gt_band_fits(ds_max_n, caps.nodes), band_width=w_g)
    sub = SubgraphBatch(
        node_feat=None, node_center=node_center, node_orig=node_orig,
        node_mask=sub_node_mask, senders=sub_s, receivers=sub_r,
        edge_mask=sub_edge_mask,
        band_col_off=col_off(caps.sub_nodes, w_sub, fd.max_ego[sel]),
        gt_fits=gt_band_fits(ds_max_ego, caps.sub_nodes),
        pool_fits=window_fits(node_center, sub_node_mask, caps.nodes),
        band_width=w_sub)
    return g, sub
