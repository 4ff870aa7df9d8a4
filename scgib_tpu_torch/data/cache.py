"""On-disk dataset cache — packed flat arrays instead of the reference's
pickled DGL graph lists (``pts/*.bin`` + ``torch.save`` subgraph
list-of-lists, exp_pcqm4mv2.py:437-441, exp_pretraining.py:178-186).

Format: one ``.npz`` holding every graph's nodes/edges/ego-nets as flat
arrays + offset tables — O(1) mmap-able load, no Python object decoding,
and the ego-nets (the expensive k-hop precompute) are stored flattened the
same way the device consumes them.

The port's own copy of ``scgib_tpu/data/cache.py`` (NumPy only), held to
it by ``tests/test_torch_data.py``.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from ..graph.batching import EgoNets, GraphData
from .loader import GraphDataset


def save_dataset(path: str, ds: GraphDataset) -> None:
    graphs, egos = ds.graphs, ds.egonets
    n_graphs = len(graphs)

    node_off = np.zeros(n_graphs + 1, np.int64)
    edge_off = np.zeros(n_graphs + 1, np.int64)
    for i, g in enumerate(graphs):
        node_off[i + 1] = node_off[i] + g.num_nodes
        edge_off[i + 1] = edge_off[i] + g.num_edges

    feat = np.concatenate([g.node_feat for g in graphs]).astype(np.float32)
    senders = np.concatenate([g.senders for g in graphs]).astype(np.int32)
    receivers = np.concatenate([g.receivers for g in graphs]).astype(
        np.int32)

    has_labels = any(g.label is not None for g in graphs)
    labels = None
    if has_labels:
        t = max(np.atleast_1d(g.label).shape[0] for g in graphs
                if g.label is not None)
        labels = np.full((n_graphs, t), np.nan, np.float32)
        for i, g in enumerate(graphs):
            if g.label is not None:
                lab = np.atleast_1d(g.label)
                labels[i, :lab.shape[0]] = lab

    # ego-nets: per-center node lists and local edge lists, flattened with
    # per-center offsets; centers are concatenated in (graph, node) order.
    ego_nodes: List[np.ndarray] = []
    ego_es: List[np.ndarray] = []
    ego_er: List[np.ndarray] = []
    ego_node_off = [0]
    ego_edge_off = [0]
    for ego in egos:
        for nl, (es, er) in zip(ego.node_lists, ego.edge_lists):
            ego_nodes.append(np.asarray(nl, np.int32))
            ego_es.append(np.asarray(es, np.int32))
            ego_er.append(np.asarray(er, np.int32))
            ego_node_off.append(ego_node_off[-1] + len(nl))
            ego_edge_off.append(ego_edge_off[-1] + len(es))

    arrays = dict(
        version=np.int64(1),
        k=np.int64(ds.k),
        node_off=node_off, edge_off=edge_off,
        feat=feat, senders=senders, receivers=receivers,
        ego_nodes=np.concatenate(ego_nodes) if ego_nodes else
        np.zeros(0, np.int32),
        ego_senders=np.concatenate(ego_es) if ego_es else
        np.zeros(0, np.int32),
        ego_receivers=np.concatenate(ego_er) if ego_er else
        np.zeros(0, np.int32),
        ego_node_off=np.asarray(ego_node_off, np.int64),
        ego_edge_off=np.asarray(ego_edge_off, np.int64),
    )
    if labels is not None:
        arrays["labels"] = labels
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)


def load_dataset(path: str) -> GraphDataset:
    """The dataset of a cache.  Each array is read (decompressed) once and
    every graph and ego-net is a view into it; the JAX package's
    ``load_dataset`` indexes the ``NpzFile`` per slice, which decompresses
    the whole array again for every slice and leaves each slice holding
    its own full copy (quadratic time, and memory past a card machine's
    96 GiB at 4096 molecules)."""
    with np.load(path) as npz:
        z = {k: npz[k] for k in npz.files}
    node_off = z["node_off"]
    edge_off = z["edge_off"]
    n_graphs = len(node_off) - 1
    labels = z.get("labels")

    graphs: List[GraphData] = []
    for i in range(n_graphs):
        n0, n1 = node_off[i], node_off[i + 1]
        e0, e1 = edge_off[i], edge_off[i + 1]
        lab = labels[i] if labels is not None else None
        graphs.append(GraphData(
            senders=z["senders"][e0:e1], receivers=z["receivers"][e0:e1],
            node_feat=z["feat"][n0:n1], label=lab))

    egos: List[EgoNets] = []
    eno = z["ego_node_off"]
    eeo = z["ego_edge_off"]
    c = 0
    for i in range(n_graphs):
        node_lists, edge_lists = [], []
        for _v in range(node_off[i + 1] - node_off[i]):
            s0, s1 = eno[c], eno[c + 1]
            q0, q1 = eeo[c], eeo[c + 1]
            node_lists.append(z["ego_nodes"][s0:s1])
            edge_lists.append((z["ego_senders"][q0:q1],
                               z["ego_receivers"][q0:q1]))
            c += 1
        egos.append(EgoNets(node_lists=node_lists, edge_lists=edge_lists))

    return GraphDataset(graphs=graphs, k=int(z["k"]), egonets=egos)
