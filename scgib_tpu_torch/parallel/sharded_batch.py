"""The node-sharded batch and the host-side resharding that builds it.

Counterpart of ``scgib_tpu/parallel/sharded_batch.py``.  Takes an
already-packed union ``GraphBatch``/``SubgraphBatch`` (the arrays a single
device would train on, packed with ``banded=False``) and splits it into
per-rank slices for the node-sharded pretraining step
(``sharded_scgib.py``):

* nodes: contiguous equal ranges, one a rank (graphs MAY span ranks; every
  per-graph reduction goes through the group's segment ops,
  ``sharded_ops.py``),
* graph edges: the ring plan of ``edge_partition.partition_edges_ring``,
* ego-net sub-nodes: each ego-net follows its CENTER node's rank, so the
  second encoder and the candidate pooling are local to the rank (a
  sub-edge joins two members of one ego-net, so it never crosses ranks),
* graph ownership: each real graph is owned by the rank holding its first
  node, the disjoint cover the local-numerator loss terms use.

``shard_pretrain_batch`` is NumPy, copied from the JAX package and held
bit-equal to it; every leaf carries a leading shard axis [S, ...].
``local_slice`` takes rank r's slice, and ``.to(device)`` makes tensors of
it, as the port's batch containers do.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..graph.container import GraphBatch, SubgraphBatch
from .edge_partition import partition_edges_ring

_INDEX_FIELDS = ("node_graph", "senders_owner_local", "receivers_local",
                 "sub_center_local", "sub_senders", "sub_receivers")
_MASK_FIELDS = ("node_mask", "edge_mask", "graph_mask", "graph_own",
                "sub_node_mask", "sub_edge_mask")


@dataclasses.dataclass
class ShardedPretrainBatch:
    """Per-rank slices of one union batch; every array field is [S, ...]
    (stacked) or, after ``local_slice``, one rank's [...]."""

    # graph-batch node slices (P = nodes per shard)
    node_feat: object               # [S, P, F]
    node_graph: object              # [S, P] GLOBAL graph ids
    node_mask: object               # [S, P]
    # ring edge plan (edge_partition.RingPartition, shard-leading)
    senders_owner_local: object     # [S, 2R+1, E]
    receivers_local: object         # [S, 2R+1, E]
    edge_mask: object               # [S, 2R+1, E]
    # global graph masks (graph_mask identical on every shard; graph_own
    # is this shard's disjoint ownership slice)
    graph_mask: object              # [S, G]
    graph_own: object               # [S, G]
    # shard-local ego-net batch (Q = sub-node cap, Qe = sub-edge cap)
    sub_node_feat: object           # [S, Q, F]
    sub_center_local: object        # [S, Q] center index within shard range
    sub_node_mask: object           # [S, Q]
    sub_senders: object             # [S, Qe] shard-local sub-node ids
    sub_receivers: object           # [S, Qe] sorted ascending
    sub_edge_mask: object           # [S, Qe]
    radius: int = 1

    @property
    def num_shards(self) -> int:
        return self.node_feat.shape[0]

    @property
    def nodes_per_shard(self) -> int:
        return self.node_feat.shape[1]

    @property
    def num_graphs(self) -> int:
        return self.graph_mask.shape[-1]

    def to(self, device) -> "ShardedPretrainBatch":
        """A copy with every array field a tensor on ``device``: indices
        int64, masks bool, features float32."""
        def tensor(name, value):
            dtype = (torch.int64 if name in _INDEX_FIELDS else
                     torch.bool if name in _MASK_FIELDS else torch.float32)
            if not isinstance(value, torch.Tensor):
                value = torch.from_numpy(np.asarray(value))
            return value.to(device=device, dtype=dtype)
        return dataclasses.replace(self, **{
            f.name: tensor(f.name, getattr(self, f.name))
            for f in dataclasses.fields(self) if f.name != "radius"})


def local_slice(batch: ShardedPretrainBatch, rank: int
                ) -> ShardedPretrainBatch:
    """Rank ``rank``'s slice: the leading shard axis taken at ``rank``."""
    return dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name)[rank]
        for f in dataclasses.fields(batch) if f.name != "radius"})


def _round_up(x: int, m: int) -> int:
    return max(m, ((x + m - 1) // m) * m)


def shard_pretrain_batch(g: GraphBatch, sub: SubgraphBatch,
                         num_shards: int,
                         sub_node_cap: Optional[int] = None,
                         sub_edge_cap: Optional[int] = None,
                         ring_edge_cap: Optional[int] = None
                         ) -> ShardedPretrainBatch:
    """Reshard a packed union batch (NumPy fields) into per-shard slices.

    ``g.num_nodes`` must be divisible by ``num_shards`` (pad the node
    capacity to a shard multiple when packing).  Per-shard sub-node/edge
    capacities default to the observed max, rounded up to 8/32, and the
    ring plan's per-slot edge capacity to its largest load.  Fixed caps
    (``ring_edge_cap`` is the port's addition) give every batch one shape,
    so the captured step replays instead of capturing anew.
    """
    n = g.num_nodes
    if n % num_shards != 0:
        raise ValueError(f"node capacity {n} not divisible by "
                         f"{num_shards} shards")
    per = n // num_shards
    feat = np.asarray(g.node_feat)
    node_graph = np.asarray(g.node_graph)
    node_mask = np.asarray(g.node_mask)
    graph_mask = np.asarray(g.graph_mask)
    num_graphs = graph_mask.shape[0]

    # --- ring plan over the real graph edges -----------------------------
    em = np.asarray(g.edge_mask)
    plan = partition_edges_ring(np.asarray(g.senders)[em],
                                np.asarray(g.receivers)[em], n, num_shards,
                                ring_edge_cap)
    # [2R+1, S, E] -> [S, 2R+1, E]
    sol = np.transpose(plan.senders_owner_local, (1, 0, 2))
    rl = np.transpose(plan.receivers_local, (1, 0, 2))
    pem = np.transpose(plan.edge_mask, (1, 0, 2))

    # --- graph ownership: shard of the graph's first real node -----------
    own = np.zeros((num_shards, num_graphs), dtype=bool)
    first = np.full(num_graphs, n, dtype=np.int64)
    idx = np.nonzero(node_mask)[0]
    np.minimum.at(first, node_graph[idx], idx)
    for gi in range(num_graphs):
        if graph_mask[gi]:
            own[min(int(first[gi]) // per, num_shards - 1), gi] = True

    # --- ego-nets follow their center's shard -----------------------------
    centers = np.asarray(sub.node_center)
    sub_mask = np.asarray(sub.node_mask)
    sub_orig = np.asarray(sub.node_orig)
    if sub.node_feat is not None:
        sub_feat_union = np.asarray(sub.node_feat)
    else:
        sub_feat_union = feat[sub_orig]   # host-side gather of the wire fmt
    s_send = np.asarray(sub.senders)
    s_recv = np.asarray(sub.receivers)
    s_emask = np.asarray(sub.edge_mask)

    shard_of_sub = np.where(sub_mask, centers // per, -1)
    real_edges = np.nonzero(s_emask)[0]
    # every sub-edge joins two members of one ego-net -> same shard
    edge_shard = shard_of_sub[s_recv[real_edges]]

    q_counts = [int(np.sum(shard_of_sub == s)) for s in range(num_shards)]
    qe_counts = [int(np.sum(edge_shard == s)) for s in range(num_shards)]
    q_cap = sub_node_cap or _round_up(max(q_counts + [1]), 8)
    qe_cap = sub_edge_cap or _round_up(max(qe_counts + [1]), 32)
    if max(q_counts) > q_cap:
        raise ValueError(f"sub_node_cap {q_cap} < shard load "
                         f"{max(q_counts)}")
    if max(qe_counts) > qe_cap:
        raise ValueError(f"sub_edge_cap {qe_cap} < shard load "
                         f"{max(qe_counts)}")

    fdim = feat.shape[1]
    sub_feat = np.zeros((num_shards, q_cap, fdim), np.float32)
    sub_cl = np.zeros((num_shards, q_cap), np.int32)
    sub_nm = np.zeros((num_shards, q_cap), bool)
    sub_s = np.zeros((num_shards, qe_cap), np.int32)
    sub_r = np.zeros((num_shards, qe_cap), np.int32)
    sub_em = np.zeros((num_shards, qe_cap), bool)
    for s in range(num_shards):
        sel = np.nonzero(shard_of_sub == s)[0]
        k = len(sel)
        remap = np.full(sub_mask.shape[0], -1, np.int64)
        remap[sel] = np.arange(k)
        sub_feat[s, :k] = sub_feat_union[sel]
        sub_cl[s, :k] = centers[sel] - s * per
        sub_nm[s, :k] = True
        esel = real_edges[edge_shard == s]
        ke = len(esel)
        ls = remap[s_send[esel]]
        lr = remap[s_recv[esel]]
        if (ls < 0).any() or (lr < 0).any():
            raise ValueError("sub-edge endpoint missing from its shard's "
                             "ego-nets")
        order = np.lexsort((ls, lr))        # sort by local receiver
        sub_s[s, :ke] = ls[order]
        sub_r[s, :ke] = lr[order]
        sub_em[s, :ke] = True

    def tile(a):
        return np.broadcast_to(a, (num_shards,) + a.shape).copy()

    return ShardedPretrainBatch(
        node_feat=feat.reshape(num_shards, per, fdim),
        node_graph=node_graph.reshape(num_shards, per),
        node_mask=node_mask.reshape(num_shards, per),
        senders_owner_local=sol,
        receivers_local=rl,
        edge_mask=pem,
        graph_mask=tile(graph_mask),
        graph_own=own,
        sub_node_feat=sub_feat,
        sub_center_local=sub_cl,
        sub_node_mask=sub_nm,
        sub_senders=sub_s,
        sub_receivers=sub_r,
        sub_edge_mask=sub_em,
        radius=plan.radius,
    )
