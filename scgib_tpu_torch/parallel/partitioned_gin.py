"""GIN over a node-sharded graph: message passing across ranks.

Counterpart of ``scgib_tpu/parallel/partitioned_gin.py``.  Each rank holds
its contiguous range of node rows, and every conv runs

    agg = ring_partitioned_spmm(h, ...)        # the ring halo
    h   = relu(syncBN(MLP(h + agg)))

on the rank, with cross-rank traffic limited to the 2R neighbour blocks of
the ring and the sync-BatchNorm's one all-reduce a conv.  Its parameters and
buffers are those of ``models/encoders.py::GIN`` (``conv{i}``: ``MLP2``,
``bn{i}``: ``MaskedBatchNorm``), so one state dict drives the single-device
encoder and this one; on the union graph the two agree in train mode (the
statistics are the group's) and in eval mode.
"""

from __future__ import annotations

from torch import nn

from ..models.layers import MLP2, MaskedBatchNorm, _mask_rows
from .edge_partition import ring_partitioned_spmm


class PartitionedGIN(nn.Module):
    """``num_convs`` GIN convs over this rank's rows.  ``forward(h,
    senders_owner_local, receivers_local, edge_mask, node_mask=None)``: h
    [N/S, d] this rank's node features, the plan arrays this rank's
    [2R+1, Ecap] slices of ``edge_partition.partition_edges_ring``,
    node_mask [N/S] or None.  ``group``: the ranks the nodes are sharded
    over (the JAX module's ``axis_name``)."""

    def __init__(self, in_dim: int, hidden: int = 64, num_convs: int = 4,
                 group=None):
        super().__init__()
        self.num_convs = num_convs
        self.group = group
        for i in range(num_convs):
            self.add_module(f"conv{i}", MLP2(in_dim if i == 0 else hidden,
                                             hidden, hidden))
            self.add_module(f"bn{i}", MaskedBatchNorm(hidden, group=group))

    def forward(self, h, senders_owner_local, receivers_local, edge_mask,
                node_mask=None):
        h = _mask_rows(h, node_mask)
        for i in range(self.num_convs):
            agg = ring_partitioned_spmm(h, senders_owner_local,
                                        receivers_local, edge_mask,
                                        self.group)
            h = getattr(self, f"conv{i}")(h + agg)
            h = getattr(self, f"bn{i}").normalize_relu(h, node_mask)
        return h
