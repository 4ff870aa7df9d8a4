"""Edge-partitioned message passing over node-sharded graphs.

Counterpart of ``scgib_tpu/parallel/edge_partition.py``.  Nodes are split
into contiguous equal ranges, one a rank, and every edge belongs to the
rank that owns its receiver.  Two host plans (NumPy, copied from the JAX
package and held bit-equal to it) and the aggregation each drives:

- ``partition_edges`` -> ``partitioned_spmm``: the rank's edges with global
  sender ids; every rank's rows are gathered (``all_gather``) and the
  rank's edges aggregate locally.
- ``partition_edges_ring`` -> ``ring_partitioned_spmm``: edges grouped by
  the signed ring distance from the receiver's rank to the sender's; the
  rank's own block, then for each distance d one hop forward and one hop
  backward round the ring (``collectives.ring_shift``), so a rank ships 2R
  blocks instead of all_gather's S - 1 (R = 1 for contiguously packed
  batches).

Each equals the single-device ``gather_sum`` on the union graph up to
summation order.  The aggregation inside a rank is ``index_select`` plus
``index_add`` (``ops/segment.py::segment_sum``), as the JAX package's is a
gather plus ``segment_sum``: no Pallas kernel there, so no hand-written
kernel here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.segment import segment_sum
from .collectives import all_gather, ring_shift


@dataclasses.dataclass(frozen=True)
class EdgePartition:
    """Host-side plan: per-shard padded edge lists over contiguous node
    ranges.

    senders_global: [S, Ecap] int32 — sender's GLOBAL node id
    receivers_local: [S, Ecap] int32 — receiver's index within its shard
    edge_mask: [S, Ecap] bool
    nodes_per_shard: int
    """

    senders_global: np.ndarray
    receivers_local: np.ndarray
    edge_mask: np.ndarray
    nodes_per_shard: int

    @property
    def num_shards(self) -> int:
        return self.senders_global.shape[0]


def partition_edges(senders: np.ndarray, receivers: np.ndarray,
                    num_nodes: int, num_shards: int,
                    edge_cap: Optional[int] = None) -> EdgePartition:
    """Assign edges to the shard owning the receiver (contiguous equal
    node ranges); pad each shard's list to a common capacity."""
    if num_nodes % num_shards != 0:
        raise ValueError("pad node capacity to a shard multiple")
    per = num_nodes // num_shards
    shard = receivers // per
    counts = np.bincount(shard, minlength=num_shards)
    cap = int(counts.max()) if edge_cap is None else edge_cap
    cap = max(cap, 1)
    if counts.max() > cap:
        raise ValueError(f"edge_cap {cap} < max shard load {counts.max()}")

    sg = np.zeros((num_shards, cap), np.int32)
    rl = np.zeros((num_shards, cap), np.int32)
    em = np.zeros((num_shards, cap), bool)
    fill = np.zeros(num_shards, np.int64)
    for e in range(len(senders)):
        s = shard[e]
        i = fill[s]
        sg[s, i] = senders[e]
        rl[s, i] = receivers[e] - s * per
        em[s, i] = True
        fill[s] += 1
    return EdgePartition(senders_global=sg, receivers_local=rl,
                         edge_mask=em, nodes_per_shard=per)


def _aggregate(block: torch.Tensor, senders: torch.Tensor,
               receivers: torch.Tensor, edge_mask: torch.Tensor,
               num_rows: int) -> torch.Tensor:
    """sum over the edges of ``block[sender]`` into ``receiver``."""
    return segment_sum(block.index_select(0, senders), receivers, num_rows,
                       mask=edge_mask)


def partitioned_spmm(h_local: torch.Tensor, senders_global: torch.Tensor,
                     receivers_local: torch.Tensor, edge_mask: torch.Tensor,
                     group) -> torch.Tensor:
    """This rank's neighbour sums, [N/S, d] -> [N/S, d], from its rows of
    an ``EdgePartition`` ([Ecap] each): every rank's rows gathered, then
    the rank's edges aggregated."""
    h_all = all_gather(h_local, group)
    return _aggregate(h_all, senders_global, receivers_local, edge_mask,
                      h_local.shape[0])


@dataclasses.dataclass(frozen=True)
class RingPartition:
    """Host-side plan for the ring halo exchange.

    Edges are grouped by the ring offset of their SENDER's shard relative
    to the receiver's shard: offset 0 edges are shard-internal, offset +d
    edges read rows owned by shard (s+d) mod S, offset -d by (s-d) mod S.

    Arrays are indexed [offset_slot, shard, Ecap_slot] where slot o maps
    to offset ``o - radius`` (so slot 0 is -radius, slot radius is 0).
    ``senders_owner_local`` holds the sender's index WITHIN ITS OWNER's
    shard range — after d ring hops the owner's block is resident locally
    and the gather is purely local.
    """

    senders_owner_local: np.ndarray   # [2R+1, S, Ecap] int32
    receivers_local: np.ndarray       # [2R+1, S, Ecap] int32
    edge_mask: np.ndarray             # [2R+1, S, Ecap] bool
    nodes_per_shard: int
    radius: int

    @property
    def num_shards(self) -> int:
        return self.senders_owner_local.shape[1]


def partition_edges_ring(senders: np.ndarray, receivers: np.ndarray,
                         num_nodes: int, num_shards: int,
                         edge_cap: Optional[int] = None) -> RingPartition:
    """Build the ring plan: group edges by signed ring distance from the
    receiver's shard to the sender's shard (shortest wraparound direction;
    ties at S/2 go to +S/2).  ``edge_cap``: pad every slot's lists to it
    (the port's addition, as ``partition_edges`` has it: batches of one
    shape replay one captured step); by default the largest load."""
    if num_nodes % num_shards != 0:
        raise ValueError("pad node capacity to a shard multiple")
    per = num_nodes // num_shards
    s_shard = np.asarray(senders) // per
    r_shard = np.asarray(receivers) // per
    # signed shortest ring distance in (-S/2, S/2]
    diff = (s_shard - r_shard) % num_shards
    signed = np.where(diff > num_shards // 2, diff - num_shards, diff)
    radius = int(np.abs(signed).max(initial=0))

    slots = 2 * radius + 1
    caps = np.zeros(slots, np.int64)
    for o in range(slots):
        d = o - radius
        sel = signed == d
        if sel.any():
            caps[o] = np.bincount(r_shard[sel],
                                  minlength=num_shards).max()
    cap = max(int(caps.max()), 1)
    if edge_cap is not None:
        if cap > edge_cap:
            raise ValueError(f"edge_cap {edge_cap} < max slot load {cap}")
        cap = edge_cap

    sol = np.zeros((slots, num_shards, cap), np.int32)
    rl = np.zeros((slots, num_shards, cap), np.int32)
    em = np.zeros((slots, num_shards, cap), bool)
    fill = np.zeros((slots, num_shards), np.int64)
    for e in range(len(senders)):
        o = int(signed[e]) + radius
        sh = int(r_shard[e])
        i = fill[o, sh]
        sol[o, sh, i] = senders[e] - s_shard[e] * per
        rl[o, sh, i] = receivers[e] - sh * per
        em[o, sh, i] = True
        fill[o, sh] += 1
    return RingPartition(senders_owner_local=sol, receivers_local=rl,
                         edge_mask=em, nodes_per_shard=per, radius=radius)


def ring_radius(senders_owner_local: torch.Tensor) -> int:
    """R of a rank's [2R+1, Ecap] ring plan, from its number of slots."""
    return (senders_owner_local.shape[0] - 1) // 2


def ring_partitioned_spmm(h_local: torch.Tensor,
                          senders_owner_local: torch.Tensor,
                          receivers_local: torch.Tensor,
                          edge_mask: torch.Tensor, group) -> torch.Tensor:
    """This rank's neighbour sums, [N/S, d] -> [N/S, d], over the ring:
    the plan arrays are the rank's [2R+1, Ecap] slices of a
    ``RingPartition``.  Slot R (offset 0) aggregates the rank's own block;
    hop d sends each rank's ORIGINAL block one rank further both ways
    round the ring, after which the block of rank r - d (slot R - d) and
    then that of rank r + d (slot R + d) aggregate locally, in that
    order."""
    radius = ring_radius(senders_owner_local)
    n_local = h_local.shape[0]

    def agg(block, slot):
        return _aggregate(block, senders_owner_local[slot],
                          receivers_local[slot], edge_mask[slot], n_local)

    out = agg(h_local, radius)                 # offset 0: internal edges
    fwd = h_local   # travels +1 each hop: after d hops rank r holds r - d
    bwd = h_local   # travels -1 each hop: after d hops rank r holds r + d
    for d in range(1, radius + 1):
        fwd = ring_shift(fwd, 1, group)
        out = out + agg(fwd, radius - d)       # offset -d edges
        bwd = ring_shift(bwd, -1, group)
        out = out + agg(bwd, radius + d)       # offset +d edges
    return out
