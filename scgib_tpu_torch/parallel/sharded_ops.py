"""Global segment ops over node-sharded ranks, and the ring SDDMM.

Counterpart of ``scgib_tpu/parallel/sharded_ops.py``: node features live
split over the ranks of ``group``, graph segments may SPAN ranks, and every
per-graph reduction is

    the local partial segment op  ->  a sum / max over the group

giving the same [G, ...] result on every rank.  Each function takes this
rank's rows with GLOBAL segment ids.  The sums go through
``collectives.all_reduce_sum``, whose backward all-reduces the cotangent
(psum's transpose with ``check_vma=False``): summing the ranks' gradients
afterwards is then the union batch's gradient.  The max goes through
``collectives.all_reduce_max`` and has no gradient: it is taken of
detached logits only, as in the JAX package.

``ring_sddmm_sum`` is the sharded reconstruction's per-edge dot term: the
sender rows arrive over the same ring as in
``edge_partition.ring_partitioned_spmm``, so the loss never gathers every
rank's rows.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.segment import segment_broadcast, segment_max, segment_sum
from .collectives import all_reduce_max, all_reduce_sum, ring_shift
from .edge_partition import ring_radius


def _per_segment(x: torch.Tensor, ndim: int) -> torch.Tensor:
    return x.reshape(x.shape + (1,) * (ndim - 1))


def gseg_sum(data: torch.Tensor, segment_ids: torch.Tensor,
             num_segments: int, group,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-rank segment sum: [N/S, ...] local rows with global segment
    ids -> [num_segments, ...] on every rank."""
    return all_reduce_sum(segment_sum(data, segment_ids, num_segments, mask),
                          group)


def gseg_count(segment_ids: torch.Tensor, num_segments: int, group,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    ones = torch.ones(segment_ids.shape, dtype=torch.float32,
                      device=segment_ids.device)
    return gseg_sum(ones, segment_ids, num_segments, group, mask)


def gseg_mean(data: torch.Tensor, segment_ids: torch.Tensor,
              num_segments: int, group,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    total = gseg_sum(data, segment_ids, num_segments, group, mask)
    count = gseg_count(segment_ids, num_segments, group, mask)
    return total / _per_segment(count.clamp_min(1.0), data.ndim)


def gseg_std_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                  num_segments: int, group,
                  mask: Optional[torch.Tensor] = None, ddof: int = 1):
    """Cross-rank (std, mean) per segment, ``ops.segment.segment_std_mean``
    of the union batch (``torch.std_mean`` with ``ddof``; single-element
    segments get std 0)."""
    mean = gseg_mean(data, segment_ids, num_segments, group, mask)
    centered = data - segment_broadcast(mean, segment_ids, num_segments)
    sq = gseg_sum(centered * centered, segment_ids, num_segments, group,
                  mask)
    count = gseg_count(segment_ids, num_segments, group, mask)
    var = sq / _per_segment((count - ddof).clamp_min(1.0), data.ndim)
    return torch.sqrt(var), mean


def gseg_max(data: torch.Tensor, segment_ids: torch.Tensor,
             num_segments: int, group,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-rank segment max (-inf for an empty segment), no gradient."""
    return all_reduce_max(segment_max(data, segment_ids, num_segments, mask),
                          group)


def gseg_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, group,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-rank per-segment softmax of [N/S] logits (the core<->candidate
    attention's): the group's per-segment max as the shift (0 where it is
    not finite; a per-segment constant, so its gradient is exactly 0), the
    group's denominator, this rank's rows' weights.  Masked rows are set to
    -inf before the exponential, so the denominator is summed without the
    mask, as the JAX package sums it."""
    seg_max = gseg_max(logits.detach(), segment_ids, num_segments, group,
                       mask)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.zeros_like(seg_max))
    if mask is not None:
        logits = torch.where(mask, logits,
                             torch.full((), float("-inf"),
                                        dtype=logits.dtype,
                                        device=logits.device))
    e = torch.exp(logits - segment_broadcast(seg_max, segment_ids,
                                             num_segments))
    denom = gseg_sum(e, segment_ids, num_segments, group).clamp_min(1e-16)
    return e / segment_broadcast(denom, segment_ids, num_segments)


def ring_sddmm_sum(x: torch.Tensor, senders_owner_local: torch.Tensor,
                   receivers_local: torch.Tensor, edge_mask: torch.Tensor,
                   group) -> torch.Tensor:
    """The sum over this rank's (receiver-owned) edges of
    ``dot(x[sender], x[receiver])``, the sender rows living on other ranks.

    The slots of ``edge_partition.ring_partitioned_spmm``: the plan arrays
    are this rank's [2R+1, Ecap] slices; slot R - d holds offset -d edges,
    whose sender block arrives after d forward hops, slot R + d after d
    backward hops.  Returns this rank's scalar; the ranks' scalars sum to
    the union graph's."""
    radius = ring_radius(senders_owner_local)

    def acc(block, slot):
        s_rows = block.index_select(0, senders_owner_local[slot])
        r_rows = x.index_select(0, receivers_local[slot])
        dots = (s_rows * r_rows).sum(-1)
        return (dots * edge_mask[slot].to(dots.dtype)).sum()

    out = acc(x, radius)                       # offset 0: internal edges
    fwd = x
    bwd = x
    for d in range(1, radius + 1):
        fwd = ring_shift(fwd, 1, group)
        out = out + acc(fwd, radius - d)       # offset -d edges
        bwd = ring_shift(bwd, -1, group)
        out = out + acc(bwd, radius + d)       # offset +d edges
    return out
