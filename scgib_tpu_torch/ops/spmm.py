"""COO message passing: gather the senders' rows, segment-sum into the
receivers; the mean and the symmetric-normalized aggregations of GraphSAGE
and GCN; and the per-edge dot products of the graph transformer's scores.
Counterpart of ``scgib_tpu/ops/spmm.py`` — the path a batch takes when it
does not fit the banded layout."""

from __future__ import annotations

from typing import Optional

import torch

from .segment import segment_count, segment_sum


def gather_sum(node_feat: torch.Tensor, senders: torch.Tensor,
               receivers: torch.Tensor, num_nodes: int,
               edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum_{(u -> v) in E} x_u for every node v.   [N, F] -> [N, F]."""
    return segment_sum(node_feat[senders], receivers, num_nodes,
                       mask=edge_mask)


def gather_mean(node_feat: torch.Tensor, senders: torch.Tensor,
                receivers: torch.Tensor, num_nodes: int,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over in-neighbors (SAGE's 'mean' aggregator); zero for a node
    without one."""
    total = gather_sum(node_feat, senders, receivers, num_nodes, edge_mask)
    deg = segment_count(receivers, num_nodes, mask=edge_mask)
    return total / deg.clamp_min(1.0)[:, None]


def in_degrees(receivers: torch.Tensor, num_nodes: int,
               edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    return segment_count(receivers, num_nodes, mask=edge_mask)


def jax_rsqrt(x: torch.Tensor) -> torch.Tensor:
    """``1 / sqrt(max(x, 1e-30))``, the JAX package's ``jax_rsqrt``."""
    return 1.0 / torch.sqrt(x.clamp_min(1e-30))


def gcn_degree_norms(senders: torch.Tensor, receivers: torch.Tensor,
                     num_nodes: int, edge_mask: Optional[torch.Tensor] = None):
    """(src_norm, dst_norm), each [N]: out- and in-degree ** -1/2, zero
    where the degree is 0."""
    out_deg = segment_count(senders, num_nodes, mask=edge_mask)
    in_deg = segment_count(receivers, num_nodes, mask=edge_mask)
    zero = out_deg.new_zeros(())
    return (torch.where(out_deg > 0, jax_rsqrt(out_deg), zero),
            torch.where(in_deg > 0, jax_rsqrt(in_deg), zero))


def gcn_norm_sum(node_feat: torch.Tensor, senders: torch.Tensor,
                 receivers: torch.Tensor, num_nodes: int,
                 edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Symmetric-normalized aggregation D^-1/2 A D^-1/2 x, DGL's
    ``GraphConv(norm='both', allow_zero_in_degree=True)``: out-degree
    normalize the sources, aggregate, in-degree normalize the result."""
    src_norm, dst_norm = gcn_degree_norms(senders, receivers, num_nodes,
                                          edge_mask)
    h = gather_sum(node_feat * src_norm[:, None], senders, receivers,
                   num_nodes, edge_mask)
    return h * dst_norm[:, None]


def sddmm_dot(src_feat: torch.Tensor, dst_feat: torch.Tensor,
              senders: torch.Tensor, receivers: torch.Tensor) -> torch.Tensor:
    """Per-edge dot products <x_{u_e}, y_{v_e}> over the last axis:
    [N, H, D] inputs give [E, H]."""
    return (src_feat[senders] * dst_feat[receivers]).sum(-1)
