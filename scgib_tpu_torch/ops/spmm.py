"""COO message passing: gather the senders' rows, segment-sum into the
receivers, and the per-edge dot products of the graph transformer's scores.
Counterpart of ``scgib_tpu/ops/spmm.py::gather_sum`` and ``sddmm_dot`` —
the path a batch takes when it does not fit the banded layout."""

from __future__ import annotations

from typing import Optional

import torch

from .segment import segment_sum


def gather_sum(node_feat: torch.Tensor, senders: torch.Tensor,
               receivers: torch.Tensor, num_nodes: int,
               edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum_{(u -> v) in E} x_u for every node v.   [N, F] -> [N, F]."""
    return segment_sum(node_feat[senders], receivers, num_nodes,
                       mask=edge_mask)


def sddmm_dot(src_feat: torch.Tensor, dst_feat: torch.Tensor,
              senders: torch.Tensor, receivers: torch.Tensor) -> torch.Tensor:
    """Per-edge dot products <x_{u_e}, y_{v_e}> over the last axis:
    [N, H, D] inputs give [E, H]."""
    return (src_feat[senders] * dst_feat[receivers]).sum(-1)
