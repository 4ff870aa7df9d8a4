"""GNN encoders: ``GIN`` (the default) and ``GraphTransformer``.

Counterpart of ``scgib_tpu/models/encoders.py``.

``GIN``: ``num_convs`` layers of ``MLP(h_v + sum_{u->v} h_u)`` (GINConv,
eps = 0) -> masked BatchNorm -> ReLU, re-zeroing padding rows after each.
With a banded adjacency a conv up to ``MAX_FUSED_DIM`` wide is the fused
layer (``ops/kernels/banded.py::gin_banded_layer``): its CUDA kernels on the
card, its plain version on the CPU, with no size gate.  A wider conv is
``mlp(h + A h)`` with the banded product ``spmm_banded_fast`` (its kernel on
the card) and the two Linear layers as plain products: the JAX package's
XLA branch.  The choice depends on the conv's widths only.

``GraphTransformer``: a bias-free embedding, then ``num_layers + 1`` layers of
per-edge attention with the unshifted ``exp(clamp(score / sqrt(hd), +-5))``
normalization, O-projection, residual + LayerNorm, FFN with dropout 0.5,
residual + LayerNorm; padding rows are masked once, after the last layer
(every op of a layer is row-local or gated by the adjacency, so padding
cannot leak into real rows).  With a banded adjacency the attention is
``ops/kernels/gt_flash.py::gt_flash_attention``: its CUDA kernels on the
card, its plain versions on the CPU, at any head width up to 512 with
either backward (a layer wider than that raises when it is built).

A batch that does not fit the band takes the COO gather + segment-sum path;
``branch_counts`` records which path each conv or attention took (for the
transformer, with the band's geometry).
"""

from __future__ import annotations

import collections
import math
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from ..ops.kernels.banded import (MAX_FUSED_DIM, gin_banded_layer,
                                   spmm_banded_fast)
from ..ops.kernels.gt_flash import gt_flash_attention, served_head_width
from ..ops.segment import segment_normalize_exp, segment_sum
from ..ops.spmm import gather_sum, sddmm_dot
from .layers import MLP2, MaskedBatchNorm

branch_counts: collections.Counter = collections.Counter()


def _mask_rows(x: torch.Tensor, mask: Optional[torch.Tensor]):
    if mask is None:
        return x
    return x * mask.to(x.dtype)[:, None]


class GIN(nn.Module):
    def __init__(self, in_dim: int, hidden: int = 64, num_convs: int = 4):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            self.add_module(f"conv{i}", MLP2(in_dim if i == 0 else hidden,
                                             hidden, hidden))
            self.add_module(f"bn{i}", MaskedBatchNorm(hidden))

    def forward(self, h, senders, receivers, node_mask=None, edge_mask=None,
                band: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        n = h.shape[0]
        h = _mask_rows(h, node_mask)
        for i in range(self.num_convs):
            mlp = getattr(self, f"conv{i}")
            fused = max(mlp.Dense_0.in_features, mlp.Dense_0.out_features,
                        mlp.Dense_1.out_features) <= MAX_FUSED_DIM
            if band is not None and fused:
                branch_counts["band"] += 1
                h = gin_banded_layer(band[0], band[1], h,
                                     mlp.Dense_0.weight.t(), mlp.Dense_0.bias,
                                     mlp.Dense_1.weight.t(), mlp.Dense_1.bias)
            elif band is not None:
                branch_counts["band_spmm"] += 1
                h = mlp(h + spmm_banded_fast(band[0], band[1], h))
            else:
                branch_counts["coo"] += 1
                h = mlp(h + gather_sum(h, senders, receivers, n, edge_mask))
            h = getattr(self, f"bn{i}")(h, node_mask)
            h = _mask_rows(torch.relu(h), node_mask)
        return h


def dropout(x: torch.Tensor, rate: float,
            rand: Callable[[tuple], torch.Tensor]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep where u < 1 - rate, scaled by 1 / (1 -
    rate), with u ~ U[0, 1) from ``rand`` (``shape -> tensor``)."""
    if rate == 0.0:
        return x
    return torch.where(rand(tuple(x.shape)) < 1.0 - rate, x / (1.0 - rate),
                       torch.zeros((), dtype=x.dtype, device=x.device))


class GraphTransformerLayer(nn.Module):
    """One graph-transformer layer.  Q, K and V are one fused ``qkv``
    Linear [d, 3d], sliced [q | k | v]; LayerNorm eps 1e-6 as in flax.
    ``dropout`` is the FFN's rate (0.5); set it to 0 to turn it off.
    ``bwd`` picks the attention kernels' backward ("twopass" or
    "merged").  A head width the kernels cannot serve raises here."""

    def __init__(self, hidden: int, num_heads: int, dropout: float = 0.5,
                 bwd: str = "twopass"):
        super().__init__()
        if hidden % num_heads:
            raise ValueError(f"hidden {hidden} is not a multiple of "
                             f"num_heads {num_heads}")
        served_head_width(num_heads, hidden // num_heads)
        self.hidden = hidden
        self.num_heads = num_heads
        self.dropout = dropout
        self.bwd = bwd
        self.qkv = nn.Linear(hidden, 3 * hidden)
        self.O = nn.Linear(hidden, hidden)
        self.ln1 = nn.LayerNorm(hidden, eps=1e-6)
        self.ffn1 = nn.Linear(hidden, 2 * hidden)
        self.ffn2 = nn.Linear(2 * hidden, hidden)
        self.ln2 = nn.LayerNorm(hidden, eps=1e-6)

    def forward(self, h, senders, receivers, edge_mask=None,
                band: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                rand=None):
        n, d = h.shape[0], self.hidden
        hd = d // self.num_heads
        q, k, v = (part.reshape(n, self.num_heads, hd)
                   for part in self.qkv(h).split(d, dim=1))
        if band is not None:
            branch_counts["gt_band_{}x{}".format(*band[0].shape[1:])] += 1
            attn = gt_flash_attention(band[0], band[1], q, k, v, bwd=self.bwd)
        else:
            branch_counts["gt_coo"] += 1
            score = sddmm_dot(k, q, senders, receivers) / math.sqrt(hd)
            w = segment_normalize_exp(score, receivers, n, mask=edge_mask)
            attn = segment_sum(v[senders] * w[:, :, None], receivers, n,
                               mask=edge_mask)
        h = self.ln1(h + self.O(attn.reshape(n, d)))
        h2 = torch.relu(self.ffn1(h))
        if self.training:
            h2 = dropout(h2, self.dropout, rand)
        return self.ln2(h + self.ffn2(h2))


class GraphTransformer(nn.Module):
    """Bias-free embedding + ``num_layers + 1`` transformer layers."""

    def __init__(self, in_dim: int, hidden: int = 64, num_layers: int = 4,
                 num_heads: int = 8, bwd: str = "twopass"):
        super().__init__()
        self.num_layers = num_layers + 1
        self.embed = nn.Linear(in_dim, hidden, bias=False)
        for i in range(self.num_layers):
            self.add_module(f"layer{i}", GraphTransformerLayer(
                hidden, num_heads, bwd=bwd))

    def forward(self, h, senders, receivers, node_mask=None, edge_mask=None,
                band: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                rand=None):
        """``band``: (blocks, col_off) in any banded geometry; the model
        hands it the narrow one when the batch's ``gt_fits`` is set
        (``models/scgib.py::_resolve_band``).  ``rand`` (``shape -> U[0,
        1)``) draws the dropout masks; training mode needs it."""
        h = _mask_rows(self.embed(h), node_mask)
        for i in range(self.num_layers):
            h = getattr(self, f"layer{i}")(h, senders, receivers,
                                           edge_mask=edge_mask, band=band,
                                           rand=rand)
        return _mask_rows(h, node_mask)


def make_encoder(name: str, in_dim: int, hidden: int, num_layers: int = 4,
                 num_heads: int = 8, gt_bwd: str = "twopass"):
    if name == "GIN":
        return GIN(in_dim, hidden=hidden, num_convs=num_layers)
    if name == "Transformer":
        return GraphTransformer(in_dim, hidden=hidden, num_layers=num_layers,
                                num_heads=num_heads, bwd=gt_bwd)
    raise ValueError(f"encoder {name!r} is not ported yet (GIN or "
                     "Transformer)")
