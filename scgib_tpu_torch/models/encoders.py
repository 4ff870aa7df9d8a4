"""GNN encoders: ``GIN`` (the default), ``GCN``, ``GraphSAGE``,
``GraphTransformer``, and ``DenseGIN`` for dense ego-net batches.

Counterpart of ``scgib_tpu/models/encoders.py``.

``GIN``: ``num_convs`` layers of ``MLP(h_v + sum_{u->v} h_u)`` (GINConv,
eps = 0) -> masked BatchNorm -> ReLU, re-zeroing padding rows after each
(``MaskedBatchNorm.normalize_relu``: on the card one operation of four CUDA
kernels, ``ops/kernels/batchnorm.py``; ``DenseGIN`` shares it).
With a banded adjacency a conv up to ``MAX_FUSED_DIM`` wide is the fused
layer (``ops/kernels/banded.py::gin_banded_layer``): its CUDA kernels on the
card, its plain version on the CPU, with no size gate.  A wider conv is
``mlp(h + A h)`` with the banded product ``spmm_banded_fast`` (its kernel on
the card) and the two Linear layers as plain products: the JAX package's
XLA branch.  The choice depends on the conv's widths only.
``compute_dtype="bfloat16"`` (the JAX encoder's attribute of that name, or its
``SCGIB_COMPUTE_DTYPE``) runs the fused layer on bf16 h, W1 and W2
(``gin_fwd_bf16``: bf16 products, float32 accumulation and output); like
JAX it leaves the banded SpMM and COO branches in float32.

``GraphTransformer``: a bias-free embedding, then ``num_layers + 1`` layers of
per-edge attention with the unshifted ``exp(clamp(score / sqrt(hd), +-5))``
normalization, O-projection, residual + LayerNorm, FFN with dropout 0.5,
residual + LayerNorm; padding rows are masked once, after the last layer
(every op of a layer is row-local or gated by the adjacency, so padding
cannot leak into real rows).  With a banded adjacency the attention is
``ops/kernels/gt_flash.py::gt_flash_attention``: its CUDA kernels on the
card, its plain versions on the CPU, at any head width with either
backward.  Two numerics knobs, each a JAX one: ``bf16_dots`` (the flash
kernels' argument, ``SCGIB_GT_BF16`` there and on by default on a TPU) runs
every product of the attention on bf16 operands; ``dtype=torch.bfloat16``
(``GraphTransformerLayer.dtype``, ``SCGIB_GT_ACT_BF16``) runs the dense tail
the way flax's ``Dense(dtype=bf16)`` and ``LayerNorm(dtype=bf16)`` do:
operands and bias cast to bf16 (the parameters stay float32), LayerNorm
statistics in float32 and its output in bf16, one cast back to float32
after the last layer.  Both default off: float32 throughout.

``GCN``: three ``nn.Linear`` convs d -> 2h -> 2h -> h over the symmetric
normalized aggregation D^-1/2 A D^-1/2 x, ReLU after the first two, no
BatchNorm.  ``GraphSAGE``: per conv ``self{i}(x) + neigh{i}(mean_agg(x))``;
with ``faithful_bug`` (the default, as the reference runs it) the third
round reapplies layer 1's weights, so ``self2`` and ``neigh2`` do not exist
(flax never creates them either).  With a banded adjacency both aggregate
through ``spmm_banded_fast`` (its CUDA kernel on the card, its plain
version on the CPU) with row scalings around it.  Each re-zeroes padding
rows after every conv.

``DenseGIN``: ``GIN``'s parameters over [C, S, d] ego-net slots with a
dense [C, S, S] adjacency; the aggregation is one batched product, as the
JAX package's ``jnp.einsum`` (no Pallas kernel there).

A batch that does not fit the band takes the COO gather + segment-sum path;
Each conv or attention counts the path it took (kind ``encoder`` in
``utils/counters.py``; for the transformer, with the band's geometry).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.banded import (MAX_FUSED_DIM, gin_banded_layer,
                                   spmm_banded_fast)
from ..ops.kernels.gt_flash import check_bwd, gt_flash_attention
from ..ops.segment import (segment_count, segment_normalize_exp,
                           segment_sum)
from ..ops.spmm import (gather_mean, gather_sum, gcn_degree_norms,
                        gcn_norm_sum, sddmm_dot)
from ..utils import counters
from .layers import MLP2, MaskedBatchNorm, _mask_rows


class GIN(nn.Module):
    """``group``: its BatchNorms' sync-BN process group (the JAX
    encoder's ``axis_name``).  ``compute_dtype``: None (float32), or
    "bfloat16" for the fused layer's bf16 mode."""

    def __init__(self, in_dim: int, hidden: int = 64, num_convs: int = 4,
                 group=None, compute_dtype: Optional[str] = None):
        super().__init__()
        if compute_dtype not in (None, "bfloat16"):
            raise ValueError(f"compute_dtype must be None or 'bfloat16', got "
                             f"{compute_dtype!r}")
        self.num_convs = num_convs
        self.compute_dtype = compute_dtype
        for i in range(num_convs):
            self.add_module(f"conv{i}", MLP2(in_dim if i == 0 else hidden,
                                             hidden, hidden))
            self.add_module(f"bn{i}", MaskedBatchNorm(hidden, group=group))

    def forward(self, h, senders, receivers, node_mask=None, edge_mask=None,
                band: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        n = h.shape[0]
        h = _mask_rows(h, node_mask)
        for i in range(self.num_convs):
            mlp = getattr(self, f"conv{i}")
            fused = max(mlp.Dense_0.in_features, mlp.Dense_0.out_features,
                        mlp.Dense_1.out_features) <= MAX_FUSED_DIM
            if band is not None and fused:
                counters.tick("encoder", "band")
                x, w1, w2 = h, mlp.Dense_0.weight.t(), mlp.Dense_1.weight.t()
                if self.compute_dtype == "bfloat16":
                    x, w1, w2 = (t.to(torch.bfloat16) for t in (x, w1, w2))
                h = gin_banded_layer(band[0], band[1], x, w1,
                                     mlp.Dense_0.bias, w2, mlp.Dense_1.bias)
            elif band is not None:
                counters.tick("encoder", "band_spmm")
                h = mlp(h + spmm_banded_fast(band[0], band[1], h))
            else:
                counters.tick("encoder", "coo")
                h = mlp(h + gather_sum(h, senders, receivers, n, edge_mask))
            h = getattr(self, f"bn{i}").normalize_relu(h, node_mask)
        return h


class GCN(nn.Module):
    """Three GraphConv layers d -> 2h -> 2h -> h (reference
    models.py:75-88)."""

    def __init__(self, in_dim: int, hidden: int = 64):
        super().__init__()
        dims = (in_dim, 2 * hidden, 2 * hidden, hidden)
        for i in range(3):
            self.add_module(f"conv{i}", nn.Linear(dims[i], dims[i + 1]))

    def forward(self, h, senders, receivers, node_mask=None, edge_mask=None,
                band: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        n = h.shape[0]
        h = _mask_rows(h, node_mask)
        if band is not None:
            src_norm, dst_norm = gcn_degree_norms(senders, receivers, n,
                                                  edge_mask)

            def agg(x):
                counters.tick("encoder", "gcn_band")
                return spmm_banded_fast(band[0], band[1],
                                        x * src_norm[:, None]
                                        ) * dst_norm[:, None]
        else:
            def agg(x):
                counters.tick("encoder", "gcn_coo")
                return gcn_norm_sum(x, senders, receivers, n, edge_mask)
        for i in range(3):
            h = getattr(self, f"conv{i}")(agg(h))
            if i < 2:
                h = torch.relu(h)
            h = _mask_rows(h, node_mask)
        return h


class GraphSAGE(nn.Module):
    """Three mean-aggregation SAGE convs (reference models.py:91-104).
    ``faithful_bug``: the third round reapplies conv 1 (the reference's
    repeated ``self.conv2``), and conv 2's layers are never built."""

    def __init__(self, in_dim: int, hidden: int = 64,
                 faithful_bug: bool = True):
        super().__init__()
        self.faithful_bug = faithful_bug
        for i in range(2 if faithful_bug else 3):
            width = in_dim if i == 0 else hidden
            self.add_module(f"self{i}", nn.Linear(width, hidden))
            self.add_module(f"neigh{i}", nn.Linear(width, hidden,
                                                   bias=False))

    def forward(self, h, senders, receivers, node_mask=None, edge_mask=None,
                band: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        n = h.shape[0]
        h = _mask_rows(h, node_mask)
        if band is not None:
            inv_deg = 1.0 / segment_count(receivers, n,
                                          mask=edge_mask).clamp_min(1.0)

            def mean(x):
                counters.tick("encoder", "sage_band")
                return spmm_banded_fast(band[0], band[1], x) * inv_deg[:, None]
        else:
            def mean(x):
                counters.tick("encoder", "sage_coo")
                return gather_mean(x, senders, receivers, n, edge_mask)

        def conv(i, x):
            return (getattr(self, f"self{i}")(x)
                    + getattr(self, f"neigh{i}")(mean(x)))

        h = _mask_rows(torch.relu(conv(0, h)), node_mask)
        h = _mask_rows(torch.relu(conv(1, h)), node_mask)
        h = conv(1 if self.faithful_bug else 2, h)
        return _mask_rows(h, node_mask)


class DenseGIN(GIN):
    """GIN over dense ego-net slots: [C, S, d] features, [C, S, S] 0/1
    adjacency, [C, S] mask.  The same parameters as ``GIN``; the BatchNorm
    takes the C*S rows with the flattened mask, so its statistics are the
    COO encoder's over the same real rows."""

    def forward(self, h, adj, mask=None):
        c, s, _ = h.shape
        flat_mask = mask.reshape(c * s) if mask is not None else None
        keep = mask.to(h.dtype)[:, :, None] if mask is not None else None
        if keep is not None:
            h = h * keep
        for i in range(self.num_convs):
            z = (h + torch.bmm(adj.to(h.dtype), h)).reshape(c * s, -1)
            h = getattr(self, f"bn{i}").normalize_relu(
                getattr(self, f"conv{i}")(z), flat_mask).reshape(c, s, -1)
        return h


def dropout(x: torch.Tensor, rate: float,
            rand: Callable[[tuple], torch.Tensor]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep where u < 1 - rate, scaled by 1 / (1 -
    rate), with u ~ U[0, 1) from ``rand`` (``shape -> tensor``)."""
    if rate == 0.0:
        return x
    return torch.where(rand(tuple(x.shape)) < 1.0 - rate, x / (1.0 - rate),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _dense(lin: nn.Linear, x, dtype):
    """``lin(x)``, or flax's ``Dense(dtype=dtype)``: input, weight and bias
    cast to ``dtype``."""
    if dtype is None:
        return lin(x)
    return F.linear(x.to(dtype), lin.weight.to(dtype),
                    None if lin.bias is None else lin.bias.to(dtype))


def _layer_norm(ln: nn.LayerNorm, x, dtype):
    """``ln(x)``, or flax's ``LayerNorm(dtype=dtype)``: statistics and the
    affine map in the parameters' dtype (float32), the output in
    ``dtype``."""
    if dtype is None:
        return ln(x)
    return F.layer_norm(x.to(ln.weight.dtype), ln.normalized_shape,
                        ln.weight, ln.bias, ln.eps).to(dtype)


class GraphTransformerLayer(nn.Module):
    """One graph-transformer layer.  Q, K and V are one fused ``qkv``
    Linear [d, 3d], sliced [q | k | v]; LayerNorm eps 1e-6 as in flax.
    ``dropout`` is the FFN's rate (0.5); set it to 0 to turn it off.
    ``bwd`` picks the attention kernels' backward ("twopass" or
    "merged").  Any head width runs (``gt_flash_attention`` pads one the
    kernels do not take).  ``bf16_dots`` and ``dtype``: the module's
    note."""

    def __init__(self, hidden: int, num_heads: int, dropout: float = 0.5,
                 bwd: str = "twopass", bf16_dots: bool = False, dtype=None):
        super().__init__()
        if hidden % num_heads:
            raise ValueError(f"hidden {hidden} is not a multiple of "
                             f"num_heads {num_heads}")
        check_bwd(bwd)
        if dtype not in (None, torch.bfloat16):
            raise ValueError(f"dtype must be None (float32) or torch.bfloat16,"
                             f" got {dtype!r}")
        self.hidden = hidden
        self.num_heads = num_heads
        self.dropout = dropout
        self.bwd = bwd
        self.bf16_dots = bf16_dots
        self.dtype = dtype
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
        dt = self.dtype
        q, k, v = (part.reshape(n, self.num_heads, hd)
                   for part in _dense(self.qkv, h, dt).split(d, dim=1))
        if band is not None:
            counters.tick("encoder",
                          "gt_band_{}x{}".format(*band[0].shape[1:]))
            attn = gt_flash_attention(band[0], band[1], q, k, v, bwd=self.bwd,
                                      bf16_dots=self.bf16_dots)
        else:
            counters.tick("encoder", "gt_coo")
            score = sddmm_dot(k, q, senders, receivers) / math.sqrt(hd)
            w = segment_normalize_exp(score, receivers, n, mask=edge_mask)
            attn = segment_sum(v[senders] * w[:, :, None], receivers, n,
                               mask=edge_mask)
        h = _layer_norm(self.ln1, h + _dense(self.O, attn.reshape(n, d), dt),
                        dt)
        h2 = torch.relu(_dense(self.ffn1, h, dt))
        if self.training:
            h2 = dropout(h2, self.dropout, rand)
        return _layer_norm(self.ln2, h + _dense(self.ffn2, h2, dt), dt)


class GraphTransformer(nn.Module):
    """Bias-free embedding + ``num_layers + 1`` transformer layers;
    ``bf16_dots`` and ``dtype`` go to every layer (``dtype`` to the
    embedding too)."""

    def __init__(self, in_dim: int, hidden: int = 64, num_layers: int = 4,
                 num_heads: int = 8, bwd: str = "twopass",
                 bf16_dots: bool = False, dtype=None):
        super().__init__()
        self.num_layers = num_layers + 1
        self.dtype = dtype
        self.embed = nn.Linear(in_dim, hidden, bias=False)
        for i in range(self.num_layers):
            self.add_module(f"layer{i}", GraphTransformerLayer(
                hidden, num_heads, bwd=bwd, bf16_dots=bf16_dots,
                dtype=dtype))

    def forward(self, h, senders, receivers, node_mask=None, edge_mask=None,
                band: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                rand=None):
        """``band``: (blocks, col_off) in any banded geometry; the model
        hands it the narrow one when the batch's ``gt_fits`` is set
        (``models/scgib.py::_resolve_band``).  ``rand`` (``shape -> U[0,
        1)``) draws the dropout masks; training mode needs it."""
        h = _mask_rows(_dense(self.embed, h, self.dtype), node_mask)
        for i in range(self.num_layers):
            h = getattr(self, f"layer{i}")(h, senders, receivers,
                                           edge_mask=edge_mask, band=band,
                                           rand=rand)
        if self.dtype is not None:     # the readouts and losses take the
            h = h.to(self.embed.weight.dtype)   # parameters' dtype
        return _mask_rows(h, node_mask)


def make_encoder(name: str, in_dim: int, hidden: int, num_layers: int = 4,
                 num_heads: int = 8, gt_bwd: str = "twopass", group=None,
                 compute_dtype: Optional[str] = None,
                 gt_bf16_dots: bool = False, gt_dtype=None):
    """``num_layers`` is GIN's conv count and the transformer's layers less
    one; GCN and GraphSAGE have three convs whatever it is.  ``group``
    (sync-BN) reaches GIN only: the others have no BatchNorm.  The numerics
    (the module's note): ``compute_dtype`` reaches GIN, ``gt_bf16_dots``
    and ``gt_dtype`` the transformer; GCN and GraphSAGE compute in float32,
    as in the JAX package."""
    if name == "GIN":
        return GIN(in_dim, hidden=hidden, num_convs=num_layers, group=group,
                   compute_dtype=compute_dtype)
    if name == "GCN":
        return GCN(in_dim, hidden=hidden)
    if name == "GraphSAGE":
        return GraphSAGE(in_dim, hidden=hidden)
    if name == "Transformer":
        return GraphTransformer(in_dim, hidden=hidden, num_layers=num_layers,
                                num_heads=num_heads, bwd=gt_bwd,
                                bf16_dots=gt_bf16_dots, dtype=gt_dtype)
    raise ValueError(f"unknown encoder {name!r} (expected GIN | GCN | "
                     "GraphSAGE | Transformer)")
