"""The S-CGIB models.

Counterpart of ``scgib_tpu/models/scgib.py``: ``SCGIBCore`` (twin GIN or
graph-transformer encoders, concrete-relaxation compression gate with
per-graph noise, core<->candidate attention) in ``coo`` sub-graph mode,
with the ``sum`` or ``s2s`` (Set2Set) readout and the attention on or off;
``PretrainModel`` with the ``corrected`` or ``reference`` KL and the
adjacency (gram or dense) or k-step logM reconstruction; and the two
downstream models around a pretrained core, ``FinetuneModel`` (the
supervised head) and ``DomainAdaptModel`` (whose forward is its loss).
Train or eval mode (BatchNorm statistics, the transformer's dropout) is
the module's ``training`` flag; the gate's noise is drawn in both, as in
the JAX package.  Submodules exist only where the JAX model has parameters
for them (no ``attn_layer`` without the attention, ``reduce_d`` only with
the ``s2s`` readout and the attention), so the two trees match.

Noise: the compression gate takes two uniform draws per call (reference
``torch.rand`` at models.py:599, 650), and the graph transformer's dropout
one per layer in training mode.  ``forward`` takes them all from ``rand``, a
callable ``shape -> U[0, 1)`` tensor; ``uniform_draws(generator)`` builds
one from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from ..graph.banded import (GT_ALIGN, GT_BAND, GT_TILE, build_blocks,
                           device_col_off)
from ..graph.container import GraphBatch, SubgraphBatch
from ..ops.pool import sorted_segment_sum_banded
from ..ops.segment import (segment_broadcast, segment_softmax,
                           segment_std_mean, segment_sum)
from .encoders import GraphTransformer, make_encoder
from .layers import MLP2, SegmentBatchNorm
from .losses import (contrastive_infonce, kl_loss, l2_normalize,
                     recon_adj_loss, recon_logm_loss)
from .set2set import Set2Set

Rand = Callable[[tuple], torch.Tensor]


def uniform_draws(generator: Optional[torch.Generator],
                  device) -> Rand:
    """``shape -> U[0, 1)`` float32 draws from ``generator`` on ``device``."""
    def rand(shape):
        return torch.rand(shape, generator=generator, device=device)
    return rand


def _resolve_band(batch, gt: bool = False):
    """(blocks, col_off) of a batch's banded adjacency, or None.

    When the packer shipped only the offsets, the bf16 blocks are built on
    the device at first use and kept on the batch object (not in its
    ``band_blocks`` field, which stays what the packer shipped), so both
    encoders' uses and the reconstruction loss's share one build per batch.
    With ``gt`` and the batch's ``gt_fits``, the graph transformer's narrow
    (GT_TILE, GT_BAND) geometry instead, built once per batch likewise."""
    col_off = batch.band_col_off
    if col_off is None:
        return None
    if gt and batch.gt_fits:
        band = getattr(batch, "_gt_band", None)
        if band is None:
            n = batch.node_mask.shape[0]
            off = device_col_off(n, GT_TILE, GT_BAND, GT_ALIGN,
                                 col_off.device)
            band = (build_blocks(batch.senders, batch.receivers,
                                 batch.edge_mask, off, n, tile=GT_TILE,
                                 band=GT_BAND), off)
            batch._gt_band = band
        return band
    if batch.band_blocks is not None:
        return batch.band_blocks, col_off
    blocks = getattr(batch, "_band", None)
    if blocks is None:
        blocks = build_blocks(batch.senders, batch.receivers,
                              batch.edge_mask, col_off,
                              batch.node_mask.shape[0])
        batch._band = blocks
    return blocks, col_off


def _sub_features(g: GraphBatch, sub: SubgraphBatch) -> torch.Tensor:
    if sub.node_feat is not None:
        return sub.node_feat
    return g.node_feat[sub.node_orig]


def _project_inputs(transfer_d: nn.Module, g: GraphBatch, sub: SubgraphBatch,
                    normalize: bool):
    """(x_proj, x_sub_proj): one projection of the concatenated [N+S, F]
    features."""
    x = l2_normalize(g.node_feat) if normalize else g.node_feat
    x_sub = _sub_features(g, sub)
    x_sub = l2_normalize(x_sub) if normalize else x_sub
    proj = transfer_d(torch.cat([x, x_sub], 0))
    return proj[:x.shape[0]], proj[x.shape[0]:]


class CoreFeatures(NamedTuple):
    interaction_map: torch.Tensor   # [N, 2d]
    kl_node: torch.Tensor           # [N, d]
    noisy: torch.Tensor             # [N, d]
    clean_readout: torch.Tensor     # [G, d] ([G, 2d] with s2s)


class Compressor(nn.Module):
    """d -> d -> per-graph BatchNorm -> ReLU -> 1 gate scorer."""

    def __init__(self, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(hidden, hidden)
        self.bn = SegmentBatchNorm(hidden)
        self.fc2 = nn.Linear(hidden, 1)

    def forward(self, h, segment_ids, num_segments, mask=None):
        x = self.bn(self.fc1(h), segment_ids, num_segments, mask=mask)
        return self.fc2(torch.relu(x))


class SCGIBCore(nn.Module):
    """Twin encoders + compression + core<->candidate attention."""

    def __init__(self, in_dim: int, hidden: int = 64, encoder: str = "GIN",
                 num_layers: int = 4, num_heads: int = 8,
                 readout: str = "sum", use_att: bool = True,
                 gt_bwd: str = "twopass", gate_bias: float = 1e-4,
                 std_eps: float = 1e-7, deterministic: bool = False):
        super().__init__()
        if readout not in ("sum", "s2s"):
            raise ValueError(f"unknown readout {readout!r}")
        self.readout = readout
        self.use_att = use_att
        self.gate_bias = gate_bias
        self.std_eps = std_eps
        self.deterministic = deterministic
        self.encoder1 = make_encoder(encoder, in_dim, hidden, num_layers,
                                     num_heads, gt_bwd)
        self.encoder2 = make_encoder(encoder, in_dim, hidden, num_layers,
                                     num_heads, gt_bwd)
        self.compressor = Compressor(hidden)
        if use_att:
            self.attn_layer = nn.Linear(2 * hidden, 1)
        if readout == "s2s":
            self.s2s = Set2Set(hidden)
            if use_att:
                self.reduce_d = nn.Linear(2 * hidden, hidden)

    def graph_readout(self, h, g: GraphBatch):
        if self.readout == "sum":
            return segment_sum(h, g.node_graph, g.num_graphs,
                               mask=g.node_mask)
        return self.s2s(h, g.node_graph, g.num_graphs, mask=g.node_mask)

    def compress(self, h, g: GraphBatch, rand: Optional[Rand]):
        """Gate lambda = sigmoid(logit(eps) + p), eps ~ U(bias, 1 - bias)."""
        p = self.compressor(h, g.node_graph, g.num_graphs, mask=g.node_mask)
        if self.deterministic:
            return torch.sigmoid(p), p
        lo, hi = self.gate_bias, 1.0 - self.gate_bias
        # jax.random.uniform's affine map and floor at minval
        eps = (rand(tuple(p.shape)) * (hi - lo) + lo).clamp_min(lo)
        return torch.sigmoid(torch.log(eps) - torch.log1p(-eps) + p), p

    def compression(self, h, g: GraphBatch, rand: Optional[Rand]):
        """Noise-gated node features and the per-node KL matrix (the
        reference's per-graph loop, models.py:631-660, vectorized)."""
        lam, _ = self.compress(h, g, rand)
        lam_neg = 1.0 - lam
        std_g, mean_g = segment_std_mean(h.detach(), g.node_graph,
                                         g.num_graphs, mask=g.node_mask)
        mean_n = segment_broadcast(mean_g, g.node_graph, g.num_graphs)
        std_n = segment_broadcast(std_g, g.node_graph, g.num_graphs)
        noisy_mean = lam * h + lam_neg * mean_n
        noisy_std = lam_neg * std_n
        if self.deterministic:
            noisy = noisy_mean
        else:
            noisy = noisy_mean + rand(tuple(noisy_mean.shape)) * noisy_std
        node_m = g.node_mask.to(noisy.dtype)[:, None]
        noisy = noisy * node_m
        denom = std_n + self.std_eps
        term1 = 0.5 * noisy_std ** 2 / denom ** 2
        dev = (noisy_mean - mean_n) / denom
        term2_g = segment_sum(dev * dev, g.node_graph, g.num_graphs,
                              mask=g.node_mask)
        kl_node = term1 + segment_broadcast(term2_g, g.node_graph,
                                            g.num_graphs)
        return noisy, kl_node * node_m

    def extract_features(self, g: GraphBatch, sub: SubgraphBatch,
                         x_proj, x_sub_proj,
                         rand: Optional[Rand] = None) -> CoreFeatures:
        gt = isinstance(self.encoder1, GraphTransformer)
        kw = {"rand": rand} if gt else {}
        h = self.encoder1(x_proj, g.senders, g.receivers,
                          node_mask=g.node_mask, edge_mask=g.edge_mask,
                          band=_resolve_band(g, gt), **kw)
        h_sub = self.encoder2(x_sub_proj, sub.senders, sub.receivers,
                              node_mask=sub.node_mask,
                              edge_mask=sub.edge_mask,
                              band=_resolve_band(sub, gt), **kw)
        clean_readout = self.graph_readout(h, g)
        noisy, kl_node = self.compression(h, g, rand)
        cand = sorted_segment_sum_banded(h_sub, sub.node_center, g.num_nodes,
                                         mask=sub.node_mask,
                                         fits=sub.pool_fits)
        if not self.use_att:
            return CoreFeatures(torch.cat([noisy, cand], -1), kl_node, noisy,
                                clean_readout)
        noisy_readout = self.graph_readout(noisy, g)
        if self.readout == "s2s":
            noisy_readout = self.reduce_d(noisy_readout)
        inter = torch.cat([segment_broadcast(noisy_readout, g.node_graph,
                                             g.num_graphs), cand], -1)
        att = self.attn_layer(inter)[:, 0]
        alpha = segment_softmax(att, g.node_graph, g.num_graphs,
                                mask=g.node_mask)
        im = torch.cat([noisy, cand * alpha[:, None]], -1)
        im = im * g.node_mask.to(im.dtype)[:, None]
        return CoreFeatures(im, kl_node, noisy, clean_readout)


class PretrainLosses(NamedTuple):
    kl: torch.Tensor
    contrastive: torch.Tensor
    reconstruction: torch.Tensor

    @property
    def total(self) -> torch.Tensor:
        return self.kl + self.contrastive + self.reconstruction


class PretrainModel(nn.Module):
    """Projection + core + head MLP + the three losses (KL, InfoNCE,
    reconstruction), unit weights.

    ``kl_mode``: 'corrected' (mean over every graph) or 'reference' (the
    last graph only, models.py:659).  ``recons_type``: 'adj' (adjacency,
    ``recons_impl`` 'gram' or the literal 'dense') or 'logM' (k-step
    transition targets of ``k_transition`` steps, passed in or carried by
    the batch from ``batch_iterator(logm_k=...)``); any other value gives
    a reconstruction term of 0, as in the JAX package."""

    def __init__(self, in_dim: int, hidden: int = 64, d_transfer: int = 32,
                 encoder: str = "GIN", num_layers: int = 4,
                 num_heads: int = 8, readout: str = "sum",
                 use_att: bool = True, recons_type: str = "adj",
                 recons_impl: str = "gram", kl_mode: str = "corrected",
                 k_transition: int = 1, gt_bwd: str = "twopass",
                 deterministic: bool = False, normalize_input: bool = True):
        super().__init__()
        self.readout = readout
        self.recons_type = recons_type
        self.recons_impl = recons_impl
        self.kl_mode = kl_mode
        self.k_transition = k_transition
        self.normalize_input = normalize_input
        self.transfer_d = nn.Linear(in_dim, d_transfer, bias=False)
        self.core = SCGIBCore(d_transfer, hidden=hidden, encoder=encoder,
                              num_layers=num_layers, num_heads=num_heads,
                              readout=readout, use_att=use_att,
                              gt_bwd=gt_bwd, deterministic=deterministic)
        self.head_mlp = MLP2(2 * hidden, hidden, hidden)
        if readout == "s2s":
            self.s2s = Set2Set(hidden)

    def forward(self, g: GraphBatch, sub: SubgraphBatch,
                rand: Optional[Rand] = None,
                logm_targets: Optional[torch.Tensor] = None,
                logm_weights: Optional[torch.Tensor] = None
                ) -> PretrainLosses:
        if rand is None:
            rand = uniform_draws(None, g.node_feat.device)
        x_proj, x_sub_proj = _project_inputs(self.transfer_d, g, sub,
                                             self.normalize_input)
        feats = self.core.extract_features(g, sub, x_proj, x_sub_proj, rand)
        im = self.head_mlp(feats.interaction_map)
        kl = kl_loss(feats.kl_node, g.node_mask, g.node_graph, g.graph_mask,
                     mode=self.kl_mode)
        if self.readout == "sum":
            noisy_readout = segment_sum(feats.noisy, g.node_graph,
                                        g.num_graphs, mask=g.node_mask)
        else:
            noisy_readout = self.s2s(feats.noisy, g.node_graph, g.num_graphs,
                                     mask=g.node_mask)
        contrastive = contrastive_infonce(noisy_readout, feats.clean_readout,
                                          g.graph_mask)
        if self.recons_type == "adj":
            band = _resolve_band(g) if self.recons_impl == "gram" else None
            recon = recon_adj_loss(im, g.senders, g.receivers, g.edge_mask,
                                   g.node_mask, band=band,
                                   impl=self.recons_impl)
        elif self.recons_type == "logM":
            if logm_targets is None:
                logm_targets, logm_weights = g.logm_targets, g.logm_weights
            if logm_targets is None or logm_weights is None:
                raise ValueError("recons_type='logM' requires logm targets "
                                 "(pass them or pack with logm_k)")
            recon = recon_logm_loss(im, logm_targets, logm_weights,
                                    self.k_transition)
        else:
            recon = im.new_zeros(())
        return PretrainLosses(kl=kl, contrastive=contrastive,
                              reconstruction=recon)


class FinetuneModel(nn.Module):
    """``Mainmodel_finetuning`` (models.py:501-520): fresh heads around the
    pretrained core.  Projection -> core -> ``head_mlp`` (2d -> d) ->
    ``Set2Set`` (-> 2d) -> ``predict`` (2d -> d -> num_out), then a sigmoid
    unless ``regression``.  The features are L2-normalized by row and the
    attention takes its two-pass backward, as the JAX verbs run them."""

    def __init__(self, in_dim: int, num_out: int = 1, hidden: int = 64,
                 d_transfer: int = 32, encoder: str = "GIN",
                 num_layers: int = 4, num_heads: int = 8,
                 readout: str = "sum", use_att: bool = True,
                 regression: bool = False, deterministic: bool = False):
        super().__init__()
        self.regression = regression
        self.transfer_d = nn.Linear(in_dim, d_transfer, bias=False)
        self.core = SCGIBCore(d_transfer, hidden=hidden, encoder=encoder,
                              num_layers=num_layers, num_heads=num_heads,
                              readout=readout, use_att=use_att,
                              deterministic=deterministic)
        self.head_mlp = MLP2(2 * hidden, hidden, hidden)
        self.s2s = Set2Set(hidden)
        self.predict = MLP2(2 * hidden, hidden, num_out)

    def forward(self, g: GraphBatch, sub: SubgraphBatch,
                rand: Optional[Rand] = None) -> torch.Tensor:
        """Scores [G, num_out]: probabilities, or the raw outputs with
        ``regression``."""
        if rand is None:
            rand = uniform_draws(None, g.node_feat.device)
        x_proj, x_sub_proj = _project_inputs(self.transfer_d, g, sub, True)
        feats = self.core.extract_features(g, sub, x_proj, x_sub_proj, rand)
        im = self.head_mlp(feats.interaction_map)
        pooled = self.s2s(im, g.node_graph, g.num_graphs, mask=g.node_mask)
        out = self.predict(pooled)
        return out if self.regression else torch.sigmoid(out)


class DomainAdaptModel(nn.Module):
    """``Mainmodel_domainadapt`` (models.py:107-281): the Set2Set readout of
    the interaction map, decoded by ``r_transfer_d`` (2d -> d -> 2F), is
    held against the Set2Set readout (``s2s_rev``) of the same normalized
    features the projection takes; the forward is the loss, the
    unnormalized squared error over real graphs (models.py:276-281)."""

    def __init__(self, in_dim: int, hidden: int = 64, d_transfer: int = 32,
                 encoder: str = "GIN", num_layers: int = 4,
                 num_heads: int = 8, readout: str = "sum",
                 use_att: bool = True, deterministic: bool = False):
        super().__init__()
        self.transfer_d = nn.Linear(in_dim, d_transfer, bias=False)
        self.core = SCGIBCore(d_transfer, hidden=hidden, encoder=encoder,
                              num_layers=num_layers, num_heads=num_heads,
                              readout=readout, use_att=use_att,
                              deterministic=deterministic)
        self.head_mlp = MLP2(2 * hidden, hidden, hidden)
        self.s2s = Set2Set(hidden)
        self.s2s_rev = Set2Set(in_dim)
        self.r_transfer_d = MLP2(2 * hidden, hidden, 2 * in_dim)

    def forward(self, g: GraphBatch, sub: SubgraphBatch,
                rand: Optional[Rand] = None) -> torch.Tensor:
        if rand is None:
            rand = uniform_draws(None, g.node_feat.device)
        x = l2_normalize(g.node_feat)
        x_proj, x_sub_proj = _project_inputs(self.transfer_d, g, sub, True)
        feats = self.core.extract_features(g, sub, x_proj, x_sub_proj, rand)
        im = self.head_mlp(feats.interaction_map)
        pooled = self.s2s(im, g.node_graph, g.num_graphs, mask=g.node_mask)
        pred = self.r_transfer_d(pooled)
        target = self.s2s_rev(x, g.node_graph, g.num_graphs,
                              mask=g.node_mask)
        m = g.graph_mask.to(pred.dtype)[:, None]
        return (((pred - target) ** 2) * m).sum()
