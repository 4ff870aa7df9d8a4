"""Node-sharded S-CGIB pretraining: one union batch's nodes split over the
ranks of a process group.

Counterpart of ``scgib_tpu/parallel/sharded_scgib.py``.  The whole
pretraining step (twin encoders, the compression gate's per-graph
statistics, the core<->candidate attention and the three losses) runs
with each rank holding a contiguous range of the batch's nodes, so one
batch too large for one card trains across several:

- Encoder 1 (``partitioned_gin.PartitionedGIN``): the ring halo
  (``edge_partition.ring_partitioned_spmm``), 2R neighbour blocks a conv.
- Encoder 2 and the candidates: each ego-net lies on its CENTER node's
  rank (``sharded_batch.py``), so the ego-net encoder (``GIN`` on the COO
  path, with sync-BN) and the candidate pooling are local.
- Per-graph reductions (readouts, the compression's mean and std, the
  per-graph BatchNorm, the attention softmax): the group's segment ops
  (``sharded_ops.py``) over GLOBAL graph ids; graphs may span ranks.
- Losses: this rank's numerator over the group's count; the
  reconstruction's edge term rides the ring (``ring_sddmm_sum``).  Summing
  the ranks' losses and gradients after the backward is then the union
  batch's loss and gradient.

As in the JAX package this path reaches no Pallas kernel, so it launches
none of the port's hand-written kernels: every op is a torch op
(``index_select``, ``index_add``, the d x d gram's product).

The parameter and buffer names are ``models/scgib.py::PretrainModel``'s,
so one state dict (and one ``utils/params.py::from_jax_variables`` result)
loads into both.  Unlike data parallelism, ``kl_mode='reference'`` is exact
here: the last graph is the union batch's, its nodes on whichever ranks
hold them.  GIN encoders and the sum readout only, as in the JAX package.

Noise: the gate's draws come from ``rand`` (``models/scgib.py``), one
generator a rank, as JAX gives each shard its own key.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from ..models.encoders import GIN
from ..models.layers import MLP2, SegmentBatchNorm
from ..models.losses import (contrastive_infonce_replicated, kl_loss,
                             l2_normalize)
from ..models.scgib import (Compressor, PretrainLosses, Rand,
                            uniform_draws)
from ..ops.segment import segment_broadcast, segment_sum
from . import dp
from .collectives import all_reduce_sum
from .partitioned_gin import PartitionedGIN
from .sharded_batch import ShardedPretrainBatch
from .sharded_ops import (gseg_count, gseg_mean, gseg_softmax,
                          gseg_std_mean, gseg_sum, ring_sddmm_sum)


class ShardedSegmentBatchNorm(SegmentBatchNorm):
    """``SegmentBatchNorm`` with the group's segment statistics: the same
    parameters and buffers, the same update of the running statistics
    (momentum 0.1, the unbiased variance, the mean over segments with a
    positive count), each computed identically on every rank, so the
    replicated buffers never diverge."""

    def __init__(self, features: int, group, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__(features, momentum, eps)
        self.group = group

    def forward(self, x: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.training:
            return super().forward(x, segment_ids, num_segments, mask)
        mean_g = gseg_mean(x, segment_ids, num_segments, self.group, mask)
        centered = x - segment_broadcast(mean_g, segment_ids, num_segments)
        count = gseg_count(segment_ids, num_segments, self.group, mask)
        var_g = gseg_sum(centered * centered, segment_ids, num_segments,
                         self.group, mask) / count.clamp_min(1.0)[:, None]
        if not self.frozen:
            with torch.no_grad():
                seg = (count > 0).to(torch.float32)
                n_seg = seg.sum().clamp_min(1.0)
                unb = var_g * (count / (count - 1.0).clamp_min(1.0))[:, None]
                self.mean.mul_(1 - self.momentum).add_(
                    self.momentum * (mean_g * seg[:, None]).sum(0) / n_seg)
                self.var.mul_(1 - self.momentum).add_(
                    self.momentum * (unb * seg[:, None]).sum(0) / n_seg)
        var = segment_broadcast(var_g, segment_ids, num_segments)
        return centered / torch.sqrt(var + self.eps) * self.scale + self.bias


class ShardedCompressor(Compressor):
    """``Compressor`` (d -> d -> per-graph BatchNorm -> ReLU -> 1) with the
    group's per-graph BatchNorm."""

    def __init__(self, hidden: int, group):
        super().__init__(hidden)
        self.bn = ShardedSegmentBatchNorm(hidden, group)


class ShardedCoreFeatures(NamedTuple):
    interaction_map: torch.Tensor   # [P, 2d] this rank's rows
    kl_node: torch.Tensor           # [P, d] this rank's rows
    noisy: torch.Tensor             # [P, d] this rank's rows
    clean_readout: torch.Tensor     # [G, d] the same on every rank


class ShardedSCGIBCore(nn.Module):
    """Node-sharded twin encoders, compression and attention on one rank's
    slice of a ``ShardedPretrainBatch``: ``models/scgib.py::SCGIBCore``
    with GIN encoders and the sum readout."""

    def __init__(self, in_dim: int, hidden: int = 64, num_layers: int = 4,
                 use_att: bool = True, gate_bias: float = 1e-4,
                 std_eps: float = 1e-7, deterministic: bool = False,
                 group=None):
        super().__init__()
        self.group = group
        self.use_att = use_att
        self.gate_bias = gate_bias
        self.std_eps = std_eps
        self.deterministic = deterministic
        self.encoder1 = PartitionedGIN(in_dim, hidden, num_layers, group)
        # ego-nets are local to the rank; sync-BN makes the statistics
        # the group's
        self.encoder2 = GIN(in_dim, hidden, num_layers, group)
        self.compressor = ShardedCompressor(hidden, group)
        if use_att:
            self.attn_layer = nn.Linear(2 * hidden, 1)

    def compression(self, h, b: ShardedPretrainBatch, rand: Optional[Rand]):
        """``SCGIBCore.compression`` with the group's per-graph
        statistics."""
        ng, G, nm = b.node_graph, b.num_graphs, b.node_mask
        p = self.compressor(h, ng, G, mask=nm)
        if self.deterministic:
            lam = torch.sigmoid(p)
        else:
            lo, hi = self.gate_bias, 1.0 - self.gate_bias
            eps = (rand(tuple(p.shape)) * (hi - lo) + lo).clamp_min(lo)
            lam = torch.sigmoid(torch.log(eps) - torch.log1p(-eps) + p)
        lam_neg = 1.0 - lam
        std_g, mean_g = gseg_std_mean(h.detach(), ng, G, self.group, mask=nm)
        mean_n = segment_broadcast(mean_g, ng, G)
        std_n = segment_broadcast(std_g, ng, G)
        noisy_mean = lam * h + lam_neg * mean_n
        noisy_std = lam_neg * std_n
        if self.deterministic:
            noisy = noisy_mean
        else:
            noisy = noisy_mean + rand(tuple(noisy_mean.shape)) * noisy_std
        node_m = nm.to(noisy.dtype)[:, None]
        noisy = noisy * node_m
        denom = std_n + self.std_eps
        term1 = 0.5 * noisy_std ** 2 / denom ** 2
        dev = (noisy_mean - mean_n) / denom
        term2_g = gseg_sum(dev * dev, ng, G, self.group, mask=nm)
        kl_node = term1 + segment_broadcast(term2_g, ng, G)
        return noisy, kl_node * node_m

    def forward(self, b: ShardedPretrainBatch, x_proj, x_sub_proj,
                rand: Optional[Rand] = None) -> ShardedCoreFeatures:
        ng, G, nm = b.node_graph, b.num_graphs, b.node_mask
        h = self.encoder1(x_proj, b.senders_owner_local, b.receivers_local,
                          b.edge_mask, node_mask=nm)
        h_sub = self.encoder2(x_sub_proj, b.sub_senders, b.sub_receivers,
                              node_mask=b.sub_node_mask,
                              edge_mask=b.sub_edge_mask)
        clean_readout = gseg_sum(h, ng, G, self.group, mask=nm)
        noisy, kl_node = self.compression(h, b, rand)
        cand = segment_sum(h_sub, b.sub_center_local, x_proj.shape[0],
                           mask=b.sub_node_mask)
        if not self.use_att:
            return ShardedCoreFeatures(torch.cat([noisy, cand], -1), kl_node,
                                       noisy, clean_readout)
        noisy_readout = gseg_sum(noisy, ng, G, self.group, mask=nm)
        inter = torch.cat([segment_broadcast(noisy_readout, ng, G), cand],
                          -1)
        att = self.attn_layer(inter)[:, 0]
        alpha = gseg_softmax(att, ng, G, self.group, mask=nm)
        im = torch.cat([noisy, cand * alpha[:, None]], -1)
        im = im * nm.to(im.dtype)[:, None]
        return ShardedCoreFeatures(im, kl_node, noisy, clean_readout)


class ShardedPretrainModel(nn.Module):
    """``PretrainModel`` over one rank's slice of a node-sharded batch: the
    same parameters and buffers, the losses this rank's share (summed over
    the ranks, the union batch's losses and gradients).  ``forward(b,
    rand=None)`` takes ``sharded_batch.local_slice(batch, rank)`` on the
    rank's device.  ``group``: the ranks the nodes are sharded over (None:
    every process).  ``encoder`` and ``readout`` are ``PretrainModel``'s
    arguments; only GIN and ``sum`` exist here, as in the JAX package."""

    def __init__(self, in_dim: int, hidden: int = 64, d_transfer: int = 32,
                 num_layers: int = 4, use_att: bool = True,
                 kl_mode: str = "corrected", deterministic: bool = False,
                 normalize_input: bool = True, encoder: str = "GIN",
                 readout: str = "sum", group=None):
        super().__init__()
        if encoder != "GIN" or readout != "sum":
            raise ValueError(f"the node-sharded model has GIN encoders and "
                             f"the sum readout only, not {encoder!r} with "
                             f"{readout!r}")
        if kl_mode not in ("corrected", "reference"):
            raise ValueError(f"unknown kl mode {kl_mode!r}")
        self.group = group
        self.kl_mode = kl_mode
        self.normalize_input = normalize_input
        self.transfer_d = nn.Linear(in_dim, d_transfer, bias=False)
        self.core = ShardedSCGIBCore(d_transfer, hidden=hidden,
                                     num_layers=num_layers, use_att=use_att,
                                     deterministic=deterministic,
                                     group=group)
        self.head_mlp = MLP2(2 * hidden, hidden, hidden)

    def forward(self, b: ShardedPretrainBatch,
                rand: Optional[Rand] = None) -> PretrainLosses:
        if rand is None:
            rand = uniform_draws(None, b.node_feat.device)
        x, x_sub = b.node_feat, b.sub_node_feat
        if self.normalize_input:
            x, x_sub = l2_normalize(x), l2_normalize(x_sub)
        feats = self.core(b, self.transfer_d(x), self.transfer_d(x_sub),
                          rand)
        im = self.head_mlp(feats.interaction_map)
        # 'reference' is exact: graph_mask is the union batch's on every
        # rank, so the last graph is global
        kl = kl_loss(feats.kl_node, b.node_mask, b.node_graph, b.graph_mask,
                     mode=self.kl_mode, group=self.group)
        noisy_readout = gseg_sum(feats.noisy, b.node_graph, b.num_graphs,
                                 self.group, mask=b.node_mask)
        contrastive = contrastive_infonce_replicated(
            noisy_readout, feats.clean_readout, b.graph_mask, b.graph_own,
            self.group)
        return PretrainLosses(kl=kl, contrastive=contrastive,
                              reconstruction=self._recon_adj(im, b))

    def _recon_adj(self, im, b: ShardedPretrainBatch):
        """``losses.recon_adj_loss``'s gram form, ||IM IM^T - A||^2 / N:
        sum(G_local * psum G) - 2 (the ring SDDMM) + |E_local|, over the
        group's real node count."""
        im = im * b.node_mask.to(im.dtype)[:, None]
        g_local = im.T @ im
        g_global = all_reduce_sum(g_local, self.group)
        cross = ring_sddmm_sum(im, b.senders_owner_local, b.receivers_local,
                               b.edge_mask, self.group)
        e_count = b.edge_mask.to(im.dtype).sum()
        n_real = all_reduce_sum(b.node_mask.to(torch.float32).sum(),
                                self.group)
        total = (g_local * g_global).sum() - 2.0 * cross + e_count
        return total / n_real.clamp_min(1.0)


class _ShardedSteps(dp._DPSteps):
    """``step(batch, generator=None)`` on one ``ShardedPretrainBatch``
    slice: ``_DPSteps``'s rules (the key, every field's shape, the caps
    and ``radius`` included, agreed over a host group; captured over NCCL
    in ``thread_local`` mode; eager over gloo)."""

    def __call__(self, batch: ShardedPretrainBatch,
                 generator: Optional[torch.Generator] = None):
        return self._step((batch,), generator)

    def _arg(self, batches):
        return batches[0]


def make_sharded_pretrain_step(model: ShardedPretrainModel,
                               optimizer: torch.optim.Optimizer, group
                               ) -> Callable[..., PretrainLosses]:
    """``step(batch, generator=None) -> losses``: one node-sharded
    optimizer step over ``group`` on this rank's slice
    (``dp.dp_pretrain_step_eager``: this rank's losses and their backward,
    the gradients and losses summed over ``group``, the BatchNorm
    statistics averaged, one Adam update); the returned losses and the
    update are the single-device step's on the union batch.  ``model`` is
    built with ``group=group``; on the card over NCCL one CUDA graph a
    key."""
    return _ShardedSteps(lambda b, gen: dp.dp_pretrain_step_eager(
        model, optimizer, group, b, generator=gen), optimizer, group)
