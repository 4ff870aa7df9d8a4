"""S-CGIB losses.

Counterpart of ``scgib_tpu/models/losses.py``: for pretraining the KL
compression term (``corrected``, or the reference's last-graph
``reference``), the InfoNCE contrastive term, the adjacency reconstruction
(gram form with its banded cross term, or the literal dense form) and the
k-step logM reconstruction; for fine-tuning the five supervised losses of
the per-dataset table (BCE on probabilities, BCE with logits, cross
entropy, RMSE, MAE), each averaged over the entries a mask keeps.  Single
device: no ``axis_name``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.kernels.banded import spmm_banded_fast


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """``F.normalize`` with the clamp inside the sqrt, so an all-zero row
    has a finite gradient."""
    sq = (x * x).sum(dim, keepdim=True)
    return x / torch.sqrt(sq.clamp_min(eps * eps))


def contrastive_infonce(z1: torch.Tensor, z2: torch.Tensor,
                        graph_mask: torch.Tensor,
                        tau: float = 1.0) -> torch.Tensor:
    """InfoNCE between noisy readouts z1 and clean readouts z2, [G, d]:
    loss_i = -log f(z1_i, z2_i) / (sum_j f(z1_i, z1_j) + sum_j f(z1_i, z2_j)
    - f(z1_i, z1_i)), f = exp(cos / tau), averaged over real graphs."""
    m = graph_mask.to(z1.dtype)
    z1n = l2_normalize(z1)
    z2n = l2_normalize(z2)
    refl = torch.exp(z1n @ z1n.T / tau)
    betw = torch.exp(z1n @ z2n.T / tau)
    denom = refl @ m + betw @ m - torch.diagonal(refl)
    loss_i = -torch.log(torch.diagonal(betw) / denom.clamp_min(1e-30))
    return (loss_i * m).sum() / m.sum().clamp_min(1.0)


def kl_loss(kl_node: torch.Tensor, node_mask: torch.Tensor,
            node_graph: torch.Tensor = None, graph_mask: torch.Tensor = None,
            mode: str = "corrected") -> torch.Tensor:
    """The per-node KL matrix [N, d] reduced to a scalar.  ``corrected``:
    its mean over real nodes (the paper's Eq. 12).  ``reference``: its mean
    over the last real graph's nodes only, the reference's accumulation
    bug (models.py:659); it needs ``node_graph`` and ``graph_mask``."""
    if mode == "corrected":
        w = node_mask.to(kl_node.dtype)
    elif mode == "reference":
        last = graph_mask.to(torch.int64).sum() - 1
        w = ((node_graph == last) & node_mask).to(kl_node.dtype)
    else:
        raise ValueError(f"unknown kl mode {mode!r}")
    total = (kl_node * w[:, None]).sum()
    count = w.sum() * kl_node.shape[-1]
    return total / count.clamp_min(1.0)


def recon_adj_loss(interaction_map: torch.Tensor, senders: torch.Tensor,
                   receivers: torch.Tensor, edge_mask: torch.Tensor,
                   node_mask: torch.Tensor, band=None,
                   impl: str = "gram") -> torch.Tensor:
    """||IM IM^T - A||_F^2 / N_real.  ``gram``: with A binary,
    tr((IM^T IM)^2) - 2 sum_e IM_s . IM_r + |E|; with the banded layout
    the edge cross term is sum(IM * (A IM)), a banded product whose
    backward is the same product.  ``dense``: the literal N x N gram and
    adjacency (the reference's form, for parity checks)."""
    im = interaction_map * node_mask.to(interaction_map.dtype)[:, None]
    n_real = node_mask.to(torch.float32).sum()
    em = edge_mask.to(im.dtype)
    if impl == "dense":
        gram = im @ im.T
        adj = torch.zeros_like(gram).index_put_((senders, receivers), em,
                                                accumulate=True)
        return ((gram - adj) ** 2).sum() / n_real.clamp_min(1.0)
    if impl != "gram":
        raise ValueError(f"unknown recon impl {impl!r}")
    gram = im.T @ im
    if band is not None:
        cross = (im * spmm_banded_fast(band[0], band[1], im)).sum()
    else:
        cross = ((im[senders] * im[receivers]).sum(-1) * em).sum()
    total = (gram * gram).sum() - 2.0 * cross + em.sum()
    return total / n_real.clamp_min(1.0)


def recon_logm_loss(interaction_map: torch.Tensor, targets: torch.Tensor,
                    weights: torch.Tensor, k_transition: int) -> torch.Tensor:
    """Per-graph k-step transition reconstruction (models.py:770-782):
    (1/k) sum_k sum_g ||IM_g IM_g^T - logM_{g,k}||^2 / n_g^2, with
    ``targets`` [k, N, N] block-diagonal and ``weights`` [N, N] holding
    1/n_g^2 inside each graph's block (``graph/transition.py::
    pack_logm_targets``)."""
    gram = interaction_map @ interaction_map.T
    diff = gram[None] - targets
    return (diff * diff * weights[None]).sum() / float(k_transition)


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    if mask is None:
        return x.mean()
    m = mask.to(x.dtype)
    return (x * m).sum() / m.sum().clamp_min(1.0)


def _safe_log(x: torch.Tensor) -> torch.Tensor:
    """log(x), -100 where x <= 0, with a gradient of exactly 0 there (torch
    BCELoss's clamp): the log is taken of a safe input only, so no 0 * inf
    turns into NaN."""
    zero = x <= 0.0
    return torch.where(zero, torch.full_like(x, -100.0),
                       torch.log(torch.where(zero, torch.ones_like(x), x)))


def bce_loss(probs: torch.Tensor, targets: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``nn.BCELoss`` over probabilities (models.py:522-525), NaN targets
    taken as 0 (they are masked): the logs, not the probabilities, are
    clamped at -100, so a saturated sigmoid's exact 0 or 1 keeps the value
    and the gradient finite."""
    targets = torch.nan_to_num(targets, nan=0.0)
    ll = -(targets * _safe_log(probs)
           + (1.0 - targets) * _safe_log(1.0 - probs))
    return _masked_mean(ll, mask)


def bce_with_logits_loss(logits: torch.Tensor, targets: torch.Tensor,
                         mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """``nn.BCEWithLogitsLoss`` (models.py:536-539), the stable form."""
    ll = (logits.clamp_min(0) - logits * targets
          + torch.log1p(torch.exp(-logits.abs())))
    return _masked_mean(ll, mask)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``nn.CrossEntropyLoss`` with integer class labels (models.py:527-530)
    over whatever the head produced (the reference applies it to sigmoided
    scores, train_tudataset.py)."""
    shifted = logits - logits.max(-1, keepdim=True).values
    log_probs = shifted - torch.log(torch.exp(shifted).sum(-1, keepdim=True))
    picked = log_probs.gather(-1, labels.to(torch.int64)[:, None])[:, 0]
    return -_masked_mean(picked, mask)


def rmse_loss(scores: torch.Tensor, targets: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sqrt(MSE) (models.py:532-535)."""
    return torch.sqrt(_masked_mean((scores - targets) ** 2, mask))


def mae_loss(scores: torch.Tensor, targets: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L1 loss (models.py:541-543)."""
    return _masked_mean((scores - targets).abs(), mask)
