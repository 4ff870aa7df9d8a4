"""S-CGIB pretraining losses.

Counterpart of ``scgib_tpu/models/losses.py`` for pretraining: the KL
compression term (``corrected``, or the reference's last-graph
``reference``), the InfoNCE contrastive term, the adjacency reconstruction
(gram form with its banded cross term, or the literal dense form) and the
k-step logM reconstruction.  Single device: no ``axis_name``.
"""

from __future__ import annotations

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
