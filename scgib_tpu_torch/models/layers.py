"""Shared layers: masked BatchNorm, per-segment BatchNorm, the 2-layer MLP
and the auxiliary heads (``MLPReadout``, ``ReconstructX``, ``MLPA``).

Counterpart of ``scgib_tpu/models/layers.py``.  A flax Dense learns its
input width at first call; an ``nn.Linear`` is given it, so each head here
takes ``in_dim`` first.  Parameter and buffer names
follow the flax tree (``scale``, ``bias``; running ``mean``, ``var``;
``Dense_0``, ``Dense_1``) so ``utils/params.py`` maps one onto the other.
Train or eval mode is the module's ``training`` flag.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.segment import (segment_broadcast, segment_count, segment_mean,
                           segment_sum)


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the rows a mask selects.

    Like ``nn.BatchNorm1d``: biased variance to normalize, unbiased variance
    in the running statistics, momentum 0.1, eps 1e-5, affine — but padding
    rows neither contribute to nor are kept out of the statistics by
    ``nn.BatchNorm1d``, hence this module.  Moments are one-pass
    (E[x^2] - mean^2), as in the JAX package."""

    def __init__(self, features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.training:
            if mask is None:
                count = x.new_full((), float(x.shape[0]))
                total = x.sum(0)
                total_sq = (x * x).sum(0)
            else:
                m = mask.to(x.dtype)[:, None]
                xm = x * m
                count = m.sum()
                total = xm.sum(0)
                total_sq = (xm * x).sum(0)
            count = count.clamp_min(1.0)
            mean = total / count
            var = (total_sq / count - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                unbiased = var * count / (count - 1.0).clamp_min(1.0)
                self.mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.var.mul_(1 - self.momentum).add_(
                    self.momentum * unbiased)
        else:
            mean, var = self.mean, self.var
        a = self.scale * torch.rsqrt(var + self.eps)
        return x * a + (self.bias - mean * a)


class SegmentBatchNorm(nn.Module):
    """BatchNorm with train-mode statistics per segment (per graph): the
    reference runs its compressor inside a per-graph loop.  The running
    statistics move once per call by the mean over non-empty segments of
    their statistics (the reference's per-graph sequential updates are
    order-dependent; the JAX package documents the same deviation)."""

    def __init__(self, features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.training:
            mean_g = segment_mean(x, segment_ids, num_segments, mask)
            mean = segment_broadcast(mean_g, segment_ids, num_segments)
            centered = x - mean
            count = segment_count(segment_ids, num_segments, mask)
            var_g = segment_sum(centered * centered, segment_ids,
                                num_segments, mask)
            var_g = var_g / count.clamp_min(1.0)[:, None]
            var = segment_broadcast(var_g, segment_ids, num_segments)
            with torch.no_grad():
                seg = (count > 0).to(torch.float32)
                n_seg = seg.sum().clamp_min(1.0)
                unb = var_g * (count / (count - 1.0).clamp_min(1.0))[:, None]
                avg_mean = (mean_g * seg[:, None]).sum(0) / n_seg
                avg_var = (unb * seg[:, None]).sum(0) / n_seg
                self.mean.mul_(1 - self.momentum).add_(
                    self.momentum * avg_mean)
                self.var.mul_(1 - self.momentum).add_(self.momentum * avg_var)
        else:
            mean, var = self.mean, self.var
        return (x - mean) / torch.sqrt(var + self.eps) * self.scale + self.bias


class MLP2(nn.Module):
    """Linear -> ReLU -> Linear."""

    def __init__(self, in_dim: int, hidden: int, out: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_dim, hidden)
        self.Dense_1 = nn.Linear(hidden, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(torch.relu(self.Dense_0(x)))


class MLPReadout(nn.Module):
    """Halving-width readout: L layers ``Linear(d / 2^l -> d / 2^(l+1))``
    with ReLU, then a Linear to ``out`` (reference models.py:961-978)."""

    def __init__(self, in_dim: int, out: int, L: int = 2):
        super().__init__()
        self.L = L
        for l in range(L):
            setattr(self, f"fc{l}", nn.Linear(in_dim // 2 ** l,
                                              in_dim // 2 ** (l + 1)))
        self.out = nn.Linear(in_dim // 2 ** L, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for l in range(self.L):
            x = torch.relu(getattr(self, f"fc{l}")(x))
        return self.out(x)


class ReconstructX(nn.Module):
    """Feature decoder ``d -> hidden -> in_dim`` with ReLU (reference
    ``Reconstruct_X``, models.py:785-796, 924-937); ``out`` is the decoded
    feature width."""

    def __init__(self, in_dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.relu(self.fc1(x)))


class MLPA(nn.Module):
    """Inner-product adjacency decoder, sigmoid(Z Z^T) of Z = MLP(x)
    (reference ``MLP_A``, models.py:940-956)."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden)
        self.fc2 = nn.Linear(hidden, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = self.fc2(torch.relu(self.fc1(x)))
        return torch.sigmoid(z @ z.T)
