"""Masked segment reductions over padded batches.

Counterpart of ``scgib_tpu/ops/segment.py``.  The JAX package lowers small
reductions to dense one-hot matmuls because scatters serialize on a TPU; on
a GPU ``index_add_`` is the natural form, so that path is not ported.

Semantics follow ``jax.ops.segment_sum``: ids outside [0, num_segments) are
dropped.  ``index_add_`` raises on them instead, so their rows are zeroed
and their ids clamped (no boolean compaction, hence no host sync).
"""

from __future__ import annotations

from typing import Optional

import torch


def _apply_mask(data: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return data
    m = mask.to(data.dtype)
    return data * m.reshape(m.shape + (1,) * (data.ndim - m.ndim))


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked segment sum.  data: [N, ...] -> [num_segments, ...]."""
    data = _apply_mask(data, mask)
    valid = (segment_ids >= 0) & (segment_ids < num_segments)
    data = torch.where(valid.reshape(valid.shape + (1,) * (data.ndim - 1)),
                       data, torch.zeros((), dtype=data.dtype,
                                         device=data.device))
    ids = segment_ids.clamp(0, num_segments - 1)
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add(0, ids, data)


def segment_broadcast(values: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """``values[segment_ids]`` with out-of-range ids clamped (``jnp.take``'s
    clip mode); its gradient is the segment sum of the cotangent."""
    return values[segment_ids.clamp(0, num_segments - 1)]


def segment_count(segment_ids: torch.Tensor, num_segments: int,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    ones = torch.ones(segment_ids.shape, dtype=torch.float32,
                      device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments, mask)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    total = segment_sum(data, segment_ids, num_segments, mask)
    count = segment_count(segment_ids, num_segments, mask).clamp_min(1.0)
    return total / count.reshape(count.shape + (1,) * (data.ndim - 1))


def segment_std_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                     num_segments: int, mask: Optional[torch.Tensor] = None,
                     ddof: int = 1):
    """Per-segment (std, mean) like ``torch.std_mean`` (unbiased); single-
    element segments get std 0 instead of NaN."""
    mean = segment_mean(data, segment_ids, num_segments, mask)
    centered = data - segment_broadcast(mean, segment_ids, num_segments)
    sq = segment_sum(centered * centered, segment_ids, num_segments, mask)
    count = segment_count(segment_ids, num_segments, mask)
    denom = (count - ddof).clamp_min(1.0)
    var = sq / denom.reshape(denom.shape + (1,) * (data.ndim - 1))
    return torch.sqrt(var), mean


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-segment max; empty segments give -inf.  Ids are in range."""
    if mask is not None:
        m = mask.reshape(mask.shape + (1,) * (data.ndim - 1))
        data = torch.where(m, data, torch.full((), float("-inf"),
                                               dtype=data.dtype,
                                               device=data.device))
    idx = segment_ids.reshape(segment_ids.shape + (1,) * (data.ndim - 1))
    out = torch.full((num_segments,) + tuple(data.shape[1:]), float("-inf"),
                     dtype=data.dtype, device=data.device)
    return out.scatter_reduce(0, idx.expand_as(data), data, "amax",
                              include_self=True)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-segment softmax of [N] logits; masked entries get weight 0.

    The max shift is detached: softmax is shift invariant, so its exact
    gradient through the max is zero (JAX's is zero up to rounding)."""
    seg_max = segment_max(logits.detach(), segment_ids, num_segments, mask)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.zeros_like(seg_max))
    if mask is not None:
        # mask before exp: a padded logit minus a very negative max would
        # overflow, and inf * 0 is NaN
        logits = torch.where(mask, logits,
                             torch.full((), float("-inf"),
                                        dtype=logits.dtype,
                                        device=logits.device))
    shifted = logits - segment_broadcast(seg_max, segment_ids, num_segments)
    e = torch.exp(shifted)
    denom = segment_sum(e, segment_ids, num_segments).clamp_min(1e-16)
    return e / segment_broadcast(denom, segment_ids, num_segments)


def segment_normalize_exp(scores: torch.Tensor, segment_ids: torch.Tensor,
                          num_segments: int,
                          mask: Optional[torch.Tensor] = None,
                          clamp: float = 5.0,
                          eps: float = 1e-6) -> torch.Tensor:
    """The graph transformer's unshifted edge softmax: ``exp(clamp(score,
    +-clamp))`` divided by the per-destination sum plus ``eps``."""
    e = _apply_mask(torch.exp(scores.clamp(-clamp, clamp)), mask)
    z = segment_sum(e, segment_ids, num_segments)
    return e / segment_broadcast(z + eps, segment_ids, num_segments)
