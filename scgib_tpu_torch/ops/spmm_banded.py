"""Banded SpMM and graph-transformer attention — the plain PyTorch versions.

Counterpart of ``scgib_tpu/ops/spmm_banded.py``.  ``banded_spmm``: per
row-tile, gather the band window of ``x`` and multiply it by the tile's dense
[tile, band] block; it is the semantics reference of the CUDA kernel in
``ops/kernels/banded.py`` and the path CPU tensors take.
``gt_banded_attention`` is the reference of the graph-transformer attention
whose kernels are in ``ops/kernels/gt_flash.py``.
"""

from __future__ import annotations

import math

import torch


def _banded_spmm_impl(blocks: torch.Tensor, col_off: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """[T, tile, W] blocks x windows of [S, d] -> [T*tile, d], in float32.

    The output has T*tile rows, which need not equal S (the candidate
    pooling maps S sub-rows onto T*tile centers)."""
    n_tiles, tile, width = blocks.shape
    win = col_off[:, None] + torch.arange(width, device=x.device)
    windows = x[win]                                     # [T, W, d]
    out = torch.matmul(blocks.to(x.dtype), windows)      # [T, tile, d]
    return out.reshape(n_tiles * tile, x.shape[-1])


class _BandedSpmm(torch.autograd.Function):
    """Symmetric-A product: the packers always symmetrize edges, so the
    backward A^T g is the same banded product."""

    @staticmethod
    def forward(ctx, blocks, col_off, x):
        ctx.save_for_backward(blocks, col_off)
        return _banded_spmm_impl(blocks, col_off, x)

    @staticmethod
    def backward(ctx, g):
        blocks, col_off = ctx.saved_tensors
        return None, None, _banded_spmm_impl(blocks, col_off, g)


def banded_spmm(blocks: torch.Tensor, col_off: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """[T, tile, band] x [T] x [N, d] -> [N, d] neighbor sums (A x).
    Requires a symmetric A."""
    return _BandedSpmm.apply(blocks, col_off, x)


def gt_windows(col_off: torch.Tensor, band: int,
               x: torch.Tensor) -> torch.Tensor:
    """[T, band, ...] band windows ``x[col_off[t] : col_off[t] + band]``."""
    return x[col_off[:, None] + torch.arange(band, device=x.device)]


def gt_scores(blocks: torch.Tensor, col_off: torch.Tensor, q: torch.Tensor,
              k: torch.Tensor, clamp: float = 5.0, scale=None):
    """(S, E), each [T, H, tile, band]: S = Q_tile K_win^T * scale (default
    1 / sqrt(hd)) and E = exp(clip(S, +-clamp)) * blocks[t], in the inputs'
    dtype."""
    n_tiles, tile, band = blocks.shape
    _, num_heads, hd = q.shape
    s = torch.einsum("tihd,tjhd->thij",
                     q.reshape(n_tiles, tile, num_heads, hd),
                     gt_windows(col_off, band, k))
    s = s / math.sqrt(hd) if scale is None else s * scale
    return s, torch.exp(s.clamp(-clamp, clamp)) * blocks.to(s.dtype)[:, None]


def gt_banded_attention(blocks: torch.Tensor, col_off: torch.Tensor,
                        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        clamp: float = 5.0, eps: float = 1e-6) -> torch.Tensor:
    """Graph-transformer edge attention over the banded layout, by autograd.

    Per row-tile, dense over the [tile, band] window:

        S   = Q_tile K_win^T / sqrt(hd)            (per head)
        E   = exp(clip(S, +-clamp)) * blocks[t]    (no max shift)
        out = (E / (rowsum(E) + eps)) V_win

    the COO path's ``sddmm_dot`` + ``segment_normalize_exp`` + weighted
    ``segment_sum`` up to reduction order.  The gradient is zero where
    |S| > clamp; ``torch.clamp`` passes it where |S| <= clamp, the inclusive
    mask of the flash kernels.  Computes in the inputs' dtype.
    q, k, v: [N, H, hd] -> [N, H, hd]."""
    _, e = gt_scores(blocks, col_off, q, k, clamp)
    w = e / (e.sum(-1) + eps)[..., None]
    out = torch.einsum("thij,tjhd->tihd", w,
                       gt_windows(col_off, blocks.shape[2], v))
    return out.reshape(q.shape)
