"""Sorted-segment pooling as banded block products.

Counterpart of ``scgib_tpu/ops/pool.py``.  The candidate embedding
``cand[v] = sum_{i: center[i] = v} h[i]`` maps the S sub-node rows onto the
N centers.  The packer emits sub-nodes sorted by center, so the rows owned
by one tile of 128 centers form one contiguous window of sub-rows: per tile
a dense [128, window] 0/1 block times that window, which is the banded SpMM
kernel with a wider window.  The backward of a segment sum is the gather
``g[center]``.

A batch too skewed for the window (one center tile owning more sub-rows
than it holds) takes the scatter branch instead.  The JAX package decides
that on the device with ``lax.cond``.  The test depends only on the batch's
index arrays, so here the packer takes it once per batch in NumPy
(``window_fits``) and ships it as the ``SubgraphBatch``'s ``pool_fits``;
the pool reads no tensor on the host, and counts which branch ran (kind
``pool`` in ``utils/counters.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils import counters
from .kernels.banded import blocks, pool
from .segment import _apply_mask, segment_sum


class _PoolMatmul(torch.autograd.Function):
    """[T, tile, W] blocks x windows of data -> [T*tile, d]; the backward
    is the gather g[cc_clip]."""

    @staticmethod
    def forward(ctx, blocks, col_off, data, cc_clip):
        ctx.save_for_backward(cc_clip)
        return pool(blocks, col_off, data)

    @staticmethod
    def backward(ctx, g):
        (cc_clip,) = ctx.saved_tensors
        return None, None, g[cc_clip], None


def default_window(s_rows: int, num_segments: int, tile: int = 128) -> int:
    """2x headroom over the average sub-rows per center tile, rounded up
    to a multiple of 256."""
    window = max(256, min(s_rows, 2 * tile * ((s_rows + num_segments - 1)
                                              // num_segments)))
    return ((window + 255) // 256) * 256


def _banded_shape(s_rows: int, num_segments: int, tile: int, window: int,
                  ndim: int = 2) -> bool:
    """Whether the shapes admit the banded branch at all."""
    return not (num_segments % tile != 0 or s_rows < window
                or s_rows % 64 != 0 or window % 64 != 0 or ndim != 2)


def window_fits(segment_ids: np.ndarray, mask: Optional[np.ndarray],
                num_segments: int, tile: int = 128,
                window: Optional[int] = None) -> bool:
    """The JAX function's device-side ``fits`` (``jnp.max(span) <=
    window``), from the index arrays on the host: every center tile's
    sub-rows lie in its 64-aligned window.  False where the shapes leave
    only the scatter branch."""
    ids = np.asarray(segment_ids, np.int64)
    s_rows = ids.shape[0]
    if window is None:
        window = default_window(s_rows, num_segments, tile)
    if not _banded_shape(s_rows, num_segments, tile, window):
        return False
    m = np.ones(s_rows, bool) if mask is None else np.asarray(mask, bool)
    cc = np.where(m, ids, num_segments)
    bounds = np.searchsorted(cc, np.arange(num_segments // tile + 1) * tile)
    off = np.minimum((bounds[:-1] // 64) * 64, max(s_rows - window, 0))
    return bool((bounds[1:] - off).max() <= window)


def sorted_segment_sum_banded(data: torch.Tensor, segment_ids: torch.Tensor,
                              num_segments: int,
                              mask: Optional[torch.Tensor] = None,
                              tile: int = 128,
                              window: Optional[int] = None,
                              fits: Optional[bool] = None) -> torch.Tensor:
    """Masked segment sum of [S, d] rows whose real (mask=True) segment ids
    ascend (the pack_subgraphs layout) -> [num_segments, d].  ``fits``:
    the batch's ``pool_fits`` from the packer.  Without it, ids on the CPU
    are tested here (``window_fits``); ids on the card raise, since the test
    would read them back to the host in the middle of the step."""
    s_rows = data.shape[0]
    if window is None:
        window = default_window(s_rows, num_segments, tile)
    if not _banded_shape(s_rows, num_segments, tile, window, data.dim()):
        counters.tick("pool", "fallback")
        return _scatter(data, segment_ids, num_segments, mask)
    if fits is None:
        if segment_ids.is_cuda:
            raise ValueError("sorted_segment_sum_banded: pass fits (the "
                             "batch's pool_fits, from the packer) for ids "
                             "on the card")
        fits = window_fits(segment_ids.numpy(), None if mask is None
                           else mask.numpy(), num_segments, tile, window)
    if not fits:
        counters.tick("pool", "scatter")
        return _scatter(data, segment_ids, num_segments, mask)
    counters.tick("pool", "banded")
    m = (mask if mask is not None
         else torch.ones(segment_ids.shape, dtype=torch.bool,
                         device=segment_ids.device))
    off = window_offsets(segment_ids, m, num_segments, tile, window)
    blocks, cc_clip = pool_blocks(segment_ids, m, off, num_segments, tile,
                                  window)
    return _PoolMatmul.apply(blocks, off, _apply_mask(data, mask), cc_clip)


def window_offsets(segment_ids, m, num_segments: int, tile: int,
                   window: int) -> torch.Tensor:
    """64-aligned window start of each center tile, clamped into the
    rows, on the ids' device (``window_fits`` takes the same starts)."""
    s_rows = segment_ids.shape[0]
    n_tiles = num_segments // tile
    # padding rows sort past every real center
    cc = torch.where(m, segment_ids, torch.full_like(segment_ids,
                                                     num_segments))
    tile_starts = torch.arange(n_tiles + 1, device=cc.device) * tile
    bounds = torch.searchsorted(cc, tile_starts)               # [T+1]
    return ((bounds[:-1] // 64) * 64).clamp_max(max(s_rows - window, 0))


def pool_blocks(segment_ids, m, off, num_segments: int, tile: int,
                window: int):
    """The [T, tile, window] bf16 0/1 pooling blocks and the clipped
    center ids (the backward's gather map): each real sub-row i adds 1 at
    its center's row, column i - off[t] (``kernels/banded.py::blocks``,
    which drops masked and out-of-window rows)."""
    cc_clip = torch.where(m, segment_ids, torch.full_like(
        segment_ids, num_segments)).clamp_max(num_segments - 1)
    return (blocks(cc_clip, None, m, off, num_segments // tile, tile,
                   window), cc_clip)


def _scatter(data, segment_ids, num_segments, mask):
    # padding rows map past the last segment and are dropped, like the
    # masked rows
    ids = segment_ids
    if mask is not None:
        ids = torch.where(mask, segment_ids,
                          torch.full_like(segment_ids, num_segments))
    return segment_sum(_apply_mask(data, mask), ids, num_segments)
