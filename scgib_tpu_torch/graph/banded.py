"""Banded block-dense adjacency layout.

Counterpart of ``scgib_tpu/graph/banded.py``.  The packers lay graphs out
contiguously, so every edge (u, v) of a batch has |u - v| < the largest
graph's size and the adjacency is banded: row-tile t of ``tile`` rows owns a
dense [tile, band] slab whose columns start at ``col_off[t]``, and

    agg[t*tile:(t+1)*tile] = blocks[t] @ h[col_off[t] : col_off[t]+band]

The NumPy helpers run on the host; ``build_blocks`` builds the same blocks
from the COO edge list on the device.

The graph-transformer attention takes a narrower geometry, tile
``GT_TILE`` = 64, band ``GT_BAND`` = 128, offsets aligned to ``GT_ALIGN`` = 8:
its work grows with the window.  The window [t0 - 32, t0 + 96) holds every
edge of a row tile when no graph (or ego-net) has more than GT_TILE / 2 + 1
= 33 nodes, since an edge's endpoints then differ by at most 32; the
packers record that as the batch's ``gt_fits`` flag.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class BandedAdjacency:
    """blocks: [T, tile, band] float32 0/1; col_off: [T] int32."""

    blocks: np.ndarray
    col_off: np.ndarray
    num_nodes: int


def banded_col_off(num_nodes: int, tile: int = 128, band: int = 256,
                   align: int = 64) -> np.ndarray:
    """The [T] window offsets — a pure function of the node capacity."""
    n_tiles = num_nodes // tile
    all_t0 = np.arange(n_tiles, dtype=np.int64) * tile
    all_lo = np.maximum(all_t0 + tile // 2 - band // 2, 0)
    col_off = (all_lo // align) * align
    return np.minimum(col_off, max(num_nodes - band, 0)).astype(np.int32)


GT_TILE = 64
GT_BAND = 128
GT_ALIGN = 8


def gt_band_fits(max_component: int, cap: int) -> bool:
    """True when the (GT_TILE, GT_BAND) geometry fits every batch of
    capacity ``cap`` whose largest graph / ego-net has ``max_component``
    nodes."""
    return (cap % GT_TILE == 0 and cap >= GT_BAND
            and max_component <= GT_TILE // 2 + 1)


def fits_band_masked(senders: np.ndarray, receivers: np.ndarray,
                     edge_mask: Optional[np.ndarray], num_nodes: int,
                     tile: int = 128, band: int = 256,
                     align: int = 64) -> bool:
    """True iff every unmasked edge lies in its receiver-tile's (clamped)
    window."""
    if num_nodes % tile != 0 or num_nodes < band:
        return False
    s = np.asarray(senders)
    r = np.asarray(receivers)
    if edge_mask is not None:
        keep = np.asarray(edge_mask, bool)
        s, r = s[keep], r[keep]
    if not len(s):
        return True
    off = banded_col_off(num_nodes, tile, band, align)
    col = s - off[r // tile]
    return bool((col.min() >= 0) and (col.max() < band))


def pack_banded(senders: np.ndarray, receivers: np.ndarray,
                edge_mask: Optional[np.ndarray], num_nodes: int,
                tile: int = 128, band: int = 256,
                align: int = 64) -> BandedAdjacency:
    """Host build of the banded layout; raises ValueError if an edge
    escapes its window."""
    if num_nodes % tile != 0:
        raise ValueError("node capacity must be a tile multiple")
    if band % align != 0 or tile % align != 0:
        raise ValueError("band and tile must be multiples of align")
    n_tiles = num_nodes // tile
    if edge_mask is not None:
        keep = np.asarray(edge_mask, dtype=bool)
        senders = np.asarray(senders)[keep]
        receivers = np.asarray(receivers)[keep]
    col_off = banded_col_off(num_nodes, tile, band, align)
    t_idx = receivers // tile
    col = senders - col_off[t_idx]
    if len(col) and (col.min() < 0 or col.max() >= band):
        raise ValueError(
            "edge escapes band window; increase band or use the COO path")
    blocks = np.zeros((n_tiles, tile, band), dtype=np.float32)
    lin = receivers.astype(np.int64) * band + col
    np.add.at(blocks.reshape(-1), lin, 1.0)
    return BandedAdjacency(blocks=blocks, col_off=col_off,
                           num_nodes=num_nodes)


def build_blocks(senders: torch.Tensor, receivers: torch.Tensor,
                 edge_mask: Optional[torch.Tensor], col_off: torch.Tensor,
                 num_nodes: int, tile: int = 128,
                 band: int = 256) -> torch.Tensor:
    """Device-side build of the [T, tile, band] bf16 blocks from COO.

    Equals ``build_blocks_jax``: a scatter-add of the edge weights (the
    edge mask) that drops entries outside their window.  ``index_add_``
    raises on an out-of-range index where XLA's ``mode="drop"`` skips it,
    so masked and out-of-window edges are routed to one spare slot past
    the end and cut off — no boolean compaction, hence no host sync.
    Counts add in float32 and are cast once: small integer counts are
    exact in both types, so the bf16 result is bit-equal to the bf16
    scatter."""
    n_tiles = num_nodes // tile
    size = n_tiles * tile * band
    t_idx = receivers // tile
    col = senders - col_off[t_idx.clamp(0, n_tiles - 1)]
    keep = (col >= 0) & (col < band) & (t_idx < n_tiles)
    if edge_mask is not None:
        keep = keep & edge_mask
    lin = torch.where(keep, receivers * band + col,
                      torch.full_like(receivers, size))
    flat = torch.zeros(size + 1, dtype=torch.float32,
                       device=receivers.device)
    flat.index_add_(0, lin, torch.ones(lin.shape, dtype=torch.float32,
                                       device=receivers.device))
    return flat[:size].view(n_tiles, tile, band).to(torch.bfloat16)
