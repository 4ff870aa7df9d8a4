"""Banded block-dense adjacency layout.

Counterpart of ``scgib_tpu/graph/banded.py``.  The packers lay graphs out
contiguously, so every edge (u, v) of a batch has |u - v| < the largest
graph's size and the adjacency is banded: row-tile t of ``tile`` rows owns a
dense [tile, band] slab whose columns start at ``col_off[t]``, and

    agg[t*tile:(t+1)*tile] = blocks[t] @ h[col_off[t] : col_off[t]+band]

The NumPy helpers run on the host; ``device_col_off`` gives the offsets on
the device, where ``ops/kernels/banded.py::blocks`` builds the same blocks
from the COO edge list.

The band is sized from the data (``band_width``): with ``band`` a multiple of
the tile, a row tile's window reaches (band - tile) / 2 rows on either side
of it, so a graph (or ego-net) of at most that many nodes keeps every edge
in its receiver tile's window wherever it lands.  The packers take one
width a dataset, for its graphs and for its ego-nets apart: ``BAND`` = 256
(the JAX package's only width) up to 64 nodes, the smallest multiple of 128
that is at least 2 m + 128 past it (512 for molecules of up to 192 atoms,
384 for ego-nets of up to 128 nodes); the batches carry it as their static
``band_width``.

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


TILE = 128
BAND = 256


def band_width(max_component: int, tile: int = TILE) -> int:
    """The band of a dataset whose largest graph (or ego-net) has
    ``max_component`` nodes: the smallest multiple of ``tile`` that is at
    least 2 * max_component + tile, and at least ``BAND``."""
    need = 2 * int(max_component) + tile
    return max(BAND, -(-need // tile) * tile)


def component_fits(max_component: int, band: int, tile: int = TILE) -> bool:
    """Every edge of a graph of at most ``max_component`` nodes stays in its
    receiver tile's window of width ``band`` (a multiple of ``tile``),
    wherever the graph lands."""
    return int(max_component) <= (band - tile) // 2


def banded_col_off(num_nodes: int, tile: int = 128, band: int = 256,
                   align: int = 64) -> np.ndarray:
    """The [T] window offsets — a pure function of the node capacity."""
    n_tiles = num_nodes // tile
    all_t0 = np.arange(n_tiles, dtype=np.int64) * tile
    all_lo = np.maximum(all_t0 + tile // 2 - band // 2, 0)
    col_off = (all_lo // align) * align
    return np.minimum(col_off, max(num_nodes - band, 0)).astype(np.int32)


def device_col_off(num_nodes: int, tile: int, band: int, align: int,
                   device) -> torch.Tensor:
    """``banded_col_off`` as int64 on ``device``, computed there: a step on
    the card makes no copy from the host (which a CUDA graph cannot
    capture)."""
    t0 = torch.arange(num_nodes // tile, device=device) * tile
    lo = (t0 + (tile // 2 - band // 2)).clamp_min(0)
    return ((lo // align) * align).clamp_max(max(num_nodes - band, 0))


GT_TILE = 64
GT_BAND = 128
GT_ALIGN = 8


def gt_band_fits(max_component: int, cap: int) -> bool:
    """True when the (GT_TILE, GT_BAND) geometry fits every batch of
    capacity ``cap`` whose largest graph / ego-net has ``max_component``
    nodes."""
    return (cap % GT_TILE == 0 and cap >= GT_BAND
            and max_component <= GT_TILE // 2 + 1)


def fits_band(senders: np.ndarray, receivers: np.ndarray,
              tile: int = 128, band: int = 256, align: int = 64) -> bool:
    """True iff every edge's sender lies in its receiver-tile's window
    (unclamped: the window of ``banded_col_off`` before its clamp to the
    node capacity)."""
    t0 = (receivers // tile) * tile
    lo = np.maximum(t0 + tile // 2 - band // 2, 0)
    lo = (lo // align) * align
    return bool(np.all((senders >= lo) & (senders < lo + band)))


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

