"""The 0/1 block counts in NumPy: the reference that the tests hold every
block build to (``ops/kernels/banded.py::blocks`` and its plain version,
``ops/pool.py::pool_blocks``)."""

import numpy as np


def np_blocks(rows, src, mask, off, n_tiles, tile, width):
    """The counts in NumPy, the reference of every block build: item i adds
    1 at [t, r - t tile, c - off[t]] (r = rows[i], c = src[i] or i, t =
    r // tile) where mask[i], 0 <= r, t < n_tiles and the column lies in
    [0, width); any other item is dropped."""
    rows = np.asarray(rows, np.int64)
    src = np.arange(len(rows)) if src is None else np.asarray(src, np.int64)
    off = np.asarray(off, np.int64)
    t_idx = rows // tile
    col = src - off[np.clip(t_idx, 0, n_tiles - 1)]
    keep = (rows >= 0) & (t_idx < n_tiles) & (col >= 0) & (col < width)
    if mask is not None:
        keep &= np.asarray(mask, bool)
    out = np.zeros((n_tiles, tile, width), np.float32)
    np.add.at(out, (t_idx[keep], rows[keep] % tile, col[keep]), 1.0)
    return out
