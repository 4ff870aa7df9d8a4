"""Inputs of the fused GIN conv kernel tests, shared by the CPU tests against
the JAX Pallas kernel (``test_torch_gin.py``) and the card tests against the
plain version (``test_torch_cuda.py``).  numpy and torch only: the card's
machine has no JAX.

Every window lies inside h (the Pallas kernel slices it from h); the card
tests add windows that run past the end of h with ``_ragged_band``."""

import numpy as np
import torch

TILE = 128
EMPTY_TILE = 1         # the tile with no edge in the edge cases
REPEATED = (5, 9)      # (row of tile 0, window column): entry 2 in the edge
                       # cases, an edge given twice

# case -> (din, hid, dout, band width, row tiles, edge cases); the first two
# are the main path's widths
CASES = {"main-32": (32, 64, 64, 256, 4, False),
         "main-64": (64, 64, 64, 256, 4, False),
         "main-64-edges": (64, 64, 64, 256, 4, True),
         "narrow-8x40x24": (8, 40, 24, 128, 3, False),
         "ragged-40x64x32": (40, 64, 32, 256, 3, True),
         "wide-96x128x96": (96, 128, 96, 256, 3, False),
         "wide-128x16x128": (128, 16, 128, 128, 3, True),
         "pool-width-32x32x8": (32, 32, 8, 1024, 8, True)}


def case_inputs(case):
    """(blocks bf16 [T, 128, W], col_off int64 [T], [h, w1, b1, w2, b2] as
    float32 numpy) of one of CASES: ~2% ones, window starts multiples of 64
    around each tile's own rows."""
    din, hid, dout, width, tiles, edge_cases = CASES[case]
    rng = np.random.default_rng(list(CASES).index(case))
    n = tiles * TILE
    a = (rng.random((tiles, TILE, width)) < 0.02).astype(np.float32)
    if edge_cases:
        a[EMPTY_TILE] = 0.0
        row, col = REPEATED
        a[0, row, col] = 2.0
    start = np.arange(tiles) * TILE - (width - TILE) // 2
    off = np.clip(start, 0, n - width) // 64 * 64
    arrays = [rng.normal(size=(n, din)),
              rng.normal(size=(din, hid)) / np.sqrt(din),
              rng.normal(size=hid) * 0.1,
              rng.normal(size=(hid, dout)) / np.sqrt(hid),
              rng.normal(size=dout) * 0.1]
    return (torch.from_numpy(a).to(torch.bfloat16),
            torch.from_numpy(off.astype(np.int64)),
            [x.astype(np.float32) for x in arrays])
