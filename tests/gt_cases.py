"""Inputs of the graph-transformer attention kernel tests, shared by the CPU
tests against the JAX Pallas kernels (``test_torch_gt.py``) and the card
tests against the plain versions (``test_torch_cuda.py``).  numpy and the
port only: the card's machine has no JAX."""

import numpy as np
import torch

from scgib_tpu_torch.graph import banded

GEOMETRIES = {"narrow": (64, 128, 8), "wide": (128, 256, 64)}
EMPTY = (128, 192)     # rows no edge touches in the edge cases: all-zero
                       # gate rows, tile 2 of the narrow geometry
REPEATED = (10, 12)    # an edge given twice in the edge cases: entry 2
Q_SCALE = 10.0         # q in the edge cases: scores far past the clamp

# case -> (geometry, heads, head width, edge cases)
CASES = {"narrow": ("narrow", 8, 8, False),
         "wide": ("wide", 8, 8, False),
         "narrow-4x16": ("narrow", 4, 16, False),
         "wide-16x4": ("wide", 16, 4, False),
         "narrow-2x32": ("narrow", 2, 32, False),
         "narrow-edges": ("narrow", 8, 8, True),
         "wide-edges": ("wide", 8, 8, True)}


def banded_graph(geometry, n=256, seed=3, edge_cases=False):
    """A symmetric edge list with |u - v| <= 20, which fits both
    geometries, and its bf16 blocks and offsets.  ``edge_cases``: no edge
    touches the rows EMPTY, and the edge REPEATED is given twice more."""
    tile, band, align = GEOMETRIES[geometry]
    rng = np.random.default_rng(seed)
    send, recv = [], []
    for v in range(n):
        for _ in range(3):
            u = int(np.clip(v + rng.integers(-20, 21), 0, n - 1))
            send += [u, v]
            recv += [v, u]
    send, recv = np.asarray(send, np.int32), np.asarray(recv, np.int32)
    if edge_cases:
        lo, hi = EMPTY
        keep = ~((send >= lo) & (send < hi) | (recv >= lo) & (recv < hi))
        u, v = REPEATED
        send = np.concatenate([send[keep], [u, v, u, v]]).astype(np.int32)
        recv = np.concatenate([recv[keep], [v, u, v, u]]).astype(np.int32)
    b = banded.pack_banded(send, recv, None, n, tile=tile, band=band,
                           align=align)
    return (torch.from_numpy(b.blocks).to(torch.bfloat16),
            torch.from_numpy(b.col_off.astype(np.int64)))


def qkvg(n, heads=8, hd=8, seed=4, q_scale=1.0):
    """q, k, v and the output gradient g, [n, heads, hd] float32."""
    rng = np.random.default_rng(seed)
    x = [rng.normal(size=(n, heads, hd)).astype(np.float32)
         for _ in range(4)]
    x[0] *= np.float32(q_scale)
    return x


def case_inputs(case, n=256):
    """(blocks, col_off, [q, k, v, g] as numpy) of one of CASES."""
    geometry, heads, hd, edge_cases = CASES[case]
    blocks, off = banded_graph(geometry, n, edge_cases=edge_cases)
    return blocks, off, qkvg(n, heads, hd,
                             q_scale=Q_SCALE if edge_cases else 1.0)


# (heads, head width) the kernels serve since the widths were opened up: hd
# 64, 128, 256 and 512 as they are, 12 (hidden 96, 8 heads), 10 (hidden
# 30, 3 heads), 1 with 3 heads (3 features a row) and 200 zero-padded to
# 16, 16, 4 and 256
WIDTHS = {"8x12": (8, 12), "1x64": (1, 64), "1x128": (1, 128),
          "3x10": (3, 10), "3x1": (3, 1), "1x256": (1, 256),
          "1x200": (1, 200), "1x512": (1, 512)}
