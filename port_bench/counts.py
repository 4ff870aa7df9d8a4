"""Operations and bytes, counted from a batch's real rows and edges.

``step_flops`` is the model's FLOPs of one pretraining step, the matrix
products and edge sums of the forward pass times three (forward and
backward), the MFU convention; it follows ``bench.py::flop_model`` of the
JAX package, rewritten for the port's heads (the reconstruction's gram is of
the head's d-wide output) and with the transformer's terms.  Elementwise
work, norms and the optimizer are not counted.

``gin_conv`` and ``attention`` give (operations, bytes) of the work one
launch of a hand-written kernel does for one encoder input: every input
byte read once, every output byte written once, the adjacency as a CSR
index (a 4-byte column a real edge, a 4-byte row pointer a row), whatever
layout the kernel reads.  A batch's stats are ``Stats``: real atoms ``n``,
edges ``e``, ego-net rows ``s``, ego-net edges ``q`` and graphs ``g``.
"""

from __future__ import annotations

import dataclasses

F32 = 4


@dataclasses.dataclass(frozen=True)
class Stats:
    n: int
    e: int
    s: int
    q: int
    g: int


def _gin_encoder(rows, edges, dt, d, convs):
    f = 2.0 * rows * (dt * d + d * d)                 # conv 0: dt -> d -> d
    f += (convs - 1) * 2.0 * rows * 2 * d * d         # convs 1..: d -> d -> d
    f += 2.0 * edges * (dt + (convs - 1) * d)         # neighbour sums
    return f


def _transformer_encoder(rows, edges, dt, d, layers):
    f = 2.0 * rows * dt * d                           # embedding
    per = 2.0 * rows * d * 3 * d                      # q, k, v
    per += 2.0 * edges * d * 2                        # scores, weighted sums
    per += 2.0 * rows * d * d                         # output projection
    per += 2.0 * rows * (d * 2 * d + 2 * d * d)       # FFN d -> 2d -> d
    return f + layers * per


def step_flops(cfg: dict, st: Stats) -> float:
    """Model FLOPs of one pretraining step on a batch of ``st``."""
    d, dt, f = cfg["hidden"], cfg["d_transfer"], cfg["in_dim"]
    fwd = 2.0 * (st.n + st.s) * f * dt                # projection
    if cfg["encoder"] == "GIN":
        enc = lambda r, e: _gin_encoder(r, e, dt, d, cfg["num_layers"])
    else:
        enc = lambda r, e: _transformer_encoder(r, e, dt, d,
                                                cfg["num_layers"] + 1)
    fwd += enc(st.n, st.e) + enc(st.s, st.q)
    fwd += 2.0 * st.n * (d * d + d)                   # gate scorer
    fwd += 2.0 * st.s * d                             # candidate sums
    fwd += 2.0 * st.n * 2 * d                         # attention scorer
    fwd += 2.0 * st.n * (2 * d * d + d * d)           # head MLP 2d -> d -> d
    fwd += 2.0 * 2 * st.g * st.g * d                  # InfoNCE's two grams
    fwd += 2.0 * st.n * d * d + 2.0 * st.e * d        # reconstruction
    return 3.0 * fwd


def _csr(rows, edges):
    return F32 * (edges + rows + 1)


def gin_conv(kind: str, rows: int, edges: int, din: int, hid: int,
             dout: int):
    """(operations, bytes) of ``gin_fused_fwd`` (``kind`` "fwd": out =
    relu((h + A h) W1 + b1) W2 + b2) or ``gin_fused_bwd`` ("bwd": from h
    and the output's gradient g, recompute z1 and give dh0 = g1 W1^T for
    g1 = (g W2^T) * [z1 > 0], dW1, db1, dW2, db2)."""
    weights = din * hid + hid + hid * dout + dout
    gather = edges * din + rows * din
    if kind == "fwd":
        ops = gather + 2.0 * rows * (din * hid + hid * dout) + rows * (
            hid + dout)
        nbytes = F32 * rows * (din + dout) + _csr(rows, edges) + F32 * weights
        return ops, nbytes
    if kind != "bwd":
        raise ValueError(kind)
    ops = gather + 2.0 * rows * (3 * din * hid + 2 * hid * dout) + rows * (
        3 * hid + dout)
    nbytes = (F32 * rows * (din + dout + din) + _csr(rows, edges)
              + F32 * (weights - dout) + F32 * weights)
    return ops, nbytes


def attention(kind: str, rows: int, edges: int, heads: int, hd: int):
    """(operations, bytes) of one attention kernel over ``rows`` and their
    ``edges``: "fwd" (out and the row sums z from q, k, v), "rows" (dq and
    rho from q, k, v, g, z) or "cols" (dk, dv from q, k, v, g, z, rho)."""
    D = heads * hd
    score = 2.0 * edges * D + 2.0 * edges * heads     # dot, clamp and exp
    if kind == "fwd":
        ops = score + 2.0 * edges * D + edges * heads
        nbytes = F32 * rows * (3 * D + D + heads)
    elif kind == "rows":
        ops = score + 2.0 * edges * D * 2 + 3.0 * edges * heads
        nbytes = F32 * rows * (4 * D + heads + D + heads)
    elif kind == "cols":
        ops = score + 2.0 * edges * D * 3 + 3.0 * edges * heads
        nbytes = F32 * rows * (4 * D + 2 * heads + 2 * D)
    else:
        raise ValueError(kind)
    return ops, nbytes + _csr(rows, edges)


def least_seconds(ops: float, nbytes: float, flops_peak: float,
                  bytes_peak: float):
    """(seconds, "ops" or "bytes"): the larger of the two bounds."""
    a, b = ops / flops_peak, nbytes / bytes_peak
    return (a, "ops") if a >= b else (b, "bytes")
