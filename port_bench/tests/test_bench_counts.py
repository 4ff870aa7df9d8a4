"""The operation and byte counts against hand counts on tiny shapes."""

import pytest

from port_bench import counts
from port_bench.counts import Stats


def test_gin_conv_forward_by_hand():
    # 3 rows, 4 edges, widths 2 -> 3 -> 2
    ops, nbytes = counts.gin_conv("fwd", 3, 4, 2, 3, 2)
    gather = 4 * 2 + 3 * 2                 # an add a feature an edge, + h
    products = 2 * 3 * (2 * 3) + 2 * 3 * (3 * 2)
    elementwise = 3 * (3 + 2)              # the two bias adds
    assert ops == gather + products + elementwise
    weights = 2 * 3 + 3 + 3 * 2 + 2
    assert nbytes == 4 * (3 * 2 + 3 * 2) + 4 * (4 + 3 + 1) + 4 * weights


def test_gin_conv_backward_by_hand():
    ops, nbytes = counts.gin_conv("bwd", 3, 4, 2, 3, 2)
    gather = 4 * 2 + 3 * 2
    # z1 = z0 W1, g W2^T, dW2, dW1, dh0: three din x hid, two hid x dout
    products = 2 * 3 * (3 * 2 * 3 + 2 * 3 * 2)
    elementwise = 3 * (3 * 3 + 2)          # bias, ReLU mask, db1; db2
    assert ops == gather + products + elementwise
    weights = 2 * 3 + 3 + 3 * 2 + 2
    # read h, g, W1, b1, W2 and the index; write dh0 and the four grads
    assert nbytes == (4 * 3 * (2 + 2) + 4 * 3 * 2 + 4 * (4 + 3 + 1)
                      + 4 * (weights - 2) + 4 * weights)


@pytest.mark.parametrize("kind,dots,rows_io", [
    ("fwd", 2, 3 * 4 + 4 + 2),      # q k v in, out and z out
    ("rows", 3, 4 * 4 + 2 + 4 + 2),  # q k v g z in, dq rho out
    ("cols", 4, 4 * 4 + 2 * 2 + 2 * 4),  # q k v g z rho in, dk dv out
])
def test_attention_by_hand(kind, dots, rows_io):
    # 5 rows, 6 edges, 2 heads of 2 (D = 4)
    ops, nbytes = counts.attention(kind, 5, 6, 2, 2)
    score = 2 * 6 * 4 + 2 * 6 * 2
    per_edge = {"fwd": 6 * 2, "rows": 3 * 6 * 2, "cols": 3 * 6 * 2}[kind]
    assert ops == score + (dots - 1) * 2 * 6 * 4 + per_edge
    assert nbytes == 4 * 5 * rows_io + 4 * (6 + 5 + 1)


def test_step_flops_gin_by_hand():
    cfg = {"encoder": "GIN", "hidden": 2, "d_transfer": 1, "in_dim": 3,
           "num_layers": 2}
    st = Stats(n=4, e=6, s=10, q=12, g=2)

    def enc(r, e):      # conv0 1 -> 2 -> 2, conv1 2 -> 2 -> 2, edge sums
        return 2 * r * (1 * 2 + 2 * 2) + 2 * r * 2 * 2 * 2 + 2 * e * (1 + 2)
    fwd = (2 * 14 * 3 * 1 + enc(4, 6) + enc(10, 12) + 2 * 4 * (4 + 2)
           + 2 * 10 * 2 + 2 * 4 * 4 + 2 * 4 * (8 + 4) + 2 * 2 * 2 * 2 * 2
           + 2 * 4 * 4 + 2 * 6 * 2)
    assert counts.step_flops(cfg, st) == 3 * fwd


def test_step_flops_transformer_by_hand():
    cfg = {"encoder": "Transformer", "hidden": 2, "d_transfer": 1,
           "in_dim": 3, "num_layers": 1}
    st = Stats(n=4, e=6, s=10, q=12, g=2)

    def enc(r, e):      # embed, then 2 layers: qkv, scores + sums, O, FFN
        layer = (2 * r * 2 * 6 + 2 * e * 2 * 2 + 2 * r * 4
                 + 2 * r * (2 * 4 + 4 * 2))
        return 2 * r * 1 * 2 + 2 * layer
    fwd = (2 * 14 * 3 + enc(4, 6) + enc(10, 12) + 2 * 4 * 6 + 2 * 10 * 2
           + 2 * 4 * 4 + 2 * 4 * 12 + 2 * 2 * 2 * 2 * 2 + 2 * 4 * 4
           + 2 * 6 * 2)
    assert counts.step_flops(cfg, st) == 3 * fwd


def test_least_seconds_takes_the_larger_bound():
    assert counts.least_seconds(10.0, 1.0, 10.0, 10.0) == (1.0, "ops")
    assert counts.least_seconds(1.0, 30.0, 10.0, 10.0) == (3.0, "bytes")
