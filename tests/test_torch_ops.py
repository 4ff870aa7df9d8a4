"""PyTorch port vs the JAX package: segment ops, COO and banded SpMM, the
fused GIN layer (forward and its custom backward) and the candidate
pooling, each with the kernel wrappers' plain versions (the CPU path).

Tolerance: rtol = atol = 1e-5 in float32 (reduction order differs between
the two packages; the 0/1 block operands are exact).  Where the reference
is a Pallas kernel it runs in TPU interpret mode on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from scgib_tpu.ops import pool as jpool
from scgib_tpu.ops import segment as jseg
from scgib_tpu.ops.pallas import banded as jkb
from scgib_tpu.ops.spmm import gather_sum as jgather_sum
from scgib_tpu.ops.spmm_banded import banded_spmm as jbanded_spmm

from scgib_tpu_torch.data.synthetic import random_dataset
from scgib_tpu_torch.graph.batching import pack_graphs, pack_subgraphs
from scgib_tpu_torch.graph.egonet import extract_egonets
from scgib_tpu_torch.ops import pool, segment
from scgib_tpu_torch.ops.kernels import banded as kb
from scgib_tpu_torch.ops.spmm import gather_sum
from scgib_tpu_torch.ops.spmm_banded import banded_spmm
from scgib_tpu_torch.utils import counters

from block_counts import np_blocks

TOL = dict(rtol=1e-5, atol=1e-5)


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               **(tol or TOL))


@pytest.fixture(scope="module")
def batch():
    """(g, sub) tensor batches and their blocks: 512 graph rows (4 tiles)
    and 1536 ego-net rows (12 tiles)."""
    graphs = random_dataset(16, seed=5, min_nodes=8, max_nodes=28)
    egos = [extract_egonets(g, 1) for g in graphs]
    g = pack_graphs(graphs, 512, 2048, 16).to("cpu")
    sub = pack_subgraphs(graphs, egos, 1536, 4096).to("cpu")
    for b in (g, sub):
        b.band_blocks = kb.blocks(b.receivers, b.senders, b.edge_mask,
                                  b.band_col_off, b.node_mask.shape[0] // 128,
                                  128, 256)
    return g, sub


def jband(b):
    return (jnp.asarray(b.band_blocks.float().numpy()).astype(jnp.bfloat16),
            jnp.asarray(b.band_col_off.numpy().astype(np.int32)))


def randn(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# --- segment ops --------------------------------------------------------

@pytest.fixture(scope="module")
def seg_inputs():
    rng = np.random.default_rng(0)
    ids = np.sort(rng.integers(0, 12, size=200)).astype(np.int32)
    mask = rng.random(200) < 0.8
    data = randn(rng, 200, 7)
    return ids, mask, data


@pytest.mark.parametrize("op", ["sum", "count", "mean", "std_mean",
                                "softmax", "broadcast",
                                "broadcast_helper"])
def test_segment_ops_match(seg_inputs, op):
    ids, mask, data = seg_inputs
    S = 16     # more segments than ids: empty segments included
    ti, tm, td = t(ids).long(), t(mask), t(data)
    ji, jm, jd = jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(data)
    if op == "sum":
        close(segment.segment_sum(td, ti, S, tm),
              jseg.segment_sum(jd, ji, S, jm))
    elif op == "count":
        close(segment.segment_count(ti, S, tm), jseg.segment_count(ji, S, jm))
    elif op == "mean":
        close(segment.segment_mean(td, ti, S, tm),
              jseg.segment_mean(jd, ji, S, jm))
    elif op == "std_mean":
        for a, b in zip(segment.segment_std_mean(td, ti, S, tm),
                        jseg.segment_std_mean(jd, ji, S, jm)):
            close(a, b)
    elif op == "softmax":
        close(segment.segment_softmax(td[:, 0] * 5, ti, S, tm),
              jseg.segment_softmax(jd[:, 0] * 5, ji, S, jm))
    elif op == "broadcast":
        vals = td[:S]
        close(segment.segment_broadcast(vals, ti, S),
              jseg.segment_broadcast(jd[:S], ji, S))
    else:                      # num_segments taken from the values
        close(segment.broadcast(td[:S], ti), jseg.broadcast(jd[:S], ji))


def test_segment_sum_drops_out_of_range_ids():
    data = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    ids = torch.tensor([0, 1, 1, 3, 4, -1])
    got = segment.segment_sum(data, ids, 4)
    want = jax.ops.segment_sum(jnp.asarray(data.numpy()),
                               jnp.asarray(ids.numpy()), num_segments=4)
    close(got, want)


def test_segment_softmax_grad_matches(seg_inputs):
    ids, mask, data = seg_inputs
    w = randn(np.random.default_rng(1), 200)
    x = t(data[:, 0]).requires_grad_()
    (segment.segment_softmax(x, t(ids).long(), 16, t(mask))
     * t(w)).sum().backward()
    jg = jax.grad(lambda v: jnp.sum(jseg.segment_softmax(
        v, jnp.asarray(ids), 16, jnp.asarray(mask)) * w))(
            jnp.asarray(data[:, 0]))
    close(x.grad, jg)


# --- SpMM ---------------------------------------------------------------

def test_gather_sum_matches(batch):
    g, _ = batch
    x = randn(np.random.default_rng(2), 512, 8)
    close(gather_sum(t(x), g.senders, g.receivers, 512, g.edge_mask),
          jgather_sum(jnp.asarray(x), jnp.asarray(g.senders.numpy()),
                      jnp.asarray(g.receivers.numpy()), 512,
                      jnp.asarray(g.edge_mask.numpy())))


@pytest.mark.parametrize("which", ["graph", "sub"])
def test_banded_spmm_and_grad_match(batch, which):
    b = batch[0] if which == "graph" else batch[1]
    n = b.node_mask.shape[0]
    rng = np.random.default_rng(3)
    x, w = randn(rng, n, 16), randn(rng, n, 16)
    jb = jband(b)
    for fn, jfn in ((banded_spmm, jbanded_spmm),
                    (kb.spmm_banded_fast, jkb.spmm_banded_fast)):
        xt = t(x).requires_grad_()
        out = fn(b.band_blocks, b.band_col_off, xt)
        (out * t(w)).sum().backward()
        close(out, jfn(*jb, jnp.asarray(x)))
        close(xt.grad, jax.grad(lambda v: jnp.sum(jfn(*jb, v) * w))(
            jnp.asarray(x)))
    # the banded product equals the COO gather-sum (A is symmetric)
    close(banded_spmm(b.band_blocks, b.band_col_off, t(x)),
          gather_sum(t(x), b.senders, b.receivers, n, b.edge_mask).numpy())


def test_spmm_plain_matches_pallas_kernels(batch):
    """spmm / spmm_self plain versions vs _spmm_kernel and
    _spmm_self_kernel (via _backward_fused's stage 2), interpret mode."""
    _, sub = batch
    x = randn(np.random.default_rng(4), 1536, 32)
    jb = jband(sub)
    with pltpu.force_tpu_interpret_mode():
        want = jkb._spmm_pallas(*jb, jnp.asarray(x))
    close(kb.spmm(sub.band_blocks, sub.band_col_off, t(x)), want)
    close(kb.spmm_self(sub.band_blocks, sub.band_col_off, t(x)),
          np.asarray(want) + x)


# --- fused GIN layer ----------------------------------------------------

def gin_args(rng, n, d, hid=64):
    return (randn(rng, n, d), randn(rng, d, hid, scale=d ** -0.5),
            randn(rng, hid, scale=0.1), randn(rng, hid, hid, scale=0.125),
            randn(rng, hid, scale=0.1))


@pytest.mark.parametrize("d", [32, 64])
def test_gin_layer_forward_matches(batch, d):
    _, sub = batch
    args = gin_args(np.random.default_rng(d), 1536, d)
    out = kb.gin_banded_layer(sub.band_blocks, sub.band_col_off,
                              *map(t, args))
    jb = jband(sub)
    close(out, jkb.gin_banded_layer_reference(*jb, *map(jnp.asarray, args)))
    with pltpu.force_tpu_interpret_mode():
        want = jkb.gin_banded_layer(*jb, *map(jnp.asarray, args))
    close(out, want)


@pytest.mark.parametrize("d", [32, 64])
def test_gin_layer_backward_matches_xla_bwd(batch, d):
    """The port's custom backward (gin_bwd + spmm_self) vs the JAX
    package's ``_bwd`` XLA branch, for the same cotangent."""
    g, _ = batch
    rng = np.random.default_rng(10 + d)
    args = gin_args(rng, 512, d)
    ct = randn(rng, 512, 64)
    ts = [t(a).requires_grad_() for a in args]
    out = kb.gin_banded_layer(g.band_blocks, g.band_col_off, *ts)
    (out * t(ct)).sum().backward()
    jb = jband(g)
    want = jkb._bwd((*jb, *map(jnp.asarray, args)), jnp.asarray(ct))[2:]
    # weight gradients are sums over all 512 rows: float32 reduction
    # order alone moves them ~2e-5 relative
    for got, ref in zip(ts, want):
        close(got.grad, ref, rtol=1e-4, atol=1e-4)


def test_gin_bwd_plain_matches_fused_pallas(batch):
    """Plain stage 1 + stage 2 vs _bwd_kernel + _spmm_self_kernel
    (``_backward_fused``), interpret mode."""
    g, _ = batch
    rng = np.random.default_rng(7)
    h, w1, b1, w2, _ = gin_args(rng, 512, 32)
    ct = randn(rng, 512, 64)
    gz0, dw1, db1, dw2, db2 = kb.gin_bwd(g.band_blocks, g.band_col_off,
                                         t(h), t(ct), t(w1), t(b1), t(w2))
    dh = kb.spmm_self(g.band_blocks, g.band_col_off, gz0)
    with pltpu.force_tpu_interpret_mode():
        want = jkb._backward_fused(*jband(g), jnp.asarray(h),
                                   jnp.asarray(ct), jnp.asarray(w1),
                                   jnp.asarray(b1), jnp.asarray(w2))
    for got, ref in zip((dh, dw1, db1, dw2, db2), want):
        close(got, ref, rtol=1e-4, atol=1e-4)     # row sums, as above


# --- candidate pooling ---------------------------------------------------

def test_pool_forward_and_grad_match(batch):
    g, sub = batch
    counters.reset("pool")
    rng = np.random.default_rng(8)
    x, w = randn(rng, 1536, 16), randn(rng, 512, 16)
    xt = t(x).requires_grad_()
    out = pool.sorted_segment_sum_banded(xt, sub.node_center, 512,
                                         mask=sub.node_mask)
    (out * t(w)).sum().backward()
    assert counters.of("pool") == {"banded": 1}
    args = (jnp.asarray(sub.node_center.numpy().astype(np.int32)), 512)
    jm = jnp.asarray(sub.node_mask.numpy())
    close(out, jpool.sorted_segment_sum_banded(jnp.asarray(x), *args,
                                               mask=jm))
    close(xt.grad, jax.grad(lambda v: jnp.sum(jpool.sorted_segment_sum_banded(
        v, *args, mask=jm) * w))(jnp.asarray(x)))
    # and the exact segment sum
    close(out, segment.segment_sum(t(x), sub.node_center, 512,
                                   sub.node_mask).numpy())


def test_pool_plain_matches_pallas_kernel(batch):
    g, sub = batch
    m = sub.node_mask
    window = pool.default_window(1536, 512)
    assert pool.window_fits(sub.node_center.numpy(), m.numpy(), 512)
    off = pool.window_offsets(sub.node_center, m, 512, 128, window)
    blocks, _ = pool.pool_blocks(sub.node_center, m, off, 512, 128, window)
    x = randn(np.random.default_rng(9), 1536, 64)
    with pltpu.force_tpu_interpret_mode():
        want = jkb.pool_banded_pallas(
            jnp.asarray(blocks.float().numpy()).astype(jnp.bfloat16),
            jnp.asarray(off.numpy().astype(np.int32)), jnp.asarray(x))
    # the TPU kernel's hi/lo bf16 split keeps ~2^-17 of each summand
    close(kb.pool(blocks, off, t(x)), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("case", ["packed", "masked", "narrow_window",
                                  "shifted_window"])
def test_pool_blocks_cases_bit_equal(batch, case):
    """pool_blocks (the wrapper's plain version) == the NumPy counts, bit
    for bit, and its clipped centers == NumPy's: the packer's sub-rows,
    some real rows masked, a window of 256 that leaves rows past its end,
    and windows moved 64 rows on, which leaves rows before their start."""
    _, sub = batch
    ids, m = sub.node_center, sub.node_mask
    window = 256 if case == "narrow_window" else pool.default_window(1536,
                                                                     512)
    off = pool.window_offsets(ids, m, 512, 128, window)
    if case == "shifted_window":
        off = off + 64
    if case == "masked":     # after the offsets, which take sorted centers
        m = m & (torch.arange(m.shape[0]) % 3 != 0)
    blocks, cc_clip = pool.pool_blocks(ids, m, off, 512, 128, window)
    want_cc = np.minimum(np.where(m.numpy(), ids.numpy(), 512), 511)
    np.testing.assert_array_equal(cc_clip.numpy(), want_cc)
    want = np_blocks(want_cc, None, m.numpy(), off.numpy(), 4, 128, window)
    assert blocks.dtype == torch.bfloat16
    np.testing.assert_array_equal(blocks.float().numpy(), want)
    kept = int(want.sum())
    assert want.max() == 1
    assert (kept == int(m.sum())) == (case in ("packed", "masked"))


@pytest.mark.parametrize("fault", ["rows_int32", "src_int32", "mask_uint8",
                                   "off_int32", "off_short", "off_long"])
def test_blocks_wrapper_refuses_bad_operands(fault):
    """``kb.blocks`` raises on an index of the wrong dtype and on window
    offsets that are not one a tile, on the CPU as on the card."""
    rows = torch.arange(256, dtype=torch.int64)
    args = dict(rows=rows, src=rows.flip(0), mask=rows % 2 == 0,
                off=torch.zeros(2, dtype=torch.int64))
    kind, what = fault.split("_")
    if kind == "off" and what in ("short", "long"):
        args["off"] = torch.zeros(1 if what == "short" else 3,
                                  dtype=torch.int64)
        err = ValueError
    else:
        args[kind] = args[kind].to(getattr(torch, what))
        err = TypeError
    with pytest.raises(err, match="blocks"):
        kb.blocks(args["rows"], args["src"], args["mask"], args["off"], 2,
                  128, 256)
    ok = kb.blocks(rows, rows.flip(0), rows % 2 == 0,
                   torch.zeros(2, dtype=torch.int64), 2, 128, 256)
    assert ok.shape == (2, 128, 256) and float(ok.float().sum()) == 128


def test_pool_scatter_branch_on_skewed_batch():
    """One center tile owning more sub-rows than the window holds sends
    both packages to the scatter branch; the result is the same sum."""
    rng = np.random.default_rng(11)
    ids = np.sort(np.concatenate([rng.integers(0, 128, 700),
                                  rng.integers(128, 256, 300)]))
    ids = np.concatenate([ids, np.zeros(24, np.int64)]).astype(np.int32)
    mask = np.arange(1024) < 1000
    x = randn(rng, 1024, 8)
    counters.reset("pool")
    got = pool.sorted_segment_sum_banded(t(x), t(ids).long(), 256,
                                         mask=t(mask), window=256)
    assert counters.of("pool") == {"scatter": 1}
    close(got, jpool.sorted_segment_sum_banded(
        jnp.asarray(x), jnp.asarray(ids), 256, mask=jnp.asarray(mask),
        window=256))


# --- wrapper dispatch ------------------------------------------------------

def test_wrappers_on_cpu_take_the_plain_path_without_counting(batch):
    g, _ = batch
    counters.reset("launch")
    x = torch.randn(512, 64)
    kb.spmm(g.band_blocks, g.band_col_off, x)
    kb.spmm_self(g.band_blocks, g.band_col_off, x)
    kb.pool(g.band_blocks, g.band_col_off, x)
    assert counters.of("launch", kb.KERNELS) == dict.fromkeys(kb.KERNELS, 0)
    with pytest.raises(ValueError, match="unsupported device"):
        kb.spmm(g.band_blocks, g.band_col_off, x.to("meta"))
