"""The port's CUDA kernels on the card, at a small size: each wrapper against
its plain version, the fused GIN layer's and the graph-transformer
attention's kernel backward against autograd on the CPU, operand checks,
short pretraining runs, the captured steps (GCN and GraphSAGE, dense
ego-nets among them) and the captured evaluation against their eager
forms, the captured remat step against the plain one and the captured
data-parallel step at world size 1 over NCCL against the single step; the
GIN layer's BatchNorm -> ReLU -> row mask kernels against their plain
versions in float64 and, over two gloo ranks on the card, as sync-BN;
the block build (``kb.blocks``) bitwise against its plain version at every
cell's shapes, and replayed in a graph on new indices.
Marked ``cuda``; without a CUDA device every
test skips.  On a machine with one:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerance: rtol 1e-5 of the largest entry for the products (fp32 FMA on
0/1 operands; only the summation order differs), 1e-4 for the GIN layer's
backward (3xTF32 products, sums over every row) and for the attention
kernels (exponentials and sums in another order than the plain
version's).  The GIN forward's 3xTF32 products keep about 21 bits, inside
1e-5.  The bf16 kernels: 1e-3 of the largest entry (a float32 sum in another
order can move an operand to the next bf16 value), and the float32 kernel
on the same inputs must sit past that gate (the gate would catch a kernel
that skipped its rounding), as must the control of each single rounding
point that lies at least twice the gate from the plain version
(``gt_rounding.py``).  Every kernel but the
merged attention backward uses no atomics (the block build's add integer
counts, exact in any order), so two runs on one card agree bitwise."""

import copy
import functools
import os

import numpy as np
import pytest
import torch

from scgib_tpu_torch import cli
from scgib_tpu_torch.data.synthetic import random_dataset
from scgib_tpu_torch.graph import banded
from scgib_tpu_torch.graph.batching import pack_graphs, pack_subgraphs
from scgib_tpu_torch.graph.egonet import extract_egonets
from scgib_tpu_torch.models.scgib import PretrainModel, _resolve_band
from scgib_tpu_torch.ops import pool
from scgib_tpu_torch.models import encoders
from scgib_tpu_torch.models.layers import MaskedBatchNorm, _mask_rows
from scgib_tpu_torch.ops.kernels import banded as kb
from scgib_tpu_torch.ops.kernels import batchnorm as kbn
from scgib_tpu_torch.ops.kernels import gt_flash as kg
from scgib_tpu_torch.ops.spmm_banded import gt_banded_attention
from scgib_tpu_torch.train import checkpoint, trainer
from scgib_tpu_torch.utils import counters
from scgib_tpu_torch.utils.params import (from_jax_variables,
                                          init_flax_style_, to_jax_variables)

import bn_sync_ranks
import gin_rounding
import gt_rounding
from gin_cases import CASES as GIN_CASES
from gin_cases import case_inputs as gin_case_inputs
from gt_cases import CASES, EMPTY, WIDTHS, banded_graph, case_inputs, qkvg

pytestmark = pytest.mark.cuda

# torch's deterministic algorithms (the captured-against-eager tests) refuse
# cuBLAS products unless its workspace is fixed before the first one
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def batch(dev):
    graphs = random_dataset(16, seed=5, min_nodes=8, max_nodes=28)
    egos = [extract_egonets(g, 1) for g in graphs]
    g = pack_graphs(graphs, 512, 2048, 16).to(dev)
    sub = pack_subgraphs(graphs, egos, 1536, 4096, num_centers=512).to(dev)
    return g, sub


def close(got, want, rtol=1e-5):
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rtol * max(scale, 1.0), (err, scale)


@pytest.mark.parametrize("d", [32, 64])
def test_kernels_match_plain_versions(batch, dev, d):
    g, sub = batch
    gen = torch.Generator(device=dev).manual_seed(d)
    counters.reset("launch")
    for b in (g, sub):
        blocks, off = _resolve_band(b)
        n = blocks.shape[0] * 128
        h = torch.randn(n, d, device=dev, generator=gen)
        w1 = torch.randn(d, 64, device=dev, generator=gen) / d ** 0.5
        b1 = torch.randn(64, device=dev, generator=gen) * 0.1
        w2 = torch.randn(64, 64, device=dev, generator=gen) / 8
        b2 = torch.randn(64, device=dev, generator=gen) * 0.1
        gr = torch.randn(n, 64, device=dev, generator=gen)
        close(kb.spmm(blocks, off, h), kb.spmm_plain(blocks, off, h))
        close(kb.spmm_self(blocks, off, h),
              kb.spmm_self_plain(blocks, off, h))
        close(kb.gin_fwd(blocks, off, h, w1, b1, w2, b2),
              kb.gin_fwd_plain(blocks, off, h, w1, b1, w2, b2))
        for a, w in zip(kb.gin_bwd(blocks, off, h, gr, w1, b1, w2),
                        kb.gin_bwd_plain(blocks, off, h, gr, w1, b1, w2)):
            close(a, w, rtol=1e-4)
    window = pool.default_window(1536, 512)
    assert sub.pool_fits
    off = pool.window_offsets(sub.node_center, sub.node_mask, 512, 128,
                              window)
    pblocks, _ = pool.pool_blocks(sub.node_center, sub.node_mask, off, 512,
                                  128, window)
    x = torch.randn(1536, d, device=dev, generator=gen)
    close(kb.pool(pblocks, off, x), kb.spmm_plain(pblocks, off, x))
    assert counters.of("launch", kb.KERNELS) == {
        "gin_fwd": 2, "gin_fwd_bf16": 0, "gin_bwd": 2, "spmm_self": 2,
        "spmm": 2, "pool": 1}


@pytest.mark.parametrize("din", [32, 64])
def test_gin_layer_kernel_backward_matches_cpu_autograd(batch, dev, din):
    g, _ = batch
    blocks, off = _resolve_band(g)
    rng = np.random.default_rng(din)
    arrays = [rng.normal(size=s).astype(np.float32) * c for s, c in
              (((512, din), 1.0), ((din, 64), din ** -0.5), ((64,), 0.1),
               ((64, 64), 0.125), ((64,), 0.1))]
    ct = torch.from_numpy(rng.normal(size=(512, 64)).astype(np.float32))
    grads = []
    for device in (dev, torch.device("cpu")):
        ts = [torch.from_numpy(a).to(device).requires_grad_() for a in arrays]
        out = kb.gin_banded_layer(blocks.to(device), off.to(device), *ts)
        (out * ct.to(device)).sum().backward()
        grads.append([t.grad.cpu() for t in ts])
    for a, w in zip(*grads):
        assert torch.allclose(a, w, rtol=1e-4, atol=1e-4)


def test_wrappers_reject_what_the_kernels_do_not_take(batch, dev):
    g, _ = batch
    counters.reset("launch")
    blocks, off = _resolve_band(g)
    w1, b1, w2 = (torch.zeros(s, device=dev) for s in ((8, 64), 64, (64, 64)))
    gr = torch.zeros(512, 64, device=dev)
    with pytest.raises(TypeError, match="float32"):
        kb.spmm(blocks, off, torch.zeros(512, 8, device=dev,
                                         dtype=torch.float64))
    with pytest.raises(TypeError, match="bfloat16"):
        kb.spmm(blocks.float(), off, torch.zeros(512, 8, device=dev))
    with pytest.raises(ValueError, match="CUDA device"):
        kb.spmm(blocks.cpu(), off, torch.zeros(512, 8, device=dev))
    # contiguous, but 4 bytes past a 16-byte boundary
    shifted = torch.zeros(512 * 8 + 1, device=dev)[1:].view(512, 8)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kb.spmm(blocks, off, shifted)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kb.spmm_self(blocks, off, shifted)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kb.gin_bwd(blocks, off, shifted, gr, w1, b1, w2)
    flat = torch.zeros(blocks.numel() + 1, device=dev, dtype=torch.bfloat16)
    flat[1:] = blocks.flatten()
    with pytest.raises(ValueError, match="16-byte aligned"):
        kb.pool(flat[1:].view(blocks.shape), off,
                torch.zeros(512, 8, device=dev))
    with pytest.raises(ValueError, match="16-byte aligned"):
        kb.gin_fwd(flat[1:].view(blocks.shape), off,
                   torch.zeros(512, 8, device=dev), w1, b1, w2, b1)
    with pytest.raises(TypeError, match="float32"):
        kb.gin_bwd(blocks, off, torch.zeros(512, 8, device=dev,
                                            dtype=torch.float64),
                   gr, w1, b1, w2)
    assert counters.of("launch", kb.KERNELS) == dict.fromkeys(kb.KERNELS, 0)


def test_gin_fwd_takes_features_off_a_16_byte_boundary(batch, dev):
    """gin_fused_fwd reads h in 16-byte vectors, but its wrapper takes what
    it took before: features 4 bytes past a boundary are copied first."""
    g, _ = batch
    blocks, off = _resolve_band(g)
    rng = np.random.default_rng(2)
    h = torch.zeros(512 * 8 + 1, device=dev)[1:].view(512, 8)
    h.copy_(torch.from_numpy(rng.normal(size=(512, 8)).astype(np.float32)))
    w1, b1, w2, b2 = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                      .to(dev) for s in ((8, 64), 64, (64, 64), 64))
    assert h.data_ptr() % 16
    close(kb.gin_fwd(blocks, off, h, w1, b1, w2, b2),
          kb.gin_fwd_plain(blocks, off, h, w1, b1, w2, b2))


def _ragged_band(width, n_tiles=3, seed=0):
    """[T, 128, width] blocks with ~2% ones, some twos (repeated edges),
    an all-zero tile, a row of ones across the whole window, and window
    starts (multiples of 64) the last of which runs past T*128 rows."""
    rng = np.random.default_rng(seed + width)
    a = (rng.random((n_tiles, 128, width)) < 0.02).astype(np.float32)
    a[0, 3, ::7] += 1.0
    a[1] = 0.0
    a[2, 7, :] = 1.0
    n = n_tiles * 128
    off = [0, 64, max(0, (n - width // 2) // 64 * 64)]
    return (torch.from_numpy(a).to(torch.bfloat16),
            torch.tensor(off, dtype=torch.int64))


def _zero_padded(x, off, width):
    """x with zero rows appended to cover every window: the plain versions
    index the windows, where the kernels read rows past the end as 0."""
    rows = max(int(off.max()) + width, x.shape[0])
    return torch.cat([x, x.new_zeros(rows - x.shape[0], x.shape[1])])


def _gin_bwd_reference(blocks, off, h, g, w1, b1, w2):
    """``gin_bwd_plain`` over zero-padded windows."""
    z0 = kb.spmm_plain(blocks, off, _zero_padded(h, off, blocks.shape[2])) + h
    z1 = z0 @ w1 + b1
    gz1 = (g @ w2.T) * (z1 > 0).to(g.dtype)
    return (gz1 @ w1.T, z0.T @ gz1, gz1.sum(0), torch.relu(z1).T @ g,
            g.sum(0))


@pytest.mark.parametrize("width", [128, 256, 384, 512, 1024])
@pytest.mark.parametrize("d", [8, 32, 64, 96, 128, 160])
def test_banded_spmm_matches_plain_at_ragged_shapes(dev, d, width):
    blocks, off = (t.to(dev) for t in _ragged_band(width))
    gen = torch.Generator(device=dev).manual_seed(d)
    x = torch.randn(3 * 128, d, device=dev, generator=gen)
    data = torch.randn(1000, d, device=dev, generator=gen)
    xp, dp = _zero_padded(x, off, width), _zero_padded(data, off, width)
    close(kb.spmm(blocks, off, x), kb.spmm_plain(blocks, off, xp))
    close(kb.spmm_self(blocks, off, x), x + kb.spmm_plain(blocks, off, xp))
    close(kb.pool(blocks, off, data), kb.spmm_plain(blocks, off, dp))


@pytest.mark.parametrize("width", [128, 256, 384, 512, 1024])
@pytest.mark.parametrize("din", [8, 32, 64, 96, 128])
def test_gin_bwd_matches_plain_at_ragged_shapes(dev, din, width):
    blocks, off = (t.to(dev) for t in _ragged_band(width, seed=1))
    gen = torch.Generator(device=dev).manual_seed(din)
    for hid, dout in ((64, 64), (40, 24), (128, 96), (16, 8)):
        h = torch.randn(3 * 128, din, device=dev, generator=gen)
        w1 = torch.randn(din, hid, device=dev, generator=gen) / din ** 0.5
        b1 = torch.randn(hid, device=dev, generator=gen) * 0.1
        w2 = torch.randn(hid, dout, device=dev, generator=gen) / hid ** 0.5
        gr = torch.randn(3 * 128, dout, device=dev, generator=gen)
        for a, w in zip(kb.gin_bwd(blocks, off, h, gr, w1, b1, w2),
                        _gin_bwd_reference(blocks, off, h, gr, w1, b1, w2)):
            close(a, w, rtol=1e-4)


def _long_band(width, n_tiles, seed=0):
    """[T, 128, width] blocks with ~2% ones and windows starting a quarter
    of the width before their tile (multiples of 64, the last running past
    T*128 rows): enough row tiles that every block of ``gin_fused_bwd``
    walks several."""
    rng = np.random.default_rng(seed + width)
    a = (rng.random((n_tiles, 128, width)) < 0.02).astype(np.float32)
    off = [max(0, 128 * t - width // 4) // 64 * 64 for t in range(n_tiles)]
    return (torch.from_numpy(a).to(torch.bfloat16),
            torch.tensor(off, dtype=torch.int64))


@pytest.mark.parametrize("din,hid,dout", [(32, 64, 64), (64, 64, 64),
                                          (9, 64, 40), (96, 128, 96)])
def test_gin_bwd_pipelined_tiles_match_plain(dev, din, hid, dout):
    """400 band tiles (51,200 rows): every block of ``gin_fused_bwd``
    walks several row tiles, its producers gathering tile k while its
    consumers run the products of tile k - 1, at the narrow plan (64-row
    tiles) and the wide one (16).  h, W1 and b1 are small integers and
    halves, which keep z1 exact and never 0 (past ~10^5 rows some random
    pre-activations lie within rounding of 0, where the 3xTF32 and the
    float32 ReLU part).  Against the plain version, bitwise equal in two
    runs, the tiles and the overlapped ones counted, and ``kernel_info``'s
    rows a tile and shared bytes as the wrapper's mirror of the plan gives
    them."""
    blocks, off = (t.to(dev) for t in _long_band(384, 400, seed=2))
    n = blocks.shape[0] * blocks.shape[1]
    gen = torch.Generator(device=dev).manual_seed(din + hid)

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, device=dev, generator=gen).float()
    h, w1, b1 = ints(-3, 4, n, din), ints(-2, 3, din, hid), ints(-4, 4, hid)
    b1 = b1 + 0.5
    w2 = torch.randn(hid, dout, device=dev, generator=gen) / hid ** 0.5
    gr = torch.randn(n, dout, device=dev, generator=gen)
    counters.reset("gin_bwd")
    runs = [kb.gin_bwd(blocks, off, h, gr, w1, b1, w2) for _ in range(2)]
    for a, w in zip(runs[0], _gin_bwd_reference(blocks, off, h, gr, w1, b1,
                                                w2)):
        close(a, w, rtol=1e-4)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    grid = kb._bwd_grid(n, din, hid, dout, h.device.index)
    tiles = n // kb.bwd_tile_rows(din, hid, dout)
    assert 2 * grid < tiles
    assert counters.of("gin_bwd") == {"tiles": 2 * tiles,
                                      "overlapped": 2 * (tiles - grid)}
    info = kb.kernel_info("gin_fused_bwd", din, hid, dout)
    assert info["tile_rows"] == kb.bwd_tile_rows(din, hid, dout)
    assert info["smem_bytes"] == kb.bwd_smem_bytes(din, hid, dout)
    assert info["blocks_per_sm"] == 1 and info["threads"] == 512
    counters.reset("gin_bwd")


def _gin_fwd_reference(blocks, off, h, w1, b1, w2, b2):
    """``gin_fwd_plain`` over zero-padded windows."""
    z0 = kb.spmm_plain(blocks, off, _zero_padded(h, off, blocks.shape[2])) + h
    return torch.relu(z0 @ w1 + b1) @ w2 + b2


@pytest.mark.parametrize("case", list(GIN_CASES))
def test_gin_fwd_matches_plain_at_cases(dev, case):
    """The inputs of the CPU tests against the Pallas kernel: ragged
    widths, bands 128-1024, an empty tile, a repeated edge."""
    blocks, off, arrays = gin_case_inputs(case)
    blocks, off = blocks.to(dev), off.to(dev)
    args = [torch.from_numpy(a).to(dev) for a in arrays]
    counters.reset("launch")
    close(kb.gin_fwd(blocks, off, *args), kb.gin_fwd_plain(blocks, off, *args))
    assert counters.of("launch", kb.KERNELS)["gin_fwd"] == 1


@pytest.mark.parametrize("width", [128, 256, 384, 512, 1024])
@pytest.mark.parametrize("din", [8, 32, 64, 96, 128])
def test_gin_fwd_matches_plain_at_ragged_shapes(dev, din, width):
    """Every (hid, dout) in {8, 32, 64, 96, 128}^2 at this din, on blocks
    with an empty tile, a full row, repeated edges and windows past the
    end of h."""
    blocks, off = (t.to(dev) for t in _ragged_band(width, seed=2))
    gen = torch.Generator(device=dev).manual_seed(din + width)
    for hid in (8, 32, 64, 96, 128):
        for dout in (8, 32, 64, 96, 128):
            h = torch.randn(3 * 128, din, device=dev, generator=gen)
            w1 = torch.randn(din, hid, device=dev, generator=gen) / din ** 0.5
            b1 = torch.randn(hid, device=dev, generator=gen) * 0.1
            w2 = torch.randn(hid, dout, device=dev, generator=gen) / hid ** 0.5
            b2 = torch.randn(dout, device=dev, generator=gen) * 0.1
            close(kb.gin_fwd(blocks, off, h, w1, b1, w2, b2),
                  _gin_fwd_reference(blocks, off, h, w1, b1, w2, b2))


def _components_band(rows, width, dev, seed=0):
    """blocks and offsets at ``width`` over ``rows`` rows packed as the
    packers lay molecules out: one component after another, each a random
    tree plus 15% chords of (width - 128) / 2 nodes at most (the band's
    limit), the last rows padding; and the real edge count."""
    rng = np.random.default_rng(seed + width)
    lim = (width - 128) // 2
    s, r, at = [], [], 0
    while True:
        m = int(rng.integers(lim * 2 // 3, lim + 1))
        if at + m > rows - 128:
            break
        child = np.arange(1, m)
        parent = (rng.random(m - 1) * child).astype(np.int64)
        extra = rng.integers(0, m, size=(2, int(0.15 * m)))
        extra = extra[:, extra[0] != extra[1]]
        a = np.concatenate([child, extra[0]]) + at
        b = np.concatenate([parent, extra[1]]) + at
        s += [a, b]
        r += [b, a]
        at += m
    key = np.unique(np.concatenate(r) * rows + np.concatenate(s))
    snd = torch.from_numpy(key % rows).to(dev)
    rcv = torch.from_numpy(key // rows).to(dev)
    off = banded.device_col_off(rows, 128, width, 64, dev)
    blocks = kb.blocks(rcv, snd, None, off, rows // 128, 128, width)
    return blocks, off, len(key)


@pytest.mark.parametrize("rows,width", [(22016, 512), (401920, 384)],
                         ids=["atoms", "egonets"])
def test_kernels_at_the_wide_bands_and_the_cells_rows(dev, rows, width):
    """The wide-band cell's bands at its capacities (128 Peptides-sized
    molecules: 22016 atom rows at W = 512, 401920 rows of 3-hop ego-nets at
    W = 384): every edge kept in its window, and ``spmm``, ``spmm_self``,
    ``gin_fwd`` and ``gin_bwd`` against their plain versions.  Over 25
    million pre-activations some lie within rounding of 0 with random
    inputs, where the kernel's 3xTF32 z1 and the plain float32 one may take
    the ReLU apart; so h and W1 hold small integers and b1 halves, which
    every product keeps exact: z1 is exact and at least 1/2 from 0."""
    blocks, off, edges = _components_band(rows, width, dev)
    assert blocks.shape == (rows // 128, 128, width)
    assert int(blocks.float().sum()) == edges
    gen = torch.Generator(device=dev).manual_seed(width)

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, device=dev,
                             generator=gen).float()
    for din in (32, 64):
        h = ints(-3, 4, rows, din)
        close(kb.spmm(blocks, off, h), kb.spmm_plain(blocks, off, h))
        close(kb.spmm_self(blocks, off, h),
              kb.spmm_self_plain(blocks, off, h))
        w1 = ints(-2, 3, din, 64)
        b1 = ints(-4, 4, 64) + 0.5
        w2 = torch.randn(64, 64, device=dev, generator=gen) / 8
        b2 = torch.randn(64, device=dev, generator=gen) * 0.1
        gr = torch.randn(rows, 64, device=dev, generator=gen)
        close(kb.gin_fwd(blocks, off, h, w1, b1, w2, b2),
              kb.gin_fwd_plain(blocks, off, h, w1, b1, w2, b2))
        for a, w in zip(kb.gin_bwd(blocks, off, h, gr, w1, b1, w2),
                        kb.gin_bwd_plain(blocks, off, h, gr, w1, b1, w2)):
            close(a, w, rtol=1e-4)


def _band_items(rows, width, tile, seed, edges=None):
    """(senders, receivers, edge_mask) as the packers lay a batch out over
    ``rows`` rows: components of at most (width - tile) / 2 nodes, a tree
    plus chords each, symmetric, no edge twice; then one real edge doubled
    (the only count of 2), padding self-loops (masked) up to ``edges``
    items, and the order permuted."""
    rng = np.random.default_rng(seed)
    lim = (width - tile) // 2
    s, r, at = [], [], 0
    while True:
        m = int(rng.integers(lim // 2, lim + 1))
        if at + m > rows - tile:
            break
        child = np.arange(1, m)
        parent = (rng.random(m - 1) * child).astype(np.int64)
        extra = rng.integers(0, m, size=(2, int(0.15 * m)))
        extra = extra[:, extra[0] != extra[1]]
        a = np.concatenate([child, extra[0]]) + at
        b = np.concatenate([parent, extra[1]]) + at
        s += [a, b]
        r += [b, a]
        at += m
    key = np.unique(np.concatenate(r) * rows + np.concatenate(s))
    s, r = key % rows, key // rows       # a chord may repeat a tree edge
    s, r = np.append(s, s[0]), np.append(r, r[0])        # a doubled edge
    pad = (edges or len(s) + 64) - len(s)
    mask = np.arange(len(s) + pad) < len(s)
    s = np.concatenate([s, np.full(pad, rows - 1)])
    r = np.concatenate([r, np.full(pad, rows - 1)])
    p = rng.permutation(len(s))
    return s[p], r[p], mask[p]


# cell -> (rows, band width, tile, offsets' alignment): the Peptides cell's
# atom and 3-hop ego-net bands, the PCQM cells' (N and S of a batch of 128
# at W 256) and the graph transformer's narrow geometry
BUILD_BANDS = {"peptides-atoms": (22016, 512, 128, 64),
               "peptides-egonets": (403712, 384, 128, 64),
               "pcqm-atoms": (3072, 256, 128, 64),
               "pcqm-egonets": (9728, 256, 128, 64),
               "gt": (9728, 128, 64, 8)}
# cell -> (ego-net rows S, centers N, pooling window)
BUILD_POOLS = {"peptides": (403712, 22016, 4864),
               "pcqm": (9728, 3072, pool.default_window(9728, 3072))}


@pytest.mark.parametrize("cell", list(BUILD_BANDS))
def test_band_build_kernel_is_bitwise_the_plain_one(dev, cell):
    """``kb.blocks`` on the card (the blocks kernel) == the plain
    float32 scatter cast once, bit for bit, at each cell's band: masked
    padding, a doubled edge (a count of 2) and a permuted edge order."""
    rows, width, tile, align = BUILD_BANDS[cell]
    snd, rcv, mask = (torch.from_numpy(a).to(dev)
                      for a in _band_items(rows, width, tile, seed=rows))
    off = banded.device_col_off(rows, tile, width, align, dev)
    got = kb.blocks(rcv, snd, mask, off, rows // tile, tile, width)
    want = kb.blocks_plain(rcv, snd, mask, off, rows // tile, tile, width)
    torch.cuda.synchronize()
    assert got.shape == (rows // tile, tile, width)
    assert torch.equal(got, want)
    assert float(got.float().sum()) == int(mask.sum())
    assert float(got.float().max()) == 2         # the doubled edge alone


@pytest.mark.parametrize("cell", list(BUILD_POOLS))
def test_pool_build_kernel_is_bitwise_the_plain_one(dev, cell):
    """``pool_blocks`` on the card == the plain version, bit for bit, at
    each cell's pooling window: sorted centers, padding rows masked."""
    s_rows, centers, window = BUILD_POOLS[cell]
    rng = np.random.default_rng(s_rows)
    per = 1 + rng.poisson(0.9 * s_rows / centers - 1, size=centers)
    ids = np.repeat(np.arange(centers), per)[:s_rows]
    mask = np.arange(s_rows) < len(ids)
    ids = np.concatenate([ids, np.zeros(s_rows - len(ids), np.int64)])
    assert 0.8 * s_rows < mask.sum() < s_rows
    assert pool.window_fits(ids, mask, centers, 128, window)
    ids, mask = torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)
    off = pool.window_offsets(ids, mask, centers, 128, window)
    got, cc = pool.pool_blocks(ids, mask, off, centers, 128, window)
    want = kb.blocks_plain(cc, None, mask, off, centers // 128, 128, window)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert float(got.float().sum()) == int(mask.sum())


def test_band_build_replayed_in_a_graph_sees_the_next_batch(dev):
    """A build captured in a CUDA graph, replayed after another batch's
    indices are copied into its inputs, equals that batch's plain blocks:
    the zero pass leaves none of the first batch's counts behind."""
    rows, width, tile, align = BUILD_BANDS["pcqm-egonets"]
    first = _band_items(rows, width, tile, seed=1, edges=24000)
    second = _band_items(rows, width, tile, seed=2, edges=24000)
    bufs = [torch.from_numpy(a).to(dev) for a in first]
    off = banded.device_col_off(rows, tile, width, align, dev)

    def build():
        return kb.blocks(bufs[1], bufs[0], bufs[2], off, rows // tile, tile,
                         width)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        build()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = build()
    for items in (first, second, first):
        for buf, a in zip(bufs, items):
            buf.copy_(torch.from_numpy(a))
        graph.replay()
        want = kb.blocks_plain(bufs[1], bufs[0], bufs[2], off, rows // tile,
                               tile, width)
        torch.cuda.synchronize()
        assert torch.equal(out, want)


def test_block_builds_count_one_launch_each(dev):
    """Each build ticks one ``launch`` of ``kb.BLOCKS`` and its entries
    (kind ``blocks``); the plain version on the CPU ticks neither."""
    rows, width, tile, align = BUILD_BANDS["pcqm-atoms"]
    snd, rcv, mask = (torch.from_numpy(a).to(dev)
                      for a in _band_items(rows, width, tile, seed=3))
    off = banded.device_col_off(rows, tile, width, align, dev)
    counters.reset("launch", "blocks")
    kb.blocks(rcv, snd, mask, off, rows // tile, tile, width)
    assert counters.of("launch", [kb.BLOCKS]) == {kb.BLOCKS: 1}
    assert counters.of("blocks") == {"entries": rows * width}
    ids = torch.div(torch.arange(rows, device=dev), 4, rounding_mode="floor")
    m = torch.ones(rows, dtype=torch.bool, device=dev)
    poff = pool.window_offsets(ids, m, rows // 4, 128, 1024)
    pool.pool_blocks(ids, m, poff, rows // 4, 128, 1024)
    assert counters.of("launch", [kb.BLOCKS]) == {kb.BLOCKS: 2}
    assert counters.of("blocks") == {"entries": rows * width + rows // 4
                                     * 1024}
    kb.blocks(rcv.cpu(), snd.cpu(), mask.cpu(), off.cpu(), rows // tile,
              tile, width)
    assert counters.of("launch", [kb.BLOCKS]) == {kb.BLOCKS: 2}


def _tf32(fn):
    """``fn()`` with float32 products in TF32: the control of a 3xTF32
    kernel."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("rows,width", [(22016, 512), (401920, 384)],
                         ids=["atoms", "egonets"])
def test_products_at_the_cells_rows_on_random_inputs(dev, rows, width):
    """The 3xTF32 products of ``gin_fwd`` and ``gin_bwd`` at the wide-band
    cell's bands and rows on random inputs, beside the exact integer ones
    above: h, W1 and b1 positive keep every pre-activation at least 0.1
    from 0, so no ReLU flips, and z1 carries its rounding.  The plain
    versions in TF32 (the control) lie past the tolerances."""
    blocks, off, _ = _components_band(rows, width, dev)
    gen = torch.Generator(device=dev).manual_seed(width + 1)
    for din in (32, 64):
        h = torch.rand(rows, din, device=dev, generator=gen)
        w1 = torch.rand(din, 64, device=dev, generator=gen) / din
        b1 = 0.1 + 0.1 * torch.rand(64, device=dev, generator=gen)
        w2 = torch.randn(64, 64, device=dev, generator=gen) / 8
        b2 = torch.randn(64, device=dev, generator=gen) * 0.1
        gr = torch.randn(rows, 64, device=dev, generator=gen)
        fwd = kb.gin_fwd_plain(blocks, off, h, w1, b1, w2, b2)
        close(kb.gin_fwd(blocks, off, h, w1, b1, w2, b2), fwd)
        with pytest.raises(AssertionError):
            close(_tf32(lambda: kb.gin_fwd_plain(blocks, off, h, w1, b1,
                                                 w2, b2)), fwd)
        bwd = kb.gin_bwd_plain(blocks, off, h, gr, w1, b1, w2)
        for a, w in zip(kb.gin_bwd(blocks, off, h, gr, w1, b1, w2), bwd):
            close(a, w, rtol=1e-4)
        control = _tf32(lambda: kb.gin_bwd_plain(blocks, off, h, gr, w1, b1,
                                                 w2))
        with pytest.raises(AssertionError):     # gz0, dW1
            for a, w in zip(control[:2], bwd[:2]):
                close(a, w, rtol=1e-4)


def test_gin_fwd_is_bitwise_reproducible(batch, dev):
    _, sub = batch
    blocks, off = _resolve_band(sub)
    gen = torch.Generator(device=dev).manual_seed(12)
    n = sub.num_nodes
    args = [torch.randn(s, device=dev, generator=gen) for s in
            ((n, 64), (64, 64), 64, (64, 64), 64)]
    runs = [kb.gin_fwd(blocks, off, *args) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(*runs)


def test_spmm_and_gin_bwd_are_bitwise_reproducible(batch, dev):
    _, sub = batch
    blocks, off = _resolve_band(sub)
    gen = torch.Generator(device=dev).manual_seed(11)
    n = sub.num_nodes
    h = torch.randn(n, 64, device=dev, generator=gen)
    w1 = torch.randn(64, 64, device=dev, generator=gen) / 8
    b1 = torch.randn(64, device=dev, generator=gen) * 0.1
    w2 = torch.randn(64, 64, device=dev, generator=gen) / 8
    gr = torch.randn(n, 64, device=dev, generator=gen)
    runs = [(kb.spmm(blocks, off, h),)
            + kb.gin_bwd(blocks, off, h, gr, w1, b1, w2) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_pretrain_steps_on_card(dev):
    counters.reset("launch", "pool")
    records = cli.run_pretrain(synthetic=48, batch_size=16, steps=2,
                               device="cuda")
    assert all(np.isfinite(r[k]) for r in records
               for k in ("kl", "contrastive", "reconstruction"))
    counts = counters.of("launch", kb.KERNELS)
    assert counts["pool"] == counters.of("pool", ["banded"])["banded"]
    assert all(counts[k] > 0 for k in ("gin_fwd", "gin_bwd", "spmm_self",
                                        "spmm"))


def _gt_inputs(n, dev, seed, heads=8, hd=8):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(n, heads, hd, device=dev, generator=gen)
            for _ in range(4)]                                  # q, k, v, g


@pytest.mark.parametrize("gt", [True, False], ids=["narrow", "wide"])
def test_gt_kernels_match_plain_versions(batch, dev, gt):
    counters.reset("launch", "route")
    for seed, b in enumerate(batch):
        blocks, off = _resolve_band(b, gt=gt)
        assert blocks.shape[1:] == ((64, 128) if gt else (128, 256))
        q, k, v, g = _gt_inputs(b.num_nodes, dev, seed)
        out, z = kg.gt_fwd(blocks, off, q, k, v)
        for a, w in zip((out, z), kg.gt_fwd_plain(blocks, off, q, k, v)):
            close(a, w, rtol=1e-4)
        dq, rho = kg.gt_bwd_rows(blocks, off, q, k, v, g, z)
        for a, w in zip((dq, rho),
                        kg.gt_bwd_rows_plain(blocks, off, q, k, v, g, z)):
            close(a, w, rtol=1e-4)
        dk, dv = kg.gt_bwd_cols(blocks, off, q, k, v, g, z, rho)
        for a, w in zip((dk, dv), kg.gt_bwd_cols_plain(blocks, off, q, k, v,
                                                       g, z, rho)):
            close(a, w, rtol=1e-4)
        merged = kg.gt_bwd_merged(blocks, off, q, k, v, g, z)
        for a, w in zip(merged, kg.gt_bwd_merged_plain(blocks, off, q, k, v,
                                                       g, z)):
            close(a, w, rtol=1e-4)
        for a, w in zip(merged, (dq, dk, dv)):           # merged vs two-pass
            close(a, w, rtol=1e-4)
    assert counters.of("launch", kg.KERNELS) == {
        **dict.fromkeys(kg.KERNELS, 0), "gt_fwd": 2, "gt_bwd_rows": 2,
        "gt_bwd_cols": 2, "gt_bwd_merged": 2}


@pytest.mark.parametrize("bwd", ["twopass", "merged"])
def test_gt_attention_kernel_backward_matches_cpu_autograd(batch, dev, bwd):
    """The autograd function on the card against autograd through the
    plain ``gt_banded_attention`` on the CPU, in float64."""
    _, sub = batch
    blocks, off = _resolve_band(sub, gt=True)
    rng = np.random.default_rng(1)
    q, k, v, ct = (rng.normal(size=(sub.num_nodes, 4, 4)) for _ in range(4))
    grads = []
    for device, dtype in ((dev, torch.float32), ("cpu", torch.float64)):
        ts = [torch.from_numpy(a).to(device, dtype).requires_grad_()
              for a in (q, k, v)]
        bl, of = blocks.to(device), off.to(device)
        out = (kg.gt_flash_attention(bl, of, *ts, bwd=bwd) if device == dev
               else gt_banded_attention(bl, of, *ts))
        (out * torch.from_numpy(ct).to(device, dtype)).sum().backward()
        grads.append([out.detach().cpu().double()]
                     + [t.grad.cpu().double() for t in ts])
    for a, w in zip(*grads):
        assert torch.allclose(a, w, rtol=1e-4, atol=1e-4)


def test_gt_wrappers_reject_what_the_kernels_do_not_take(batch, dev):
    g, _ = batch
    counters.reset("launch", "route")
    blocks, off = _resolve_band(g, gt=True)
    q, k, v, _ = _gt_inputs(g.num_nodes, dev, 0)
    with pytest.raises(TypeError, match="float32"):
        kg.gt_fwd(blocks, off, q.double(), k, v)
    with pytest.raises(ValueError, match="head width"):
        kg.gt_fwd(blocks, off, *(t.reshape(-1, 4, 16)[:, :, :12]
                                 for t in (q, k, v)))
    with pytest.raises(ValueError, match="CUDA device"):
        kg.gt_fwd(blocks.cpu(), off, q, k, v)
    assert counters.of("launch", kg.KERNELS)["gt_fwd"] == 0


def _gt_bwd_check(blocks, off, q, k, v, g):
    """The two-pass kernels against their plain versions; (dq, rho, dk,
    dv) from the kernels."""
    z = kg.gt_fwd_plain(blocks, off, q, k, v)[1]
    dq, rho = kg.gt_bwd_rows(blocks, off, q, k, v, g, z)
    dq_p, rho_p = kg.gt_bwd_rows_plain(blocks, off, q, k, v, g, z)
    close(dq, dq_p, rtol=1e-4)
    close(rho, rho_p, rtol=1e-4)
    # the column pass from the plain rho, so that each pass is held alone
    dk, dv = kg.gt_bwd_cols(blocks, off, q, k, v, g, z, rho_p)
    for a, w in zip((dk, dv), kg.gt_bwd_cols_plain(blocks, off, q, k, v, g,
                                                   z, rho_p)):
        close(a, w, rtol=1e-4)
    return dq, rho, dk, dv


def _gt_fwd_check(blocks, off, q, k, v):
    """The forward kernel against its plain version; (out, z) from the
    kernel."""
    out, z = kg.gt_fwd(blocks, off, q, k, v)
    for a, w in zip((out, z), kg.gt_fwd_plain(blocks, off, q, k, v)):
        close(a, w, rtol=1e-4)
    return out, z


@pytest.mark.parametrize("case", list(CASES))
def test_gt_fwd_matches_plain_at_cases(dev, case):
    """As the backward's case test below: in the edge cases an all-zero
    row gives z = 0 and out = 0, and an entry 2 weighs its edge twice."""
    blocks, off, arrays = case_inputs(case)
    blocks, off = blocks.to(dev), off.to(dev)
    q, k, v = (torch.from_numpy(a).to(dev) for a in arrays[:3])
    outs = _gt_fwd_check(blocks, off, q, k, v)
    if CASES[case][3]:
        lo, hi = EMPTY
        for x in outs:
            assert float(x[lo:hi].abs().max()) == 0.0


@pytest.mark.parametrize("hd", kg.HEAD_WIDTHS)
@pytest.mark.parametrize("gt", [True, False], ids=["narrow", "wide"])
def test_gt_fwd_matches_plain_at_head_widths(batch, dev, gt, hd):
    """Every (H, hd) with H * hd = 64 (one head from hd = 64 on) on the N
    and S batches, and at hd = 32 also 8 heads (256 features a row: two
    passes of 128)."""
    for seed, b in enumerate(batch):
        blocks, off = _resolve_band(b, gt=gt)
        for heads in (max(1, 64 // hd),) + ((8,) if hd == 32 else ()):
            _gt_fwd_check(blocks, off, *_gt_inputs(b.num_nodes, dev, seed,
                                                   heads=heads, hd=hd)[:3])


def test_gt_fwd_is_bitwise_reproducible(batch, dev):
    _, sub = batch
    blocks, off = _resolve_band(sub, gt=True)
    q, k, v, _ = _gt_inputs(sub.num_nodes, dev, 8)
    runs = [kg.gt_fwd(blocks, off, q, k, v) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", list(CASES))
def test_gt_bwd_passes_match_plain_at_cases(dev, case):
    """The inputs of the CPU tests against the Pallas kernels: head
    layouts (4, 16), (16, 4), (2, 32) beside (8, 8), both geometries, and
    the edge cases (all-zero rows and in the narrow geometry an empty
    tile, an entry 2, scores past the clamp)."""
    blocks, off, arrays = case_inputs(case)
    blocks, off = blocks.to(dev), off.to(dev)
    q, k, v, g = (torch.from_numpy(a).to(dev) for a in arrays)
    outs = _gt_bwd_check(blocks, off, q, k, v, g)
    if CASES[case][3]:
        lo, hi = EMPTY
        for x in outs:
            assert float(x[lo:hi].abs().max()) == 0.0


@pytest.mark.parametrize("hd", kg.HEAD_WIDTHS)
@pytest.mark.parametrize("gt", [True, False], ids=["narrow", "wide"])
def test_gt_bwd_passes_match_plain_at_head_widths(batch, dev, gt, hd):
    """Every (H, hd) with H * hd = 64, the CLI's widths at hidden 64 (one
    head from hd = 64 on), on the graph (N) and ego-net (S) batches."""
    for seed, b in enumerate(batch):
        blocks, off = _resolve_band(b, gt=gt)
        _gt_bwd_check(blocks, off, *_gt_inputs(b.num_nodes, dev, seed,
                                               heads=max(1, 64 // hd),
                                               hd=hd))


@pytest.mark.parametrize("hd", kg.HEAD_WIDTHS)
@pytest.mark.parametrize("gt", [True, False], ids=["narrow", "wide"])
def test_gt_bwd_merged_matches_plain_at_head_widths(batch, dev, gt, hd):
    """The merged backward in the lane-group layout against its plain
    version and against the two-pass kernels, at every head width (one
    head from hd = 64 on), on the N and S batches."""
    for seed, b in enumerate(batch):
        blocks, off = _resolve_band(b, gt=gt)
        q, k, v, g = _gt_inputs(b.num_nodes, dev, seed, heads=max(
            1, 64 // hd), hd=hd)
        z = kg.gt_fwd_plain(blocks, off, q, k, v)[1]
        merged = kg.gt_bwd_merged(blocks, off, q, k, v, g, z)
        for a, w in zip(merged, kg.gt_bwd_merged_plain(blocks, off, q, k, v,
                                                       g, z)):
            close(a, w, rtol=1e-4)
        dq, rho = kg.gt_bwd_rows(blocks, off, q, k, v, g, z)
        for a, w in zip(merged, (dq,) + kg.gt_bwd_cols(blocks, off, q, k, v,
                                                       g, z, rho)):
            close(a, w, rtol=1e-4)


def test_attention_kernels_fit_the_registers_at_every_width(dev):
    """Every attention kernel at every head width keeps at least one block
    of 128 threads an SM, and the row pass at hd 256 no more than twice
    its registers at hd 8."""
    for kernel in ("gt_fwd", "gt_bwd_rows", "gt_bwd_cols", "gt_bwd_merged"):
        infos = {hd: kg.kernel_info(kernel, hd) for hd in kg.HEAD_WIDTHS}
        assert all(i["blocks_per_sm"] >= 1 for i in infos.values()), infos
        assert infos[256]["registers"] <= 2 * infos[8]["registers"], infos


def test_pool_without_the_flag_refuses_ids_on_the_card(batch, dev):
    _, sub = batch
    with pytest.raises(ValueError, match="pool_fits"):
        pool.sorted_segment_sum_banded(torch.zeros(1536, 8, device=dev),
                                       sub.node_center, 512,
                                       mask=sub.node_mask)


def _steps(dev, batches, kwargs, captured, remat=False, group=None):
    """Three steps from one start; (losses, state_dict, Adam state,
    generator state) on the host.  ``remat``: the captured remat step;
    ``group``: the captured data-parallel step over it."""
    model = PretrainModel(9, hidden=32, d_transfer=16, num_layers=2,
                          num_heads=4, group=group, **kwargs)
    init_flax_style_(model, torch.Generator().manual_seed(1))
    model.to(dev)
    opt = trainer.adam_l2(model, 1e-3, 5e-5)
    gen = torch.Generator(device=dev).manual_seed(2)
    if group is not None:
        from scgib_tpu_torch.parallel import dp
        step = dp.make_dp_pretrain_step(model, opt, group)
    elif captured:
        step = trainer.make_pretrain_step(model, opt, remat=remat)
    else:
        step = functools.partial(trainer.pretrain_step_eager, model, opt)
    losses = [torch.stack(list(step(g, s, gen))).cpu() for g, s in batches]
    adam = [t.cpu() for p in model.parameters()
            for t in opt.state[p].values()]
    return (losses, {k: v.cpu() for k, v in model.state_dict().items()},
            adam, gen.get_state(), step)


@pytest.mark.parametrize("encoder", ["GIN", "Transformer"])
def test_captured_step_is_the_eager_step(dev, encoder):
    """Under torch's deterministic algorithms, three captured steps (the
    first eager, then two replays of one graph) write the very bits of
    three eager steps: losses, weights, BatchNorm statistics, Adam state,
    generator state; and the launch counts are per optimizer step."""
    from scgib_tpu_torch.data.loader import (GraphDataset, batch_iterator,
                                             plan_capacities)
    ds = GraphDataset(random_dataset(48, seed=3, min_nodes=8, max_nodes=24),
                      k=1)
    caps = plan_capacities(ds, 16)
    batches = [(g.to(dev), s.to(dev)) for g, s in
               list(batch_iterator(ds, 16, caps, shuffle=False))[:3]]
    assert len({trainer.batch_key(*b) for b in batches}) == 1
    kw = {"encoder": encoder}
    torch.use_deterministic_algorithms(True)
    try:
        eager = _steps(dev, batches, kw, False)
        counters.reset("launch", "route")
        captured = _steps(dev, batches, kw, True)
        counts = counters.of("launch", kb.KERNELS + kg.KERNELS)
        bn_counts = counters.of("launch", kbn.KERNELS)
    finally:
        torch.use_deterministic_algorithms(False)
    assert len(captured[4].graphs) == 1
    for a, b in zip(eager[0], captured[0]):
        assert torch.equal(a, b)
    assert all(torch.equal(eager[1][k], captured[1][k]) for k in eager[1])
    assert all(torch.equal(a, b) for a, b in zip(eager[2], captured[2]))
    assert torch.equal(eager[3], captured[3])
    if encoder == "GIN":
        assert counts["gin_fwd"] == 3 * 4 and counts["pool"] == 3
    else:
        assert counts["gt_fwd"] == 3 * 6 and counts["gt_bwd_rows"] == 3 * 6
    # the BatchNorm -> ReLU -> row mask of each GIN conv, 2 an encoder
    assert bn_counts == dict.fromkeys(kbn.KERNELS,
                                      3 * 4 if encoder == "GIN" else 0)


def test_gt_twopass_backward_is_bitwise_reproducible(batch, dev):
    _, sub = batch
    blocks, off = _resolve_band(sub, gt=True)
    q, k, v, ct = _gt_inputs(sub.num_nodes, dev, 7)
    runs = []
    for _ in range(2):
        ts = [x.clone().requires_grad_() for x in (q, k, v)]
        (kg.gt_flash_attention(blocks, off, *ts) * ct).sum().backward()
        runs.append([x.grad for x in ts])
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_gt_bwd_passes_reject_what_they_do_not_take(batch, dev):
    """H * hd not a multiple of 4, or blocks off a 16-byte boundary, raise
    in the two passes and the forward (launch counts stay 0); features off
    a 16-byte boundary are copied and give the plain version's result."""
    g, _ = batch
    counters.reset("launch", "route")
    blocks, off = _resolve_band(g, gt=True)
    n = g.num_nodes
    q, k, v, gr = _gt_inputs(n, dev, 3, heads=3, hd=1)
    with pytest.raises(ValueError, match="multiple of 4"):
        kg.gt_fwd(blocks, off, q, k, v)
    z = kg.gt_fwd_plain(blocks, off, q, k, v)[1]
    rho = torch.zeros_like(z)
    with pytest.raises(ValueError, match="multiple of 4"):
        kg.gt_bwd_rows(blocks, off, q, k, v, gr, z)
    with pytest.raises(ValueError, match="multiple of 4"):
        kg.gt_bwd_cols(blocks, off, q, k, v, gr, z, rho)
    q, k, v, gr = _gt_inputs(n, dev, 4)
    z = kg.gt_fwd_plain(blocks, off, q, k, v)[1]
    rho = torch.zeros_like(z)
    flat = torch.zeros(blocks.numel() + 1, device=dev, dtype=torch.bfloat16)
    flat[1:] = blocks.flatten()
    shifted = flat[1:].view(blocks.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kg.gt_fwd(shifted, off, q, k, v)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kg.gt_bwd_rows(shifted, off, q, k, v, gr, z)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kg.gt_bwd_cols(shifted, off, q, k, v, gr, z, rho)
    assert counters.of("launch", kg.KERNELS) == dict.fromkeys(kg.KERNELS, 0)
    # q 4 bytes past a boundary, contiguous: copied, then launched
    qs = torch.zeros(q.numel() + 1, device=dev)[1:].view(q.shape)
    qs.copy_(q)
    assert qs.data_ptr() % 16
    _gt_bwd_check(blocks, off, qs, k, v, gr)
    _gt_fwd_check(blocks, off, qs, k, v)
    assert counters.of("launch", kg.KERNELS)["gt_bwd_rows"] == 1
    assert counters.of("launch", kg.KERNELS)["gt_fwd"] == 1


@pytest.mark.parametrize("bwd", ["twopass", "merged"])
def test_gt_pretrain_steps_on_card(dev, bwd):
    counters.reset("launch", "route", "encoder")
    records = cli.run_pretrain(synthetic=48, batch_size=16, steps=2,
                               device="cuda", encoder="Transformer",
                               gt_bwd=bwd)
    assert all(np.isfinite(r[k]) for r in records
               for k in ("kl", "contrastive", "reconstruction"))
    per_call = 2 * 5 * 2             # encoders x layers x steps
    rows = per_call if bwd == "twopass" else 0
    assert counters.of("launch", kg.KERNELS) == {
        **dict.fromkeys(kg.KERNELS, 0), "gt_fwd": per_call,
        "gt_bwd_rows": rows, "gt_bwd_cols": rows,
        "gt_bwd_merged": per_call - rows}
    assert counters.of("encoder") == {"gt_band_64x128": per_call}
    assert counters.of("launch", kb.KERNELS)["gin_fwd"] == 0
    assert counters.of("launch", kb.KERNELS)["spmm"] == 2 * 2


# --- the widths the card path now serves, checkpoints and the verb ----------

@pytest.mark.parametrize("hidden", [30, 130, 160, 256])
def test_gin_at_any_width_matches_cpu(batch, dev, hidden):
    """The GIN encoder on the card against itself on the CPU, forward and
    backward: at 30 (not a multiple of 4) through the fused kernels, past
    128 through the banded SpMM with the MLP as plain products.  The
    weights come from a seed, as x and ct do: drawn from torch's default
    generator, seeded anew in every process, about one draw in a hundred
    at widths 160 and 256 put a relu input within float32 rounding of
    zero, where the gradients of float32 and float64 on the CPU part by
    1e-3 to 7e-2 of the largest entry as well."""
    g, _ = batch
    band = _resolve_band(g)
    rng = np.random.default_rng(hidden)
    x = rng.normal(size=(512, 32)).astype(np.float32)
    ct = torch.from_numpy(rng.normal(size=(512, hidden)).astype(np.float32))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(hidden)
        gin = encoders.GIN(32, hidden=hidden, num_convs=2)
    runs = []
    for device in (dev, torch.device("cpu")):
        counters.reset("launch", "encoder")
        m = copy.deepcopy(gin).to(device)
        xt = torch.from_numpy(x).to(device).requires_grad_()
        out = m(xt, g.senders.to(device), g.receivers.to(device),
                node_mask=g.node_mask.to(device),
                edge_mask=g.edge_mask.to(device),
                band=tuple(t.to(device) for t in band))
        (out * ct.to(device)).sum().backward()
        runs.append([out.detach().cpu(), xt.grad.cpu()]
                    + [p.grad.cpu() for p in m.parameters()])
        if device == dev:
            counts = counters.of("launch", kb.KERNELS)
            branches = counters.of("encoder")
    for a, w in zip(*runs):
        close(a, w, rtol=1e-4)
    if hidden <= kb.MAX_FUSED_DIM:
        assert branches == {"band": 2}
        assert counts == {"gin_fwd": 2, "gin_fwd_bf16": 0, "gin_bwd": 2,
                          "spmm_self": 2, "spmm": 0, "pool": 0}
    else:
        assert branches == {"band_spmm": 2}
        assert counts == {"gin_fwd": 0, "gin_fwd_bf16": 0, "gin_bwd": 0,
                          "spmm_self": 0, "spmm": 4, "pool": 0}


@pytest.mark.parametrize("case,bwd", [
    (case, bwd) for case in sorted(WIDTHS) for bwd in ("twopass", "merged")])
def test_attention_at_new_head_widths_matches_cpu(dev, case, bwd):
    """``gt_flash_attention`` on the card at the head widths served since
    they were opened up (zero-padded where the kernels do not take them)
    against autograd through the plain reference in float64 on the CPU,
    with either backward."""
    heads, hd = WIDTHS[case]
    blocks, off = banded_graph("narrow")
    q, k, v, ct = qkvg(256, heads=heads, hd=hd, seed=6)
    counters.reset("launch", "route")
    grads = []
    for device, dtype in ((dev, torch.float32), ("cpu", torch.float64)):
        ts = [torch.from_numpy(a).to(device, dtype).requires_grad_()
              for a in (q, k, v)]
        bl, of = blocks.to(device), off.to(device)
        out = (kg.gt_flash_attention(bl, of, *ts, bwd=bwd) if device == dev
               else gt_banded_attention(bl, of, *ts))
        (out * torch.from_numpy(ct).to(device, dtype)).sum().backward()
        grads.append([out.detach().cpu().double()]
                     + [t.grad.cpu().double() for t in ts])
    for a, w in zip(*grads):
        assert torch.allclose(a, w, rtol=1e-4, atol=1e-4)
    rows = int(bwd == "twopass")
    assert counters.of("launch", kg.KERNELS) == {
        **dict.fromkeys(kg.KERNELS, 0), "gt_fwd": 1, "gt_bwd_rows": rows,
        "gt_bwd_cols": rows, "gt_bwd_merged": 1 - rows}


def test_checkpoint_saved_on_card_reloads_to_the_same_losses(batch, dev,
                                                             tmp_path):
    g, sub = batch
    model = PretrainModel(9, hidden=64, d_transfer=32,
                          deterministic=True).to(dev).train()
    with torch.no_grad():
        want = model(g, sub)
    path = str(tmp_path / "card.msgpack")
    checkpoint.save_checkpoint(path, to_jax_variables(model))
    variables, _ = checkpoint.load_checkpoint(path)
    again = PretrainModel(9, hidden=64, d_transfer=32, deterministic=True)
    again.load_state_dict(from_jax_variables(variables))
    with torch.no_grad():
        got = again.to(dev).train()(g, sub)
    for a, b in zip(got, want):      # segment sums add with atomics
        assert abs(float(a) - float(b)) <= 1e-6 * abs(float(b))


def test_pretrain_verb_one_epoch_on_card(dev, tmp_path):
    counters.reset("launch", "pool")
    info = cli.main(["pretrain", "--synthetic", "48", "--batch_size", "16",
                     "--epochs", "1", "--out", str(tmp_path / "p.msgpack")])
    assert len(info["history"]) == 1 and np.isfinite(info["history"][0])
    steps = info["throughput"]["steps"]
    assert steps > 0
    assert counters.of("launch", kb.KERNELS) == {
        "gin_fwd": 8 * steps, "gin_fwd_bf16": 0, "gin_bwd": 8 * steps,
        "spmm_self": 8 * steps, "spmm": 2 * steps,
        "pool": counters.of("pool", ["banded"])["banded"]}
    variables, meta = checkpoint.load_checkpoint(str(tmp_path / "p.msgpack"))
    assert meta["step"] == 0 and "core" in variables["params"]


def test_wide_head_kernels_share_one_instantiation(dev):
    """Every multiple of 512 past it runs the one WIDE instantiation: the
    same registers at hd 1024, 1536 and 4096, at least one block an SM;
    other widths past 512 are refused by the kernels."""
    for kernel in ("gt_fwd", "gt_bwd_rows", "gt_bwd_cols", "gt_bwd_merged"):
        infos = [kg.kernel_info(kernel, hd) for hd in (1024, 1536, 4096)]
        assert infos[0] == infos[1] == infos[2]
        assert infos[0]["blocks_per_sm"] >= 1
        with pytest.raises(RuntimeError):
            kg.kernel_info(kernel, 1100)


def test_attention_ptxas_report_survives_a_built_library(dev):
    """Once the library is built, loading it again builds nothing and
    still gives ptxas's report of every instantiation (which phase 2 of
    chip_smoke.py reads), the WIDE one and the staged ones without a
    spill."""
    from scgib_tpu_torch.ops.kernels import build
    kg.build()
    so = build._so_path("gt_flash")
    built = so.stat().st_mtime_ns
    build._libs.pop("gt_flash")
    build.logs.pop("gt_flash")
    build.load("gt_flash")
    assert so.stat().st_mtime_ns == built
    report = kg.ptxas_report()
    staged = {(kg.ptxas_key(k, "staged"), hd) for k in kg.STAGED
              for hd in kg.STAGED_HEAD_WIDTHS}
    assert set(report) == {(k, hd) for k in kg.KERNELS
                           for hd in kg.HEAD_WIDTHS + (0,)} | staged
    for k in kg.KERNELS:
        wide = report[k, 0]
        assert wide["spill_stores"] == wide["spill_loads"] == 0
        assert wide["registers"] == kg.kernel_info(k, 1024)["registers"]
    for key in staged:                       # the staged kernels: no spill
        assert report[key]["spill_stores"] == report[key]["spill_loads"] == 0


def _ft_steps(dev, batches, kwargs, accum, captured):
    """Steps of FinetuneModel from one start (reference freeze, BCE) over
    groups of ``accum`` batches; (losses, state_dict, Adam state,
    generator state, step) on the host."""
    from scgib_tpu_torch.models.scgib import FinetuneModel
    model = FinetuneModel(9, hidden=32, d_transfer=16, num_layers=3,
                          num_heads=4, **kwargs)
    init_flax_style_(model, torch.Generator().manual_seed(1))
    model.to(dev)
    opt = trainer.masked_adam(model, trainer.finetune_trainable_mask(model),
                              1e-3, 1e-5)
    gen = torch.Generator(device=dev).manual_seed(2)
    groups = [batches[i:i + accum] for i in range(0, len(batches), accum)]
    if captured:
        step = trainer.make_finetune_step(model, opt, "bce", accum)
        losses = [step(*(grp[0] if accum == 1 else
                         ([b[0] for b in grp], [b[1] for b in grp])), gen)
                  for grp in groups]
    else:
        step = None
        losses = [trainer.finetune_step_eager(model, opt, grp, "bce", gen)
                  for grp in groups]
    adam = [t.cpu() for group in opt.param_groups for p in group["params"]
            for t in opt.state[p].values()]
    return ([x.cpu() for x in losses],
            {k: v.cpu() for k, v in model.state_dict().items()}, adam,
            gen.get_state(), step)


@pytest.mark.parametrize("encoder,accum", [("GIN", 1), ("GIN", 2),
                                           ("Transformer", 1)])
def test_captured_finetune_step_is_the_eager_step(dev, encoder, accum):
    """Under torch's deterministic algorithms the captured fine-tuning step
    (with gradient accumulation over two batches too) writes the bits of
    the eager one: losses, weights, BatchNorm statistics of frozen and
    trained layers, the masked Adam state, the generator; one graph."""
    from scgib_tpu_torch.data.loader import (GraphDataset, batch_iterator,
                                             plan_capacities)
    ds = GraphDataset(random_dataset(80, seed=3, min_nodes=8, max_nodes=24,
                                     num_tasks=2, label_nan_frac=0.2), k=1)
    caps = plan_capacities(ds, 16)
    batches = [(g.to(dev), s.to(dev)) for g, s in
               list(batch_iterator(ds, 16, caps, shuffle=False))[:4]]
    kw = {"encoder": encoder}
    torch.use_deterministic_algorithms(True)
    try:
        eager = _ft_steps(dev, batches, kw, accum, False)
        counters.reset("launch", "route")
        captured = _ft_steps(dev, batches, kw, accum, True)
        counts = counters.of("launch", kb.KERNELS + kg.KERNELS)
    finally:
        torch.use_deterministic_algorithms(False)
    assert len(captured[4].graphs) == 1
    for a, b in zip(eager[0], captured[0]):
        assert torch.equal(a, b)
    assert all(torch.equal(eager[1][k], captured[1][k]) for k in eager[1])
    assert all(torch.equal(a, b) for a, b in zip(eager[2], captured[2]))
    assert torch.equal(eager[3], captured[3])
    if encoder == "GIN":
        assert counts["gin_bwd"] == 4 * 6 and counts["spmm"] == 0
    else:
        assert counts["gt_bwd_cols"] == 4 * 8 and counts["pool"] == 4


def test_finetune_then_eval_on_the_card(dev, tmp_path):
    out = str(tmp_path / "ft.msgpack")
    small = ["--dataset", "BACE", "--synthetic", "120", "--hidden", "32",
             "--d_transfer", "16", "--batch_size", "32"]
    run = cli.main(["finetune", "--epochs", "2", "--out", out] + small)
    got = cli.main(["eval", "--checkpoint", out, "--split", "test"] + small)
    assert abs(got["test"] - run["last"]["history"][-1][2]) <= 1e-6
    info = cli.main(["adapt", "--synthetic", "120", "--hidden", "32",
                     "--d_transfer", "16", "--batch_size", "32", "--epochs",
                     "1", "--out", str(tmp_path / "a.msgpack")])
    assert np.isfinite(info["best_loss"])


# --- GCN and GraphSAGE, dense ego-nets, the captured evaluation -------------

def _same_steps(a, b):
    assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
    assert all(torch.equal(a[1][k], b[1][k]) for k in a[1])
    assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))
    assert torch.equal(a[3], b[3])


@pytest.mark.parametrize("encoder", ["GIN", "Transformer"])
def test_captured_remat_step_is_the_captured_plain_step(dev, encoder):
    """Under torch's deterministic algorithms three captured remat steps
    write the bits of three captured plain steps, the recomputation
    launching every forward kernel again."""
    batches = _pretrain_batches(dev)
    runs = []
    torch.use_deterministic_algorithms(True)
    try:
        for remat in (False, True):
            counters.reset("launch", "route")
            runs.append((_steps(dev, batches, {"encoder": encoder}, True,
                                remat=remat),
                         counters.of("launch", kb.KERNELS + kg.KERNELS),
                         counters.of("launch", kbn.KERNELS)))
    finally:
        torch.use_deterministic_algorithms(False)
    (plain, n_plain, bn_plain), (remat, n_remat, bn_remat) = runs
    _same_steps(plain, remat)
    fwd = ("gin_fwd", "pool") if encoder == "GIN" else ("gt_fwd", "pool")
    assert {k: n_remat[k] - n_plain[k] for k in n_plain
            if n_remat[k] != n_plain[k]} == {
        **{k: n_plain[k] for k in fwd}, "spmm": n_plain["spmm"] // 2}
    # the recomputed forward runs the BatchNorm's forward kernels again,
    # with its running statistics frozen (the steps' bits say so)
    per = 3 * 4 if encoder == "GIN" else 0
    assert bn_plain == dict.fromkeys(kbn.KERNELS, per)
    assert bn_remat == {"bn_stats": 2 * per, "bn_apply": 2 * per,
                        "bn_grad_stats": per, "bn_grad_apply": per}


def test_dp_step_at_world_size_one_is_the_single_step(dev):
    """The captured data-parallel step over NCCL at world size 1 (its
    collectives inside the graph) writes the bits of the captured single
    step, under torch's deterministic algorithms."""
    import socket

    import torch.distributed as dist
    from scgib_tpu_torch.parallel import dp, multihost

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    multihost.initialize_distributed(f"tcp://127.0.0.1:{port}",
                                     world_size=1, rank=0)
    try:
        group = dp.make_mesh()
        batches = _pretrain_batches(dev)
        torch.use_deterministic_algorithms(True)
        try:
            single = _steps(dev, batches, {}, True)
            parallel = _steps(dev, batches, {}, True, group=group)
        finally:
            torch.use_deterministic_algorithms(False)
        assert len(parallel[4].graphs) == 1
        _same_steps(single, parallel)
    finally:
        dist.destroy_process_group()


def _pretrain_batches(dev, n=3):
    from scgib_tpu_torch.data.loader import (GraphDataset, batch_iterator,
                                             plan_capacities)
    ds = GraphDataset(random_dataset(48, seed=3, min_nodes=8, max_nodes=24),
                      k=1)
    caps = plan_capacities(ds, 16)
    return [(g.to(dev), s.to(dev)) for g, s in
            list(batch_iterator(ds, 16, caps, shuffle=False))[:n]]


@pytest.mark.parametrize("encoder", ["GCN", "GraphSAGE"])
def test_gcn_sage_model_on_card_matches_cpu(batch, dev, encoder):
    """Losses and gradients of PretrainModel with the encoder, card
    (banded SpMM kernel) against the CPU plain path: losses rtol 1e-4,
    gradients 1e-3 of the largest; 3 aggregations an encoder, each
    launching the kernel forward and backward, plus the reconstruction's
    2: 14 spmm launches, 1 pool."""
    g, sub = batch
    model = PretrainModel(9, hidden=32, d_transfer=16, encoder=encoder,
                          deterministic=True)
    init_flax_style_(model, torch.Generator().manual_seed(1))
    ref = copy.deepcopy(model)
    counters.reset("launch", "encoder")
    out = []
    for m, gb, sb in ((model.to(dev), g, sub),
                      (ref, g.to("cpu"), sub.to("cpu"))):
        losses = m.train()(gb, sb)
        losses.total.backward()
        out.append(([float(v.detach()) for v in losses],
                    {k: p.grad.cpu() for k, p in m.named_parameters()}))
        if m is model:
            torch.cuda.synchronize()
            counts = counters.of("launch", kb.KERNELS)
            branches = counters.of("encoder")
    assert counts == {"gin_fwd": 0, "gin_fwd_bf16": 0, "gin_bwd": 0,
                      "spmm_self": 0, "spmm": 14, "pool": 1}
    prefix = "gcn" if encoder == "GCN" else "sage"
    assert branches == {f"{prefix}_band": 6}
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-4)
    floor = 1e-3 * max(float(v.abs().max()) for v in out[1][1].values())
    for k, want in out[1][1].items():
        err = float((out[0][1][k] - want).abs().max())
        assert err <= 1e-3 * max(float(want.abs().max()), floor), k


@pytest.mark.parametrize("encoder", ["GCN", "GraphSAGE"])
def test_captured_gcn_sage_step_is_the_eager_step(dev, encoder):
    batches = _pretrain_batches(dev)
    torch.use_deterministic_algorithms(True)
    try:
        eager = _steps(dev, batches, {"encoder": encoder}, False)
        counters.reset("launch")
        captured = _steps(dev, batches, {"encoder": encoder}, True)
        counts = counters.of("launch", kb.KERNELS)
    finally:
        torch.use_deterministic_algorithms(False)
    assert len(captured[4].graphs) == 1
    for a, b in zip(eager[0], captured[0]):
        assert torch.equal(a, b)
    assert all(torch.equal(eager[1][k], captured[1][k]) for k in eager[1])
    assert all(torch.equal(a, b) for a, b in zip(eager[2], captured[2]))
    assert torch.equal(eager[3], captured[3])
    assert counts["spmm"] == 3 * 14 and counts["gin_fwd"] == 0


def test_dense_mode_captured_step_is_the_eager_step(dev):
    """Dense ego-nets: encoder1 on the fused GIN kernels (2 convs), the
    reconstruction's 2 spmm, no pool; captured bits equal eager bits."""
    from scgib_tpu_torch.graph.batching import (max_egonet_size,
                                                pack_subgraphs_dense)
    out = []
    for s in (3, 4, 5):
        graphs = random_dataset(12, seed=s, min_nodes=8, max_nodes=20)
        egos = [extract_egonets(x, 1) for x in graphs]
        out.append((pack_graphs(graphs, 256, 1024, 16).to(dev),
                    pack_subgraphs_dense(graphs, egos, 256, 16).to(dev)))
        assert max_egonet_size(egos) <= 16
    kw = {"subgraph_mode": "dense"}
    torch.use_deterministic_algorithms(True)
    try:
        eager = _steps(dev, out, kw, False)
        counters.reset("launch")
        captured = _steps(dev, out, kw, True)
        counts = counters.of("launch", kb.KERNELS)
    finally:
        torch.use_deterministic_algorithms(False)
    for a, b in zip(eager[0], captured[0]):
        assert torch.equal(a, b)
    assert all(torch.equal(eager[1][k], captured[1][k]) for k in eager[1])
    assert counts == {"gin_fwd": 3 * 2, "gin_fwd_bf16": 0, "gin_bwd": 3 * 2,
                      "spmm_self": 3 * 2, "spmm": 3 * 2, "pool": 0}
    # DenseGIN's two convs take the BatchNorm kernels as GIN's do
    assert counters.of("launch", kbn.KERNELS) == dict.fromkeys(kbn.KERNELS,
                                                               3 * 4)


@pytest.mark.parametrize("live_noise", [False, True])
@pytest.mark.parametrize("encoder", ["GIN", "GraphSAGE"])
def test_captured_eval_is_the_eager_eval(dev, encoder, live_noise):
    """Two evaluations of three batches, each from a fresh generator
    seeded 0 (as ``PackedEval`` draws them): the captured evaluation's
    scores are the eager form's bits (the first call eager, then replays,
    the second evaluation through a lent generator), the BatchNorm
    statistics and the model's mode are kept, and one graph serves."""
    from scgib_tpu_torch.models.scgib import FinetuneModel
    batches = _pretrain_batches(dev)
    model = FinetuneModel(9, hidden=32, d_transfer=16, num_layers=3,
                          encoder=encoder)
    init_flax_style_(model, torch.Generator().manual_seed(1))
    model.to(dev).train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    run = trainer.make_eval_fn(model, live_noise)
    torch.use_deterministic_algorithms(True)
    try:
        for _ in range(2):
            gen_e = torch.Generator(device=dev).manual_seed(0)
            gen_c = torch.Generator(device=dev).manual_seed(0)
            for g, s in batches:
                want = run.run([(g, s)], gen_e)
                got = run(g, s, gen_c)
                assert torch.equal(got, want)
            assert torch.equal(gen_e.get_state(), gen_c.get_state())
    finally:
        torch.use_deterministic_algorithms(False)
    assert len(run.graphs) == 1 and model.training
    assert all(torch.equal(v, before[k])
               for k, v in model.state_dict().items())


def _superbatches(dev, n_super=2, k=3):
    """``n_super`` wire superbatches of ``k`` batches of 16, prefetched
    onto the card, with their spec."""
    from scgib_tpu_torch.data import loader
    ds = loader.GraphDataset(random_dataset(16 * k * n_super + 5, seed=3,
                                            min_nodes=8, max_nodes=24), k=1)
    caps = loader.plan_capacities(ds, 16)
    spec = loader.superbatch_spec(ds, 16, caps, k)
    return spec, list(loader.prefetch_to_device(
        loader.wire_superbatches(ds, 16, caps, k, seed=4, byte_spec=spec),
        size=2, device=dev, host_stage=1))


def test_prefetch_onto_the_card_keeps_the_bytes(dev):
    """Prefetched superbatch buffers land on the card equal to the host's,
    in order, ahead of the consumer (the ring of pinned buffers reused)."""
    from scgib_tpu_torch.data import loader
    ds = loader.GraphDataset(random_dataset(200, seed=3, min_nodes=8,
                                            max_nodes=24), k=1)
    caps = loader.plan_capacities(ds, 16)
    host = list(loader.wire_superbatches(ds, 16, caps, 2, seed=4))
    got = list(loader.prefetch_to_device(iter(host), size=2, device=dev,
                                         host_stage=2))
    assert len(got) == len(host) > 4
    for (buf, edges, fits), (hbuf, hedges, hfits) in zip(got, host):
        assert buf.is_cuda and (edges, fits) == (hedges, hfits)
        assert np.array_equal(buf.cpu().numpy(), hbuf)
    batches = list(loader.prefetch_to_device(
        loader.batch_iterator(ds, 16, caps, seed=1), device=dev))
    for (g, s), (hg, hs) in zip(batches, loader.batch_iterator(
            ds, 16, caps, seed=1)):
        assert torch.equal(g.senders.cpu(), hg.to("cpu").senders)
        assert s.pool_fits is hs.pool_fits and g.node_feat.is_cuda


def test_captured_superbatch_step_is_the_single_steps(dev):
    """Under torch's deterministic algorithms, two superbatches of 3
    through the captured superbatch step (the first eager, the second a
    replay of one graph) write the very bits of 6 captured single steps
    on the same decoded batches; launches are per optimizer step."""
    from scgib_tpu_torch.graph import wire
    spec, supers = _superbatches(dev)

    def run(superbatch):
        model = PretrainModel(9, hidden=32, d_transfer=16, num_layers=2)
        init_flax_style_(model, torch.Generator().manual_seed(1))
        model.to(dev)
        opt = trainer.adam_l2(model, 1e-3, 5e-5)
        gen = torch.Generator(device=dev).manual_seed(2)
        counters.reset("launch")
        if superbatch:
            step = trainer.make_pretrain_superbatch_step(model, opt, spec)
            losses = [step(buf, fits, gen).total.cpu()
                      for buf, _, fits in supers]
        else:
            step = trainer.make_pretrain_step(model, opt)
            losses = []
            for buf, _, fits in supers:
                gs, subs = wire.unpack_bytes(buf, spec)
                for i in range(3):
                    sub = wire.from_wire_sub(wire.index_wire(subs, i))
                    sub.pool_fits = fits
                    losses.append(step(wire.from_wire_graph(
                        wire.index_wire(gs, i)), sub, gen).total.cpu())
            losses = [torch.stack(losses[:3]), torch.stack(losses[3:])]
        torch.cuda.synchronize()
        state = [v.cpu() for v in model.state_dict().values()] + [
            t.cpu() for p in model.parameters()
            for t in opt.state[p].values()]
        return (losses, state, gen.get_state(),
                counters.of("launch", kb.KERNELS), step)

    torch.use_deterministic_algorithms(True)
    try:
        single = run(False)
        sup = run(True)
    finally:
        torch.use_deterministic_algorithms(False)
    assert len(sup[4].graphs) == 1
    assert all(torch.equal(a, b) for a, b in zip(single[0], sup[0]))
    assert all(torch.equal(a, b) for a, b in zip(single[1], sup[1]))
    assert torch.equal(single[2], sup[2])
    assert sup[3] == single[3] and sup[3]["gin_fwd"] == 6 * 4


def test_superbatch_step_captures_one_graph_a_flag(dev):
    """The superbatch step's graphs are keyed by the buffer and the one
    pooling flag of its K batches: four superbatches passed with the flag
    True, False, True, False (the scatter branch is exact for batches that
    fit) capture two graphs, and every replay's losses are finite."""
    spec, supers = _superbatches(dev, n_super=4)
    model = PretrainModel(9, hidden=32, d_transfer=16, num_layers=2)
    init_flax_style_(model, torch.Generator().manual_seed(1))
    model.to(dev)
    step = trainer.make_pretrain_superbatch_step(
        model, trainer.adam_l2(model, 1e-3, 5e-5), spec)
    gen = torch.Generator(device=dev).manual_seed(2)
    for i, (buf, _, fits) in enumerate(supers):
        assert fits is True
        losses = step(buf, i % 2 == 0, gen)
        assert losses.total.shape == (3,)
        assert torch.isfinite(losses.total).all()
    assert len(step.graphs) == 2


# --- the bf16 compute modes --------------------------------------------------

BF = torch.bfloat16
BF16_GATE = 1e-3


def rel_gap(got, want):
    """The largest error over a kernel's outputs, each relative to its
    largest entry."""
    return max(float((a - b).abs().max()) / float(b.abs().max())
               for a, b in zip(got, want))


def bf16_close(got, want, f32):
    """A bf16 kernel's outputs ``got`` within ``BF16_GATE`` of its plain
    version's ``want``, and the float32 kernel's ``f32`` on the same inputs
    past it."""
    torch.cuda.synchronize()
    err, control = rel_gap(got, want), rel_gap(f32, want)
    assert err <= BF16_GATE < control, (err, control)


@pytest.mark.parametrize("case", list(GIN_CASES))
def test_gin_fwd_bf16_matches_plain_at_cases(dev, case):
    """The bf16 conv against its plain version (the same rounding points,
    float32 sums in another order: a z0 entry may round to the next bf16,
    hence 1e-3 of the largest entry, the phase 13 gate); the float32 conv
    on the unrounded operands sits past the gate."""
    blocks, off, arrays = gin_case_inputs(case)
    h, w1, b1, w2, b2 = (torch.from_numpy(a).to(dev) for a in arrays)
    blocks, off = blocks.to(dev), off.to(dev)
    args = (blocks, off, h.to(BF), w1.to(BF), b1, w2.to(BF), b2)
    counters.reset("launch")
    got = kb.gin_fwd_bf16(*args)
    assert counters.of("launch", kb.KERNELS)["gin_fwd_bf16"] == 1
    assert counters.of("launch", kb.KERNELS)["gin_fwd"] == 0
    bf16_close((got,), (kb.gin_fwd_bf16_plain(*args),),
               (kb.gin_fwd(blocks, off, h, w1, b1, w2, b2),))


def bf16_attention_checks(blocks, off, q, k, v, g):
    """The four bf16-dot kernels against their plain versions, each
    beside its float32 kernel (``bf16_close``); and each backward kernel
    past the gate from the control of every rounding point the gate can
    separate (``gt_rounding.py``)."""
    plain = kg.gt_fwd_plain(blocks, off, q, k, v, bf16_dots=True)
    out, z = kg.gt_fwd(blocks, off, q, k, v, bf16_dots=True)
    bf16_close((out, z), plain, kg.gt_fwd(blocks, off, q, k, v))
    plain = kg.gt_bwd_rows_plain(blocks, off, q, k, v, g, z, bf16_dots=True)
    dq, rho = kg.gt_bwd_rows(blocks, off, q, k, v, g, z, bf16_dots=True)
    bf16_close((dq, rho), plain, kg.gt_bwd_rows(blocks, off, q, k, v, g, z))
    cols = kg.gt_bwd_cols(blocks, off, q, k, v, g, z, rho, bf16_dots=True)
    bf16_close(cols,
               kg.gt_bwd_cols_plain(blocks, off, q, k, v, g, z, rho,
                                    bf16_dots=True),
               kg.gt_bwd_cols(blocks, off, q, k, v, g, z, rho))
    merged = kg.gt_bwd_merged(blocks, off, q, k, v, g, z, bf16_dots=True)
    bf16_close(merged,
               kg.gt_bwd_merged_plain(blocks, off, q, k, v, g, z,
                                      bf16_dots=True),
               kg.gt_bwd_merged(blocks, off, q, k, v, g, z))
    inputs = (blocks, off, q, k, v, g, z)
    for kernel, got, given in (("rows", (dq, rho), None),
                               ("cols", cols, rho), ("merged", merged, None)):
        records = gt_rounding.controls(kernel, got, inputs, BF16_GATE,
                                       rho=given)
        assert not gt_rounding.unseen(records, BF16_GATE), (kernel, records)


@pytest.mark.parametrize("case", list(CASES))
def test_gt_bf16_kernels_match_plain_at_cases(dev, case):
    blocks, off, arrays = case_inputs(case)
    blocks, off = blocks.to(dev), off.to(dev)
    q, k, v, g = (torch.from_numpy(a).to(dev) for a in arrays)
    counters.reset("launch", "route")
    bf16_attention_checks(blocks, off, q, k, v, g)
    assert counters.of("launch", kg.KERNELS) == dict.fromkeys(kg.KERNELS, 1)


@pytest.mark.parametrize("hd", kg.HEAD_WIDTHS + (1024,))
def test_gt_bf16_kernels_match_plain_at_head_widths(batch, dev, hd):
    _, sub = batch
    blocks, off = _resolve_band(sub, gt=True)
    heads = max(1, 4 // hd)
    gen = torch.Generator(device=dev).manual_seed(hd)
    q, k, v, g = (torch.randn(sub.num_nodes, heads, hd, device=dev,
                              generator=gen) for _ in range(4))
    bf16_attention_checks(blocks, off, q, k, v, g)


@pytest.mark.parametrize("encoder,mode", [
    ("GIN", {"compute_dtype": "bfloat16"}),
    ("Transformer", {"gt_bf16_dots": True, "gt_dtype": BF})],
    ids=["GIN", "Transformer"])
def test_bf16_model_on_card_matches_cpu(batch, dev, encoder, mode):
    """A bf16-mode model on the card against the same model on the CPU
    plain path (the same rounding points): losses within 1e-3."""
    g, sub = batch
    model = PretrainModel(9, hidden=32, d_transfer=16, encoder=encoder,
                          num_layers=2, num_heads=4, deterministic=True,
                          **mode)
    init_flax_style_(model, torch.Generator().manual_seed(4))
    for m in model.modules():
        if isinstance(m, encoders.GraphTransformerLayer):
            m.dropout = 0.0
    cpu = copy.deepcopy(model).train()
    with torch.no_grad():
        got = model.to(dev).train()(g, sub)
        want = cpu(g.to("cpu"), sub.to("cpu"))
    for a, b in zip(got, want):
        assert abs(float(a) - float(b)) <= 1e-3 * abs(float(b))


@pytest.mark.parametrize("encoder,mode", [
    ("GIN", {"compute_dtype": "bfloat16"}),
    ("Transformer", {"gt_bf16_dots": True, "gt_dtype": BF}),
    ("Transformer", {"gt_bf16_dots": True, "gt_bwd": "merged"})],
    ids=["GIN", "Transformer", "Transformer-merged"])
def test_bf16_pretrain_steps_on_card(dev, encoder, mode):
    """Two captured steps in each bf16 mode (the last the JAX package's
    TPU-default Transformer): only the bf16 forms launch."""
    counters.reset("launch", "route")
    records = cli.run_pretrain(synthetic=48, batch_size=16, steps=2,
                               device="cuda", encoder=encoder, **mode)
    assert all(np.isfinite(r[k]) for r in records
               for k in ("kl", "contrastive", "reconstruction"))
    counts = counters.of("launch", kb.KERNELS + kg.KERNELS)
    assert counters.of("launch", kbn.KERNELS) == dict.fromkeys(
        kbn.KERNELS, 8 * 2 if encoder == "GIN" else 0)
    if encoder == "GIN":
        assert counts["gin_fwd_bf16"] == 8 * 2 and counts["gin_fwd"] == 0
    elif mode.get("gt_bwd") == "merged":
        assert counts["gt_fwd_bf16"] == counts["gt_bwd_merged_bf16"] == \
            2 * 5 * 2
        # each launch on one route
        routes = counters.of("route", [(k, r) for k in kg.STAGED
                                       for r in kg.ROUTES])
        for name in kg.STAGED:
            assert sum(routes[name, r] for r in kg.ROUTES) == counts[name]
        assert not any(counts[k] for k in kg.KERNELS
                       if k not in ("gt_fwd_bf16", "gt_bwd_merged_bf16"))
    else:
        assert counts["gt_fwd_bf16"] == counts["gt_bwd_rows_bf16"] == \
            counts["gt_bwd_cols_bf16"] == 2 * 5 * 2
        assert counts["gt_fwd"] == counts["gt_bwd_rows"] == 0


# --- the staged routes of rows 6b and 9b -------------------------------------

@pytest.fixture
def route(request, monkeypatch):
    """The route the wrappers take: "staged" (``gt_route``'s pick) or
    "lane_group" (every wrapper on its lane-group kernel)."""
    if request.param == "lane_group":
        monkeypatch.setattr(kg, "gt_route",
                            lambda *args, **kw: kg.Route("lane_group"))
    return request.param


@pytest.mark.parametrize("route", ["staged", "lane_group"], indirect=True)
@pytest.mark.parametrize("shape", [(8, 8), (1, 64), (1, 1024)],
                         ids=["8x8", "1x64", "1x1024"])
@pytest.mark.parametrize("kernel", ["gt_fwd_bf16", "gt_bwd_merged_bf16"])
def test_gt_bf16_routes_match_plain(batch, dev, kernel, shape, route):
    """Both routes of rows 6b and 9b against their plain bf16 versions on
    the ego-net batch, the float32 kernel past the gate; the launch is
    counted on the wrapper's name and on the route it took (the staged
    route where ``gt_route`` stages the shape: not at 1 x 1024)."""
    _, sub = batch
    blocks, off = _resolve_band(sub, gt=True)
    heads, hd = shape
    gen = torch.Generator(device=dev).manual_seed(hd)
    q, k, v, g = (torch.randn(sub.num_nodes, heads, hd, device=dev,
                              generator=gen) for _ in range(4))
    counters.reset("launch", "route")
    if kernel == "gt_fwd_bf16":
        args = (blocks, off, q, k, v)
        got = kg.gt_fwd(*args, bf16_dots=True)
        bf16_close(got, kg.gt_fwd_plain(*args, bf16_dots=True),
                   kg.gt_fwd(*args))
    else:
        args = (blocks, off, q, k, v, g,
                kg.gt_fwd_plain(blocks, off, q, k, v, bf16_dots=True)[1])
        got = kg.gt_bwd_merged(*args, bf16_dots=True)
        bf16_close(got, kg.gt_bwd_merged_plain(*args, bf16_dots=True),
                   kg.gt_bwd_merged(*args))
    taken = kg.gt_route(kernel, heads, hd).name
    assert taken == ("lane_group" if route == "lane_group" or hd == 1024
                     else "staged")
    assert counters.of("launch", kg.KERNELS)[kernel] == 1
    assert counters.of("route", [(kernel, taken)])[kernel, taken] == 1


def test_staged_forward_is_the_lane_group_forward(batch, dev, monkeypatch):
    """The staged forward rounds where the lane-group one does and sums in
    the same order; only the compiler's fusing of a product into a sum
    (an FMA in one kernel, not in the other) may move a last bit: within
    1e-6 of the largest entry (measured 1e-8 on z)."""
    _, sub = batch
    blocks, off = _resolve_band(sub, gt=True)
    q, k, v, _ = _gt_inputs(sub.num_nodes, dev, 15)
    staged = kg.gt_fwd(blocks, off, q, k, v, bf16_dots=True)
    monkeypatch.setattr(kg, "gt_route",
                        lambda *args, **kw: kg.Route("lane_group"))
    lane = kg.gt_fwd(blocks, off, q, k, v, bf16_dots=True)
    torch.cuda.synchronize()
    assert rel_gap(staged, lane) <= 1e-6


@pytest.mark.parametrize("route", ["staged", "lane_group"], indirect=True)
@pytest.mark.parametrize("shape", [(8, 8), (1, 64)], ids=["8x8", "1x64"])
def test_crafted_inputs_hold_the_kernels_past_each_control(dev, shape,
                                                           route):
    """On ``gt_rounding.separating_inputs`` the controls that random inputs
    leave within twice the gate (v and w before out; dS before dk, w
    before dv) lie far from the plain version: each kernel on its route
    within the gate of its plain version and past it from every control
    at least twice the gate away."""
    heads, hd = shape
    ins = [x.to(dev) for x in gt_rounding.separating_inputs("fwd", heads,
                                                            hd)]
    got = kg.gt_fwd(*ins, bf16_dots=True)
    bf16_close(got, kg.gt_fwd_plain(*ins, bf16_dots=True), kg.gt_fwd(*ins))
    records = gt_rounding.controls("fwd", got, ins, BF16_GATE)
    assert records["v"][2] and records["w before out"][2], records
    assert not gt_rounding.unseen(records, BF16_GATE), records
    ins = [x.to(dev) for x in gt_rounding.separating_inputs("merged", heads,
                                                            hd)]
    ins.append(kg.gt_fwd_plain(*ins[:5], bf16_dots=True)[1])
    got = kg.gt_bwd_merged(*ins, bf16_dots=True)
    bf16_close(got, kg.gt_bwd_merged_plain(*ins, bf16_dots=True),
               kg.gt_bwd_merged(*ins))
    records = gt_rounding.controls("merged", got, ins, BF16_GATE)
    assert records["dS before dk"][2] and records["w before dv"][2], records
    assert not gt_rounding.unseen(records, BF16_GATE), records


@pytest.mark.parametrize("shape", [(8, 8), (1, 64)], ids=["8x8", "1x64"])
@pytest.mark.parametrize("kernel", sorted(kg.STAGED))
def test_staged_kernel_info_reports_its_route(dev, kernel, shape):
    """``kernel_info`` at a staged shape: the route, its blocks a tile and
    threads, and the shared memory ``gt_route`` computed (none static),
    at least one block an SM."""
    heads, hd = shape
    route = kg.gt_route(kernel, heads, hd)
    info = kg.kernel_info(kernel, hd, heads)
    assert info["route"] == route.name == "staged"
    assert (info["blocks_per_tile"], info["threads"]) == (route.split,
                                                          route.threads)
    assert info["smem_bytes"] == route.smem_bytes
    assert info["blocks_per_sm"] >= 1
    assert kg.kernel_info(kernel, hd)["route"] == "lane_group"


def test_staged_launch_refuses_a_shape_it_does_not_take(batch, dev,
                                                        monkeypatch):
    """A staged launch at a shape whose block does not fit (one head of
    1024) raises, and counts nothing: no route gives way to another."""
    _, sub = batch
    blocks, off = _resolve_band(sub, gt=True)
    q, k, v, _ = _gt_inputs(sub.num_nodes, dev, 16, heads=1, hd=1024)
    monkeypatch.setattr(kg, "gt_route", lambda *args, **kw: kg.Route(
        "staged", 1, 512, kg.SMEM_LIMIT))
    counters.reset("launch", "route")
    with pytest.raises(RuntimeError, match="CUDA error"):
        kg.gt_fwd(blocks, off, q, k, v, bf16_dots=True)
    assert counters.of("launch", kg.KERNELS)["gt_fwd_bf16"] == 0
    assert not any(counters.of("route").values())


@pytest.mark.parametrize("kernel", sorted(kg.STAGED))
def test_staged_kernels_keep_every_nonzero_of_dense_rows(dev, kernel):
    """Rows of 29-57 nonzeros, far past the KEEP exponentials the staged
    forward holds in registers (the rest go through its spill) and the NG
    terms the merged pass keeps: both staged kernels against their plain
    versions, on the staged route."""
    n = 256
    u, v = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    keep = np.abs(u - v) <= 28
    b = banded.pack_banded(u[keep].astype(np.int32), v[keep].astype(np.int32),
                           None, n, tile=64, band=128, align=8)
    blocks = torch.from_numpy(b.blocks).to(torch.bfloat16).to(dev)
    off = torch.from_numpy(b.col_off.astype(np.int64)).to(dev)
    assert int((blocks != 0).sum(-1).max()) > 50
    q, k, v, g = _gt_inputs(n, dev, 17)
    assert kg.gt_route(kernel, 8, 8).name == "staged"
    if kernel == "gt_fwd_bf16":
        bf16_close(kg.gt_fwd(blocks, off, q, k, v, bf16_dots=True),
                   kg.gt_fwd_plain(blocks, off, q, k, v, bf16_dots=True),
                   kg.gt_fwd(blocks, off, q, k, v))
    else:
        z = kg.gt_fwd_plain(blocks, off, q, k, v, bf16_dots=True)[1]
        args = (blocks, off, q, k, v, g, z)
        bf16_close(kg.gt_bwd_merged(*args, bf16_dots=True),
                   kg.gt_bwd_merged_plain(*args, bf16_dots=True),
                   kg.gt_bwd_merged(*args))


# --- row 1b: the bf16 conv's kernel ------------------------------------------

def _gin_bf16_inputs(n, d, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(n, d, device=dev, generator=gen)
    w1 = torch.randn(d, d, device=dev, generator=gen) / d ** 0.5
    w2 = torch.randn(d, d, device=dev, generator=gen) / d ** 0.5
    b1, b2 = (torch.randn(d, device=dev, generator=gen) * 0.1
              for _ in range(2))
    return h, w1, b1, w2, b2


@pytest.mark.parametrize("d", [9, 16, 64, 128])
def test_gin_fwd_bf16_matches_plain(batch, dev, d):
    """``gin_fused_fwd_bf16`` against the plain bf16 conv on the ego-net
    batch at widths 9 (the atoms' own, one value a lane in two pieces), 16,
    64 and 128 (the NT = 4 plan), within 1e-3 of the largest entry, the
    float32 kernel past it; one launch counted."""
    _, sub = batch
    blocks, off = _resolve_band(sub)
    h, w1, b1, w2, b2 = _gin_bf16_inputs(sub.num_nodes, d, dev, d)
    args = (blocks, off, h.to(BF), w1.to(BF), b1, w2.to(BF), b2)
    counters.reset("launch")
    got = kb.gin_fwd_bf16(*args)
    assert counters.of("launch", kb.KERNELS)["gin_fwd_bf16"] == 1
    bf16_close((got,), (kb.gin_fwd_bf16_plain(*args),),
               (kb.gin_fwd(blocks, off, h, w1, b1, w2, b2),))


@pytest.mark.parametrize("din", [9, 64])
def test_gin_crafted_inputs_hold_the_kernel_past_each_control(dev, din):
    """On ``gin_rounding.separating_inputs`` both controls (z0 and
    relu(z1) left unrounded) lie 1/32 of the largest entry from the plain
    version: the kernel within the gate of the plain version and past it
    from both."""
    ins = [x.to(dev) for x in gin_rounding.separating_inputs(din, 64, 64)]
    got = kb.gin_fwd_bf16(*ins)
    torch.cuda.synchronize()
    assert rel_gap((got,), (kb.gin_fwd_bf16_plain(*ins),)) <= BF16_GATE
    records = gin_rounding.controls(got, ins, BF16_GATE)
    assert all(sep for _, _, sep in records.values()), records
    assert not gin_rounding.unseen(records, BF16_GATE), records


@pytest.mark.parametrize("d", [9, 64, 128])
def test_gin_kernel_info_reports_its_route(dev, d):
    """``kernel_info`` of the bf16 conv names ``gin_route``'s
    instantiation; its bf16 shared memory is less than the float32
    kernel's at the same widths, with at least as many blocks an SM."""
    new = kb.kernel_info("gin_fused_fwd_bf16", d, d, d)
    f32 = kb.kernel_info("gin_fused_fwd", d, d, d)
    assert new["route"] == kb.gin_route(d, d, d)
    assert new["smem_bytes"] < f32["smem_bytes"]
    assert new["blocks_per_sm"] >= f32["blocks_per_sm"] >= 1


# --- the GIN layer's BatchNorm -> ReLU -> row mask (ops/kernels/batchnorm.py)

BN_SHAPES = {"3072x64": (3072, 64, True), "9728x64": (9728, 64, True),
             "9728x64 no mask": (9728, 64, False),
             "3072x30": (3072, 30, True), "3072x256": (3072, 256, True)}
BN_RTOL = 1e-6      # float32 results of float64 sums, against float64


def _bn_inputs(n, f, masked, dev, seed):
    """x (offset from 0, as a conv's output is), dy, the mask (~80% kept or
    None) and a module's scale, bias and running statistics."""
    gen = torch.Generator().manual_seed(seed)
    x = 1.5 + torch.randn(n, f, generator=gen)
    dy = torch.randn(n, f, generator=gen)
    mask = torch.rand(n, generator=gen) < 0.8 if masked else None
    params = (1 + 0.3 * torch.randn(f, generator=gen),
              0.2 * torch.randn(f, generator=gen),
              0.5 * torch.randn(f, generator=gen),
              0.5 + torch.rand(f, generator=gen))
    return [None if t is None else t.to(dev)
            for t in (x, dy, mask) + params]


def _rel(got, want):
    torch.cuda.synchronize()
    return float((got.double() - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("shape", list(BN_SHAPES))
def test_bn_kernels_match_float64_plain(dev, shape, mode):
    """Each of the four kernels against its plain version in float64 on
    the same inputs (the backward's on the forward kernel's own
    coefficients, so the relu gate is the same): the totals to 1e-12, the
    rest within float32 rounding (``BN_RTOL`` of the largest entry); in
    train mode the float32 composed ops (``MaskedBatchNorm`` then relu and
    the row mask) read farther from float64 than the kernels, the control
    of that tolerance.  One launch each, the same bits twice."""
    n, f, masked = BN_SHAPES[shape]
    x, dy, mask, scale, bias, rmean, rvar = _bn_inputs(n, f, masked, dev, n)
    d = (lambda t: None if t is None else t.double())
    counters.reset("launch")
    totals = None
    if mode == "train":
        totals = kbn.bn_stats(x, mask)
        assert torch.equal(totals, kbn.bn_stats(x, mask))
        assert _rel(totals, kbn.bn_stats_plain(d(x), mask)) <= 1e-12
    run = (rmean.clone(), rvar.clone())
    y, stats = kbn.bn_apply(x, mask, totals, scale, bias, *run, update=True)
    run64 = (d(rmean), d(rvar))
    y64, stats64 = kbn.bn_apply_plain(d(x), mask, totals, d(scale), d(bias),
                                      *run64, update=True)
    err = _rel(y, y64)
    assert err <= BN_RTOL
    for k in range(4):                          # a, c, mean, rsqrt
        assert _rel(stats[k], stats64[k]) <= BN_RTOL, kbn.STATS[k]
    assert torch.equal(stats[4].double(), stats64[4])
    for got, want in zip(run, run64):
        assert _rel(got, want) <= BN_RTOL
    if mode == "train":
        bn = MaskedBatchNorm(f).to(dev)
        with torch.no_grad():
            for t, v in ((bn.scale, scale), (bn.bias, bias),
                         (bn.mean, rmean), (bn.var, rvar)):
                t.copy_(v)
            control = _mask_rows(torch.relu(bn(x, mask)), mask)
        assert err < _rel(control, y64), (err, _rel(control, y64))
    grads = kbn.bn_grad_stats(dy, x, mask, stats, totals, scale)
    want = kbn.bn_grad_stats_plain(d(dy), d(x), mask, d(stats), totals,
                                   d(scale))
    for name, a, b in zip(("dscale", "dbias", "terms"), grads, want):
        assert _rel(a, b) <= BN_RTOL, name
    dx = kbn.bn_grad_apply(dy, x, mask, stats, grads[2])
    assert _rel(dx, kbn.bn_grad_apply_plain(d(dy), d(x), mask, d(stats),
                                            d(grads[2]))) <= BN_RTOL
    assert torch.equal(dx, kbn.bn_grad_apply(dy, x, mask, stats, grads[2]))
    if masked:
        assert not y[~mask].any() and not dx[~mask].any()
    assert counters.of("launch", kbn.KERNELS) == {
        "bn_stats": 2 if mode == "train" else 0, "bn_apply": 1,
        "bn_grad_stats": 1, "bn_grad_apply": 2}


def test_bn_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.randn(64, 8, device=dev)
    with pytest.raises(TypeError):
        kbn.bn_stats(x.double(), None)
    with pytest.raises(ValueError):
        kbn.bn_stats(x, torch.ones(63, dtype=torch.bool, device=dev))
    with pytest.raises(ValueError):
        kbn.bn_apply(x, None, None, torch.ones(7, device=dev),
                     torch.zeros(8, device=dev), torch.zeros(8, device=dev),
                     torch.ones(8, device=dev))


def test_sync_bn_over_two_gloo_ranks_on_the_card(dev, tmp_path):
    """Two gloo ranks on the one card, each with half of a batch, one
    sync-BN group: the kernels give the float64 composed ops' outputs, dx
    and running statistics, each rank's own dscale and dbias, and summed
    over the ranks the union batch's (``bn_sync_ranks.py``)."""
    worst = bn_sync_ranks.gaps(bn_sync_ranks.spawn(tmp_path, "cuda"))
    assert max(worst.values()) <= 1e-5, worst
