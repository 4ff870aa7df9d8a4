"""The port's CUDA kernels on the card, at a small size: each wrapper against
its plain version, the fused GIN layer's and the graph-transformer
attention's kernel backward against autograd on the CPU, operand checks,
and short pretraining runs.  Marked ``cuda``; without a CUDA device every
test skips.  On a machine with one:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerance: rtol 1e-5 of the largest entry for the products (fp32 FMA on
0/1 operands; only the summation order differs), 1e-4 for the GIN layer's
backward (3xTF32 products, sums over every row) and for the attention
kernels (exponentials and sums in another order than the plain
version's).  The GIN forward's 3xTF32 products keep about 21 bits, inside
1e-5.  Every kernel but the merged attention backward uses no atomics, so
two runs on one card agree bitwise."""

import copy
import functools
import os

import numpy as np
import pytest
import torch

from scgib_tpu_torch import cli
from scgib_tpu_torch.data.synthetic import random_dataset
from scgib_tpu_torch.graph.batching import pack_graphs, pack_subgraphs
from scgib_tpu_torch.graph.egonet import extract_egonets
from scgib_tpu_torch.models.scgib import PretrainModel, _resolve_band
from scgib_tpu_torch.ops import pool
from scgib_tpu_torch.models import encoders
from scgib_tpu_torch.ops.kernels import banded as kb
from scgib_tpu_torch.ops.kernels import gt_flash as kg
from scgib_tpu_torch.ops.spmm_banded import gt_banded_attention
from scgib_tpu_torch.train import checkpoint, trainer
from scgib_tpu_torch.utils.params import (from_jax_variables,
                                          init_flax_style_, to_jax_variables)

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
    kb.reset_launch_counts()
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
    assert kb.launch_counts() == {"gin_fwd": 2, "gin_bwd": 2,
                                  "spmm_self": 2, "spmm": 2, "pool": 1}


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
    kb.reset_launch_counts()
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
    assert kb.launch_counts() == dict.fromkeys(kb.KERNELS, 0)


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


@pytest.mark.parametrize("width", [128, 256, 1024])
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


@pytest.mark.parametrize("width", [128, 256, 1024])
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
    kb.reset_launch_counts()
    close(kb.gin_fwd(blocks, off, *args), kb.gin_fwd_plain(blocks, off, *args))
    assert kb.launch_counts()["gin_fwd"] == 1


@pytest.mark.parametrize("width", [128, 256, 1024])
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
    kb.reset_launch_counts()
    pool.branch_counts.clear()
    records = cli.run_pretrain(synthetic=48, batch_size=16, steps=2,
                               device="cuda")
    assert all(np.isfinite(r[k]) for r in records
               for k in ("kl", "contrastive", "reconstruction"))
    counts = kb.launch_counts()
    assert counts["pool"] == pool.branch_counts["banded"]
    assert all(counts[k] > 0 for k in ("gin_fwd", "gin_bwd", "spmm_self",
                                        "spmm"))


def _gt_inputs(n, dev, seed, heads=8, hd=8):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(n, heads, hd, device=dev, generator=gen)
            for _ in range(4)]                                  # q, k, v, g


@pytest.mark.parametrize("gt", [True, False], ids=["narrow", "wide"])
def test_gt_kernels_match_plain_versions(batch, dev, gt):
    kg.reset_launch_counts()
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
    assert kg.launch_counts() == {"gt_fwd": 2, "gt_bwd_rows": 2,
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
    kg.reset_launch_counts()
    blocks, off = _resolve_band(g, gt=True)
    q, k, v, _ = _gt_inputs(g.num_nodes, dev, 0)
    with pytest.raises(TypeError, match="float32"):
        kg.gt_fwd(blocks, off, q.double(), k, v)
    with pytest.raises(ValueError, match="head width"):
        kg.gt_fwd(blocks, off, *(t.reshape(-1, 4, 16)[:, :, :12]
                                 for t in (q, k, v)))
    with pytest.raises(ValueError, match="CUDA device"):
        kg.gt_fwd(blocks.cpu(), off, q, k, v)
    assert kg.launch_counts()["gt_fwd"] == 0


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


def _steps(dev, batches, kwargs, captured):
    """Three steps from one start; (losses, state_dict, Adam state,
    generator state) on the host."""
    model = PretrainModel(9, hidden=32, d_transfer=16, num_layers=2,
                          num_heads=4, **kwargs)
    init_flax_style_(model, torch.Generator().manual_seed(1))
    model.to(dev)
    opt = trainer.adam_l2(model, 1e-3, 5e-5)
    gen = torch.Generator(device=dev).manual_seed(2)
    step = (trainer.make_pretrain_step(model, opt) if captured else
            functools.partial(trainer.pretrain_step_eager, model, opt))
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
        kb.reset_launch_counts()
        kg.reset_launch_counts()
        captured = _steps(dev, batches, kw, True)
        counts = {**kb.launch_counts(), **kg.launch_counts()}
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
    kg.reset_launch_counts()
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
    assert kg.launch_counts() == dict.fromkeys(kg.KERNELS, 0)
    # q 4 bytes past a boundary, contiguous: copied, then launched
    qs = torch.zeros(q.numel() + 1, device=dev)[1:].view(q.shape)
    qs.copy_(q)
    assert qs.data_ptr() % 16
    _gt_bwd_check(blocks, off, qs, k, v, gr)
    _gt_fwd_check(blocks, off, qs, k, v)
    assert kg.launch_counts()["gt_bwd_rows"] == 1
    assert kg.launch_counts()["gt_fwd"] == 1


@pytest.mark.parametrize("bwd", ["twopass", "merged"])
def test_gt_pretrain_steps_on_card(dev, bwd):
    kb.reset_launch_counts()
    kg.reset_launch_counts()
    encoders.branch_counts.clear()
    records = cli.run_pretrain(synthetic=48, batch_size=16, steps=2,
                               device="cuda", encoder="Transformer",
                               gt_bwd=bwd)
    assert all(np.isfinite(r[k]) for r in records
               for k in ("kl", "contrastive", "reconstruction"))
    per_call = 2 * 5 * 2             # encoders x layers x steps
    rows = per_call if bwd == "twopass" else 0
    assert kg.launch_counts() == {"gt_fwd": per_call, "gt_bwd_rows": rows,
                                  "gt_bwd_cols": rows,
                                  "gt_bwd_merged": per_call - rows}
    assert dict(encoders.branch_counts) == {"gt_band_64x128": per_call}
    assert kb.launch_counts()["gin_fwd"] == 0
    assert kb.launch_counts()["spmm"] == 2 * 2


# --- the widths the card path now serves, checkpoints and the verb ----------

@pytest.mark.parametrize("hidden", [30, 130, 160, 256])
def test_gin_at_any_width_matches_cpu(batch, dev, hidden):
    """The GIN encoder on the card against itself on the CPU, forward and
    backward: at 30 (not a multiple of 4) through the fused kernels, past
    128 through the banded SpMM with the MLP as plain products."""
    g, _ = batch
    band = _resolve_band(g)
    rng = np.random.default_rng(hidden)
    x = rng.normal(size=(512, 32)).astype(np.float32)
    ct = torch.from_numpy(rng.normal(size=(512, hidden)).astype(np.float32))
    gin = encoders.GIN(32, hidden=hidden, num_convs=2)
    runs = []
    for device in (dev, torch.device("cpu")):
        kb.reset_launch_counts()
        encoders.branch_counts.clear()
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
            counts = kb.launch_counts()
            branches = dict(encoders.branch_counts)
    for a, w in zip(*runs):
        close(a, w, rtol=1e-4)
    if hidden <= kb.MAX_FUSED_DIM:
        assert branches == {"band": 2}
        assert counts == {"gin_fwd": 2, "gin_bwd": 2, "spmm_self": 2,
                          "spmm": 0, "pool": 0}
    else:
        assert branches == {"band_spmm": 2}
        assert counts == {"gin_fwd": 0, "gin_bwd": 0, "spmm_self": 0,
                          "spmm": 4, "pool": 0}


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
    kg.reset_launch_counts()
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
    assert kg.launch_counts() == {"gt_fwd": 1, "gt_bwd_rows": rows,
                                  "gt_bwd_cols": rows,
                                  "gt_bwd_merged": 1 - rows}


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
    kb.reset_launch_counts()
    pool.branch_counts.clear()
    info = cli.main(["pretrain", "--synthetic", "48", "--batch_size", "16",
                     "--epochs", "1", "--out", str(tmp_path / "p.msgpack")])
    assert len(info["history"]) == 1 and np.isfinite(info["history"][0])
    steps = info["throughput"]["steps"]
    assert steps > 0
    assert kb.launch_counts() == {"gin_fwd": 8 * steps, "gin_bwd": 8 * steps,
                                  "spmm_self": 8 * steps, "spmm": 2 * steps,
                                  "pool": pool.branch_counts["banded"]}
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
    chip_smoke.py reads), the WIDE one without a spill."""
    from scgib_tpu_torch.ops.kernels import build
    kg.build()
    so = build._so_path("gt_flash")
    built = so.stat().st_mtime_ns
    build._libs.pop("gt_flash")
    build.logs.pop("gt_flash")
    build.load("gt_flash")
    assert so.stat().st_mtime_ns == built
    report = kg.ptxas_report()
    assert set(report) == {(k, hd) for k in kg.KERNELS
                           for hd in kg.HEAD_WIDTHS + (0,)}
    for k in kg.KERNELS:
        wide = report[k, 0]
        assert wide["spill_stores"] == wide["spill_loads"] == 0
        assert wide["registers"] == kg.kernel_info(k, 1024)["registers"]


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
        kb.reset_launch_counts()
        kg.reset_launch_counts()
        captured = _ft_steps(dev, batches, kw, accum, True)
        counts = {**kb.launch_counts(), **kg.launch_counts()}
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
