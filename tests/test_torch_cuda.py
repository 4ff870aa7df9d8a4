"""The port's CUDA kernels on the card, at a small size: each wrapper against
its plain version, the fused GIN layer's and the graph-transformer
attention's kernel backward against autograd on the CPU, operand checks,
and short pretraining runs.  Marked ``cuda``; without a CUDA device every
test skips.  On a machine with one:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerance: rtol 1e-5 of the largest entry for the products (fp32 FMA on
0/1 operands; only the summation order differs), 1e-4 for the GIN layer's
weight gradients (sums over every row) and for the attention kernels
(exponentials and sums in another order than the plain version's)."""

import numpy as np
import pytest
import torch

from scgib_tpu_torch import cli
from scgib_tpu_torch.data.synthetic import random_dataset
from scgib_tpu_torch.graph.batching import pack_graphs, pack_subgraphs
from scgib_tpu_torch.graph.egonet import extract_egonets
from scgib_tpu_torch.models.scgib import _resolve_band
from scgib_tpu_torch.ops import pool
from scgib_tpu_torch.models import encoders
from scgib_tpu_torch.ops.kernels import banded as kb
from scgib_tpu_torch.ops.kernels import gt_flash as kg
from scgib_tpu_torch.ops.spmm_banded import gt_banded_attention

pytestmark = pytest.mark.cuda


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
    sub = pack_subgraphs(graphs, egos, 1536, 4096).to(dev)
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
    off, span = pool.window_offsets(sub.node_center, sub.node_mask, 512,
                                    128, window)
    assert bool(span <= window)
    pblocks, _ = pool.pool_blocks(sub.node_center, sub.node_mask, off, 512,
                                  128, window)
    x = torch.randn(1536, d, device=dev, generator=gen)
    close(kb.pool(pblocks, off, x), kb.spmm_plain(pblocks, off, x))
    assert kb.launch_counts() == {"gin_fwd": 2, "gin_bwd": 2,
                                  "spmm_self": 2, "spmm": 2, "pool": 1}


def test_gin_layer_kernel_backward_matches_cpu_autograd(batch, dev):
    g, _ = batch
    blocks, off = _resolve_band(g)
    rng = np.random.default_rng(0)
    arrays = [rng.normal(size=s).astype(np.float32) * c for s, c in
              (((512, 32), 1.0), ((32, 64), 0.18), ((64,), 0.1),
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
    with pytest.raises(TypeError, match="float32"):
        kb.spmm(blocks, off, torch.zeros(512, 8, device=dev,
                                         dtype=torch.float64))
    with pytest.raises(ValueError, match="CUDA device"):
        kb.spmm(blocks.cpu(), off, torch.zeros(512, 8, device=dev))
    assert kb.launch_counts()["spmm"] == 0


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
