"""The GIN layer's BatchNorm -> ReLU -> row mask as one operation
(``scgib_tpu_torch/ops/kernels/batchnorm.py``), on the CPU.

``masked_bn_relu`` over the four kernels' plain versions (the kernels'
formulas: statistics, apply, the backward's column sums and dx) is held to
``MaskedBatchNorm``'s composed ops, then relu and the row mask, by
autograd, in float64: outputs, the gradients of x, scale and bias, and the
running statistics, with the mask given and absent, in train, frozen and
eval modes, at widths 30, 64 and 256.  The module's own ``normalize_relu``
is those composed ops on the CPU.  The step's tally routes the four
kernels' launches to their module; a GIN pretraining step runs the
operation once a conv, 8 times, and a Transformer step never.  The card
tests are in ``test_torch_cuda.py``.  This file imports neither JAX nor
the JAX package.
"""

import copy
import functools

import pytest
import torch

from scgib_tpu_torch.data.synthetic import random_dataset
from scgib_tpu_torch.graph.batching import pack_graphs, pack_subgraphs
from scgib_tpu_torch.graph.egonet import extract_egonets
from scgib_tpu_torch.models.layers import MaskedBatchNorm, _mask_rows
from scgib_tpu_torch.models.scgib import PretrainModel
from scgib_tpu_torch.ops.kernels import batchnorm as kbn
from scgib_tpu_torch.train import trainer
from scgib_tpu_torch.utils import counters

import bn_sync_ranks

MODES = ("train", "frozen", "eval")


def _module(f, seed, dtype=torch.float64):
    gen = torch.Generator().manual_seed(seed)
    bn = MaskedBatchNorm(f).to(dtype)
    with torch.no_grad():
        bn.scale.copy_(1 + 0.3 * torch.randn(f, generator=gen))
        bn.bias.copy_(0.2 * torch.randn(f, generator=gen))
        bn.mean.copy_(0.5 * torch.randn(f, generator=gen))
        bn.var.copy_(0.5 + torch.rand(f, generator=gen))
    return bn


def _inputs(n, f, seed, masked, dtype=torch.float64):
    gen = torch.Generator().manual_seed(seed)
    x = 1.5 + torch.randn(n, f, generator=gen, dtype=dtype)
    ct = torch.randn(n, f, generator=gen, dtype=dtype)
    mask = torch.rand(n, generator=gen) < 0.8 if masked else None
    return x, ct, mask


def _run(bn, x, ct, mask, mode, op):
    """op's output and the gradients of x, scale and bias under loss
    sum(out * ct), and the running statistics after it."""
    bn.train(mode != "eval")
    bn.frozen = mode == "frozen"
    x = x.clone().requires_grad_()
    out = op(bn, x, mask)
    (out * ct).sum().backward()
    return [out.detach(), x.grad, bn.scale.grad, bn.bias.grad,
            bn.mean.clone(), bn.var.clone()]


def _composed(bn, x, mask):
    return _mask_rows(torch.relu(bn(x, mask)), mask)


def _fused(bn, x, mask):
    return kbn.masked_bn_relu(x, mask, bn.scale, bn.bias, bn.mean, bn.var,
                              training=bn.training, update=not bn.frozen,
                              momentum=bn.momentum, eps=bn.eps)


@pytest.mark.parametrize("f", [30, 64, 256])
@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no_mask"])
@pytest.mark.parametrize("mode", MODES)
def test_masked_bn_relu_is_the_composed_module(f, masked, mode):
    """The four plain kernels behind the autograd function against
    autograd through the composed ops, in float64: every quantity to 1e-10
    of its largest entry; the running statistics moved only in train mode;
    ``normalize_relu`` on the CPU gives the composed ops' bits."""
    bn = _module(f, seed=f)
    x, ct, mask = _inputs(200, f, seed=f + 1, masked=masked)
    want = _run(copy.deepcopy(bn), x, ct, mask, mode, _composed)
    got = _run(copy.deepcopy(bn), x, ct, mask, mode, _fused)
    for name, a, b in zip(("y", "dx", "dscale", "dbias", "mean", "var"),
                          got, want):
        err = float((a - b).abs().max())
        assert err <= 1e-10 * max(float(b.abs().max()), 1.0), (name, err)
    moved = not torch.equal(want[4], bn.mean)
    assert moved == (mode == "train")
    assert torch.equal(want[0], _run(copy.deepcopy(bn), x, ct, mask, mode,
                                     MaskedBatchNorm.normalize_relu)[0])
    if masked:
        assert not got[0][~mask].any() and not got[1][~mask].any()


def test_plain_kernels_keep_float32_coefficients_and_the_clamp():
    """In float32 the kernels' coefficients a and c are float32, the sums
    float64: a constant column (variance 0 in exact arithmetic, a rounding
    residue either side of it) reads var 0, its clamp passing exactly where
    the residue is not negative, and the output stays within float32
    rounding of the composed ops."""
    f = 8
    bn = _module(f, seed=3, dtype=torch.float32)
    x, _, mask = _inputs(64, f, seed=4, masked=True, dtype=torch.float32)
    x[:, 0] = 0.1
    totals = kbn.bn_stats(x, mask)
    assert totals.dtype == torch.float64
    assert float(totals[2 * f]) == float(mask.sum())
    with torch.no_grad():
        y, stats = kbn.bn_apply(x, mask, totals, bn.scale, bn.bias, bn.mean,
                                bn.var)
    a, c, mean, r, passed = stats
    count = totals[2 * f]
    residue = totals[f] / count - (totals[0] / count) ** 2
    assert stats.dtype == torch.float32
    assert float(passed[0]) == float(residue >= 0)
    assert abs(float(r[0]) - 1e-5 ** -0.5) <= 1e-6 * float(r[0])
    bn.train()
    with torch.no_grad():
        want = _composed(bn, x, mask)
    assert float((y - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_tally_routes_each_kernel_to_its_module():
    before = counters.snapshot()
    diff = {("launch", name): i + 1 for i, name in enumerate(kbn.KERNELS)}
    diff[("launch", "gin_fwd")] = 5
    counters.add(diff)
    after = counters.snapshot()
    assert {k: after[k] - before.get(k, 0) for k in diff} == diff
    assert counters.of("launch", kbn.KERNELS) == {
        name: before.get(("launch", name), 0) + i + 1
        for i, name in enumerate(kbn.KERNELS)}
    counters.add(diff, -1)
    assert counters.snapshot() == before


def _counted(name, x):
    """The card's dispatch, played on the CPU: every kernel wrapper counts
    a launch and runs its plain version; the module takes the kernels'
    path."""
    if name in kbn.KERNELS:
        counters.tick("launch", name)
    return name == "masked_bn_relu"


@functools.lru_cache(maxsize=None)
def _batch():
    graphs = random_dataset(16, seed=5, min_nodes=8, max_nodes=28)
    egos = [extract_egonets(g, 1) for g in graphs]
    return (pack_graphs(graphs, 512, 2048, 16).to("cpu"),
            pack_subgraphs(graphs, egos, 1536, 4096,
                           num_centers=512).to("cpu"))


@pytest.mark.parametrize("encoder,per_step", [("GIN", 8), ("Transformer", 0)])
def test_a_pretraining_step_ticks_each_kernel_once_a_conv(monkeypatch,
                                                          encoder, per_step):
    """With the card's dispatch played on the CPU, one pretraining step
    (two encoders of 4 layers) launches each of the four kernels once a
    GIN conv, forward and backward: 8; the Transformer none.  The step's
    losses are the composed path's, to float32 rounding (seeded weights:
    the KL's 1 / std amplifies it)."""
    g, sub = _batch()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(7)
        model = PretrainModel(9, hidden=16, d_transfer=8, encoder=encoder,
                              deterministic=True)
    plain = copy.deepcopy(model)
    counters.reset("launch")
    monkeypatch.setattr(kbn, "on_card", _counted)
    losses = trainer.pretrain_step_eager(
        model, trainer.adam_l2(model, 1e-4), g, sub,
        torch.Generator().manual_seed(1))
    assert counters.of("launch", kbn.KERNELS) == dict.fromkeys(kbn.KERNELS,
                                                               per_step)
    assert {k: v for (kind, k), v in counters.snapshot().items()
            if kind == "launch" and k in kbn.KERNELS} == {
                k: v for k, v in counters.of("launch", kbn.KERNELS).items()
                if v}
    monkeypatch.undo()
    want = trainer.pretrain_step_eager(plain, trainer.adam_l2(plain, 1e-4),
                                       g, sub,
                                       torch.Generator().manual_seed(1))
    for a, b in zip(losses, want):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-6)
    counters.reset("launch")


def test_sync_bn_over_two_gloo_ranks_is_the_composed_path(tmp_path):
    """Two gloo ranks, each with half of a batch, one sync-BN group: the
    operation (its plain kernels) gives the composed ops' outputs, dx and
    running statistics, each rank's own dscale and dbias, and summed over
    the ranks the union batch's (a dbias summed over the group twice, or
    dx's terms left unsummed, would show)."""
    worst = bn_sync_ranks.gaps(bn_sync_ranks.spawn(tmp_path, "cpu"))
    assert max(worst.values()) <= 1e-5, worst
