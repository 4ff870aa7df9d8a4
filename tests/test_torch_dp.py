"""Data parallelism over ``torch.distributed``: 4 gloo ranks on the CPU
against the port's single-process step on the union batch, as
``tests/test_parallel.py`` and ``tests/test_multichip_loop.py`` hold the
JAX package's mesh step.

One world of 4 rank processes (``tests/dp_cases.py``, spawned once for the
module) runs every case; the tests read what the ranks saw.  Tolerances are
``tests/test_parallel.py``'s: losses rtol 1e-5 (KL, contrastive) and 1e-4
(reconstruction), gradients rtol 2e-3 with atol 5e-4, updated parameters
rtol 5e-4 with atol 2.5e-4 (Adam turns rounding-level gradients into +-lr
steps); BatchNorm statistics rtol 1e-5.  The ranks' states must be
byte-equal, and at world size 1 the DP step bitwise the single step.  One
test holds the DP gradient against the JAX package's single-device
gradient on the same union batch and weights.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import scgib_tpu.native
from scgib_tpu.data import loader as jloader
from scgib_tpu.data.synthetic import random_dataset as jrandom_dataset
from scgib_tpu.models.scgib import PretrainModel as JPretrainModel

from scgib_tpu_torch.models.scgib import FinetuneModel, PretrainModel
from scgib_tpu_torch.parallel import dp
from scgib_tpu_torch.train.trainer import (adam_l2, finetune_trainable_mask,
                                           make_finetune_step,
                                           make_pretrain_step, masked_adam)
from scgib_tpu_torch.utils.params import from_jax_variables, to_jax_variables

import dp_cases as C

NAMES = ("kl", "contrastive", "reconstruction")
LOSS_RTOL = {"kl": 1e-5, "contrastive": 1e-5, "reconstruction": 1e-4}
GRAD_TOL = dict(rtol=2e-3, atol=5e-4)
PARAM_TOL = dict(rtol=5e-4, atol=2.5e-4)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these steps are many tiny ops, which crawl on
    several threads when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp")
    weights = C.start_weights()
    torch.save(weights, out / "weights.pt")
    return weights, C.spawn("dp", C.WORLD, out)


def _single_pretrain(weights, counts=None, **kw):
    """One step of the single-process step on the union batch: losses,
    gradients, state."""
    ds = C.dataset()
    g, sub = (b.to("cpu") for b in C.union(ds, C.shard_caps(ds), counts))
    model = PretrainModel(C.IN, **C.PRETRAIN, **kw)
    model.load_state_dict(weights["pretrain"])
    step = make_pretrain_step(model, adam_l2(model, C.LR, C.WD))
    losses = [float(x) for x in step(g, sub)]
    return (losses, {k: p.grad for k, p in model.named_parameters()},
            model.state_dict())


def _close_losses(got, want):
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a, b, rtol=LOSS_RTOL[name], err_msg=name)


def _close_state(got, want, params):
    for k, w in want.items():
        tol = PARAM_TOL if k in params else dict(rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), **tol,
                                   err_msg=k)


def test_dp_matches_single_device(world):
    weights, ranks = world
    losses, grads, state = _single_pretrain(weights)
    params = set(grads)
    for res in ranks:
        _close_losses(res["losses"], losses)
        for k, g in grads.items():
            np.testing.assert_allclose(res["grads"][k].numpy(), g.numpy(),
                                       **GRAD_TOL, err_msg=k)
        _close_state(res["params"], state, params)


def test_dp_dense_reconstruction_matches_single_device(world):
    """``recons_impl='dense'``: each rank's rows of the gram against the
    gathered columns, its adjacency shifted to its own columns."""
    weights, ranks = world
    losses, grads, _ = _single_pretrain(weights, recons_impl="dense")
    for res in ranks:
        _close_losses(res["dense_losses"], losses)
        for k, g in grads.items():
            np.testing.assert_allclose(res["dense_grads"][k].numpy(),
                                       g.numpy(), **GRAD_TOL, err_msg=k)


def test_dp_state_replicated(world):
    """Byte-equal on every rank: the model and Adam after two steps, the
    fine-tuned model, the superbatch loop's model and Adam."""
    _, ranks = world
    for key in ("state2", "super_state"):
        for res in ranks[1:]:
            assert res[key] == ranks[0][key], key
    for res in ranks[1:]:
        for k, v in res["ft_params"].items():
            assert torch.equal(v, ranks[0]["ft_params"][k]), k


def test_dp_uneven_shards_with_empty_shard(world):
    """3, 2, 1 and 0 real graphs (the empty rank's masks all clear): the
    union of the 6 real graphs' losses."""
    weights, ranks = world
    losses, _, _ = _single_pretrain(weights, C.UNEVEN)
    for res in ranks:
        for name, a, b in zip(NAMES, res["uneven_losses"], losses):
            np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-6,
                                       err_msg=name)


def test_kl_reference_mode_rejected_under_dp():
    with pytest.raises(ValueError, match="reference"):
        PretrainModel(C.IN, **C.PRETRAIN, kl_mode="reference",
                      group=object())


def test_dp_finetune_matches_single_device(world):
    """``make_dp_finetune_step`` with ``bce_sum_count`` against the
    single-process BCE step on the union batch, the reference freeze."""
    weights, ranks = world
    lds = C.dataset(num_tasks=1)
    g, sub = (b.to("cpu") for b in C.union(lds, C.shard_caps(lds)))
    model = FinetuneModel(C.IN, **C.FINETUNE)
    model.load_state_dict(weights["finetune"])
    opt = masked_adam(model, finetune_trainable_mask(model), C.FT_LR,
                      C.FT_WD)
    loss = float(make_finetune_step(model, opt, "bce")(g, sub))
    grads = {k: p.grad for k, p in model.named_parameters()
             if p.grad is not None}
    for res in ranks:
        np.testing.assert_allclose(res["ft_loss"], loss, rtol=1e-5)
        assert set(res["ft_grads"]) == set(grads)
        for k, gr in grads.items():
            np.testing.assert_allclose(res["ft_grads"][k].numpy(),
                                       gr.numpy(), **GRAD_TOL, err_msg=k)
        _close_state(res["ft_params"], model.state_dict(), set(grads))


def test_dp_superbatch_resumes_bit_equal(world):
    """3 superbatch steps (K = 2, noise on) against 2, an autosave, a
    fresh state loading it and 1 more: byte-equal on every rank, the
    autosave's step count restored, K losses a call."""
    _, ranks = world
    for res in ranks:
        assert res["super_apart"] == []
        assert res["super_step"] == 2 * C.SUPER_K
        assert [tuple(x.shape) for x in res["super_losses"][0]] == [
            (C.SUPER_K,)] * 3
        assert all(np.isfinite(x.numpy()).all()
                   for ls in res["super_losses"] for x in ls)


def test_ranks_with_different_pool_fits_take_one_branch(world):
    """Rank 0's pooling flag False, the others' True: every rank takes the
    scatter branch (exact for any batch), and the losses are the banded
    run's to rounding."""
    _, ranks = world
    for res in ranks:
        assert res["flag_branches"] == {"scatter": 1}
        _close_losses(res["flag_losses"], ranks[0]["losses"])


def test_collectives_pass_the_capture_guard(world):
    _, ranks = world
    assert all(res["guarded_sum"] == [4.0] * 3 for res in ranks)


def test_world_size_one_is_bitwise_the_single_step(world):
    """Rank 0 alone in a group: 3 DP steps with noise on give the losses,
    weights, statistics, Adam state and generator of 3 single steps, byte
    for byte (the card's phase 11 (a) holds the captured NCCL step so)."""
    _, ranks = world
    assert ranks[0]["solo_apart"] == ([], [])


def test_stack_and_shard_batches(world):
    """``stack_batches`` then ``shard_batch`` gives each rank its own
    batch; ``stack_batches_host`` stacks on the host, then converts."""
    _, ranks = world
    assert all(res["shard_equal"] for res in ranks)
    ds = C.dataset()
    caps = C.shard_caps(ds)
    batches = [C.shard(ds, caps, r)[0] for r in range(C.WORLD)]
    stacked = dp.stack_batches_host(batches, "cpu")
    for r, b in enumerate(batches):
        mine = b.to("cpu")
        for f in dataclasses.fields(mine):
            v = getattr(mine, f.name)
            if isinstance(v, torch.Tensor):
                assert torch.equal(getattr(stacked, f.name)[r], v), f.name
    flags = [dataclasses.replace(b, gt_fits=r != 2)
             for r, b in enumerate(batches)]
    assert dp.stack_batches(flags).gt_fits is False


def test_dp_gradient_matches_jax_single_device(world, monkeypatch):
    """The DP gradient (the ranks' sum) and losses against the JAX
    package's single-device gradient of the union batch's loss, from the
    same weights: its own DP step equals that (``tests/test_parallel.py``)."""
    monkeypatch.setattr(scgib_tpu.native, "_load", lambda: None)
    weights, ranks = world
    jds = jloader.GraphDataset(jrandom_dataset(
        C.WORLD * C.PER_SHARD, seed=7, min_nodes=8, max_nodes=20), k=1)
    caps = C.union_caps(C.shard_caps(C.dataset()))
    jg, jsub = jloader.pack_batch(jds, np.arange(C.WORLD * C.PER_SHARD),
                                  jloader.Capacities(**dataclasses.asdict(
                                      caps)), use_flat=False)
    jmodel = JPretrainModel(in_dim=C.IN, **C.PRETRAIN)
    model = PretrainModel(C.IN, **C.PRETRAIN)
    model.load_state_dict(weights["pretrain"])
    v = to_jax_variables(model)

    def total(params):
        losses, _ = jmodel.apply({"params": params,
                                  "batch_stats": v["batch_stats"]}, jg, jsub,
                                 train=True, mutable=["batch_stats"])
        return losses.total, losses

    (_, jlosses), jgrad = jax.jit(jax.value_and_grad(total, has_aux=True))(
        v["params"])
    want = from_jax_variables({"params": jax.tree_util.tree_map(
        np.asarray, jgrad)})
    res = ranks[0]
    _close_losses(res["losses"], [float(x) for x in jlosses])
    for k, w in want.items():
        np.testing.assert_allclose(res["grads"][k].numpy(), w.numpy(),
                                   **GRAD_TOL, err_msg=k)
