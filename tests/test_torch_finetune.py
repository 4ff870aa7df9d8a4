"""PyTorch port vs the JAX package: the supervised path's modules — labels
in the synthetic data and the packed batches, the dataset cuts, the five
supervised losses, the auxiliary heads, ``FinetuneModel`` and
``DomainAdaptModel``, and the freeze masks.  The steps, the evaluation
function, the autosaves and the loops are ``test_torch_finetune_steps.py``.

Inputs are made from NumPy seeds (the JAX package's synthetic generator and
packers, whose output the port reproduces bit for bit).  Tolerances: data
bit-equal; losses and their gradients rtol 1e-6 (the same float32 formula);
heads and models rtol 1e-5 with atol 1e-6 (float32, reductions in another
order); BatchNorm statistics atol 1e-6; model gradients rtol 1e-3 with atol
1e-5 of the largest (gradients that are zero but for rounding,
``tests/test_torch_model.py``).
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scgib_tpu.data.loader import GraphDataset as JGraphDataset
from scgib_tpu.data.loader import batch_iterator as jbatch_iterator
from scgib_tpu.data.loader import plan_capacities as jplan_capacities
from scgib_tpu.data.synthetic import random_dataset as jrandom_dataset
from scgib_tpu.graph.batching import pack_graphs as jpack_graphs
from scgib_tpu.models import layers as jlayers
from scgib_tpu.models import losses as jlosses
from scgib_tpu.models.scgib import FinetuneModel as JFinetuneModel
from scgib_tpu.train import trainer as jtrainer

from scgib_tpu_torch.data.loader import GraphDataset, batch_iterator
from scgib_tpu_torch.data.loader import plan_capacities
from scgib_tpu_torch.data.synthetic import random_dataset
from scgib_tpu_torch.graph.batching import pack_graphs
from scgib_tpu_torch.models import layers, losses
from scgib_tpu_torch.models.scgib import FinetuneModel
from scgib_tpu_torch.train.trainer import finetune_trainable_mask
from scgib_tpu_torch.utils.params import from_jax_variables

from supervised_cases import (DT, ENCODERS, HID, IN, TASKS, TOL,
                              close_state, jax_variables, make_batches,
                              models, no_dropout, no_port_dropout, port)


@pytest.fixture(scope="module")
def batches():
    return make_batches()


# --- data: labels, packing, cuts ---------------------------------------------

@pytest.mark.parametrize("nan_frac", [0.0, 0.4])
def test_synthetic_labels_bit_equal_jax(nan_frac):
    got = random_dataset(30, seed=6, num_tasks=4, label_nan_frac=nan_frac)
    want = jrandom_dataset(30, seed=6, num_tasks=4, label_nan_frac=nan_frac)
    for a, b in zip(got, want):
        for f in ("senders", "receivers", "node_feat"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.label.dtype == b.label.dtype
        np.testing.assert_array_equal(a.label, b.label)
    if nan_frac:
        assert np.isnan(np.stack([a.label for a in got])).any()
    for a, b in zip(random_dataset(5, seed=6), jrandom_dataset(5, seed=6)):
        assert a.label is b.label is None
        np.testing.assert_array_equal(a.node_feat, b.node_feat)


@pytest.mark.parametrize("num_tasks", [1, 5])
def test_packed_labels_bit_equal_jax(num_tasks):
    """Every batch of two shuffled epochs, against the JAX loader's (its
    flat packer): labels with NaN as 0, label_mask, graph_mask."""
    kw = dict(num_tasks=num_tasks, label_nan_frac=0.3)
    ds = GraphDataset(random_dataset(70, seed=2, **kw))
    jds = JGraphDataset(jrandom_dataset(70, seed=2, **kw))
    caps = plan_capacities(ds, 16)
    assert dataclasses.astuple(caps) == dataclasses.astuple(
        jplan_capacities(jds, 16))
    for epoch in range(2):
        pairs = list(zip(batch_iterator(ds, 16, caps, seed=epoch),
                         jbatch_iterator(jds, 16, caps, seed=epoch)))
        assert len(pairs) == 5
        for (g, _), (jg, _) in pairs:
            for f in ("labels", "label_mask", "graph_mask"):
                a, b = getattr(g, f), np.asarray(getattr(jg, f))
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b, err_msg=f)
    # the per-graph packer with its own task count, and without labels
    graphs = random_dataset(6, seed=1, **kw)
    jg = jpack_graphs(jrandom_dataset(6, seed=1, **kw), 256, 512, 8,
                      num_tasks=num_tasks + 2)
    g = pack_graphs(graphs, 256, 512, 8, num_tasks=num_tasks + 2)
    np.testing.assert_array_equal(g.labels, np.asarray(jg.labels))
    np.testing.assert_array_equal(g.label_mask, np.asarray(jg.label_mask))
    g = pack_graphs(random_dataset(6, seed=1), 256, 512, 8)
    assert g.labels is None and g.label_mask is None
    t = g.to("cpu")
    assert t.labels is None
    t = pack_graphs(graphs, 256, 512, 8).to("cpu")
    assert t.labels.dtype == torch.float32 and t.label_mask.dtype == torch.bool


def test_dataset_subset_and_split_equal_jax():
    ds = GraphDataset(random_dataset(40, seed=9, num_tasks=1))
    jds = JGraphDataset(jrandom_dataset(40, seed=9, num_tasks=1))
    for shuffle in (None, 5):
        for a, b in zip(ds.split(20, 8, shuffle), jds.split(20, 8, shuffle)):
            assert len(a) == len(b)
            for x, y in zip(a.graphs, b.graphs):
                np.testing.assert_array_equal(x.node_feat, y.node_feat)
                np.testing.assert_array_equal(x.label, y.label)
            for x, y in zip(a.egonets, b.egonets):
                for p, q in zip(x.node_lists, y.node_lists):
                    np.testing.assert_array_equal(p, q)
    sub = ds.subset([3, 1])
    assert sub.graphs == [ds.graphs[3], ds.graphs[1]]
    assert sub.num_tasks() == 1 and GraphDataset(
        random_dataset(3, seed=1)).num_tasks() is None


# --- losses ------------------------------------------------------------------

LOSSES = {"bce": (losses.bce_loss, jlosses.bce_loss, "prob"),
          "bce_logits": (losses.bce_with_logits_loss,
                         jlosses.bce_with_logits_loss, "logit"),
          "ce": (losses.cross_entropy_loss, jlosses.cross_entropy_loss,
                 "class"),
          "rmse": (losses.rmse_loss, jlosses.rmse_loss, "real"),
          "mae": (losses.mae_loss, jlosses.mae_loss, "real")}


def _loss_inputs(kind, rng):
    x = rng.normal(size=(16, 4)).astype(np.float32)
    y = (rng.random((16, 4)) < 0.5).astype(np.float32)
    mask = rng.random((16, 4)) < 0.8
    if kind == "prob":
        x = 1.0 / (1.0 + np.exp(-x))
        y[~mask] = np.nan                    # masked NaN targets
    if kind == "class":
        y = rng.integers(0, 4, size=16).astype(np.float32)
        mask = mask[:, 0]
    return x.astype(np.float32), y, mask


@pytest.mark.parametrize("name", sorted(LOSSES))
@pytest.mark.parametrize("masked", [True, False])
def test_losses_and_gradients_match_jax(name, masked):
    mine, ref, kind = LOSSES[name]
    x, y, mask = _loss_inputs(kind, np.random.default_rng(1))
    if not masked:
        y = np.nan_to_num(y)
        mask = None
    xt = torch.from_numpy(x).requires_grad_()
    got = mine(xt, torch.from_numpy(y),
               None if mask is None else torch.from_numpy(mask))
    got.backward()
    got = got.detach()
    fn = (lambda a: ref(a, jnp.asarray(y),
                        None if mask is None else jnp.asarray(mask)))
    want, grad = jax.value_and_grad(fn)(jnp.asarray(x))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(grad), rtol=1e-6,
                               atol=1e-7)


def test_bce_at_saturated_probabilities_matches_jax():
    """Probabilities of exactly 0 and 1 (a saturated float32 sigmoid): the
    log clamp at -100 keeps the loss finite and NaN-free, with a gradient
    of exactly 0 where the label disagrees (the clamped log) and finite
    where it agrees."""
    p = np.array([[0.0, 1.0, 0.0, 1.0, 0.5]], np.float32)
    y = np.array([[0.0, 1.0, 1.0, 0.0, 1.0]], np.float32)
    pt = torch.from_numpy(p).requires_grad_()
    got = losses.bce_loss(pt, torch.from_numpy(y))
    got.backward()
    got = got.detach()
    want, grad = jax.value_and_grad(
        lambda a: jlosses.bce_loss(a, jnp.asarray(y)))(jnp.asarray(p))
    assert np.isfinite(float(got)) and np.isfinite(pt.grad.numpy()).all()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(grad), rtol=1e-6)
    assert float(got) == pytest.approx((100 + 100 + np.log(2)) / 5)
    assert pt.grad[0, 2] == 0 and pt.grad[0, 3] == 0


# --- the auxiliary heads -----------------------------------------------------

HEADS = {"MLPReadout": (lambda: layers.MLPReadout(32, 3, L=2),
                        lambda: jlayers.MLPReadout(3, L=2)),
         "ReconstructX": (lambda: layers.ReconstructX(32, 16, 9),
                          lambda: jlayers.ReconstructX(16, 9)),
         "MLPA": (lambda: layers.MLPA(32, 16), lambda: jlayers.MLPA(16))}


@pytest.mark.parametrize("name", sorted(HEADS))
def test_aux_heads_match_jax(name):
    mine, ref = (f() for f in HEADS[name])
    x = np.random.default_rng(2).normal(size=(12, 32)).astype(np.float32)
    v = ref.init(jax.random.PRNGKey(0), jnp.asarray(x))
    mine.load_state_dict(from_jax_variables(
        jax.tree_util.tree_map(np.asarray, v)))
    xt = torch.from_numpy(x).requires_grad_()
    out = mine(xt)
    out.sum().backward()
    want, grad = jax.value_and_grad(
        lambda a: ref.apply(v, a).sum())(jnp.asarray(x))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(ref.apply(v, jnp.asarray(x))),
                               **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(grad), **TOL)
    assert set(mine.state_dict()) == set(from_jax_variables(
        jax.tree_util.tree_map(np.asarray, v)))


# --- the models --------------------------------------------------------------

_APPLIED = {}


def _jax_apply(kind, encoder, train, jg, jsub):
    """The JAX model's output and mutated BatchNorm statistics (jitted,
    dropout off), with the gradients of its sum in train mode except for
    the regression head (the classifier's parameters and gradients but for
    the sigmoid); and the variables they came from."""
    key = (kind, encoder, train)
    if key not in _APPLIED:
        jmodel = models(kind.split("-")[0], encoder,
                         regression=kind.endswith("regression"))[1]
        v = jax_variables(models(kind.split("-")[0], encoder)[1], jg, jsub)

        def apply(p):
            y, mut = jmodel.apply(
                {"params": p, "batch_stats": v["batch_stats"]}, jg, jsub,
                train=train, mutable=["batch_stats"],
                rngs={"dropout": jax.random.PRNGKey(3)})
            return y.sum(), (y, mut["batch_stats"])
        with fnn.intercept_methods(no_dropout):
            if train and kind != "finetune-regression":
                (_, aux), grads = jax.jit(jax.value_and_grad(
                    apply, has_aux=True))(v["params"])
            else:
                aux, grads = jax.jit(apply)(v["params"])[1], None
        _APPLIED[key] = (v, jax.tree_util.tree_map(np.asarray,
                                                   aux + (grads,)))
    return _APPLIED[key]


@pytest.mark.parametrize("encoder", sorted(ENCODERS))
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("kind", ["finetune", "finetune-regression",
                                  "domainadapt"])
def test_models_match_jax(batches, kind, train, encoder):
    """Bridged weights, the deterministic gate, dropout off on both sides:
    the output (scores or the adaptation loss); in train mode also the
    BatchNorm statistics it moves and (the classifier and the adaptation
    model) every parameter's gradient."""
    jg, jsub = batches[0]
    model = models(kind.split("-")[0], encoder,
                    regression=kind.endswith("regression"))[0]
    v, (want, stats, grads) = _jax_apply(kind, encoder, train, jg, jsub)
    model.load_state_dict(from_jax_variables(v))
    no_port_dropout(model).train(train)
    out = model(*port(jg, jsub))
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6 * max(1.0, float(np.abs(want).max())))
    if kind == "finetune":
        assert (0 <= out.detach()).all() and (out.detach() <= 1).all()
    if train:
        close_state(model, {"params": v["params"], "batch_stats": stats})
    if grads is None:
        return
    out.sum().backward()
    want_g = from_jax_variables({"params": grads})
    scale = max(float(w.abs().max()) for w in want_g.values())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                   rtol=1e-3, atol=1e-5 * scale,
                                   err_msg=name)


# --- the freeze masks --------------------------------------------------------

@pytest.mark.parametrize("encoder", sorted(ENCODERS))
@pytest.mark.parametrize("mode", ["reference", "paper", "all", "frozen"])
def test_trainable_mask_matches_jax_name_for_name(batches, mode, encoder):
    jg, jsub = batches[0]
    kw = dict(hidden=HID, d_transfer=DT, **ENCODERS[encoder])
    kw.pop("num_layers")                     # GIN at its default 4 convs
    model = FinetuneModel(IN, num_out=TASKS, **kw)
    params = jax.eval_shape(
        lambda: JFinetuneModel(in_dim=IN, num_out=TASKS, **kw).init(
            {"params": jax.random.PRNGKey(0),
             "noise": jax.random.PRNGKey(1),
             "dropout": jax.random.PRNGKey(2)}, jg, jsub, train=True))[
        "params"]
    jmask = jtrainer.finetune_trainable_mask(params, mode)
    per_name = from_jax_variables({"params": jax.tree_util.tree_map(
        lambda t, p: np.full(p.shape, t), jmask, params)})
    want = [n for n, _ in model.named_parameters()
            if bool(per_name[n].all())]
    assert all(bool(t.all()) == bool(t.any()) for t in per_name.values())
    got = finetune_trainable_mask(model, mode)
    assert got == want
    if mode == "reference" and encoder == "GIN":
        assert "core.encoder1.conv2.Dense_0.weight" in got
        assert "core.encoder2.bn2.scale" in got
        assert "core.encoder1.conv3.Dense_0.weight" not in got
    if encoder == "Transformer" and mode in ("reference", "paper"):
        assert not any(n.startswith("core.encoder") for n in got)
    assert ("head_mlp.Dense_0.weight" in got and "transfer_d.weight" in got)
    with pytest.raises(ValueError):
        finetune_trainable_mask(model, "some")
