"""PyTorch port vs the JAX package: the pretraining options and the widths
the card path now serves.

The model with each option the ``pretrain`` verb can set (the ``s2s``
readout with and without the attention, the attention off, the
``reference`` KL, the literal ``dense`` reconstruction, the logM
reconstruction at k = 1 and 2), deterministic, losses and gradients from
the same weights; ``Set2Set`` alone; ``graph/transition.py`` and the
loader's logM targets; the GIN encoder at widths past the fused kernel's
128 (the banded-SpMM branch) and at 30; the attention at head widths the
kernels take only zero-padded, and the widths refused when a layer is
built.

Tolerances: losses rtol 1e-4 and gradients rtol 1e-3 with atol 1e-5 of the
largest (as ``test_torch_model.py``); Set2Set and the encoders rtol 1e-4,
atol 1e-5; the attention rtol = atol = 2e-5 (as ``test_torch_gt.py``); the
transition matrices rtol 1e-6 (float32 logs in another library), the
per-graph NumPy form and the packed weights exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scgib_tpu.data import loader as jloader
from scgib_tpu.data.synthetic import random_dataset as jrandom_dataset
from scgib_tpu.graph import transition as jtransition
from scgib_tpu.graph.batching import pack_graphs as jpack_graphs
from scgib_tpu.graph.batching import pack_subgraphs as jpack_subgraphs
from scgib_tpu.graph.egonet import extract_egonets as jextract_egonets
from scgib_tpu.models import encoders as jenc
from scgib_tpu.models.scgib import PretrainModel as JPretrainModel
from scgib_tpu.models.set2set import Set2Set as JSet2Set
from scgib_tpu.ops.spmm_banded import \
    gt_banded_attention as jgt_banded_attention

from scgib_tpu_torch.data import loader
from scgib_tpu_torch.data.synthetic import random_dataset
from scgib_tpu_torch.graph import transition
from scgib_tpu_torch.graph.batching import pack_graphs
from scgib_tpu_torch.graph.container import GraphBatch, SubgraphBatch
from scgib_tpu_torch.models import encoders
from scgib_tpu_torch.models.encoders import GraphTransformerLayer
from scgib_tpu_torch.models.scgib import PretrainModel, _resolve_band
from scgib_tpu_torch.models.set2set import Set2Set
from scgib_tpu_torch.ops.kernels import gt_flash as kg
from scgib_tpu_torch.utils import counters
from scgib_tpu_torch.utils.params import (from_jax_variables, init_flax_style_,
                                          to_jax_variables)

from gt_cases import WIDTHS, banded_graph, qkvg

IN, HID, DT = 9, 16, 8


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def setup():
    graphs = jrandom_dataset(12, seed=3, min_nodes=8, max_nodes=20,
                             feat_dim=IN)
    egos = [jextract_egonets(x, 1) for x in graphs]
    jg = jpack_graphs(graphs, 256, 1024, 16, banded="device")
    jsub = jpack_subgraphs(graphs, egos, 1024, 4096, banded="device")
    return graphs, jg, jsub


OPTIONS = {"s2s": dict(readout="s2s"),
           "s2s-no-att": dict(readout="s2s", use_att=False),
           "no-att": dict(use_att=False),
           "kl-reference": dict(kl_mode="reference"),
           "dense": dict(recons_impl="dense"),
           "logM": dict(recons_type="logM"),
           "logM-k2": dict(recons_type="logM", k_transition=2)}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_option_losses_and_grads_match_jax(setup, option):
    graphs, jg, jsub = setup
    kw = OPTIONS[option]
    targets = {}
    if kw.get("recons_type") == "logM":
        k = kw.get("k_transition", 1)
        T, W = jtransition.pack_logm_targets(
            graphs, [jtransition.transition_logm(x, k) for x in graphs],
            256, k)
        targets = dict(logm_targets=T, logm_weights=W)
    jmodel = JPretrainModel(in_dim=IN, hidden=HID, d_transfer=DT,
                            deterministic=True, **kw)
    jkw = {k: jnp.asarray(v) for k, v in targets.items()}
    v = jax.tree_util.tree_map(np.asarray, jmodel.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jg, jsub, train=True, **jkw))

    def loss(params):
        losses, _ = jmodel.apply({"params": params,
                                  "batch_stats": v["batch_stats"]},
                                 jg, jsub, train=True,
                                 mutable=["batch_stats"], **jkw)
        return losses.total, losses
    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"])

    model = PretrainModel(IN, hidden=HID, d_transfer=DT, deterministic=True,
                          **kw)
    model.load_state_dict(from_jax_variables(v))
    losses = model.train()(GraphBatch.from_numpy(jg, "cpu"),
                           SubgraphBatch.from_numpy(jsub, "cpu"),
                           **{k: t(x) for k, x in targets.items()})
    losses.total.backward()
    for a, b in zip(losses, jlosses):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=1e-4)
    want = from_jax_variables({"params": jax.tree_util.tree_map(
        np.asarray, jgrads)})
    params = dict(model.named_parameters())
    assert set(want) == set(params)
    scale = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(params[name].grad.numpy(), w.numpy(),
                                   rtol=1e-3, atol=1e-5 * scale,
                                   err_msg=name)


def test_logm_targets_come_from_the_batch(setup):
    """Without explicit targets, the model reads the batch's (as packed by
    ``batch_iterator(logm_k=...)``); without either it raises."""
    graphs, jg, jsub = setup
    T, W = jtransition.pack_logm_targets(
        graphs, [jtransition.transition_logm(x, 1) for x in graphs], 256, 1)
    model = PretrainModel(IN, hidden=HID, d_transfer=DT, deterministic=True,
                          recons_type="logM")
    g, sub = (GraphBatch.from_numpy(jg, "cpu"),
              SubgraphBatch.from_numpy(jsub, "cpu"))
    with torch.no_grad():
        with pytest.raises(ValueError, match="logm targets"):
            model(g, sub)
        explicit = model(g, sub, logm_targets=t(T), logm_weights=t(W))
        g.logm_targets, g.logm_weights = t(T), t(W)
        carried = model(g, sub)
    assert float(explicit.reconstruction) == float(carried.reconstruction)


def test_set2set_matches_jax():
    rng = np.random.default_rng(2)
    n, g, d = 40, 5, 8
    x = rng.normal(size=(n, d)).astype(np.float32)
    seg = np.sort(rng.integers(0, g - 1, size=n)).astype(np.int32)
    mask = rng.random(n) > 0.2
    ct = rng.normal(size=(g, 2 * d)).astype(np.float32)
    js2s = JSet2Set(d)
    v = js2s.init(jax.random.PRNGKey(4), jnp.asarray(x), jnp.asarray(seg), g,
                  mask=jnp.asarray(mask))

    def jloss(params, x):
        out = js2s.apply({"params": params}, x, jnp.asarray(seg), g,
                         mask=jnp.asarray(mask))
        return jnp.sum(out * ct), out
    (_, jout), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(
        v["params"], jnp.asarray(x))
    s2s = Set2Set(d)
    s2s.load_state_dict(from_jax_variables(
        jax.tree_util.tree_map(np.asarray, v)))
    xt = t(x).requires_grad_()
    out = s2s(xt, t(seg).long(), g, mask=t(mask))
    (out * t(ct)).sum().backward()
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **tol)
    want = from_jax_variables({"params": jax.tree_util.tree_map(
        np.asarray, jgp)})
    for name, p in s2s.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **tol)
    # and back: the port's tree is flax's, gate by gate
    back = to_jax_variables(s2s)["params"]
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(v["params"])
    init_flax_style_(s2s, torch.Generator().manual_seed(0))
    hh = s2s.lstm.weight_hh.detach()[:d]            # gate i's hidden kernel
    np.testing.assert_allclose((hh @ hh.T).numpy(), np.eye(d), atol=1e-5)


@pytest.fixture(scope="module")
def logm_graphs():
    return jrandom_dataset(40, seed=8, min_nodes=4, max_nodes=30)


@pytest.mark.parametrize("k", [1, 3])
def test_transition_functions_match_jax(logm_graphs, k):
    for g in logm_graphs[:6]:
        for a, b in zip(transition.transition_logm(g, k),
                        jtransition.transition_logm(g, k)):
            np.testing.assert_array_equal(a, b)
    got = transition.transition_logm_batched(logm_graphs, k, chunk=16)
    want = jtransition.transition_logm_batched(logm_graphs, k, chunk=16)
    for gs, ws, g in zip(got, want, logm_graphs):
        for a, b, c in zip(gs, ws, transition.transition_logm(g, k)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-5)
    T, W = transition.pack_logm_targets(logm_graphs[:5], got[:5], 128, k)
    jT, jW = jtransition.pack_logm_targets(logm_graphs[:5], want[:5], 128, k)
    np.testing.assert_allclose(T, jT, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(W, jW)


def test_loader_attaches_logm_targets_like_jax():
    graphs = random_dataset(40, seed=12, min_nodes=6, max_nodes=20)
    ds, jds = (loader.GraphDataset(graphs, k=1),
               jloader.GraphDataset(jrandom_dataset(40, seed=12, min_nodes=6,
                                                    max_nodes=20), k=1))
    caps, jcaps = loader.plan_capacities(ds, 8), jloader.plan_capacities(
        jds, 8)
    assert dataclasses.astuple(caps) == dataclasses.astuple(jcaps)
    g, _ = next(loader.batch_iterator(ds, 8, caps, seed=3, logm_k=2))
    jg, _ = next(jloader.batch_iterator(jds, 8, jcaps, seed=3, logm_k=2))
    np.testing.assert_allclose(g.logm_targets, jg.logm_targets, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(g.logm_weights, jg.logm_weights)
    assert next(loader.batch_iterator(ds, 8, caps))[0].logm_targets is None


# --- the widths the card path now serves --------------------------------------

@pytest.fixture(scope="module")
def gin_batch():
    graphs = random_dataset(16, seed=9, min_nodes=8, max_nodes=28)
    return pack_graphs(graphs, 512, 2048, 16).to("cpu")


@pytest.mark.parametrize("hidden,branch", [(30, "band"), (130, "band_spmm"),
                                           (256, "band_spmm")])
def test_gin_at_any_width_matches_jax(gin_batch, hidden, branch):
    """Up to 128 wide the band path is the fused layer; past it, h + A h
    through the banded SpMM and the MLP as plain products, the JAX
    package's XLA branch.  Widths not a multiple of 4 included."""
    g = gin_batch
    x = np.random.default_rng(5).normal(size=(512, 8)).astype(np.float32)
    band = _resolve_band(g)
    jband = (jnp.asarray(band[0].float().numpy()),
             jnp.asarray(band[1].numpy().astype(np.int32)))
    jgin = jenc.GIN(hidden=hidden, num_convs=2)
    jargs = (jnp.asarray(x), jnp.asarray(g.senders.numpy()),
             jnp.asarray(g.receivers.numpy()))
    jkw = dict(node_mask=jnp.asarray(g.node_mask.numpy()),
               edge_mask=jnp.asarray(g.edge_mask.numpy()), band=jband)
    v = jgin.init(jax.random.PRNGKey(1), *jargs, train=True, **jkw)
    want, _ = jgin.apply(v, *jargs, train=True, mutable=["batch_stats"],
                         **jkw)
    gin = encoders.GIN(8, hidden=hidden, num_convs=2)
    gin.load_state_dict(from_jax_variables(
        jax.tree_util.tree_map(np.asarray, v)))
    counters.reset("encoder")
    out = gin(t(x), g.senders, g.receivers, node_mask=g.node_mask,
              edge_mask=g.edge_mask, band=band)
    assert counters.of("encoder") == {branch: 2}
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bwd", ["twopass", "merged"])
@pytest.mark.parametrize("case", sorted(WIDTHS))
def test_attention_at_padded_head_widths_matches_jax(case, bwd):
    """``gt_flash_attention`` pads a head width the kernels do not take up
    to one they do, keeping the scale at 1 / sqrt(hd); values and
    gradients against the JAX reference at the original width."""
    heads, hd = WIDTHS[case]
    width = kg.served_head_width(heads, hd)
    assert width >= hd and (heads * width) % 4 == 0
    assert (width == hd) == (kg.takes_head_width(hd)
                            and (heads * hd) % 4 == 0)
    blocks, off = banded_graph("narrow")
    q, k, v, ct = qkvg(256, heads=heads, hd=hd, seed=6)
    jb = jnp.asarray(blocks.float().numpy()).astype(jnp.bfloat16)

    def jloss(q, k, v):
        out = jgt_banded_attention(jb, jnp.asarray(off.numpy()), q, k, v)
        return jnp.sum(out * ct), out
    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    ts = [t(x).requires_grad_() for x in (q, k, v)]
    out = kg.gt_flash_attention(blocks, off, *ts, bwd=bwd)
    assert out.shape == (256, heads, hd)
    (out * t(ct)).sum().backward()
    tol = dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **tol)
    for x, jgrad in zip(ts, jgrads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), **tol)


def test_head_widths_served_and_refused():
    """Every width is served with either backward (the merged one
    included): up to 512 at the next width the kernels instantiate, past
    it at the next multiple of 512, which the kernels sweep 512 features
    at a time.  Only a hidden width that is not a multiple of the heads is
    refused when the layer is built."""
    assert [kg.served_head_width(h, d) for h, d in
            ((8, 8), (8, 12), (3, 10), (3, 1), (2, 1), (1, 64), (2, 100),
             (1, 256), (1, 200), (2, 129), (1, 512), (2, 300), (1, 513),
             (1, 1024), (1, 1100), (3, 1536), (1, 4096), (1, 4097))] \
        == [8, 16, 16, 4, 2, 64, 128, 256, 256, 256, 512, 512, 1024,
            1024, 1536, 1536, 4096, 4608]
    assert [w for w in range(1, 4097) if kg.takes_head_width(w)] == \
        list(kg.HEAD_WIDTHS) + list(range(1024, 4097, 512))
    GraphTransformerLayer(96, 8)
    GraphTransformerLayer(30, 3)
    GraphTransformerLayer(128, 1)
    GraphTransformerLayer(256, 1)
    GraphTransformerLayer(256, 1, bwd="merged")
    GraphTransformerLayer(64, 1, bwd="merged")
    GraphTransformerLayer(512, 1, bwd="merged")
    for bwd in ("twopass", "merged"):
        GraphTransformerLayer(1024, 1, bwd=bwd)
        GraphTransformerLayer(4096, 1, bwd=bwd)
    with pytest.raises(ValueError, match="not a multiple"):
        GraphTransformerLayer(1024, 3)


def test_transformer_at_hidden_30_matches_jax():
    """A whole layer at 3 heads of 10 on the band path (padded to 16 in the
    attention) against the JAX layer."""
    from scgib_tpu.models.encoders import \
        GraphTransformerLayer as JGraphTransformerLayer

    graphs = random_dataset(16, seed=11, min_nodes=8, max_nodes=28)
    b = pack_graphs(graphs, 512, 2048, 16).to("cpu")
    x = np.random.default_rng(0).normal(size=(512, 30)).astype(np.float32)
    wide = _resolve_band(b)
    jband = (jnp.asarray(wide[0].float().numpy()).astype(jnp.bfloat16),
             jnp.asarray(wide[1].numpy()))
    js, jr = (jnp.asarray(y.numpy()) for y in (b.senders, b.receivers))
    jlayer = JGraphTransformerLayer(30, 3)
    jem = jnp.asarray(b.edge_mask.numpy())
    v = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x), js, jr,
                    band=jband, train=False, edge_mask=jem)
    want = jlayer.apply(v, jnp.asarray(x), js, jr, band=jband, train=False,
                        edge_mask=jem)
    layer = GraphTransformerLayer(30, 3).eval()
    layer.load_state_dict(from_jax_variables(
        jax.tree_util.tree_map(np.asarray, v)))
    got = layer(t(x), b.senders, b.receivers, edge_mask=b.edge_mask,
                band=_resolve_band(b, gt=True))
    rows = b.node_mask.numpy()
    np.testing.assert_allclose(got.detach().numpy()[rows],
                               np.asarray(want)[rows], rtol=1e-4, atol=1e-5)
