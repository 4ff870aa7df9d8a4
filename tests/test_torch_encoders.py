"""PyTorch port vs the JAX package: the GCN and GraphSAGE encoders.

The COO aggregations (``gather_mean``, ``in_degrees``, ``gcn_norm_sum``,
``jax_rsqrt``) on a packed batch with padded edges; each encoder from the
same (bridged) weights, banded and COO, output and input gradient, and the
port's banded path against its COO path; ``PretrainModel`` with either
encoder, losses and gradients; the fine-tuning freeze masks and one masked
fine-tuning step with its Adam state both ways through the bridge;
GraphSAGE's parameter tree with and without the reference's repeated-conv
bug; and the verbs on the CPU with ``--encoder GCN`` / ``GraphSAGE``.  On
the CPU the banded product is the plain version (the JAX side's XLA
``banded_spmm``, off the TPU).

Tolerances: the aggregations 1e-6 (reduction order only); encoder outputs
2e-5 and input gradients 2e-4 (those of ``tests/test_encoders.py``'s
banded-against-COO check); model losses rtol 1e-4 and gradients rtol 1e-3
with atol 1e-5 of the largest (``tests/test_torch_model.py``'s)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from scgib_tpu.data.synthetic import random_dataset as jrandom_dataset
from scgib_tpu.graph.batching import pack_graphs as jpack_graphs
from scgib_tpu.graph.batching import pack_subgraphs as jpack_subgraphs
from scgib_tpu.graph.egonet import extract_egonets as jextract_egonets
from scgib_tpu.models import encoders as jencoders
from scgib_tpu.models.scgib import PretrainModel as JPretrainModel
from scgib_tpu.ops import spmm as jspmm
from scgib_tpu.models.scgib import FinetuneModel as JFinetuneModel
from scgib_tpu.train import trainer as jtrainer

from scgib_tpu_torch import cli
from scgib_tpu_torch.graph.container import GraphBatch, SubgraphBatch
from scgib_tpu_torch.models import encoders
from scgib_tpu_torch.models.scgib import (FinetuneModel, PretrainModel,
                                          _resolve_band)
from scgib_tpu_torch.ops import spmm
from scgib_tpu_torch.train import checkpoint as ckpt
from scgib_tpu_torch.train.trainer import (TrainState,
                                           finetune_trainable_mask,
                                           make_finetune_step, masked_adam)
from scgib_tpu_torch.utils import counters
from scgib_tpu_torch.utils.params import (adam_to_optax, from_jax_variables,
                                          load_adam_state, to_jax_variables)

from supervised_cases import (DT, HID, IN, LR, TASKS, WD, close_state,
                              jax_batch, jax_variables, labelled_graphs,
                              port)

FEAT = 8
VALUE_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
ENCODER_CASES = {"GCN": (jencoders.GCN, encoders.GCN, {}),
                 "GraphSAGE": (jencoders.GraphSAGE, encoders.GraphSAGE, {}),
                 "GraphSAGE-no-bug": (jencoders.GraphSAGE,
                                      encoders.GraphSAGE,
                                      {"faithful_bug": False})}


@pytest.fixture(scope="module")
def graph():
    """16 molecules in 512 rows (padded edges), with host-packed band
    blocks, and features on every row (padding rows masked)."""
    graphs = jrandom_dataset(16, seed=5, min_nodes=6, max_nodes=20,
                             feat_dim=FEAT)
    jg = jpack_graphs(graphs, 512, 2048, 16, banded=True)
    assert jg.band_blocks is not None
    assert not np.asarray(jg.edge_mask).all()
    x = np.random.default_rng(0).normal(size=(512, FEAT)).astype(np.float32)
    return jg, GraphBatch.from_numpy(jg, "cpu"), x


# --- the COO aggregations ----------------------------------------------------

OPS = {
    "gather_mean": lambda m, x, g: m.gather_mean(
        x, g.senders, g.receivers, g.num_nodes, g.edge_mask),
    "in_degrees": lambda m, x, g: m.in_degrees(g.receivers, g.num_nodes,
                                               g.edge_mask),
    "gcn_norm_sum": lambda m, x, g: m.gcn_norm_sum(
        x, g.senders, g.receivers, g.num_nodes, g.edge_mask),
    "jax_rsqrt": lambda m, x, g: m.jax_rsqrt(
        m.in_degrees(g.receivers, g.num_nodes, g.edge_mask)),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_aggregations_match_jax(graph, name):
    jg, g, x = graph
    want = np.asarray(OPS[name](jspmm, jnp.asarray(x), jg))
    got = OPS[name](spmm, torch.from_numpy(x), g).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if name == "jax_rsqrt":        # the floor: 0 -> 1e15, not inf
        assert np.isfinite(got).all() and got.max() == pytest.approx(1e15)


# --- the encoders ------------------------------------------------------------

def _jax_encoder(case, graph):
    jcls, _, kw = ENCODER_CASES[case]
    jg, _, x = graph
    mod = jcls(hidden=16, **kw)
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), jg.senders,
                 jg.receivers, node_mask=jg.node_mask,
                 edge_mask=jg.edge_mask)
    return mod, jax.tree_util.tree_map(np.asarray, v)


def _port_encoder(case, v):
    _, cls, kw = ENCODER_CASES[case]
    enc = cls(FEAT, hidden=16, **kw)
    enc.load_state_dict(from_jax_variables(v))
    return enc


def _jax_run(mod, v, jg, x, banded):
    band = (jg.band_blocks, jg.band_col_off) if banded else None

    def f(xx):
        return mod.apply(v, xx, jg.senders, jg.receivers,
                         node_mask=jg.node_mask, edge_mask=jg.edge_mask,
                         band=band)
    out = f(jnp.asarray(x))
    grad = jax.grad(lambda xx: jnp.sum(f(xx) ** 2))(jnp.asarray(x))
    return np.asarray(out), np.asarray(grad)


def _port_run(enc, g, x, banded):
    xt = torch.from_numpy(x).requires_grad_()
    out = enc(xt, g.senders, g.receivers, node_mask=g.node_mask,
              edge_mask=g.edge_mask, band=_resolve_band(g) if banded
              else None)
    (out ** 2).sum().backward()
    return out.detach().numpy(), xt.grad.numpy()


@pytest.mark.parametrize("banded", [True, False], ids=["band", "coo"])
@pytest.mark.parametrize("case", sorted(ENCODER_CASES))
def test_encoder_matches_jax(graph, case, banded):
    jg, g, x = graph
    mod, v = _jax_encoder(case, graph)
    enc = _port_encoder(case, v)
    counters.reset("encoder")
    out, grad = _port_run(enc, g, x, banded)
    want_out, want_grad = _jax_run(mod, v, jg, x, banded)
    np.testing.assert_allclose(out, want_out, **VALUE_TOL)
    np.testing.assert_allclose(grad, want_grad, **GRAD_TOL)
    prefix = "gcn" if case == "GCN" else "sage"
    assert counters.of("encoder") == {
        f"{prefix}_{'band' if banded else 'coo'}": 3}
    assert float(np.abs(out[~np.asarray(jg.node_mask)]).max()) == 0.0


@pytest.mark.parametrize("case", sorted(ENCODER_CASES))
def test_banded_path_matches_coo_path(graph, case):
    _, g, x = graph
    enc = _port_encoder(case, _jax_encoder(case, graph)[1])
    out_b, grad_b = _port_run(enc, g, x, True)
    out_c, grad_c = _port_run(enc, g, x, False)
    np.testing.assert_allclose(out_b, out_c, **VALUE_TOL)
    np.testing.assert_allclose(grad_b, grad_c, **GRAD_TOL)


@pytest.mark.parametrize("faithful_bug", [True, False])
def test_sage_parameters_are_the_jax_tree(graph, faithful_bug):
    """Under the bug flax never calls conv 2's layers, so never creates
    them; the port does not build them either."""
    case = "GraphSAGE" if faithful_bug else "GraphSAGE-no-bug"
    _, v = _jax_encoder(case, graph)
    enc = encoders.GraphSAGE(FEAT, hidden=16, faithful_bug=faithful_bug)
    assert set(enc.state_dict()) == set(from_jax_variables(v))
    assert ("self2" in v["params"]) == (not faithful_bug)
    assert ("neigh2.weight" in dict(enc.named_parameters())) == (
        not faithful_bug)
    assert "bias" not in v["params"]["neigh0"]
    got = to_jax_variables(_port_encoder(case, v))["params"]
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(v["params"])
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(v["params"])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("faithful_bug", [True, False])
def test_sage_adam_state_bridges_both_ways(graph, faithful_bug):
    """One Adam-with-L2 step on the encoder's squared output, JAX's
    ``adam_l2`` and torch's from the same weights: the moments in the
    JAX flat layout agree, and the JAX state loads into torch's Adam and
    reads back out bit for bit, with and without conv 2's layers."""
    case = "GraphSAGE" if faithful_bug else "GraphSAGE-no-bug"
    jg, g, x = graph
    mod, v = _jax_encoder(case, graph)

    def loss(params):
        out = mod.apply({"params": params}, jnp.asarray(x), jg.senders,
                        jg.receivers, node_mask=jg.node_mask,
                        edge_mask=jg.edge_mask)
        return jnp.sum(out ** 2)
    tx = jtrainer.adam_l2(LR, WD)
    state = tx.init(v["params"])
    _, state = tx.update(jax.grad(loss)(v["params"]), state, v["params"])
    ref = serialization.to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                             state))
    enc = _port_encoder(case, v)
    opt = torch.optim.Adam(enc.parameters(), lr=LR, weight_decay=WD)
    out = enc(torch.from_numpy(x), g.senders, g.receivers,
              node_mask=g.node_mask, edge_mask=g.edge_mask)
    (out ** 2).sum().backward()
    opt.step()
    mine = adam_to_optax(enc, opt)
    for key in ("mu", "nu"):
        a, b = mine["0"]["1"][key], ref["0"]["1"][key]
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-3,
                                   atol=1e-5 * np.abs(b).max())
    again = _port_encoder(case, v)
    opt2 = torch.optim.Adam(again.parameters(), lr=LR, weight_decay=WD)
    load_adam_state(again, opt2, ref)
    back = adam_to_optax(again, opt2)
    for key in ("mu", "nu"):
        np.testing.assert_array_equal(back["0"]["1"][key],
                                      ref["0"]["1"][key])


def test_gcn_widths_are_the_references():
    enc = encoders.GCN(FEAT, hidden=16)
    assert [tuple(getattr(enc, f"conv{i}").weight.shape[::-1])
            for i in range(3)] == [(FEAT, 32), (32, 32), (32, 16)]
    with pytest.raises(ValueError, match="unknown encoder"):
        encoders.make_encoder("GAT", FEAT, 16)


# --- the pretraining model ---------------------------------------------------

@pytest.fixture(scope="module")
def pretrain_batch():
    graphs = jrandom_dataset(12, seed=3, min_nodes=8, max_nodes=20,
                             feat_dim=9)
    egos = [jextract_egonets(x, 1) for x in graphs]
    jg = jpack_graphs(graphs, 256, 1024, 16, banded="device")
    jsub = jpack_subgraphs(graphs, egos, 1024, 4096, banded="device")
    return jg, jsub


@pytest.mark.parametrize("encoder", ["GCN", "GraphSAGE"])
def test_pretrain_model_matches_jax(pretrain_batch, encoder):
    jg, jsub = pretrain_batch
    jmodel = JPretrainModel(in_dim=9, hidden=16, d_transfer=8,
                            encoder=encoder, deterministic=True)
    v = jax.tree_util.tree_map(np.asarray, jmodel.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jg, jsub, train=True))

    def loss(params):
        losses, _ = jmodel.apply({"params": params,
                                  "batch_stats": v["batch_stats"]},
                                 jg, jsub, train=True,
                                 mutable=["batch_stats"])
        return losses.total, losses
    (_, jl), jgrads = jax.value_and_grad(loss, has_aux=True)(v["params"])

    model = PretrainModel(9, hidden=16, d_transfer=8, encoder=encoder,
                          deterministic=True)
    state = from_jax_variables(v)
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    g, sub = (GraphBatch.from_numpy(jg, "cpu"),
              SubgraphBatch.from_numpy(jsub, "cpu"))
    counters.reset("encoder")
    losses = model.train()(g, sub)
    losses.total.backward()
    prefix = "gcn" if encoder == "GCN" else "sage"
    assert counters.of("encoder") == {f"{prefix}_band": 6}
    for a, b in zip(losses, jl):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=1e-4)
    want = from_jax_variables({"params": jax.tree_util.tree_map(
        np.asarray, jgrads)})
    scale = max(float(w.abs().max()) for w in want.values())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-3, atol=1e-5 * scale,
                                   err_msg=name)


# --- fine-tuning: the freeze masks, one masked step, the Adam bridge ---------

@pytest.fixture(scope="module")
def labelled():
    return jax_batch(labelled_graphs(seed=3))


def _ft_models(encoder):
    kw = dict(hidden=HID, d_transfer=DT, encoder=encoder, deterministic=True)
    return (FinetuneModel(IN, num_out=TASKS, **kw),
            JFinetuneModel(in_dim=IN, num_out=TASKS, **kw))


@pytest.mark.parametrize("encoder", ["GCN", "GraphSAGE"])
@pytest.mark.parametrize("mode", ["reference", "paper", "all", "frozen"])
def test_trainable_mask_matches_jax(labelled, mode, encoder):
    jg, jsub = labelled
    model, jmodel = _ft_models(encoder)
    params = jax_variables(jmodel, jg, jsub)["params"]
    jmask = jtrainer.finetune_trainable_mask(params, mode)
    per_name = from_jax_variables({"params": jax.tree_util.tree_map(
        lambda t, p: np.full(p.shape, t), jmask, params)})
    want = [n for n, _ in model.named_parameters()
            if bool(per_name[n].all())]
    got = finetune_trainable_mask(model, mode)
    assert got == want
    core = [n for n in got if n.startswith("core.")]
    if mode == "reference":
        # GCN's conv2 trains; no GraphSAGE parameter is named conv2 or bn2
        assert core == ([] if encoder == "GraphSAGE" else [
            f"core.encoder{e}.conv2.{w}" for e in (1, 2)
            for w in ("weight", "bias")])


@pytest.mark.parametrize("encoder", ["GCN", "GraphSAGE"])
def test_masked_finetune_step_and_adam_bridge_match_jax(labelled, encoder,
                                                        tmp_path):
    """One ``reference``-masked BCE step from the same weights: the loss,
    the parameters and statistics, and Adam's moments in the JAX
    ``masked_tx`` layout; then the port's state saved as an autosave and
    read back into a fresh port model and optimizer, byte for byte."""
    jg, jsub = labelled
    model, jmodel = _ft_models(encoder)
    v = jax_variables(jmodel, jg, jsub)
    jmask = jtrainer.finetune_trainable_mask(v["params"], "reference")
    tx = jtrainer.masked_tx(jtrainer.adam_l2(LR, WD), jmask)
    jstate = jtrainer.TrainState.create(v, tx)
    jstep = jtrainer.make_finetune_step(jmodel, tx, "bce", donate=False)
    jstate, jloss = jstep(jstate, jg, jsub, jax.random.PRNGKey(0))

    model.load_state_dict(from_jax_variables(v))
    opt = masked_adam(model, finetune_trainable_mask(model, "reference"),
                      LR, WD)
    loss = make_finetune_step(model, opt, "bce")(*port(jg, jsub))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    close_state(model, {"params": jstate.params,
                        "batch_stats": jstate.batch_stats}, lr=LR)
    mine = adam_to_optax(model, opt)["inner_states"]["train"]["inner_state"]
    ref = serialization.to_state_dict(jax.tree_util.tree_map(
        np.asarray, jstate.opt_state))["inner_states"]["train"]["inner_state"]
    for key in ("mu", "nu"):
        a, b = mine["0"]["1"][key], ref["0"]["1"][key]
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-3,
                                   atol=1e-5 * np.abs(b).max())

    path = str(tmp_path / "auto.msgpack")
    ckpt.save_train_state(path, TrainState(model, opt, step=1), 0,
                          np.zeros(2, np.uint32))
    again, _ = _ft_models(encoder)
    opt2 = masked_adam(again, finetune_trainable_mask(again, "reference"),
                       LR, WD)
    ckpt.load_train_state(path, TrainState(again, opt2))
    for (n, a), b in zip(model.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), n
    back = adam_to_optax(again, opt2)
    for key in ("mu", "nu"):
        np.testing.assert_array_equal(
            back["inner_states"]["train"]["inner_state"]["0"]["1"][key],
            mine["0"]["1"][key])


# --- the verbs ---------------------------------------------------------------

SMALL = ["--synthetic", "60", "--hidden", "16", "--d_transfer", "8",
         "--batch_size", "16", "--device", "cpu", "--epochs", "1"]


@pytest.mark.parametrize("encoder", ["GCN", "GraphSAGE"])
def test_verbs_run_with_the_encoder(tmp_path, encoder):
    pre = str(tmp_path / "pre.msgpack")
    info = cli.main(["pretrain", "--encoder", encoder, "--out", pre] + SMALL)
    assert np.isfinite(info["history"]).all()
    ft = str(tmp_path / "ft.msgpack")
    run = cli.main(["finetune", "--dataset", "BACE", "--encoder", encoder,
                    "--pretrained", pre, "--out", ft] + SMALL)
    final_test = run["last"]["history"][-1][2]
    out = cli.main(["eval", "--dataset", "BACE", "--checkpoint", ft,
                    "--split", "test"] + SMALL)
    assert abs(out["test"] - final_test) <= 1e-6
    info = cli.main(["adapt", "--encoder", encoder, "--pretrained", pre,
                     "--out", str(tmp_path / "ad.msgpack")] + SMALL)
    assert np.isfinite(info["best_loss"])
