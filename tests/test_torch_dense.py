"""PyTorch port vs the JAX package: the dense ego-net mode
(``subgraph_mode="dense"``, GIN only).

``max_egonet_size`` and ``pack_subgraphs_dense`` bit for bit; ``DenseGIN``
from the same (bridged) weights, output and input gradient; the dense
``PretrainModel``'s losses, candidates and gradients; the port's dense mode
against its own COO mode on the same graphs; the two modes' parameter
trees; and the dense batch through the training step (eager on the CPU) and
its capture key.  The graph batch is banded, so encoder1 takes the fused
GIN layer's plain version here.

Tolerances: DenseGIN outputs rtol 1e-5 and input gradients rtol 1e-4 with
atol 1e-5 of the largest; the models against JAX those of
``tests/test_torch_model.py`` (losses rtol 1e-4, gradients rtol 1e-3 with
atol 1e-5 of the largest); dense against COO those of
``tests/test_dense_subgraphs.py`` (KL and contrastive rtol 1e-4,
reconstruction 1e-3, candidates rtol 5e-3 atol 5e-4, gradients 5e-3)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scgib_tpu.data.synthetic import random_dataset as jrandom_dataset
from scgib_tpu.graph import batching as jbatching
from scgib_tpu.graph.egonet import extract_egonets as jextract_egonets
from scgib_tpu.models.encoders import DenseGIN as JDenseGIN
from scgib_tpu.models.losses import l2_normalize as jl2_normalize
from scgib_tpu.models.scgib import PretrainModel as JPretrainModel

from scgib_tpu_torch.data.synthetic import random_dataset
from scgib_tpu_torch.graph import batching
from scgib_tpu_torch.graph.container import (DenseSubgraphBatch, GraphBatch,
                                             SubgraphBatch)
from scgib_tpu_torch.graph.egonet import extract_egonets
from scgib_tpu_torch.models.encoders import DenseGIN
from scgib_tpu_torch.models.losses import l2_normalize
from scgib_tpu_torch.models.scgib import PretrainModel
from scgib_tpu_torch.ops.pool import sorted_segment_sum_banded
from scgib_tpu_torch.train import trainer
from scgib_tpu_torch.utils.params import from_jax_variables

FEAT, HID, DT = 5, 16, 8


def _s_max(egos):
    """The benchmark's dense slot width: the largest ego-net, rounded up
    to 8."""
    return (batching.max_egonet_size(egos) + 7) // 8 * 8


@pytest.fixture(scope="module")
def setup():
    graphs = jrandom_dataset(6, seed=17, min_nodes=5, max_nodes=12,
                             feat_dim=FEAT)
    egos = [jextract_egonets(g, 1) for g in graphs]
    jg = jbatching.pack_graphs(graphs, 128, 512, 8, banded="device")
    jcoo = jbatching.pack_subgraphs(graphs, egos, 384, 2048,
                                    banded="device")
    jdense = jbatching.pack_subgraphs_dense(graphs, egos, 128, _s_max(egos))
    jmodel = JPretrainModel(in_dim=FEAT, hidden=HID, d_transfer=DT,
                            deterministic=True, subgraph_mode="dense")
    v = jax.tree_util.tree_map(np.asarray, jmodel.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jg, jdense, train=True))
    port = (GraphBatch.from_numpy(jg, "cpu"),
            SubgraphBatch.from_numpy(jcoo, "cpu"),
            DenseSubgraphBatch.from_numpy(jdense, "cpu"))
    return jg, jcoo, jdense, jmodel, v, port


def _model(v, mode):
    m = PretrainModel(FEAT, hidden=HID, d_transfer=DT, deterministic=True,
                      subgraph_mode=mode)
    m.load_state_dict(from_jax_variables(v))
    return m.train()


# --- the packer --------------------------------------------------------------

@pytest.mark.parametrize("seed,k", [(0, 1), (1, 1), (2, 2)])
def test_dense_packer_is_jax_bit_for_bit(seed, k):
    graphs = random_dataset(9, seed=seed, min_nodes=4, max_nodes=15,
                            feat_dim=FEAT)
    jgraphs = jrandom_dataset(9, seed=seed, min_nodes=4, max_nodes=15,
                              feat_dim=FEAT)
    egos = [extract_egonets(g, k) for g in graphs]
    jegos = [jextract_egonets(g, k) for g in jgraphs]
    assert batching.max_egonet_size(egos) == jbatching.max_egonet_size(jegos)
    s_max = _s_max(egos)
    got = batching.pack_subgraphs_dense(graphs, egos, 160, s_max)
    want = jbatching.pack_subgraphs_dense(jgraphs, jegos, 160, s_max)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), np.asarray(getattr(want, f.name))
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        assert a.tobytes() == b.tobytes(), f.name
    assert (got.num_centers, got.max_sub) == (160, s_max)


def test_dense_packer_refuses_what_does_not_fit():
    graphs = random_dataset(4, seed=0, min_nodes=6, max_nodes=10,
                            feat_dim=FEAT)
    egos = [extract_egonets(g, 1) for g in graphs]
    with pytest.raises(ValueError, match="exceeds max_sub"):
        batching.pack_subgraphs_dense(graphs, egos, 64, 2)
    with pytest.raises(IndexError):          # as JAX's: a row past C
        batching.pack_subgraphs_dense(graphs, egos, 8,
                                      batching.max_egonet_size(egos))


def test_dense_batch_moves_to_tensors(setup):
    *_, (_, _, dense) = setup
    assert dense.node_orig.dtype == torch.int64
    assert dense.mask.dtype == torch.bool
    assert dense.adj.dtype == dense.node_feat.dtype == torch.float32


# --- DenseGIN and the dense model --------------------------------------------

def test_dense_gin_matches_jax(setup):
    _, _, jdense, *_ = setup
    rng = np.random.default_rng(1)
    x = rng.normal(size=jdense.node_feat.shape[:2] + (DT,)).astype(
        np.float32)
    jenc = JDenseGIN(hidden=HID, num_convs=3)
    v = jax.tree_util.tree_map(np.asarray, jenc.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jdense.adj,
        mask=jdense.mask, train=True))

    def f(xx):
        out, _ = jenc.apply(v, xx, jdense.adj, mask=jdense.mask, train=True,
                            mutable=["batch_stats"])
        return out
    want = np.asarray(f(jnp.asarray(x)))
    want_grad = np.asarray(jax.grad(lambda xx: jnp.sum(f(xx) ** 2))(
        jnp.asarray(x)))
    enc = DenseGIN(DT, hidden=HID, num_convs=3)
    enc.load_state_dict(from_jax_variables(v))
    xt = torch.from_numpy(x).requires_grad_()
    mask = torch.from_numpy(np.asarray(jdense.mask))
    out = enc(xt, torch.from_numpy(np.asarray(jdense.adj)), mask=mask)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(xt.grad.numpy(), want_grad, rtol=1e-4,
                               atol=1e-5 * np.abs(want_grad).max())
    assert float(out.detach()[~mask].abs().max()) == 0.0


def test_dense_model_losses_and_grads_match_jax(setup):
    jg, _, jdense, jmodel, v, (g, _, dense) = setup

    def loss(params):
        losses, _ = jmodel.apply({"params": params,
                                  "batch_stats": v["batch_stats"]},
                                 jg, jdense, train=True,
                                 mutable=["batch_stats"])
        return losses.total, losses
    (_, jl), jgrads = jax.value_and_grad(loss, has_aux=True)(v["params"])
    model = _model(v, "dense")
    losses = model(g, dense)
    losses.total.backward()
    for a, b in zip(losses, jl):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=1e-4)
    want = from_jax_variables({"params": jax.tree_util.tree_map(
        np.asarray, jgrads)})
    scale = max(float(w.abs().max()) for w in want.values())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-3, atol=1e-5 * scale,
                                   err_msg=name)


def _cand_dense(model, g, sub):
    x = model.transfer_d(l2_normalize(sub.node_feat))
    h = model.core.encoder2(x, sub.adj, mask=sub.mask)
    return (h * sub.mask.to(h.dtype)[:, :, None]).sum(1)


def _cand_coo(model, g, sub):
    x = model.transfer_d(l2_normalize(g.node_feat[sub.node_orig]))
    h = model.core.encoder2(x, sub.senders, sub.receivers,
                            node_mask=sub.node_mask, edge_mask=sub.edge_mask)
    return sorted_segment_sum_banded(h, sub.node_center, g.num_nodes,
                                     mask=sub.node_mask)


def test_dense_candidates_match_jax(setup):
    jg, _, jdense, jmodel, v, (g, _, dense) = setup

    def cand(m, g_, sub_):
        xs = m.transfer_d(jl2_normalize(sub_.node_feat))
        h = m.core.encoder2(xs, sub_.adj, mask=sub_.mask, train=True)
        return jnp.sum(h * sub_.mask.astype(h.dtype)[:, :, None], axis=1)
    want, _ = jmodel.apply(v, jg, jdense, method=cand,
                           mutable=["batch_stats"])
    with torch.no_grad():
        got = _cand_dense(_model(v, "dense"), g, dense)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_dense_mode_matches_coo_mode(setup):
    *_, v, (g, coo, dense) = setup
    dm, cm = _model(v, "dense"), _model(v, "coo")
    with torch.no_grad():
        np.testing.assert_allclose(_cand_dense(dm, g, dense).numpy(),
                                   _cand_coo(cm, g, coo).numpy(),
                                   rtol=5e-3, atol=5e-4)
    dm, cm = _model(v, "dense"), _model(v, "coo")
    ld, lc = dm(g, dense), cm(g, coo)
    for a, b, rtol in zip(ld, lc, (1e-4, 1e-4, 1e-3)):
        np.testing.assert_allclose(float(a.detach()), float(b.detach()),
                                   rtol=rtol)
    ld.total.backward()
    lc.total.backward()
    for (name, a), b in zip(dm.named_parameters(), cm.parameters()):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   rtol=5e-3, atol=5e-3, err_msg=name)


def test_parameter_trees_of_the_two_modes_are_identical(setup):
    *_, v, _ = setup
    dense = PretrainModel(FEAT, hidden=HID, d_transfer=DT,
                          subgraph_mode="dense").state_dict()
    coo = PretrainModel(FEAT, hidden=HID, d_transfer=DT).state_dict()
    assert {k: t.shape for k, t in dense.items()} == \
        {k: t.shape for k, t in coo.items()}
    assert set(dense) == set(from_jax_variables(v))
    with pytest.raises(ValueError, match="GIN only"):
        PretrainModel(FEAT, encoder="GCN", subgraph_mode="dense")


def test_dense_batch_through_the_training_step(setup):
    """The step's capture key and input buffers take a dense batch (no
    ``pool_fits``, no ``gt_fits``); on the CPU the step is the eager one,
    and one step from the same start equals ``pretrain_step_eager``."""
    *_, v, (g, _, dense) = setup
    key = trainer.batch_key(g, dense)
    assert ("adj", (tuple(dense.adj.shape), torch.float32)) in key
    bufs = trainer._input_buffers(dense)
    assert isinstance(bufs, DenseSubgraphBatch)
    assert bufs.adj.shape == dense.adj.shape and bufs.adj is not dense.adj
    out = []
    for captured in (True, False):
        model = _model(v, "dense")
        model.core.deterministic = False
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        gen = torch.Generator().manual_seed(3)
        step = (trainer.make_pretrain_step(model, opt) if captured else
                lambda a, b, gn: trainer.pretrain_step_eager(model, opt, a, b,
                                                             gn))
        losses = [step(g, dense, gen) for _ in range(2)]
        out.append((losses, model.state_dict()))
    for a, b in zip(out[0][0], out[1][0]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    for k, t in out[0][1].items():
        assert torch.equal(t, out[1][1][k]), k
