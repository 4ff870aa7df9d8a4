"""The pretraining step with ``remat`` (activation checkpointing).

On the CPU the remat step must be bitwise the plain step (losses, weights,
BatchNorm statistics and the generator after 3 steps, GIN and the graph
transformer with its dropout, the single and the scan step), with every
forward op run twice (the encoders' branch counts); two planted faults,
noise drawn afresh in the recomputation and the BatchNorm statistics moved
twice, must each break that.  Against the JAX package's
``make_pretrain_step(..., remat=True)``: the tolerances and the gradient
mask of ``tests/test_torch_trainer.py`` (rtol 1e-4; atol 5e-2 lr on the
parameters, 1e-6 on the statistics).
"""

import contextlib

import jax
import numpy as np
import optax
import pytest
import torch

from scgib_tpu.data.synthetic import random_dataset as jrandom_dataset
from scgib_tpu.graph.batching import pack_graphs as jpack_graphs
from scgib_tpu.graph.batching import pack_subgraphs as jpack_subgraphs
from scgib_tpu.graph.egonet import extract_egonets as jextract_egonets
from scgib_tpu.models.scgib import PretrainModel as JPretrainModel
from scgib_tpu.train.trainer import TrainState, adam_l2 as jadam_l2
from scgib_tpu.train.trainer import make_pretrain_step as jmake_pretrain_step

from scgib_tpu_torch.data.loader import (GraphDataset, batch_iterator,
                                         plan_capacities)
from scgib_tpu_torch.data.synthetic import random_dataset
from scgib_tpu_torch.graph.container import GraphBatch, SubgraphBatch
from scgib_tpu_torch.models.scgib import PretrainModel
from scgib_tpu_torch.train import trainer
from scgib_tpu_torch.train.trainer import (adam_l2, make_pretrain_scan_step,
                                           make_pretrain_step)
from scgib_tpu_torch.utils import counters
from scgib_tpu_torch.utils.params import from_jax_variables, init_flax_style_

IN, HID, DT = 9, 16, 8
LR, WD, STEPS = 1e-4, 5e-5, 3
# encoder -> its convs or attention layers in one forward at num_layers 2
LAYERS = {"GIN": 2 * 2, "Transformer": 2 * 3}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these steps are many tiny ops, which crawl on
    several threads when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def batch():
    ds = GraphDataset(random_dataset(16, seed=2, min_nodes=8, max_nodes=20),
                      k=1)
    g, sub = next(batch_iterator(ds, 16, plan_capacities(ds, 16),
                                 shuffle=False))
    return g.to("cpu"), sub.to("cpu")


def _run(batch, encoder, remat, scan):
    """STEPS optimizer steps from one start; returns the losses, the
    state (weights, statistics, generator) as bytes, and the branch counts
    of one step."""
    model = PretrainModel(IN, hidden=HID, d_transfer=DT, encoder=encoder,
                          num_layers=2, num_heads=2)
    init_flax_style_(model, torch.Generator().manual_seed(0))
    opt = adam_l2(model, LR, WD)
    gen = torch.Generator().manual_seed(1)
    if scan:
        step = make_pretrain_scan_step(model, opt, STEPS, remat=remat)
    else:
        step = make_pretrain_step(model, opt, remat=remat)
    counters.reset("encoder")
    losses = [step(*batch, gen) for _ in range(1 if scan else STEPS)]
    counts = {k: n // STEPS for k, n in counters.of("encoder").items()}
    state = {k: v.numpy().tobytes() for k, v in model.state_dict().items()}
    state["generator"] = gen.get_state().numpy().tobytes()
    return ([t.numpy().tobytes() for ls in losses for t in ls], state,
            counts)


@pytest.mark.parametrize("scan", [False, True], ids=["step", "scan"])
@pytest.mark.parametrize("encoder", ["GIN", "Transformer"])
def test_remat_step_is_bitwise_the_plain_step(batch, encoder, scan):
    plain = _run(batch, encoder, False, scan)
    remat = _run(batch, encoder, True, scan)
    assert plain[0] == remat[0]
    assert [k for k in plain[1] if plain[1][k] != remat[1][k]] == []
    # the recomputation runs every conv or attention layer again
    assert sum(plain[2].values()) == LAYERS[encoder]
    assert remat[2] == {k: 2 * n for k, n in plain[2].items()}


def _fresh_draws(self):
    return contextlib.nullcontext()


@pytest.mark.parametrize("fault", ["noise drawn afresh",
                                   "statistics moved twice"])
def test_planted_faults_break_the_equality(batch, monkeypatch, fault):
    plain = _run(batch, "GIN", False, False)
    if fault == "noise drawn afresh":
        monkeypatch.setattr(trainer._ReplayedDraws, "replaying",
                            _fresh_draws)
    else:
        monkeypatch.setattr(trainer, "statistics_frozen",
                            lambda model: contextlib.nullcontext())
    remat = _run(batch, "GIN", True, False)
    apart = [k for k in plain[1] if plain[1][k] != remat[1][k]]
    if fault == "noise drawn afresh":
        assert plain[0] != remat[0] and "generator" in apart
    else:
        # the statistics differ, and nothing the step computes from them
        assert apart and all(k.endswith((".mean", ".var")) for k in apart)


def test_remat_steps_match_jax_remat_steps():
    graphs = jrandom_dataset(12, seed=4, min_nodes=8, max_nodes=20,
                             feat_dim=IN)
    egos = [jextract_egonets(x, 1) for x in graphs]
    jg = jpack_graphs(graphs, 256, 1024, 16, banded="device")
    jsub = jpack_subgraphs(graphs, egos, 1024, 4096, banded="device")
    jmodel = JPretrainModel(in_dim=IN, hidden=HID, d_transfer=DT,
                            deterministic=True)
    v = jmodel.init({"params": jax.random.PRNGKey(0),
                     "noise": jax.random.PRNGKey(1)}, jg, jsub, train=True)
    v = jax.tree_util.tree_map(np.asarray, v)

    def total(params):
        losses, _ = jmodel.apply({"params": params,
                                  "batch_stats": v["batch_stats"]},
                                 jg, jsub, train=True,
                                 mutable=["batch_stats"])
        return losses.total

    grad0 = jax.tree_util.tree_map(np.abs, jax.grad(total)(v["params"]))
    scale = max(a.max() for a in jax.tree_util.tree_leaves(grad0))
    keep = jax.tree_util.tree_map(
        lambda a: (a > 1e-5 * scale).astype(np.float32), grad0)
    tx = optax.chain(
        optax.stateless(lambda u, _: jax.tree_util.tree_map(
            lambda a, k: a * k, u, keep)),
        jadam_l2(LR, WD))
    state = TrainState.create(v, tx)
    jstep = jmake_pretrain_step(jmodel, tx, donate=False, remat=True)
    for i in range(STEPS):
        state, jlosses = jstep(state, jg, jsub, jax.random.PRNGKey(i))

    model = PretrainModel(IN, hidden=HID, d_transfer=DT, deterministic=True)
    model.load_state_dict(from_jax_variables(v))
    keep_t = from_jax_variables({"params": keep})
    for name, p in model.named_parameters():
        p.register_hook(lambda g, k=keep_t[name]: g * k)
    g, sub = (GraphBatch.from_numpy(jg, "cpu"),
              SubgraphBatch.from_numpy(jsub, "cpu"))
    step = make_pretrain_step(model, torch.optim.Adam(
        model.parameters(), lr=LR, weight_decay=WD), remat=True)
    for _ in range(STEPS):
        losses = step(g, sub)
    for a, b in zip(losses, jlosses):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-4)
    want = from_jax_variables(jax.tree_util.tree_map(
        np.asarray, {"params": state.params,
                     "batch_stats": state.batch_stats}))
    got = model.state_dict()
    params = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-4,
                                   atol=5e-2 * LR if name in params else 1e-6,
                                   err_msg=name)
