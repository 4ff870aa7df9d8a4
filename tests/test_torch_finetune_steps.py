"""PyTorch port vs the JAX package: the supervised path's training —
one fine-tuning step (with and without gradient accumulation) and one
adaptation step against the JAX steps, the evaluation function, the
masked optimizer's autosave both ways, and the loops' resume.

The steps hand both trainers one mask of the gradients that are zero but
for rounding (``tests/test_torch_trainer.py``: Adam turns their rounding
into a full step of either sign), then hold the loss to rtol 1e-5,
parameters to rtol 1e-4 with atol 5e-2 lr, BatchNorm statistics to atol
1e-6 and Adam's moments to rtol 1e-3 with atol 1e-5 of the largest.  The
scores of the evaluation function rtol 1e-5, atol 1e-6.  Autosaves that
only move between formats are compared bit for bit, and a resumed run's
final autosave must be byte-equal to an uninterrupted run's (at these
sizes torch's CPU backward is reproducible).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization
from optax import MaskedNode

from scgib_tpu.models import losses as jlosses
from scgib_tpu.train import checkpoint as jckpt
from scgib_tpu.train import trainer as jtrainer

from scgib_tpu_torch.config import DATASETS
from scgib_tpu_torch.data.loader import GraphDataset, plan_capacities
from scgib_tpu_torch.data.synthetic import random_dataset
from scgib_tpu_torch.models.scgib import DomainAdaptModel, FinetuneModel
from scgib_tpu_torch.train import checkpoint as ckpt
from scgib_tpu_torch.train import loops
from scgib_tpu_torch.train.trainer import (
    TrainState, adam_l2, finetune_trainable_mask, make_domainadapt_step,
    make_eval_fn, make_finetune_step, masked_adam)
from scgib_tpu_torch.utils.params import (adam_to_optax, from_jax_variables,
                                          init_flax_style_, to_jax_variables)

from supervised_cases import (ENCODERS, HID, IN, LR, TASKS, TOL, WD, DT,
                              close_state, jax_variables, make_batches,
                              models, port)


@pytest.fixture(scope="module")
def batches():
    return make_batches()


# --- the steps ---------------------------------------------------------------

def _keep(grads):
    """1 where |grad| is above 1e-5 of the largest, else 0."""
    g = jax.tree_util.tree_map(np.abs, grads)
    scale = max(a.max() for a in jax.tree_util.tree_leaves(g))
    return jax.tree_util.tree_map(
        lambda a: (a > 1e-5 * scale).astype(np.float32), g)


def _jax_keep_tx(keep, inner):
    """``inner`` after the keep mask, inside ``masked_tx`` (whose frozen
    leaves arrive as MaskedNode)."""
    def apply(u, _):
        return jax.tree_util.tree_map(
            lambda a, k: a if isinstance(a, MaskedNode) else a * k, u, keep,
            is_leaf=lambda x: isinstance(x, MaskedNode))
    return optax.chain(optax.stateless(apply), inner)


def _hook_keep(model, keep):
    keep_t = from_jax_variables({"params": keep})
    for name, p in model.named_parameters():
        if p.requires_grad:
            p.register_hook(lambda g, k=keep_t[name]: g * k)


@pytest.mark.parametrize("accum", [1, 2])
def test_finetune_step_matches_jax(batches, accum):
    """One masked step (``reference`` freeze, BCE), with gradient
    accumulation over two batches: the loss, the parameters, the BatchNorm
    statistics (threaded through both batches) and Adam's moments."""
    model, jmodel = models("finetune", "GIN")
    jg, jsub = batches[0]
    v = jax_variables(jmodel, jg, jsub)
    jmask = jtrainer.finetune_trainable_mask(v["params"], "reference")
    group = batches[:accum]

    def loss(params):
        total = 0.0
        for bg, bsub in group:
            scores, _ = jmodel.apply({"params": params,
                                      "batch_stats": v["batch_stats"]},
                                     bg, bsub, train=True,
                                     mutable=["batch_stats"])
            m = bg.label_mask & bg.graph_mask[:, None]
            total = total + jlosses.bce_loss(scores, bg.labels, m)
        return total
    keep = _keep(jax.jit(jax.grad(loss))(v["params"]))
    tx = jtrainer.masked_tx(_jax_keep_tx(keep, jtrainer.adam_l2(LR, WD)),
                            jmask)
    state = jtrainer.TrainState.create(v, tx)
    jstep = jtrainer.make_finetune_step(jmodel, tx, "bce", grad_accum=accum,
                                        donate=False)
    if accum == 1:
        jg_in, jsub_in = group[0]
    else:
        jg_in = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                       *[b[0] for b in group])
        jsub_in = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                         *[b[1] for b in group])
    state, jloss = jstep(state, jg_in, jsub_in, jax.random.PRNGKey(0))

    model.load_state_dict(from_jax_variables(v))
    opt = masked_adam(model, finetune_trainable_mask(model, "reference"),
                      LR, WD)
    _hook_keep(model, keep)
    step = make_finetune_step(model, opt, "bce", grad_accum=accum)
    pb = [port(*b) for b in group]
    got = (step(*pb[0]) if accum == 1 else
           step([b[0] for b in pb], [b[1] for b in pb]))
    np.testing.assert_allclose(float(got), float(jloss), rtol=1e-5)
    close_state(model, {"params": state.params,
                         "batch_stats": state.batch_stats}, lr=LR)
    frozen = [p for p in model.parameters() if not p.requires_grad]
    assert frozen and all(p.grad is None for p in frozen)
    mine = adam_to_optax(model, opt)["inner_states"]["train"]["inner_state"]
    ref = serialization.to_state_dict(jax.tree_util.tree_map(
        np.asarray, state.opt_state))["inner_states"]["train"][
            "inner_state"]["1"]               # after the keep mask's state
    assert int(mine["0"]["1"]["count"]) == int(ref["0"]["1"]["count"]) == 1
    for key in ("mu", "nu"):
        a, b = mine["0"]["1"][key], ref["0"]["1"][key]
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-3,
                                   atol=1e-5 * np.abs(b).max())


def test_domainadapt_step_matches_jax(batches):
    model, jmodel = models("domainadapt", "GIN")
    jg, jsub = batches[0]
    v = jax_variables(jmodel, jg, jsub)

    def loss(params):
        out, _ = jmodel.apply({"params": params,
                               "batch_stats": v["batch_stats"]}, jg, jsub,
                              train=True, mutable=["batch_stats"])
        return out
    keep = _keep(jax.jit(jax.grad(loss))(v["params"]))
    tx = optax.chain(
        optax.stateless(lambda u, _: jax.tree_util.tree_map(
            lambda a, k: a * k, u, keep)),
        jtrainer.adam_l2(LR, WD))
    state = jtrainer.TrainState.create(v, tx)
    jstep = jtrainer.make_domainadapt_step(jmodel, tx, donate=False)
    state, jloss = jstep(state, jg, jsub, jax.random.PRNGKey(0))

    model.load_state_dict(from_jax_variables(v))
    opt = adam_l2(model, LR, WD)
    _hook_keep(model, keep)
    got = make_domainadapt_step(model, opt)(*port(jg, jsub))
    np.testing.assert_allclose(float(got), float(jloss), rtol=1e-5)
    close_state(model, {"params": state.params,
                         "batch_stats": state.batch_stats}, lr=LR)


# --- evaluation --------------------------------------------------------------

@pytest.mark.parametrize("encoder", sorted(ENCODERS))
def test_eval_fn_is_reproducible_and_matches_jax(batches, encoder):
    """Eval mode with the gate's noise drawn: two calls from one seed give
    the same scores, another seed others, and the BatchNorm statistics do
    not move; deterministic, the JAX eval function's scores; with
    ``live_noise`` train-mode statistics, which are put back."""
    jg, jsub = batches[0]
    g, sub = port(jg, jsub)
    model, jmodel = models("finetune", encoder)
    # the gate's noise adds no parameter
    v = jax_variables(jmodel, jg, jsub)
    noisy = FinetuneModel(IN, num_out=TASKS, hidden=HID, d_transfer=DT,
                          **ENCODERS[encoder])
    noisy.load_state_dict(from_jax_variables(v))
    before = {k: t.clone() for k, t in noisy.state_dict().items()}
    run = make_eval_fn(noisy)
    a, b = (run(g, sub, torch.Generator().manual_seed(0)) for _ in range(2))
    c = run(g, sub, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert noisy.training and not a.requires_grad
    live = make_eval_fn(noisy, live_noise=True)(
        g, sub, torch.Generator().manual_seed(0))
    assert not torch.equal(live, a)
    for k, t in noisy.state_dict().items():
        assert torch.equal(t, before[k]), k

    model.load_state_dict(from_jax_variables(v))
    got = make_eval_fn(model)(g, sub)
    want = jtrainer.make_eval_fn(jmodel)(v, jg, jsub, jax.random.PRNGKey(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --- the masked optimizer's autosave, both ways ------------------------------

def _masked_pair(batches, mode="reference"):
    """A port and a JAX fine-tuning state from one init, one step each."""
    jg, jsub = batches[0]
    model, jmodel = models("finetune", "GIN")
    v = jax_variables(jmodel, jg, jsub)
    tx = jtrainer.masked_tx(jtrainer.adam_l2(LR, WD),
                            jtrainer.finetune_trainable_mask(v["params"],
                                                             mode))
    jstate = jtrainer.TrainState.create(v, tx)
    jstate, _ = jtrainer.make_finetune_step(jmodel, tx, donate=False)(
        jstate, jg, jsub, jax.random.PRNGKey(0))
    model.load_state_dict(from_jax_variables(v))
    opt = masked_adam(model, finetune_trainable_mask(model, mode), LR, WD)
    make_finetune_step(model, opt)(*port(jg, jsub))
    return TrainState(model, opt, step=1), jstate, tx, v


@pytest.mark.parametrize("mode", ["reference", "frozen"])
def test_port_finetune_autosave_loads_in_jax(batches, tmp_path, mode):
    state, _, tx, v = _masked_pair(batches, mode)
    path = str(tmp_path / "auto.msgpack")
    ckpt.save_train_state(path, state, 3, np.array([0, 7], np.uint32),
                          extra={"best_val": 0.5,
                                 "history": np.zeros((2, 3))})
    template = jtrainer.TrainState.create(v, tx)
    loaded, epoch, rng, extra = jckpt.load_train_state(path, template)
    assert epoch == 3 and int(loaded.step) == 1
    assert float(extra["best_val"]) == 0.5
    want = to_jax_variables(state.model)
    for a, b in zip(jax.tree_util.tree_leaves(want["params"]),
                    jax.tree_util.tree_leaves(loaded.params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    inner = loaded.opt_state.inner_states["train"].inner_state
    mine = adam_to_optax(state.model, state.optimizer)
    adam = mine["inner_states"]["train"]["inner_state"]["0"]["1"]
    np.testing.assert_array_equal(np.asarray(inner[0][1].mu), adam["mu"])
    np.testing.assert_array_equal(np.asarray(inner[0][1].nu), adam["nu"])
    # the JAX step continues from it
    jg, jsub = batches[0]
    jmodel = models("finetune", "GIN")[1]
    nxt, loss = jtrainer.make_finetune_step(jmodel, tx, donate=False)(
        loaded, jg, jsub, jax.random.PRNGKey(1))
    assert np.isfinite(float(loss)) and int(nxt.step) == 2


def test_jax_finetune_autosave_loads_in_port(batches, tmp_path):
    state, jstate, _, _ = _masked_pair(batches)
    path = str(tmp_path / "jauto.msgpack")
    jckpt.save_train_state(path, jstate, 2, jax.random.PRNGKey(5),
                           extra={"best_val": 0.25})
    model, _ = models("finetune", "GIN")
    opt = masked_adam(model, finetune_trainable_mask(model, "reference"),
                      LR, WD)
    fresh = TrainState(model, opt)
    epoch, rng, extra = ckpt.load_train_state(path, fresh)
    assert epoch == 2 and fresh.step == 1 and float(extra["best_val"]) == 0.25
    close_state(model, jax.tree_util.tree_map(np.asarray, jstate.variables))
    mine = adam_to_optax(model, opt)["inner_states"]["train"]["inner_state"]
    ref = serialization.to_state_dict(jax.tree_util.tree_map(
        np.asarray, jstate.opt_state))["inner_states"]["train"]["inner_state"]
    for key in ("mu", "nu"):
        np.testing.assert_array_equal(mine["0"]["1"][key], ref["0"]["1"][key])
    np.testing.assert_array_equal(mine["1"], ref["1"])
    assert dataclasses.is_dataclass(fresh)


# --- the loops: resume -------------------------------------------------------

def _data(spec):
    ds = GraphDataset(random_dataset(48, seed=1, num_tasks=spec.num_tasks),
                      k=1)
    return ds, plan_capacities(ds, 8), ds.split(32, 8, shuffle_seed=2)


def _finetune(spec, epochs, autosave, seed=5):
    """``run_finetune`` at the tests' size from a fresh model (a resumed
    run loads everything the autosave holds over it)."""
    ds, caps, (train, val, test) = _data(spec)
    model = FinetuneModel(IN, num_out=spec.num_tasks, hidden=HID,
                          d_transfer=DT, num_layers=3)
    init_flax_style_(model, torch.Generator().manual_seed(seed))
    opt = masked_adam(model, finetune_trainable_mask(model), LR, WD)
    step = make_finetune_step(model, opt, spec.loss, spec.grad_accum)
    return loops.run_finetune(step, make_eval_fn(model),
                              TrainState(model, opt), train, val, test, caps,
                              8, spec, epochs=epochs, seed=3, log=None,
                              autosave_path=autosave)


def _adapt(epochs, autosave, seed=5):
    ds, caps, _ = _data(DATASETS["BACE"])
    model = DomainAdaptModel(IN, hidden=HID, d_transfer=DT, num_layers=3)
    init_flax_style_(model, torch.Generator().manual_seed(seed))
    opt = adam_l2(model, LR, WD)
    return loops.run_domain_adaptation(
        make_domainadapt_step(model, opt), TrainState(model, opt), ds, caps,
        8, epochs=epochs, seed=3, log=None, autosave_path=autosave)


SPECS = {"bce": DATASETS["BACE"],
         "bce grad_accum 2": dataclasses.replace(DATASETS["BACE"],
                                                 grad_accum=2),
         "rmse": DATASETS["ESOL"]}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_run_finetune_resumes_bit_equal(tmp_path, monkeypatch, name):
    """Two epochs straight against one epoch, then a fresh run resuming
    from its autosave: the final autosaves byte-equal (weights, masked
    Adam state, generator, the selection bookkeeping); and a resume that
    drops the Adam state is not."""
    spec = SPECS[name]
    full, part = str(tmp_path / "full"), str(tmp_path / "part")
    want = _finetune(spec, 2, full)
    assert len(want["history"]) == 2 and want["best_epoch"] >= 0
    steps = want["throughput"]["steps"]
    assert steps == (4 if spec.grad_accum == 1 else 2) * 2
    _finetune(spec, 1, part)
    first = open(part, "rb").read()
    got = _finetune(spec, 2, part, seed=9)
    assert got["history"] == want["history"]
    assert open(part, "rb").read() == open(full, "rb").read()
    with open(part, "wb") as f:
        f.write(first)
    monkeypatch.setattr(ckpt, "load_adam_state", lambda *a: None)
    _finetune(spec, 2, part)
    assert open(part, "rb").read() != open(full, "rb").read()


def test_run_domain_adaptation_resumes_bit_equal(tmp_path):
    full, part = str(tmp_path / "full"), str(tmp_path / "part")
    _, want = _adapt(2, full)
    _adapt(1, part)
    _, got = _adapt(2, part, seed=9)
    assert open(part, "rb").read() == open(full, "rb").read()
    assert got["best_loss"] == want["best_loss"] and len(want["history"]) == 2


def test_run_finetune_halts_on_a_non_finite_loss():
    spec = DATASETS["BACE"]
    ds, caps, (train, val, test) = _data(spec)
    model = FinetuneModel(IN, hidden=HID, d_transfer=DT, num_layers=3)
    opt = masked_adam(model, finetune_trainable_mask(model), LR, WD)

    def step(g, sub, gen):
        return torch.tensor(float("nan"))
    with pytest.raises(loops.NonFiniteLossError) as err:
        loops.run_finetune(step, make_eval_fn(model), TrainState(model, opt),
                           train, val, test, caps, 8, spec, epochs=2,
                           log=None)
    assert err.value.info["nonfinite_epoch"] == 0


def test_evaluate_equals_packed_eval():
    spec = DATASETS["BACE"]
    ds, caps, (_, val, _) = _data(spec)
    model = FinetuneModel(IN, hidden=HID, d_transfer=DT, num_layers=3)
    init_flax_style_(model, torch.Generator().manual_seed(1))
    run = make_eval_fn(model)
    packed = loops.PackedEval(val, caps, 8, spec)
    once = loops.evaluate(run, val, caps, 8, spec)
    assert packed.evaluate(run) == packed.evaluate(run) == once
    assert packed.y.shape == (8, 1)
