"""PyTorch port vs the JAX package: the pretraining loop and the
``pretrain`` verb.

The loop: a run stopped after an epoch and resumed from its autosave ends
bit-identical to one never stopped (CPU), a resume at the stage's end keeps
the best weights, the NaN guard halts a stage at its first non-finite epoch,
patience stops a stage early, and two epochs' losses match the JAX
package's ``run_pretraining`` from the same weights (both models
deterministic, both trainers given ``test_torch_trainer.py``'s gradient
mask; the same tolerance, rtol 1e-4).  The verb: every flag of the JAX
verb with its default, the flags whose modules are not ported yet refused
with the ROADMAP item that ports them, ``--pretrained``, and the
three-stage curriculum end to end, its core carried from stage to stage and
every stage skipped on a rerun."""

import argparse

import jax
import numpy as np
import optax
import pytest
import torch

from scgib_tpu import cli as jcli
from scgib_tpu.data import loader as jloader
from scgib_tpu.data.synthetic import random_dataset as jrandom_dataset
from scgib_tpu.models.scgib import PretrainModel as JPretrainModel
from scgib_tpu.train import checkpoint as jckpt
from scgib_tpu.train.loops import run_pretraining as jrun_pretraining
from scgib_tpu.train.trainer import TrainState as JTrainState
from scgib_tpu.train.trainer import adam_l2 as jadam_l2
from scgib_tpu.train.trainer import make_pretrain_step as jmake_pretrain_step

from scgib_tpu_torch import cli
from scgib_tpu_torch.data.loader import GraphDataset, plan_capacities
from scgib_tpu_torch.data.synthetic import random_dataset
from scgib_tpu_torch.models.scgib import PretrainLosses, PretrainModel
from scgib_tpu_torch.train import checkpoint as ckpt
from scgib_tpu_torch.train.loops import (NonFiniteLossError, jax_key,
                                         run_pretraining)
from scgib_tpu_torch.train.trainer import TrainState, make_pretrain_step
from scgib_tpu_torch.utils.params import (from_jax_variables, init_flax_style_,
                                          to_jax_variables)

BATCH = 8
HID, DT = 16, 8
LR, WD = 1e-4, 5e-5


def dataset():
    ds = GraphDataset(random_dataset(24, seed=5, min_nodes=6, max_nodes=14),
                      k=1)
    return ds, plan_capacities(ds, BATCH)


def fresh_state(lr=1e-3):
    model = PretrainModel(9, hidden=HID, d_transfer=DT)
    init_flax_style_(model, torch.Generator().manual_seed(0))
    return TrainState(model, torch.optim.Adam(model.parameters(), lr=lr,
                                              weight_decay=WD))


def run(state, ds, caps, epochs, **kw):
    step = make_pretrain_step(state.model, state.optimizer)
    return run_pretraining(step, state, ds, caps, BATCH, epochs=epochs,
                           seed=11, log=None, **kw)


def assert_states_equal(a: TrainState, b: TrainState):
    assert a.step == b.step
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for name in sa:
        assert torch.equal(sa[name], sb[name]), name
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a.optimizer.state[pa][key],
                               b.optimizer.state[pb][key]), key


def test_resume_is_bit_identical(tmp_path):
    ds, caps = dataset()
    path = str(tmp_path / "auto.msgpack")
    state_a, info_a = run(fresh_state(), ds, caps, 4)
    run(fresh_state(), ds, caps, 2, autosave_path=path)
    state_c, info_c = run(fresh_state(), ds, caps, 4, autosave_path=path)
    assert_states_equal(state_a, state_c)
    assert info_a["history"] == info_c["history"]
    assert info_a["best_loss"] == info_c["best_loss"]
    assert info_c["throughput"]["steps"] == 2 * 3     # epochs 2 and 3 only


def test_resume_at_stage_boundary_keeps_best_weights(tmp_path):
    ds, caps = dataset()
    path = str(tmp_path / "auto.msgpack")
    _, info_a = run(fresh_state(), ds, caps, 4, autosave_path=path)
    state_b, info_b = run(fresh_state(), ds, caps, 4, autosave_path=path)
    assert info_b["throughput"]["steps"] == 0
    assert (info_b["best_epoch"], info_b["best_loss"]) == \
        (info_a["best_epoch"], info_a["best_loss"])
    for (_, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(info_a["best_variables"]),
            jax.tree_util.tree_leaves_with_path(info_b["best_variables"])):
        np.testing.assert_array_equal(a, b)


def test_resume_from_a_jax_autosave_seeds_the_generator(tmp_path):
    """A JAX autosave has no torch generator state: the port seeds its
    generator from the saved key's words (and its key is the JAX
    package's PRNGKey of the seed)."""
    for seed in (42, 0, -5, 2 ** 31 + 5, 2 ** 40 + 3):
        np.testing.assert_array_equal(jax_key(seed),
                                      np.asarray(jax.random.PRNGKey(seed)))
    ds, caps = dataset()
    path = str(tmp_path / "auto.msgpack")
    state = fresh_state()
    ckpt.save_train_state(path, state, epoch=0, rng=np.array([1, 2],
                                                             np.uint32))
    gen = torch.Generator().manual_seed(0)
    run(fresh_state(), ds, caps, 1, autosave_path=path, generator=gen)
    assert gen.initial_seed() == (1 << 32) | 2


def test_nan_guard_halts_pretraining():
    ds, caps = dataset()
    state = fresh_state()
    step = make_pretrain_step(state.model, state.optimizer)
    calls = {"n": 0}

    def poisoned(g, sub, generator):
        losses = step(g, sub, generator)
        calls["n"] += 1
        if calls["n"] > 4:                  # diverge within epoch 1
            losses = losses._replace(kl=torch.tensor(float("nan")))
        return losses

    with pytest.raises(NonFiniteLossError) as err:
        run_pretraining(poisoned, state, ds, caps, BATCH, epochs=10,
                        seed=11, log=None)
    info = err.value.info
    assert info["nonfinite_epoch"] == 1 and info["best_epoch"] == 0
    assert np.isfinite(info["best_loss"])
    for leaf in jax.tree_util.tree_leaves(info["best_variables"]):
        assert np.isfinite(leaf).all()


def test_patience_stops_early():
    ds, caps = dataset()
    state = fresh_state()
    calls = {"n": 0}

    def worsening(g, sub, generator):
        calls["n"] += 1
        z = torch.tensor(0.0)
        return PretrainLosses(torch.tensor(float(calls["n"])), z, z)

    logs = []
    _, info = run_pretraining(worsening, state, ds, caps, BATCH, epochs=10,
                              patience=2, seed=11, log=logs.append)
    assert len(info["history"]) == 3 and info["best_epoch"] == 0
    assert logs[-1] == "early stop at epoch 2 (patience 2)"
    assert state.step == 3 * 3


def test_two_epochs_match_jax_loop():
    graphs = jrandom_dataset(24, seed=5, min_nodes=6, max_nodes=14)
    jds = jloader.GraphDataset(graphs, k=1)
    jcaps = jloader.plan_capacities(jds, BATCH)
    g0, sub0 = next(jloader.batch_iterator(jds, BATCH, jcaps, shuffle=False))
    jmodel = JPretrainModel(in_dim=9, hidden=HID, d_transfer=DT,
                            deterministic=True)
    v = jax.tree_util.tree_map(np.asarray, jmodel.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        g0, sub0, train=True))

    def total(params):
        losses, _ = jmodel.apply({"params": params,
                                  "batch_stats": v["batch_stats"]},
                                 g0, sub0, train=True,
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
    jstate, jinfo = jrun_pretraining(
        jmake_pretrain_step(jmodel, tx, donate=False),
        JTrainState.create(v, tx), jds, jcaps, BATCH, epochs=2, seed=11,
        log=None)

    ds, caps = dataset()
    model = PretrainModel(9, hidden=HID, d_transfer=DT, deterministic=True)
    model.load_state_dict(from_jax_variables(v))
    keep_t = from_jax_variables({"params": keep})
    for name, p in model.named_parameters():
        p.register_hook(lambda g, k=keep_t[name]: g * k)
    state = TrainState(model, torch.optim.Adam(model.parameters(), lr=LR,
                                               weight_decay=WD))
    _, info = run(state, ds, caps, 2)
    assert state.step == int(jstate.step)
    np.testing.assert_allclose(info["history"], jinfo["history"], rtol=1e-4)
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray,
                                                     jstate.variables))
    params = dict(model.named_parameters())
    for name, got in model.state_dict().items():
        np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                   rtol=1e-4,
                                   atol=5e-2 * LR if name in params else 1e-6,
                                   err_msg=name)


def _pretrain_flags(parser):
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {a.dest: a.default for a in sub.choices["pretrain"]._actions
            if a.dest != "help"}


def test_cli_has_every_jax_flag_with_its_default():
    want = _pretrain_flags(jcli.build_parser())
    got = _pretrain_flags(cli.build_parser())
    assert {k: got.get(k, "missing") for k in want} == want
    assert set(got) - set(want) == {"steps", "device"}


@pytest.mark.parametrize("flags,want", [
    ([], {"synthetic": 1024, "seed": 7}),
    (["--synthetic", "24", "--seed", "42"], {"synthetic": 24, "seed": 42})])
def test_cli_steps_keeps_its_own_defaults(monkeypatch, flags, want):
    """``--steps`` runs 1024 molecules from seed 7 unless told otherwise,
    as it did before the epoch loop took the JAX verb's defaults."""
    monkeypatch.setattr(cli, "run_pretrain", lambda **kw: kw)
    got = cli.main(["pretrain", "--steps", "1", "--device", "cpu"] + flags)
    assert {k: got[k] for k in want} == want


SMALL = ["pretrain", "--synthetic", "24", "--batch_size", "8", "--hidden",
         str(HID), "--d_transfer", str(DT), "--device", "cpu"]


@pytest.mark.parametrize("flags,item", [
    (["--cache", "x.npz"], "item 12"), (["--molnet_root", "d"], "item 12"),
    (["--stage_caches", "a.npz"], "item 12"),
    (["--synthetic_mode", "structured"], "item 12"),
    (["--superbatch", "4"], "item 14"), (["--encoder", "GCN"], "item 6"),
    (["--encoder", "GraphSAGE"], "item 6")])
def test_cli_refuses_flags_not_ported_yet(flags, item):
    with pytest.raises(SystemExit, match=item):
        cli.main(SMALL + ["--epochs", "1"] + flags)


def test_cli_pretrained_and_out(tmp_path, capsys):
    out = str(tmp_path / "a.msgpack")
    info = cli.main(SMALL + ["--epochs", "1", "--out", out])
    assert len(info["history"]) == 1
    again = str(tmp_path / "b.msgpack")
    cli.main(SMALL + ["--epochs", "0", "--pretrained", out, "--out", again])
    assert f"resumed from {out}" in capsys.readouterr().out
    first, meta = jckpt.load_checkpoint(out)
    second, _ = jckpt.load_checkpoint(again)
    for a, b in zip(jax.tree_util.tree_leaves(first),
                    jax.tree_util.tree_leaves(second)):
        np.testing.assert_array_equal(a, b)
    assert meta["config"]["hidden"] == HID and meta["step"] == 0


def test_curriculum_runs_end_to_end_and_skips_on_rerun(tmp_path,
                                                       monkeypatch):
    """Three stages (feature widths 9, 11, 9), each saved under the JAX
    package's name; each stage after the first starts from the previous
    stage's best core; a rerun skips all three."""
    starts = []
    original = cli.run_pretraining

    def recording(step_fn, state, *args, **kw):
        starts.append(to_jax_variables(state.model))
        return original(step_fn, state, *args, **kw)

    monkeypatch.setattr(cli, "run_pretraining", recording)
    argv = SMALL + ["--curriculum", "--epochs", "1", "--out",
                    str(tmp_path / "x"), "--autosave",
                    str(tmp_path / "auto.msgpack")]
    stages = cli.main(argv)
    assert [s["skipped"] for s in stages] == [False] * 3
    names = ["PCQM4Mv2", "PCQM4Mv2_QM9", "PCQM4Mv2_QM9_mol-PCBA"]
    for stage, name, fd in zip(stages, names, (9, 11, 9)):
        assert stage["path"] == str(
            tmp_path / f"pre_training_{name}_GIN_{HID}_4_1.msgpack")
        variables, meta = jckpt.load_checkpoint(stage["path"])
        assert variables["params"]["transfer_d"]["kernel"].shape == (fd, DT)
        assert (tmp_path / f"auto.msgpack.stage{stage['stage']}").exists()
    for prev, start in zip(stages, starts[1:]):
        core = prev["info"]["best_variables"]
        for col in ("params", "batch_stats"):
            for a, b in zip(jax.tree_util.tree_leaves(core[col]["core"]),
                            jax.tree_util.tree_leaves(start[col]["core"])):
                np.testing.assert_array_equal(a, b)
    assert [s["skipped"] for s in cli.main(argv)] == [True] * 3
    assert len(starts) == 3
