"""The superbatch step, the prefetch to the device and the data verbs of
the port, on the CPU at the tests' width (hidden 16, K <= 4).

The superbatch step (``make_pretrain_superbatch_step``) on one wire
buffer equals K eager steps on the batches decoded from it, bit for bit,
in both wire modes, and a superbatch whose batches' pooling flags differ
takes the scatter branch for all of them; its losses over K steps match the JAX package's
``make_pretrain_superbatch_step(byte_spec=...)`` on the same buffer (both
models deterministic, both trainers given ``test_torch_trainer.py``'s
gradient mask and tolerance, rtol 1e-4).  ``run_pretraining`` with
``superbatch_k`` drops the ragged tail group and resumes bit for bit at an
epoch's end.  ``prefetch_to_device`` and ``background_iter`` keep order
and raise a producer's exception at the consumer.  The verbs:
``preprocess``, ``pretrain --cache --superbatch`` (and ``--curriculum
--stage_caches``) and ``finetune --smiles_csv``.  ``profile_trace`` writes
a trace; ``StepTimer.summary`` is the JAX package's."""

import csv
import json
import os
import time

import jax
import numpy as np
import optax
import pytest
import torch

import scgib_tpu.native
from scgib_tpu.data import loader as jloader
from scgib_tpu.graph import wire as jwire
from scgib_tpu.models.scgib import PretrainModel as JPretrainModel
from scgib_tpu.train.trainer import TrainState as JTrainState
from scgib_tpu.train.trainer import adam_l2 as jadam_l2
from scgib_tpu.train.trainer import \
    make_pretrain_superbatch_step as jmake_superbatch_step
from scgib_tpu.utils.profiling import StepTimer as JStepTimer

from scgib_tpu_torch import cli
from scgib_tpu_torch.data import loader
from scgib_tpu_torch.data.synthetic import random_dataset
from scgib_tpu_torch.graph import wire
from scgib_tpu_torch.graph.batching import GraphData
from scgib_tpu_torch.models.scgib import PretrainModel
from scgib_tpu_torch.train.loops import run_pretraining
from scgib_tpu_torch.train.trainer import (TrainState,
                                           make_pretrain_superbatch_step,
                                           pretrain_step_eager)
from scgib_tpu_torch.utils import counters
from scgib_tpu_torch.utils.params import from_jax_variables, init_flax_style_
from scgib_tpu_torch.utils.profiling import StepTimer, profile_trace

IN, HID, DT = 9, 16, 8
LR, WD, K, B = 1e-4, 5e-5, 3, 8


@pytest.fixture(autouse=True)
def _jax_numpy_packers(monkeypatch):
    """The JAX side packs with its NumPy flat packer: its native library
    is ``tests/test_native.py``'s to build (in place)."""
    monkeypatch.setattr(scgib_tpu.native, "_load", lambda: None)


def _data(n=48, seed=2):
    kw = dict(min_nodes=6, max_nodes=20)
    ds = loader.GraphDataset(random_dataset(n, seed=seed, **kw), k=1)
    return ds, loader.plan_capacities(ds, B)


def _model(seed=11, **kw):
    model = PretrainModel(IN, hidden=HID, d_transfer=DT, **kw)
    init_flax_style_(model, torch.Generator().manual_seed(seed))
    return model


def _state(model, opt, gen):
    out = {k: v.clone() for k, v in model.state_dict().items()}
    out.update({f"adam {i} {k}": t.clone()
                for i, p in enumerate(model.parameters())
                for k, t in opt.state[p].items()})
    out["generator"] = gen.get_state()
    return out


@pytest.mark.parametrize("compact", [False, True])
def test_superbatch_step_is_k_eager_steps_bit_for_bit(compact):
    ds, caps = _data()
    spec = loader.superbatch_spec(ds, B, caps, K, compact=compact)
    buf, edges, fits = next(loader.wire_superbatches(
        ds, B, caps, K, seed=5, byte_spec=spec, compact=compact))
    assert edges > 0 and isinstance(fits, bool)
    buf = torch.from_numpy(buf)

    a = _model()
    opt_a = torch.optim.Adam(a.parameters(), lr=LR, weight_decay=WD)
    gen_a = torch.Generator().manual_seed(3)
    losses = make_pretrain_superbatch_step(a, opt_a, spec)(buf, fits, gen_a)
    assert losses.total.shape == (K,)

    b = _model()
    opt_b = torch.optim.Adam(b.parameters(), lr=LR, weight_decay=WD)
    gen_b = torch.Generator().manual_seed(3)
    gs, subs = wire.unpack_bytes(buf, spec)
    for k in range(K):
        g = wire.from_wire_graph(wire.index_wire(gs, k))
        sub = wire.from_wire_sub(wire.index_wire(subs, k))
        sub.pool_fits = fits
        one = pretrain_step_eager(b, opt_b, g, sub, gen_b)
        for x, y in zip(losses, one):
            assert torch.equal(x[k], y)
    sa, sb = _state(a, opt_a, gen_a), _state(b, opt_b, gen_b)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


def _mixed_flags_data():
    """Two batches of 61 in order at N = 512, S = 2048: the first's 11
    dense graphs (12 nodes, each pair joined with probability 0.8) make
    its first center tile own more ego-net rows than the pooling window
    holds (``pool_fits`` False), the second is small molecules (True)."""
    rng = np.random.default_rng(3)
    graphs = []
    for _ in range(11):
        upper = np.triu(rng.random((12, 12)) < 0.8, 1)
        s, r = np.nonzero(upper | upper.T)
        graphs.append(GraphData(senders=s.astype(np.int32),
                                receivers=r.astype(np.int32),
                                node_feat=rng.integers(
                                    0, 4, size=(12, IN)).astype(np.int8)))
    graphs += random_dataset(111, seed=4, min_nodes=4, max_nodes=6)
    ds = loader.GraphDataset(graphs, k=1)
    caps = loader.Capacities(nodes=512, edges=2048, graphs=64,
                             sub_nodes=2048, sub_edges=16384)
    return ds, caps


def test_superbatch_of_mixed_flags_pools_every_batch_by_scatter():
    """A superbatch whose batches' flags differ (False, True) carries
    one flag, False: its step is 2 eager steps that both pool through the
    scatter branch, bit for bit, and within float rounding of the steps
    that pool the fitting batch through the banded branch."""
    ds, caps = _mixed_flags_data()
    plans = loader.plan_batches(ds, 61, caps, shuffle=False)
    assert [len(p) for p in plans] == [61, 61]
    assert [loader.pack_batch(ds, p, caps)[1].pool_fits
            for p in plans] == [False, True]
    spec = loader.superbatch_spec(ds, 61, caps, 2)
    (buf, _, fits), = loader.wire_superbatches(ds, 61, caps, 2,
                                               shuffle=False, byte_spec=spec)
    assert fits is False
    buf = torch.from_numpy(buf)
    a = _model()
    opt_a = torch.optim.Adam(a.parameters(), lr=LR, weight_decay=WD)
    gen_a = torch.Generator().manual_seed(3)
    losses = make_pretrain_superbatch_step(a, opt_a, spec)(buf, fits, gen_a)

    gs, subs = wire.unpack_bytes(buf, spec)
    for own_flags in (False, True):
        banded = counters.of("pool", ["banded"])["banded"]
        b = _model()
        opt_b = torch.optim.Adam(b.parameters(), lr=LR, weight_decay=WD)
        gen_b = torch.Generator().manual_seed(3)
        for k in range(2):
            g = wire.from_wire_graph(wire.index_wire(gs, k))
            sub = wire.from_wire_sub(wire.index_wire(subs, k))
            sub.pool_fits = k == 1 if own_flags else fits
            one = pretrain_step_eager(b, opt_b, g, sub, gen_b)
            for x, y in zip(losses, one):
                if own_flags:
                    np.testing.assert_allclose(x[k].numpy(), y.numpy(),
                                               rtol=1e-5)
                else:
                    assert torch.equal(x[k], y)
        assert counters.of("pool", ["banded"])["banded"] - banded == own_flags
        if not own_flags:
            sa, sb = _state(a, opt_a, gen_a), _state(b, opt_b, gen_b)
            assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_superbatch_losses_match_jax():
    ds, caps = _data()
    jds = jloader.GraphDataset(ds.graphs, k=1, egonets=ds.egonets)
    spec = loader.superbatch_spec(ds, B, caps, K)
    jspec = jloader.superbatch_spec(jds, B, caps, K)
    buf, _, fits = next(loader.wire_superbatches(ds, B, caps, K, seed=5,
                                                 byte_spec=spec))
    g0, sub0 = next(jloader.batch_iterator(jds, B, caps, shuffle=False))
    jmodel = JPretrainModel(in_dim=IN, hidden=HID, d_transfer=DT,
                            deterministic=True)
    v = jax.tree_util.tree_map(np.asarray, jmodel.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        g0, sub0, train=True))

    # the mask: entries above 1e-5 of the largest gradient on every one
    # of the superbatch's K batches, at the start
    jgs, jsubs = jwire.unpack_bytes(jax.numpy.asarray(buf), jspec)
    keep = None
    for k in range(K):
        g, sub = (f(jax.tree_util.tree_map(lambda a: a[k], w))
                  for f, w in ((jwire.from_wire_graph, jgs),
                               (jwire.from_wire_sub, jsubs)))

        def total(params):
            losses, _ = jmodel.apply({"params": params,
                                      "batch_stats": v["batch_stats"]},
                                     g, sub, train=True,
                                     mutable=["batch_stats"])
            return losses.total

        grad = jax.tree_util.tree_map(np.abs, jax.grad(total)(v["params"]))
        scale = max(a.max() for a in jax.tree_util.tree_leaves(grad))
        kept = jax.tree_util.tree_map(
            lambda a: (a > 1e-5 * scale).astype(np.float32), grad)
        keep = kept if keep is None else jax.tree_util.tree_map(
            np.minimum, keep, kept)
    tx = optax.chain(optax.stateless(lambda u, _: jax.tree_util.tree_map(
        lambda a, k: a * k, u, keep)), jadam_l2(LR, WD))
    jstep = jmake_superbatch_step(jmodel, tx, donate=False, byte_spec=jspec)
    state, jlosses = jstep(JTrainState.create(v, tx), buf,
                           jax.random.PRNGKey(0))

    model = PretrainModel(IN, hidden=HID, d_transfer=DT, deterministic=True)
    model.load_state_dict(from_jax_variables(v))
    keep_t = from_jax_variables({"params": keep})
    for name, p in model.named_parameters():
        p.register_hook(lambda g, k=keep_t[name]: g * k)
    step = make_pretrain_superbatch_step(model, torch.optim.Adam(
        model.parameters(), lr=LR, weight_decay=WD), spec)
    losses = step(torch.from_numpy(buf), fits)
    for a, b in zip(losses, jlosses):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4)
    want = from_jax_variables(jax.tree_util.tree_map(
        np.asarray, {"params": state.params,
                     "batch_stats": state.batch_stats}))
    params = dict(model.named_parameters())
    for name, w in want.items():
        np.testing.assert_allclose(model.state_dict()[name].numpy(),
                                   w.numpy(), rtol=1e-4,
                                   atol=5e-2 * LR if name in params else 1e-6,
                                   err_msg=name)


def test_superbatch_loop_drops_the_tail_and_resumes(tmp_path):
    """48 graphs in batches of 8 are 6 batches: 2 superbatches of 3 an
    epoch (of 4, 1 and the tail of 2 dropped); a run stopped after epoch
    0 and resumed ends bit-equal to one never stopped."""
    ds, caps = _data()
    spec = loader.superbatch_spec(ds, B, caps, K)

    def run(epochs, path, k=K):
        model = _model()
        opt = torch.optim.Adam(model.parameters(), lr=LR, weight_decay=WD)
        k_spec = spec if k == K else loader.superbatch_spec(ds, B, caps, k)
        return run_pretraining(
            make_pretrain_superbatch_step(model, opt, k_spec),
            TrainState(model, opt), ds, caps, B, epochs=epochs, seed=1,
            log=None, autosave_path=path, superbatch_k=k,
            superbatch_spec=k_spec)

    state, info = run(2, str(tmp_path / "a.msgpack"))
    assert state.step == 2 * 6 and len(info["history"]) == 2
    assert all(np.isfinite(info["history"]))
    assert info["throughput"]["steps"] == 4
    run(1, str(tmp_path / "b.msgpack"))
    resumed, _ = run(2, str(tmp_path / "b.msgpack"))
    with open(tmp_path / "a.msgpack", "rb") as f, \
            open(tmp_path / "b.msgpack", "rb") as g:
        assert f.read() == g.read()
    four, _ = run(1, None, k=4)
    assert four.step == 4


def test_superbatches_refuse_logm_targets():
    ds, caps = _data(24)
    with pytest.raises(ValueError, match="logM"):
        loader.superbatch_spec(ds, B, caps, 2, logm_k=1)
    with pytest.raises(ValueError, match="logM"):
        next(loader.wire_superbatches(ds, B, caps, 2, logm_k=1))


def test_prefetch_keeps_order_and_raises():
    ds, caps = _data(32)
    plain = list(loader.batch_iterator(ds, B, caps, seed=2))
    got = list(loader.prefetch_to_device(
        ((g, s, i) for i, (g, s) in enumerate(
            loader.batch_iterator(ds, B, caps, seed=2))),
        size=2, device="cpu", host_stage=2))
    assert [i for _, _, i in got] == list(range(len(plain)))
    for (g, s, _), (g_ref, s_ref) in zip(got, plain):
        assert torch.equal(g.senders, g_ref.to("cpu").senders)
        assert s.pool_fits is s_ref.pool_fits
        assert g.senders.dtype == torch.int64
    buf = np.arange(10, dtype=np.uint8)
    (t, n, flags), = loader.prefetch_to_device([(buf, 7, (True, False))],
                                               device="cpu")
    assert t.dtype == torch.uint8 and t.tolist() == list(range(10))
    assert n == 7 and flags == (True, False)

    def failing():
        yield np.zeros(3, np.float32)
        raise RuntimeError("packer broke")

    for host_stage in (0, 2):
        it = loader.prefetch_to_device(failing(), device="cpu",
                                       host_stage=host_stage)
        assert next(it).shape == (3,)
        with pytest.raises(RuntimeError, match="packer broke"):
            next(it)
    with pytest.raises(RuntimeError, match="packer broke"):
        list(loader.background_iter(failing()))
    # a consumer that stops early stops the producer
    endless = loader.background_iter(iter(range(10 ** 9)), size=2)
    assert next(endless) == 0
    endless.close()


def test_preprocess_then_pretrain_on_the_cache_with_superbatches(tmp_path):
    path = str(tmp_path / "synth.npz")
    ds = cli.main(["preprocess", "--synthetic", "48", "--k", "1",
                   "--out", path])
    assert len(ds) == 48 and os.path.exists(path)
    small = ["--batch_size", str(B), "--hidden", str(HID), "--d_transfer",
             str(DT), "--device", "cpu"]
    info = cli.main(["pretrain", "--cache", path, "--superbatch", str(K),
                     "--epochs", "1", "--out", str(tmp_path / "p.msgpack")]
                    + small)
    assert len(info["history"]) == 1 and np.isfinite(info["best_loss"])
    assert info["throughput"]["steps"] == 2
    stages = cli.main(["pretrain", "--curriculum", "--stage_caches",
                       f"{path},{path}", "--epochs", "1", "--superbatch",
                       "2", "--out", str(tmp_path / "c" / "x")] + small)
    assert [s["name"] for s in stages] == ["synth.npz"] * 2
    assert all(np.isfinite(s["info"]["best_loss"]) for s in stages)


SMILES = ["CCO", "c1ccccc1", "CC(=O)O", "CCN", "c1ccncc1", "C1CCCCC1",
          "CC(C)O", "O=C=O", "CC#N", "c1ccoc1", "CCOC(=O)C", "NC(=O)N"]


def test_finetune_on_a_smiles_csv(tmp_path):
    path = tmp_path / "esol.csv"
    rng = np.random.default_rng(0)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["smiles", "logS"])
        for i in range(60):
            w.writerow([SMILES[i % len(SMILES)], f"{rng.normal():.4f}"])
    journal = str(tmp_path / "j.jsonl")
    out = cli.main(["finetune", "--dataset", "ESOL", "--smiles_csv",
                    str(path), "--epochs", "1", "--batch_size", "16",
                    "--hidden", str(HID), "--d_transfer", str(DT),
                    "--num_layers", "2", "--device", "cpu",
                    "--journal", journal])
    assert np.isfinite(out["mean"])
    with open(journal) as f:
        assert json.loads(f.readline())["config"]["smiles_csv"] == str(path)


def test_profile_trace_and_step_timer(tmp_path):
    with profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64).sum()
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    assert json.load(open(tmp_path / "trace" / files[0]))["traceEvents"]
    assert prof.key_averages()
    ours, theirs = StepTimer(), JStepTimer()
    for t in (ours, theirs):
        for edges in (10, 30):
            with t.step(edges=edges, nodes=4, graphs=2):
                time.sleep(0.002)
        t.total_time = 0.5          # the same clock for both
    assert ours.summary() == theirs.summary()
    ours.reset()
    assert ours.summary() == StepTimer().summary()


def test_run_pretrain_steps_in_superbatches():
    """``pretrain --steps N --superbatch K``: N steps as N / K calls of
    the superbatch step, each call's last losses those of the same step
    taken one batch at a time."""
    kw = dict(synthetic=64, batch_size=16, steps=4, device="cpu",
              hidden=HID, d_transfer=DT, log=lambda _: None)
    plain = cli.run_pretrain(**kw)
    sup = cli.run_pretrain(superbatch=2, **kw)
    assert len(sup) == 2
    for a, b in zip(sup, plain[1::2]):
        assert all(a[k] == b[k] for k in ("kl", "contrastive",
                                           "reconstruction"))
    with pytest.raises(ValueError, match="superbatches of 3"):
        cli.run_pretrain(superbatch=3, **kw)
