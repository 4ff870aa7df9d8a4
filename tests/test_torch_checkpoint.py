"""PyTorch port vs the JAX package: checkpoints and autosaves.

The port's msgpack codec against ``msgpack`` with flax on every committed
checkpoint and autosave (the same arrays by dtype, shape and bytes, and the
same bytes written back), a port checkpoint and a port autosave read by the
JAX package's ``load_checkpoint`` / ``load_train_state``, the three
optimizer layouts the JAX package has written bridged into torch's Adam,
each committed pretraining checkpoint's losses in the port against the JAX
model's, and ``load_core_into`` / ``checkpoint_name``.

Tolerances: arrays that only move between formats are compared bit for
bit; losses at rtol 1e-5 (float32, the same weights, reductions in another
order)."""

import pathlib

import jax
import jax.flatten_util
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from scgib_tpu.data.synthetic import random_dataset as jrandom_dataset
from scgib_tpu.graph.batching import pack_graphs as jpack_graphs
from scgib_tpu.graph.batching import pack_subgraphs as jpack_subgraphs
from scgib_tpu.graph.egonet import extract_egonets as jextract_egonets
from scgib_tpu.models.scgib import PretrainModel as JPretrainModel
from scgib_tpu.train import checkpoint as jckpt
from scgib_tpu.train.trainer import TrainState as JTrainState
from scgib_tpu.train.trainer import adam_l2

from scgib_tpu_torch.graph.container import GraphBatch, SubgraphBatch
from scgib_tpu_torch.models.scgib import PretrainModel
from scgib_tpu_torch.train import checkpoint as ckpt
from scgib_tpu_torch.train.trainer import TrainState, make_pretrain_step
from scgib_tpu_torch.utils import msgpack_codec as codec
from scgib_tpu_torch.utils.params import (adam_to_optax, from_jax_variables,
                                          to_jax_variables)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = sorted(p for pattern in ("outputs/*.msgpack*",
                                    "runs/curriculum_r0*/*.msgpack*")
                  for p in ROOT.glob(pattern) if p.suffix != ".json")
AUTOSAVES = [p for p in FIXTURES if ".stage" in p.name]
PRETRAINED = [p for p in FIXTURES if p.name.startswith("pre_training_")]
# how each directory's autosaves keep Adam's moments: per-leaf trees, or
# flat vectors (utils/params.py names the layouts)
LAYOUT = {"outputs": "tree", "curriculum_r04": "tree",
          "curriculum_r05": "flat"}


def rel(p):
    return str(p.relative_to(ROOT))


def leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def assert_same_tree(got, want):
    """Same keys; arrays equal by dtype, shape and bytes; other leaves
    equal (NaN equal to NaN)."""
    g, w = leaves(got), leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray), path
            assert (a.dtype, a.shape) == (b.dtype, b.shape), path
            assert a.tobytes() == b.tobytes(), path
        else:
            assert type(a) is type(b), path
            assert a == b or (a != a and b != b), path


@pytest.mark.parametrize("path", FIXTURES, ids=rel)
def test_codec_reads_and_writes_fixtures_like_flax(path):
    raw = path.read_bytes()
    mine = codec.unpackb(raw)
    assert_same_tree(mine, serialization.msgpack_restore(raw))
    assert codec.packb(mine) == raw


def test_codec_matches_msgpack_on_every_form():
    """Ints, floats, strings, bin, arrays and maps at each length and width
    boundary, written byte for byte as msgpack-python (with flax's array
    extension) writes them, and read back, float32 and ext forms
    included."""
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
            2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
            -2 ** 31, -2 ** 31 - 1, -2 ** 63]
    tree = {
        "ints": ints, "floats": [0.0, -1.5, 1e300, float("inf")],
        "nil": None, "bools": [True, False],
        "strs": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256,
                 "e" * 65536, "ü"],
        "bins": [b"", b"x" * 255, b"y" * 256, b"z" * 65536],
        "list16": list(range(16)), "list": list(range(70000)),
        "map16": {f"k{i:02d}": i for i in range(16)},
        "arrays": {"f32": np.arange(6, dtype=np.float32).reshape(2, 3),
                   "scalar": np.asarray(3, np.int32),
                   "u32": np.array([1, 2], np.uint32),
                   "f64": np.array([np.nan, 1.0])},
        "npscalar": np.float64(2.5),
    }
    # flax sorts every map's keys (tree_map) before packing
    tree = jax.tree_util.tree_map(lambda x: x, tree)
    want = msgpack.packb(tree, default=serialization._msgpack_ext_pack,
                         strict_types=True)
    assert codec.packb(tree) == want
    assert_same_tree(codec.unpackb(want), serialization.msgpack_restore(want))
    other = {"f32": 1.25, "ext": msgpack.ExtType(5, b"abc"),
             "fixext": msgpack.ExtType(7, b"abcd"), "neg": -5}
    got = codec.unpackb(msgpack.packb(other, use_single_float=True))
    assert got == {"f32": 1.25, "ext": codec.ExtType(5, b"abc"),
                   "fixext": codec.ExtType(7, b"abcd"), "neg": -5}


IN, HID, DT = 9, 16, 8


@pytest.fixture(scope="module")
def small():
    """A small batch (numpy, JAX-packed) and a JAX init of the model."""
    graphs = jrandom_dataset(8, seed=3, min_nodes=8, max_nodes=20,
                             feat_dim=IN)
    egos = [jextract_egonets(x, 1) for x in graphs]
    jg = jpack_graphs(graphs, 256, 1024, 8, banded="device")
    jsub = jpack_subgraphs(graphs, egos, 1024, 4096, banded="device")
    v = JPretrainModel(in_dim=IN, hidden=HID, d_transfer=DT).init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jg, jsub, train=True)
    return jg, jsub, jax.tree_util.tree_map(np.asarray, v)


def trained_state(v, jg, jsub, steps=2, wd=5e-5):
    """A port TrainState from JAX variables after ``steps`` Adam steps."""
    model = PretrainModel(IN, hidden=HID, d_transfer=DT)
    model.load_state_dict(from_jax_variables(v))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, weight_decay=wd)
    step = make_pretrain_step(model, opt)
    g, sub = (GraphBatch.from_numpy(jg, "cpu"),
              SubgraphBatch.from_numpy(jsub, "cpu"))
    for _ in range(steps):
        step(g, sub, torch.Generator().manual_seed(0))
    return TrainState(model, opt, steps)


def test_to_jax_variables_inverts_the_bridge(small):
    _, _, v = small
    model = PretrainModel(IN, hidden=HID, d_transfer=DT)
    model.load_state_dict(from_jax_variables(v))
    assert_same_tree(to_jax_variables(model), v)


def test_port_checkpoint_loads_bit_equal_in_jax(small, tmp_path):
    jg, jsub, v = small
    state = trained_state(v, jg, jsub)
    path = str(tmp_path / "p.msgpack")
    ckpt.save_checkpoint(path, state.variables, config={"hidden": HID},
                         step=3)
    got, meta = jckpt.load_checkpoint(path)
    assert_same_tree(got, to_jax_variables(state.model))
    assert meta == {"step": 3, "config": {"hidden": HID}}
    jpath = str(tmp_path / "j.msgpack")
    jckpt.save_checkpoint(jpath, got, config={"hidden": HID}, step=3)
    assert (tmp_path / "j.msgpack").read_bytes() == \
        (tmp_path / "p.msgpack").read_bytes()
    mine, meta2 = ckpt.load_checkpoint(jpath)
    assert_same_tree(mine, got)
    assert meta2 == meta


@pytest.mark.parametrize("wd", [5e-5, 0.0])
def test_port_autosave_restores_in_jax(small, tmp_path, wd):
    """The port writes today's adam_l2 layout; the JAX package restores it
    into a current TrainState template, moments and the resident parameter
    vector included."""
    jg, jsub, v = small
    state = trained_state(v, jg, jsub, wd=wd)
    path = str(tmp_path / "auto.msgpack")
    rng = np.array([0, 42], np.uint32)
    ckpt.save_train_state(path, state, epoch=3, rng=rng,
                          extra={"best_loss": 1.25, "bad_epochs": 2,
                                 "history": np.array([2.0, 1.25])})
    template = JTrainState.create(v, adam_l2(1e-3, weight_decay=wd))
    got, epoch, jrng, extra = jckpt.load_train_state(path, template)
    assert epoch == 3 and int(got.step) == 2
    np.testing.assert_array_equal(np.asarray(jrng), rng)
    assert extra["best_loss"] == 1.25 and extra["bad_epochs"] == 2
    assert_same_tree(jax.tree_util.tree_map(np.asarray, got.variables),
                     to_jax_variables(state.model))
    inner, p_flat = got.opt_state
    adam = inner[1] if wd else inner[0]
    assert int(adam.count) == 2
    flat, _ = jax.flatten_util.ravel_pytree(got.params)
    np.testing.assert_array_equal(np.asarray(p_flat), np.asarray(flat))
    # the moments, kernel by kernel, against torch's exp_avg / exp_avg_sq
    unravel = jax.flatten_util.ravel_pytree(got.params)[1]
    for moment, key in ((adam.mu, "exp_avg"), (adam.nu, "exp_avg_sq")):
        want = from_jax_variables({"params": jax.tree_util.tree_map(
            np.asarray, unravel(moment))})
        for name, p in state.model.named_parameters():
            np.testing.assert_array_equal(
                want[name].numpy(), state.optimizer.state[p][key].numpy(),
                err_msg=name)
    kernel = np.asarray(unravel(adam.mu)["transfer_d"]["kernel"])
    np.testing.assert_array_equal(
        kernel.T, state.optimizer.state[state.model.transfer_d.weight][
            "exp_avg"].numpy())


@pytest.mark.parametrize("path", AUTOSAVES, ids=rel)
def test_jax_autosaves_bridge_into_torch_adam(path, batches):
    """Each committed autosave (per-leaf trees in outputs/ and r04, flat
    vectors in r05) restores into the port: parameters, statistics and
    step as saved, the JAX model's losses from them, and torch's moments
    equal optax's mu / nu entry by entry (read back out through the flat
    layout)."""
    jtree = serialization.msgpack_restore(path.read_bytes())
    saved = jtree["state"]
    in_dim = saved["params"]["transfer_d"]["kernel"].shape[0]
    model = PretrainModel(in_dim, hidden=64, d_transfer=32,
                          deterministic=True)
    opt = torch.optim.Adam(model.parameters(), lr=1e-4, weight_decay=5e-5)
    state = TrainState(model, opt)
    epoch, rng, extra = ckpt.load_train_state(str(path), state)
    assert epoch == jtree["epoch"] and state.step == int(saved["step"])
    np.testing.assert_array_equal(rng, jtree["rng"])
    assert_same_tree(to_jax_variables(model),
                     {"params": saved["params"],
                      "batch_stats": saved["batch_stats"]})
    adam = saved["opt_state"]["1"]
    assert set(adam) == {"count", "mu", "nu"}
    layout = LAYOUT[path.parent.name]
    assert isinstance(adam["mu"], dict) == (layout == "tree")
    flat = adam_to_optax(model, opt)["0"]["1"]
    assert int(flat["count"]) == int(adam["count"])
    for key in ("mu", "nu"):
        want = adam[key]
        if layout == "tree":
            want = np.concatenate([np.ravel(x)
                                   for x in jax.tree_util.tree_leaves(want)])
        np.testing.assert_array_equal(flat[key], want)
    if layout == "tree":      # one kernel by name: [in, out] -> [out, in]
        np.testing.assert_array_equal(
            opt.state[model.transfer_d.weight]["exp_avg"].numpy(),
            adam["mu"]["transfer_d"]["kernel"].T)
    assert_losses_match(model, {"params": saved["params"],
                                "batch_stats": saved["batch_stats"]},
                        batches)


@pytest.fixture(scope="module")
def batches():
    """One small batch per feature width of the committed checkpoints."""
    out = {}
    for fd in (9, 11):
        graphs = jrandom_dataset(8, seed=6, min_nodes=8, max_nodes=20,
                                 feat_dim=fd)
        egos = [jextract_egonets(x, 1) for x in graphs]
        out[fd] = (jpack_graphs(graphs, 256, 1024, 8, banded="device"),
                   jpack_subgraphs(graphs, egos, 1024, 4096,
                                   banded="device"))
    return out


def assert_losses_match(model, jv, batches):
    """``model`` (the port's, deterministic, loaded through its own codec)
    against the JAX model with the variables ``jv`` (as flax read them):
    deterministic losses on the small batch of their feature width."""
    in_dim = jv["params"]["transfer_d"]["kernel"].shape[0]
    jg, jsub = batches[in_dim]
    jlosses, _ = JPretrainModel(in_dim=in_dim, deterministic=True).apply(
        jv, jg, jsub, train=True, mutable=["batch_stats"])
    with torch.no_grad():
        losses = model.train()(GraphBatch.from_numpy(jg, "cpu"),
                               SubgraphBatch.from_numpy(jsub, "cpu"))
    for a, b in zip(losses, jlosses):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)


@pytest.mark.parametrize("path", PRETRAINED, ids=rel)
def test_pretraining_checkpoint_losses_match_jax(path, batches):
    variables, meta = ckpt.load_checkpoint(str(path))
    jv, jmeta = jckpt.load_checkpoint(str(path))
    assert meta == jmeta
    model = PretrainModel(variables["params"]["transfer_d"]["kernel"]
                          .shape[0], deterministic=True)
    model.load_state_dict(from_jax_variables(variables))
    assert_losses_match(model, jv, batches)


def test_load_core_into_and_checkpoint_name_match_jax():
    stage0, _ = ckpt.load_checkpoint(str(PRETRAINED[0]))
    qm9 = [p for p in PRETRAINED if "_QM9_GIN" in p.name][0]
    fresh, _ = ckpt.load_checkpoint(str(qm9))
    assert_same_tree(ckpt.load_core_into(fresh, stage0),
                     jckpt.load_core_into(fresh, stage0))
    for args in (("pre_training", ["PCQM4Mv2", "QM9"], "GIN", 64, 4, 1),
                 ("pre_training", "ZINC", "Transformer", 96, 2, 3)):
        assert ckpt.checkpoint_name(*args) == jckpt.checkpoint_name(*args)
    assert ckpt.exists(str(qm9)) and not ckpt.exists(str(qm9) + ".none")
