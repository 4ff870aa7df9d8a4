"""PyTorch port vs the JAX package: the ``finetune``, ``eval`` and ``adapt``
verbs on the CPU (``--device cpu``) at small sizes.

The verbs' flags and defaults against the JAX parser's; ``finetune --out``
then ``eval --split all`` reproducing the run's final test metric (to 1e-6:
the same weights, batches and noise draws); the pretrained core grafted in
(the JAX package's committed checkpoint and the port's own ``pretrain``
output, bit for bit); repeats, the journal and the sheet; ``adapt``'s
checkpoint read by the JAX package's ``load_checkpoint`` and run by its
``DomainAdaptModel``; a run without a card refused; and the four numerics
flags (the JAX verbs' environment knobs) reaching the models, saved in
the config, and ``pretrain --steps`` in the JAX package's TPU-default
Transformer mode.
"""

import argparse
import itertools
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from scgib_tpu import cli as jcli
from scgib_tpu.graph.batching import pack_graphs as jpack_graphs
from scgib_tpu.graph.batching import pack_subgraphs as jpack_subgraphs
from scgib_tpu.graph.egonet import extract_egonets as jextract_egonets
from scgib_tpu.data.synthetic import random_dataset as jrandom_dataset
from scgib_tpu.models.scgib import DomainAdaptModel as JDomainAdaptModel
from scgib_tpu.train import checkpoint as jckpt

from scgib_tpu_torch import cli
from scgib_tpu_torch.data.loader import (GraphDataset, batch_iterator,
                                         plan_capacities)
from scgib_tpu_torch.data.synthetic import random_dataset
from scgib_tpu_torch.models import encoders
from scgib_tpu_torch.models.scgib import PretrainModel
from scgib_tpu_torch.train import checkpoint as ckpt
from scgib_tpu_torch.train.trainer import adam_l2, make_pretrain_step
from scgib_tpu_torch.utils.params import init_flax_style_

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = ["--synthetic", "100", "--hidden", "16", "--d_transfer", "8",
         "--batch_size", "32", "--device", "cpu"]


def _flags(parser, verb):
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {a.dest: a.default for a in sub.choices[verb]._actions
            if a.dest != "help"}


@pytest.mark.parametrize("verb", ["finetune", "eval", "adapt"])
def test_verbs_have_every_jax_flag_with_its_default(verb):
    want = _flags(jcli.build_parser(), verb)
    got = _flags(cli.build_parser(), verb)
    assert {k: got.get(k, "missing") for k in want} == want
    # the port's own, and the four numerics flags (the JAX verbs take those
    # as environment knobs)
    assert set(got) - set(want) == {"device", "gt_bwd", "gt_bf16_dots",
                                    "gt_dtype", "compute_dtype"}


def test_finetune_then_eval_reproduces_the_test_metric(tmp_path, capsys):
    out = str(tmp_path / "ft.msgpack")
    run = cli.main(["finetune", "--dataset", "BACE", "--epochs", "2",
                    "--out", out] + SMALL)
    last = run["last"]
    assert len(last["history"]) == 2 and run["runs"] == [
        last["test_at_best_val"]]
    final_test = last["history"][-1][2]
    assert "RESULT BACE: rocauc" in capsys.readouterr().out
    meta = json.loads(pathlib.Path(out + ".json").read_text())
    assert meta["config"]["hidden"] == 16
    assert meta["config"]["best_epoch"] == last["best_epoch"]
    # eval takes the architecture from the checkpoint, not its own flags
    got = cli.main(["eval", "--dataset", "BACE", "--checkpoint", out,
                    "--split", "all", "--synthetic", "100", "--batch_size",
                    "32", "--device", "cpu"])
    assert set(got) == {"train", "val", "test"}
    assert abs(got["test"] - final_test) <= 1e-6
    assert abs(got["val"] - last["history"][-1][1]) <= 1e-6
    assert "EVAL BACE test: rocauc" in capsys.readouterr().out
    full = cli.main(["eval", "--dataset", "BACE", "--checkpoint", out,
                     "--split", "full"] + SMALL)
    assert set(full) == {"full"} and 0.0 <= full["full"] <= 1.0
    # the JAX package reads the fine-tuned checkpoint
    variables, _ = jckpt.load_checkpoint(out)
    assert set(variables["params"]) == {"transfer_d", "core", "head_mlp",
                                        "s2s", "predict"}


def test_finetune_grafts_the_pretrained_core(tmp_path, capsys):
    """The committed JAX checkpoint (hidden 64) and the port's own
    ``pretrain`` output: with no epoch run the saved model's core is the
    pretrained core, bit for bit, and its heads are not."""
    pre = str(ROOT / "outputs" / "pre_training_PCQM4Mv2_GIN_64_4_1.msgpack")
    own = str(tmp_path / "pre.msgpack")
    cli.main(["pretrain", "--epochs", "1", "--out", own] + SMALL)
    for path, width in ((pre, "64"), (own, "16")):
        out = str(tmp_path / "ft.msgpack")
        flags = SMALL[:2] + ["--hidden", width, "--d_transfer",
                             "32" if width == "64" else "8"] + SMALL[6:]
        cli.main(["finetune", "--dataset", "BACE", "--epochs", "0",
                  "--pretrained", path, "--out", out] + flags)
        assert f"loaded pretrained core from {path}" in \
            capsys.readouterr().out
        got, _ = ckpt.load_checkpoint(out)
        want, _ = jckpt.load_checkpoint(path)
        for col in ("params", "batch_stats"):
            a = jax.tree_util.tree_leaves(got[col]["core"])
            b = jax.tree_util.tree_leaves(want[col]["core"])
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        assert got["params"]["transfer_d"]["kernel"].shape[0] == 9


@pytest.mark.parametrize("dataset,metric", [("ESOL", "rmse"),
                                            ("Mutagenicity", "acc"),
                                            ("Peptides-func", "ap")])
def test_finetune_specs_run(tmp_path, dataset, metric):
    """A regression head (rmse), cross entropy over the TUDataset spec's
    14 features with two repeats (acc), and gradient accumulation over two
    batches (ap): one epoch each."""
    journal = str(tmp_path / "j.jsonl")
    run = cli.main(["finetune", "--dataset", dataset, "--epochs", "1",
                    "--num_layers", "2", "--journal", journal,
                    "--repeats", "2" if dataset == "Mutagenicity" else "0"]
                   + SMALL)
    assert len(run["runs"]) == (2 if dataset == "Mutagenicity" else 1)
    assert all(np.isfinite(v) for v in run["runs"])
    rec = json.loads(pathlib.Path(journal).read_text())
    assert rec["dataset"] == dataset and rec["metric"] == metric
    assert rec["runs"] == run["runs"]
    steps = run["last"]["throughput"]["steps"]
    # 80 training graphs in batches of 32, 32 and 16; accumulated in
    # groups of two, the ragged third is dropped
    assert steps == (1 if dataset == "Peptides-func" else 3)


def test_finetune_xlsx_and_autosave(tmp_path, capsys):
    pytest.importorskip("pandas")
    sheet = str(tmp_path / "results.xlsx")
    auto = str(tmp_path / "auto")
    cli.main(["finetune", "--dataset", "BACE", "--epochs", "1", "--xlsx",
              sheet, "--autosave", auto, "--num_layers", "2"] + SMALL)
    assert "recorded results in" in capsys.readouterr().out
    assert pathlib.Path(auto + ".rep0").exists()
    again = cli.main(["finetune", "--dataset", "BACE", "--epochs", "1",
                      "--autosave", auto, "--num_layers", "2"] + SMALL)
    assert "resumed autosave at epoch 0" in capsys.readouterr().out
    assert again["last"]["throughput"]["steps"] == 0


def test_transformer_finetune_on_cpu():
    run = cli.main(["finetune", "--dataset", "BACE", "--epochs", "1",
                    "--encoder", "Transformer", "--num_layers", "1",
                    "--num_heads", "2"] + SMALL)
    assert np.isfinite(run["last"]["history"][0][0])


def test_adapt_writes_a_checkpoint_jax_runs(tmp_path):
    out = str(tmp_path / "adapted.msgpack")
    info = cli.main(["adapt", "--epochs", "1", "--num_layers", "2",
                     "--out", out] + SMALL)
    assert np.isfinite(info["best_loss"]) and len(info["history"]) == 1
    variables, meta = jckpt.load_checkpoint(out)
    assert meta["config"]["cmd"] == "adapt"
    graphs = jrandom_dataset(8, seed=0, min_nodes=8, max_nodes=20)
    egos = [jextract_egonets(x, 1) for x in graphs]
    jg = jpack_graphs(graphs, 256, 1024, 8)
    jsub = jpack_subgraphs(graphs, egos, 1024, 4096)
    jmodel = JDomainAdaptModel(in_dim=9, hidden=16, d_transfer=8,
                               num_layers=2)
    loss = jax.jit(lambda v: jmodel.apply(
        v, jg, jsub, train=False, rngs={"noise": jax.random.PRNGKey(0)}))(
            variables)
    assert np.isfinite(float(loss))


def test_unknown_dataset_and_no_data_exit():
    with pytest.raises(SystemExit, match="unknown dataset"):
        cli.main(["finetune", "--dataset", "NOPE"] + SMALL)
    with pytest.raises(SystemExit, match="--synthetic"):
        cli.main(["adapt", "--device", "cpu"])


@pytest.mark.parametrize("verb", ["finetune", "eval", "adapt"])
def test_verbs_refuse_to_fall_back_to_cpu(monkeypatch, verb):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = {"finetune": ["finetune", "--dataset", "BACE"],
            "eval": ["eval", "--dataset", "BACE", "--checkpoint", "x"],
            "adapt": ["adapt"]}[verb]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(args + ["--synthetic", "8"])


# --- the numerics flags ------------------------------------------------------

VERB_ARGS = {"pretrain": [], "finetune": ["--dataset", "BACE"],
             "eval": ["--dataset", "BACE", "--checkpoint", "x.msgpack"],
             "adapt": []}
TPU_DEFAULT = ["--gt_bwd", "merged", "--gt_bf16_dots"]


def _built(verb, args):
    """The model the verb builds from its parsed ``args``."""
    if verb == "pretrain":
        return cli._model(args, 9)
    cls = cli.DomainAdaptModel if verb == "adapt" else cli.FinetuneModel
    return cls(9, **cli._model_kwargs(vars(args)))


def _numerics_of(model):
    """(attention bwd, bf16_dots, dtype) of every transformer layer and
    compute_dtype of every GIN, in both encoders."""
    out = set()
    for m in model.modules():
        if isinstance(m, encoders.GraphTransformerLayer):
            out.add((m.bwd, m.bf16_dots, m.dtype))
        elif isinstance(m, encoders.GIN):
            out.add(m.compute_dtype)
    return out


@pytest.mark.parametrize("verb", list(VERB_ARGS))
def test_numerics_flags_reach_the_model(verb):
    """``--gt_bwd``, ``--gt_bf16_dots``, ``--gt_dtype`` and
    ``--compute_dtype`` (the JAX verbs' SCGIB_GT_BWD_TWOPASS,
    SCGIB_GT_BF16, SCGIB_GT_ACT_BF16, SCGIB_COMPUTE_DTYPE) parse with
    the defaults two-pass, off, float32, float32, and reach the built
    model's attention and GIN."""
    parser = cli.build_parser()
    small = ["--hidden", "16", "--num_heads", "2", "--num_layers", "1"]
    base = [verb] + VERB_ARGS[verb] + small
    args = parser.parse_args(base)
    assert {k: getattr(args, k) for k in cli.NUMERICS} == cli.NUMERICS
    assert _numerics_of(_built(verb, args)) == {None}
    args = parser.parse_args(base + ["--encoder", "Transformer"])
    assert _numerics_of(_built(verb, args)) == {("twopass", False, None)}
    args = parser.parse_args(base + ["--encoder", "Transformer",
                                     "--gt_dtype", "bfloat16"]
                             + TPU_DEFAULT)
    assert _numerics_of(_built(verb, args)) == {
        ("merged", True, torch.bfloat16)}
    args = parser.parse_args(base + ["--compute_dtype", "bfloat16"])
    assert _numerics_of(_built(verb, args)) == {"bfloat16"}


def test_numerics_are_saved_in_the_config(tmp_path):
    """The flags are saved in the run's config and a checkpoint's config
    builds the model with them; a config without them (a JAX checkpoint's,
    an older port one's) means the defaults."""
    out = str(tmp_path / "ft.msgpack")
    cli.main(["finetune", "--dataset", "BACE", "--epochs", "0", "--out", out,
              "--encoder", "Transformer", "--num_layers", "1", "--num_heads",
              "2", "--gt_dtype", "bfloat16"] + TPU_DEFAULT + SMALL)
    cfg = ckpt.load_checkpoint(out)[1]["config"]
    assert {k: cfg[k] for k in cli.NUMERICS} == {
        "gt_bwd": "merged", "gt_bf16_dots": True, "gt_dtype": "bfloat16",
        "compute_dtype": "float32"}
    model = cli.FinetuneModel(9, **cli._model_kwargs(cfg))
    assert _numerics_of(model) == {("merged", True, torch.bfloat16)}
    old = {k: v for k, v in cfg.items() if k not in cli.NUMERICS}
    model = cli.FinetuneModel(9, **cli._model_kwargs(old))
    assert _numerics_of(model) == {("twopass", False, None)}


def test_pretrain_steps_in_the_tpu_default_mode_on_cpu():
    """``pretrain --steps 2 --encoder Transformer --gt_bwd merged
    --gt_bf16_dots --device cpu`` gives the losses of the same run built
    by hand (dataset, model, Adam and captured-step code as
    ``run_pretrain`` builds them), bit for bit; without the flags the
    losses differ (the forward's products are float32)."""
    small = ["--synthetic", "48", "--batch_size", "16", "--hidden", "16",
             "--d_transfer", "8", "--num_layers", "1", "--num_heads", "2",
             "--encoder", "Transformer", "--device", "cpu"]
    argv = ["pretrain", "--steps", "2"] + small
    got = cli.main(argv + TPU_DEFAULT)
    default = cli.main(argv)
    args = cli.build_parser(steps=True).parse_args(argv)
    ds = GraphDataset(random_dataset(48, seed=7, min_nodes=10, max_nodes=30),
                      k=1)
    caps = plan_capacities(ds, 16)
    batches = itertools.islice(itertools.chain.from_iterable(
        batch_iterator(ds, 16, caps, seed=7 + e) for e in itertools.count()),
        2)
    model = PretrainModel(9, hidden=16, d_transfer=8, encoder="Transformer",
                          num_layers=1, num_heads=2, gt_bwd="merged",
                          gt_bf16_dots=True)
    init_flax_style_(model, torch.Generator().manual_seed(7))
    step = make_pretrain_step(model, adam_l2(model, args.lr,
                                             args.weight_decay))
    gen = torch.Generator().manual_seed(8)
    want = [[float(x) for x in step(g.to("cpu"), s.to("cpu"), gen)]
            for g, s in batches]
    names = ("kl", "contrastive", "reconstruction")
    assert [[r[k] for k in names] for r in got] == want
    assert [[r[k] for k in names] for r in default] != want
