"""Command-line entry point: the ``pretrain``, ``finetune``, ``eval`` and
``adapt`` verbs.

  python -m scgib_tpu_torch.cli pretrain --synthetic 2000 --epochs 3
  python -m scgib_tpu_torch.cli pretrain --curriculum --synthetic 2000 \\
      --epochs 3 --autosave outputs/auto.msgpack --out outputs/x
  python -m scgib_tpu_torch.cli pretrain --synthetic 1024 --steps 5 \\
      [--encoder Transformer --num_layers 4 --num_heads 8]
  python -m scgib_tpu_torch.cli finetune --dataset BACE --synthetic 1513 \\
      --pretrained outputs/pretrain.msgpack --out outputs/bace.msgpack
  python -m scgib_tpu_torch.cli eval --dataset BACE --synthetic 1513 \\
      --checkpoint outputs/bace.msgpack --split all
  python -m scgib_tpu_torch.cli adapt --synthetic 1513 \\
      --pretrained outputs/pretrain.msgpack --out outputs/adapted.msgpack

Counterpart of the JAX package's ``cli.py`` verbs of the same names
(``scgib_tpu/cli.py:141-563, 585-727``), with their flags and defaults.

``pretrain``: ``PretrainModel`` of ``--hidden`` / ``--d_transfer`` /
``--encoder`` / ``--num_layers`` / ``--num_heads`` / ``--readout`` /
``--use_att`` / ``--kl_mode`` / ``--recons_type`` / ``--k``, trained for
``--epochs`` with early stopping after ``--patience`` epochs without a
better loss, torch-style Adam with coupled L2, the best epoch's weights
saved to ``--out`` (default ``outputs/pretrain.msgpack``) in the JAX
package's checkpoint format.  ``--pretrained`` starts from a checkpoint;
``--autosave PATH`` writes the whole training state every
``--autosave_every`` epochs and resumes from it after a crash.
``--curriculum`` runs the three stages (PCQM4Mv2 -> QM9 -> mol-PCBA,
synthetic stand-ins of feature width 9, 11, 9), each seeded ``--seed +
stage``, carrying the core forward and skipping a stage whose checkpoint
exists in ``--out``'s directory.

``finetune``: ``FinetuneModel`` on ``--dataset``'s task (``config.DATASETS``:
outputs, loss, metric, split, gradient accumulation, repeats), the data
shuffled with ``--seed`` and cut by the reference's prefix split, the core
from ``--pretrained``, frozen by ``--freeze_mode``; test-at-best-val
selection over ``--epochs``; ``--repeats`` runs re-initialize the heads
(seeds ``--seed + 100 + rep``); ``--out`` saves the last run's final
weights for ``eval``; ``--journal`` appends a JSON record, ``--xlsx``
writes the reference's sheet (it needs pandas).  ``eval``: a ``finetune
--out`` checkpoint on ``--split``, the model's config taken from the
checkpoint.  ``adapt``: ``DomainAdaptModel`` around ``--pretrained``'s
core, patience 20, the best weights to ``--out`` (default
``outputs/adapted.msgpack``).

Data come from ``--synthetic N`` molecules only.  The flags of the JAX
verbs whose modules are not ported yet raise ``SystemExit`` naming the
``ROADMAP.md`` item that ports them: the other data sources and
``--synthetic_mode structured`` (Queue 1 item 12), ``--superbatch`` (item
14), ``--encoder GCN`` / ``GraphSAGE`` (item 6) and a reference ``.pt``
checkpoint as ``--pretrained`` (item 11).

Two flags are the port's own: ``--device`` (``cuda``, the default, or
``cpu`` for the plain path), on every verb, and ``pretrain --steps N``,
which instead of the epoch loop takes N optimizer steps on molecules of
10-30 atoms (the benchmark's recipe) and prints each step's three losses
and time (``run_pretrain``); with it ``--synthetic`` defaults to 1024 and
``--seed`` to 7.
"""

from __future__ import annotations

import argparse
import itertools
import os
import time
from typing import Callable, List

import numpy as np
import torch

from .config import (DATASETS, PRETRAIN_STAGES, DomainAdaptConfig,
                     FinetuneConfig, ModelConfig, OptimConfig,
                     PretrainConfig, reference_split)
from .data.loader import GraphDataset, batch_iterator, plan_capacities
from .data.synthetic import random_dataset
from .models.scgib import DomainAdaptModel, FinetuneModel, PretrainModel
from .train import checkpoint as ckpt
from .train.loops import (evaluate, run_domain_adaptation, run_finetune,
                          run_pretraining)
from .train.trainer import (TrainState, adam_l2, finetune_trainable_mask,
                            make_domainadapt_step, make_eval_fn,
                            make_finetune_step, make_pretrain_step,
                            masked_adam)
from .utils.device import resolve_device
from .utils.params import (from_jax_variables, init_flax_style_,
                           to_jax_variables)


def run_pretrain(synthetic: int = 1024, batch_size: int = 128,
                 steps: int = 5, lr: float = 1e-4,
                 weight_decay: float = 5e-5, seed: int = 7, device="cuda",
                 encoder: str = "GIN", num_layers: int = 4,
                 num_heads: int = 8, gt_bwd: str = "twopass",
                 log: Callable[[str], None] = print,
                 profiler=None, hidden: int = 64, d_transfer: int = 32,
                 k: int = 1, **options) -> List[dict]:
    """Pack ``steps`` batches of ``batch_size`` graphs and train on them
    with ``make_pretrain_step`` (on the card the first step eager, then
    CUDA-graph replays).

    Returns one record per step: its three losses and its time in ms
    (host clock around the step, ended by a device synchronize; batches
    are packed and moved to the device beforehand).  ``gt_bwd`` is the
    graph transformer's attention backward, "twopass" or "merged".
    ``options`` go to ``PretrainModel`` (``readout``, ``use_att``,
    ``kl_mode``, ``recons_type``, ``recons_impl``); ``k`` is the ego-net
    radius and the logM reconstruction's number of steps.  ``profiler``, a
    running ``torch.profiler.profile``, is stepped after every step."""
    dev = resolve_device(device)
    ds = GraphDataset(random_dataset(synthetic, seed=seed, min_nodes=10,
                                     max_nodes=30), k=k)
    caps = plan_capacities(ds, batch_size)
    log(f"caps: nodes {caps.nodes} edges {caps.edges} graphs {caps.graphs} "
        f"sub_nodes {caps.sub_nodes} sub_edges {caps.sub_edges}")
    logm_k = k if options.get("recons_type") == "logM" else None
    epochs = (batch_iterator(ds, batch_size, caps, seed=seed + e,
                             logm_k=logm_k)
              for e in itertools.count())
    batches = [(g.to(dev), sub.to(dev)) for g, sub in
               itertools.islice(itertools.chain.from_iterable(epochs), steps)]

    feat_dim = ds.graphs[0].node_feat.shape[1]
    model = PretrainModel(feat_dim, hidden=hidden, d_transfer=d_transfer,
                          encoder=encoder, num_layers=num_layers,
                          num_heads=num_heads, gt_bwd=gt_bwd,
                          k_transition=k, **options)
    init_flax_style_(model, torch.Generator().manual_seed(seed))
    model.to(dev)
    step = make_pretrain_step(model, adam_l2(model, lr, weight_decay))
    generator = torch.Generator(device=dev).manual_seed(seed + 1)

    records = []
    for i, (g, sub) in enumerate(batches):
        t0 = time.perf_counter()
        losses = step(g, sub, generator)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        rec = {"step": i, "kl": float(losses.kl),
               "contrastive": float(losses.contrastive),
               "reconstruction": float(losses.reconstruction), "ms": ms}
        log(f"step {i}: kl {rec['kl']:.6g} contrastive "
            f"{rec['contrastive']:.6g} reconstruction "
            f"{rec['reconstruction']:.6g} ({ms:.2f} ms)")
        records.append(rec)
        if profiler is not None:
            profiler.step()
    return records


# --- the verb ----------------------------------------------------------------

# flags of the JAX verbs whose modules are not ported yet -> ROADMAP.md item
_SOURCES = ("cache", "molnet_root", "ogb_raw", "smiles_csv", "qm9_root",
            "pcqm4mv2_root", "peptides_root", "zinc_root")
_UNPORTED_SOURCES = _SOURCES + ("stage_caches", "tudataset_root")


def _refuse_unported(args):
    for name in _UNPORTED_SOURCES:
        if getattr(args, name, None):
            raise SystemExit(f"--{name}: the dataset readers are not ported "
                             "yet (ROADMAP.md Queue 1 item 12); use "
                             "--synthetic N")
    if args.synthetic_mode != "random":
        raise SystemExit("--synthetic_mode structured: structured_dataset "
                         "is not ported yet (ROADMAP.md Queue 1 item 12)")
    if getattr(args, "superbatch", 0):
        raise SystemExit("--superbatch: the wire superbatch step is not "
                         "ported yet (ROADMAP.md Queue 1 item 14)")
    if args.encoder in ("GCN", "GraphSAGE"):
        raise SystemExit(f"--encoder {args.encoder}: not ported yet "
                         "(ROADMAP.md Queue 1 item 6); use GIN or "
                         "Transformer")
    if (args.pretrained or "").endswith(".pt"):
        raise SystemExit(f"--pretrained {args.pretrained}: importing the "
                         "reference's torch pickle is not ported yet "
                         "(ROADMAP.md Queue 1 item 11); pass a .msgpack "
                         "checkpoint")


def _args_config(args):
    return {k: v for k, v in vars(args).items() if k != "fn"}


def _model(args, feat_dim: int) -> PretrainModel:
    return PretrainModel(feat_dim, hidden=args.hidden,
                         d_transfer=args.d_transfer, encoder=args.encoder,
                         num_layers=args.num_layers, num_heads=args.num_heads,
                         readout=args.readout, use_att=bool(args.use_att),
                         recons_type=args.recons_type, kl_mode=args.kl_mode,
                         k_transition=args.k)


def _train(model, ds, args, seed: int, autosave):
    """One stage of ``run_pretraining`` with a fresh Adam and a fresh
    (captured, on the card) step, whose graphs go with it."""
    caps = plan_capacities(ds, args.batch_size)
    optimizer = adam_l2(model, args.lr, args.weight_decay)
    state = TrainState(model, optimizer)
    return run_pretraining(
        make_pretrain_step(model, optimizer), state, ds, caps,
        args.batch_size, epochs=args.epochs, patience=args.patience,
        seed=seed, autosave_path=autosave or None,
        autosave_every=args.autosave_every,
        logm_k=args.k if args.recons_type == "logM" else None)[1]


def cmd_pretrain(args):
    """Returns the step records with ``--steps``, else the run's info (a
    list of per-stage records with ``--curriculum``)."""
    _refuse_unported(args)
    dev = resolve_device(args.device)
    if not args.synthetic:
        raise SystemExit("no data: pass --synthetic N (the dataset readers "
                         "are ROADMAP.md Queue 1 item 12)")
    if args.steps is not None:
        return run_pretrain(
            synthetic=args.synthetic, batch_size=args.batch_size,
            steps=args.steps, lr=args.lr, weight_decay=args.weight_decay,
            seed=args.seed, device=dev, encoder=args.encoder,
            num_layers=args.num_layers, num_heads=args.num_heads,
            hidden=args.hidden, d_transfer=args.d_transfer, k=args.k,
            readout=args.readout, use_att=bool(args.use_att),
            kl_mode=args.kl_mode, recons_type=args.recons_type)
    if args.curriculum:
        return _run_curriculum(args, dev)

    ds = GraphDataset(random_dataset(args.synthetic, seed=args.seed),
                      k=args.k)
    model = _model(args, ds.graphs[0].node_feat.shape[1])
    if args.pretrained and os.path.exists(args.pretrained):
        variables, _ = ckpt.load_checkpoint(args.pretrained)
        model.load_state_dict(from_jax_variables(variables))
        print(f"resumed from {args.pretrained}")
    else:
        init_flax_style_(model, torch.Generator().manual_seed(args.seed))
    info = _train(model.to(dev), ds, args, args.seed, args.autosave)
    out = args.out or "outputs/pretrain.msgpack"
    ckpt.save_checkpoint(out, info["best_variables"],
                         config=_args_config(args), step=info["best_epoch"])
    print(f"saved best (epoch {info['best_epoch']}, "
          f"loss {info['best_loss']:.5f}) to {out}")
    return info


def _run_curriculum(args, dev):
    """The three-stage curriculum (exp_pretraining.py:101-141): each stage
    trains a fresh projection and head around the previous stage's best
    core; a stage whose checkpoint exists is skipped and its core carried
    on.  Returns one record per stage (``skipped``, ``path`` and, for a
    trained stage, ``info``)."""
    out_dir = os.path.dirname(args.out or "outputs/x") or "outputs"
    prev_core = None
    names, stages = [], []
    for stage_i, (name, feat_dim) in enumerate(PRETRAIN_STAGES):
        names.append(name)
        cp_path = os.path.join(
            out_dir, ckpt.checkpoint_name("pre_training", names,
                                          args.encoder, args.hidden,
                                          args.num_layers, args.k)
            + ".msgpack")
        if ckpt.exists(cp_path):
            print(f"stage {stage_i} ({name}): checkpoint exists, skipping")
            prev_core, _ = ckpt.load_checkpoint(cp_path)
            stages.append({"stage": stage_i, "name": name, "path": cp_path,
                           "skipped": True})
            continue
        seed = args.seed + stage_i
        ds = GraphDataset(random_dataset(args.synthetic, seed=seed,
                                         feat_dim=feat_dim), k=args.k)
        model = _model(args, feat_dim)
        init_flax_style_(model, torch.Generator().manual_seed(seed))
        if prev_core is not None:
            model.load_state_dict(from_jax_variables(ckpt.load_core_into(
                to_jax_variables(model), prev_core)))
        print(f"stage {stage_i} ({name}): {len(ds)} graphs, "
              f"feat_dim {feat_dim}")
        autosave = f"{args.autosave}.stage{stage_i}" if args.autosave else None
        info = _train(model.to(dev), ds, args, seed, autosave)
        ckpt.save_checkpoint(cp_path, info["best_variables"],
                             config=_args_config(args),
                             step=info["best_epoch"])
        prev_core = info["best_variables"]
        print(f"stage {stage_i} ({name}): best loss "
              f"{info['best_loss']:.5f} -> {cp_path}")
        stages.append({"stage": stage_i, "name": name, "path": cp_path,
                       "skipped": False, "info": info})
    print(f"curriculum complete: {cp_path}")
    return stages




# --- the supervised verbs ----------------------------------------------------

def _dataset(args, num_tasks=None, feat_dim: int = 9) -> GraphDataset:
    """``--synthetic`` molecules from ``--seed``, with ``num_tasks`` labels
    (the JAX verb's ``_build_dataset``)."""
    if not args.synthetic:
        raise SystemExit("no data: pass --synthetic N (the dataset readers "
                         "are ROADMAP.md Queue 1 item 12)")
    return GraphDataset(random_dataset(args.synthetic, seed=args.seed,
                                       feat_dim=feat_dim,
                                       num_tasks=num_tasks), k=args.k)


def _spec(args):
    spec = DATASETS.get(args.dataset)
    if spec is None:
        raise SystemExit(f"unknown dataset {args.dataset!r}; "
                         f"known: {sorted(DATASETS)}")
    return spec


def _model_kwargs(cfg) -> dict:
    """The architecture options of a run's config (its args or a
    checkpoint's saved config)."""
    return dict(hidden=int(cfg["hidden"]), d_transfer=int(cfg["d_transfer"]),
                encoder=cfg["encoder"], num_layers=int(cfg["num_layers"]),
                num_heads=int(cfg["num_heads"]), readout=cfg["readout"],
                use_att=bool(int(cfg["use_att"])))


def _splits(ds: GraphDataset, spec, seed: int):
    """(train, val, test): ``ds`` shuffled with ``seed``, then the
    reference's prefix slices (exp_moleculenetBACE_BBBP.py:276,
    molecules.py:211-343)."""
    order = np.random.default_rng(seed).permutation(len(ds))
    return tuple(ds.subset(order[list(r)])
                 for r in reference_split(len(ds), spec))


def _pretrained(args):
    """The variables of ``--pretrained`` where the file exists, else
    None."""
    if args.pretrained and os.path.exists(args.pretrained):
        return ckpt.load_checkpoint(args.pretrained)[0]
    return None


def _init(model, seed: int, pre_vars, dev):
    """flax-style init from ``seed``, the pretrained core grafted in, on
    ``dev``."""
    init_flax_style_(model, torch.Generator().manual_seed(seed))
    if pre_vars is not None:
        model.load_state_dict(from_jax_variables(ckpt.load_core_into(
            to_jax_variables(model), pre_vars)))
    return model.to(dev)


def cmd_finetune(args):
    """Returns ``mean``, ``std``, ``runs`` (each repeat's test at best val)
    and ``last`` (the last repeat's ``run_finetune`` result)."""
    _refuse_unported(args)
    dev = resolve_device(args.device)
    spec = _spec(args)
    ds = _dataset(args, spec.num_tasks, spec.feat_dim)
    caps = plan_capacities(ds, args.batch_size)
    train_ds, val_ds, test_ds = _splits(ds, spec, args.seed)
    pre_vars = _pretrained(args)
    feat_dim = ds.graphs[0].node_feat.shape[1]
    repeats = args.repeats if args.repeats else spec.repeats
    values, result = [], None
    for rep in range(repeats):
        # TUDataset-style repeats: fresh heads, mean +- std reported
        # (exp_tudataset.py:150-160)
        model = _init(FinetuneModel(feat_dim, num_out=spec.num_tasks,
                                    regression=spec.regression_head,
                                    **_model_kwargs(vars(args))),
                      args.seed + (100 + rep if rep else 0), pre_vars, dev)
        if rep == 0 and pre_vars is not None:
            print(f"loaded pretrained core from {args.pretrained}")
        optimizer = masked_adam(
            model, finetune_trainable_mask(model, args.freeze_mode),
            args.lr, args.weight_decay)
        step = make_finetune_step(model, optimizer, loss_type=spec.loss,
                                  grad_accum=spec.grad_accum)
        result = run_finetune(
            step, make_eval_fn(model), TrainState(model, optimizer),
            train_ds, val_ds, test_ds, caps, args.batch_size, spec,
            epochs=args.epochs, patience=args.patience, seed=args.seed + rep,
            autosave_path=(f"{args.autosave}.rep{rep}" if args.autosave
                           else None),
            autosave_every=args.autosave_every)
        values.append(result["test_at_best_val"])
    mean, std = float(np.mean(values)), float(np.std(values))
    print(f"RESULT {args.dataset}: {spec.metric} test@best-val = "
          f"{mean:.5f} +- {std:.5f} over {repeats} run(s)")
    if args.out:
        ckpt.save_checkpoint(args.out, result["state"].variables,
                             config=dict(_args_config(args),
                                         best_epoch=result["best_epoch"],
                                         best_val=result["best_val"]),
                             step=result["best_epoch"])
        print(f"saved fine-tuned model to {args.out}")
    if args.xlsx:
        # Mean / Variant / Best_epoch cells, the reference's Excel layout
        # (script_classification.py:57-68)
        from .utils.results import update_evaluation_value

        path = update_evaluation_value(args.xlsx, args.dataset, "Mean", mean)
        update_evaluation_value(args.xlsx, args.dataset, "Variant", std)
        update_evaluation_value(args.xlsx, args.dataset, "Best_epoch",
                                result["best_epoch"])
        print(f"recorded results in {path}")
    if args.journal:
        from .utils.results import append_result

        append_result(args.journal,
                      {"dataset": args.dataset, "metric": spec.metric,
                       "mean": mean, "std": std, "runs": values,
                       "best_epoch": result["best_epoch"],
                       "config": _args_config(args)})
    return {"mean": mean, "std": std, "runs": values, "last": result}


def cmd_eval(args):
    """A ``finetune --out`` checkpoint's metric on ``--split`` (train,
    val, test, all of them, or the full dataset), its architecture and
    split seed taken from the checkpoint's config.  Returns {split:
    metric}."""
    _refuse_unported(args)
    dev = resolve_device(args.device)
    spec = _spec(args)
    variables, meta = ckpt.load_checkpoint(args.checkpoint)
    cfg = {**vars(args), **{k: v for k, v in meta.get("config", {}).items()
                            if v is not None}}
    ds = _dataset(args, spec.num_tasks, spec.feat_dim)
    caps = plan_capacities(ds, args.batch_size)
    model = FinetuneModel(ds.graphs[0].node_feat.shape[1],
                          num_out=spec.num_tasks,
                          regression=spec.regression_head,
                          **_model_kwargs(cfg))
    model.load_state_dict(from_jax_variables(variables))
    eval_fn = make_eval_fn(model.to(dev))
    if args.split == "full":
        splits = {"full": ds}
    else:
        table = dict(zip(("train", "val", "test"),
                         _splits(ds, spec, int(cfg["seed"]))))
        splits = table if args.split == "all" else \
            {args.split: table[args.split]}
    out = {}
    for name, d in splits.items():
        out[name] = evaluate(eval_fn, d, caps, args.batch_size, spec, dev)
        print(f"EVAL {args.dataset} {name}: {spec.metric} = "
              f"{out[name]:.5f} ({len(d)} graphs)")
    return out


def cmd_adapt(args):
    """Returns ``run_domain_adaptation``'s info."""
    _refuse_unported(args)
    dev = resolve_device(args.device)
    ds = _dataset(args)
    caps = plan_capacities(ds, args.batch_size)
    model = _init(DomainAdaptModel(ds.graphs[0].node_feat.shape[1],
                                   **_model_kwargs(vars(args))),
                  args.seed, _pretrained(args), dev)
    optimizer = adam_l2(model, args.lr, args.weight_decay)
    _, info = run_domain_adaptation(
        make_domainadapt_step(model, optimizer), TrainState(model, optimizer),
        ds, caps, args.batch_size, epochs=args.epochs,
        patience=DomainAdaptConfig.patience,
        seed=args.seed, autosave_path=args.autosave or None,
        autosave_every=args.autosave_every)
    out = args.out or "outputs/adapted.msgpack"
    ckpt.save_checkpoint(out, info["best_variables"],
                         config=_args_config(args))
    print(f"saved adapted model (loss {info['best_loss']:.5f}) to {out}")
    return info


# --steps keeps the defaults it had before the epoch loop was ported
_STEPS_DEFAULTS = {"synthetic": 1024, "seed": 7}


def _common(sp, optim: OptimConfig, epochs: int,
            patience: int = FinetuneConfig.patience):
    """The flags every verb shares, with the JAX verbs' defaults
    (``scgib_tpu/cli.py:585-626``): the model's from ``ModelConfig``, the
    optimizer's, the epochs and the patience as the verb's config gives
    them; and the port's ``--device``."""
    m = ModelConfig
    for name in _SOURCES:
        sp.add_argument(f"--{name}", default=None,
                        help="not ported yet (ROADMAP.md Queue 1 item 12)")
    sp.add_argument("--synthetic", type=int, default=0,
                    help="generate N synthetic molecules")
    sp.add_argument("--synthetic_mode", default="random",
                    choices=["random", "structured"],
                    help="'structured' is not ported yet")
    sp.add_argument("--zinc_split", default="train",
                    choices=["train", "val", "test"])
    sp.add_argument("--limit", type=int, default=0,
                    help="cap graphs loaded (real datasets only)")
    sp.add_argument("--k", type=int, default=1,
                    help="k-hop ego-net radius (--k_transition)")
    sp.add_argument("--batch_size", type=int,
                    default=FinetuneConfig.batch_size)
    sp.add_argument("--hidden", type=int, default=m.hidden)
    sp.add_argument("--d_transfer", type=int, default=m.d_transfer)
    sp.add_argument("--encoder", default=m.encoder,
                    choices=["GIN", "GCN", "GraphSAGE", "Transformer"])
    sp.add_argument("--num_layers", type=int, default=m.num_layers,
                    help="GIN convs, or transformer layers - 1")
    sp.add_argument("--num_heads", type=int, default=m.num_heads,
                    help="attention heads of the transformer")
    sp.add_argument("--readout", default=m.readout, choices=["sum", "s2s"])
    sp.add_argument("--use_att", type=int, default=int(m.use_att))
    sp.add_argument("--lr", type=float, default=optim.lr)
    sp.add_argument("--weight_decay", type=float,
                    default=optim.weight_decay)
    sp.add_argument("--epochs", type=int, default=epochs)
    sp.add_argument("--patience", type=int, default=patience)
    sp.add_argument("--seed", type=int, default=42)
    sp.add_argument("--pretrained", default=None)
    sp.add_argument("--repeats", type=int, default=0,
                    help="override the dataset's repeat count (finetune)")
    sp.add_argument("--out", default=None)
    sp.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain path")


def _autosave(sp, help):
    sp.add_argument("--autosave", default=None, help=help)
    sp.add_argument("--autosave_every", type=int, default=1,
                    help="autosave cadence in epochs")


def build_parser(steps: bool = False) -> argparse.ArgumentParser:
    """The verbs' parser; ``steps=True`` gives ``pretrain --steps``' own
    defaults (``_STEPS_DEFAULTS``) to the flags it was not given."""
    p = argparse.ArgumentParser(prog="scgib_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("pretrain", help="self-supervised pretraining")
    _common(sp, PretrainConfig.optim, PretrainConfig.epochs,
            PretrainConfig.patience)
    sp.add_argument("--recons_type", default=ModelConfig.recons_type,
                    choices=["adj", "logM"])
    sp.add_argument("--kl_mode", default=ModelConfig.kl_mode,
                    choices=["corrected", "reference"])
    sp.add_argument("--curriculum", action="store_true",
                    help="3-stage curriculum (exp_pretraining flow)")
    sp.add_argument("--superbatch", type=int, default=0,
                    help="not ported yet; 0 only")
    _autosave(sp, "full-train-state autosave path: resumes automatically "
                  "after preemption/crash")
    sp.add_argument("--stage_caches", default=None,
                    help="not ported yet (ROADMAP.md Queue 1 item 12)")
    sp.add_argument("--steps", type=int, default=None,
                    help="take N optimizer steps instead of the epoch loop")
    sp.set_defaults(fn=cmd_pretrain, **(_STEPS_DEFAULTS if steps else {}))

    sp = sub.add_parser("finetune", help="supervised fine-tuning")
    _common(sp, FinetuneConfig.optim, FinetuneConfig.epochs)
    _autosave(sp, "full-train-state autosave path prefix (per-repeat "
                  "suffix .repN)")
    sp.add_argument("--dataset", required=True)
    sp.add_argument("--tudataset_root", default=None,
                    help="not ported yet (ROADMAP.md Queue 1 item 12)")
    sp.add_argument("--freeze_mode", default=FinetuneConfig.freeze_mode,
                    choices=["reference", "paper", "all", "frozen"])
    sp.add_argument("--xlsx", default=None,
                    help="record Mean/Variant/Best_epoch in this Excel "
                         "sheet (needs pandas)")
    sp.add_argument("--journal", default=None,
                    help="append a JSON result record to this JSONL file")
    sp.set_defaults(fn=cmd_finetune)

    sp = sub.add_parser("eval", help="evaluate a saved fine-tuned "
                                     "checkpoint on a dataset split")
    _common(sp, FinetuneConfig.optim, 0)
    sp.add_argument("--dataset", required=True)
    sp.add_argument("--tudataset_root", default=None,
                    help="not ported yet (ROADMAP.md Queue 1 item 12)")
    sp.add_argument("--checkpoint", required=True,
                    help="fine-tuned .msgpack from `finetune --out`")
    sp.add_argument("--split", default="test",
                    choices=["train", "val", "test", "all", "full"])
    sp.set_defaults(fn=cmd_eval)

    sp = sub.add_parser("adapt", help="unsupervised domain adaptation")
    _common(sp, DomainAdaptConfig.optim, DomainAdaptConfig.epochs)
    sp.add_argument("--dataset", default=None,
                    help="dataset name (for the real-data readers)")
    sp.add_argument("--tudataset_root", default=None,
                    help="not ported yet (ROADMAP.md Queue 1 item 12)")
    _autosave(sp, "full-train-state autosave path")
    sp.set_defaults(fn=cmd_adapt)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if getattr(args, "steps", None) is not None:
        args = build_parser(steps=True).parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
