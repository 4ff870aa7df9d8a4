"""Command-line entry point: the ``pretrain``, ``finetune``, ``eval``,
``adapt``, ``preprocess`` and ``download`` verbs.

  python -m scgib_tpu_torch.cli pretrain --synthetic 2000 --epochs 3
  python -m scgib_tpu_torch.cli preprocess --synthetic 4096 --k 1 \\
      --out pts/synth.npz
  python -m scgib_tpu_torch.cli pretrain --cache pts/synth.npz \\
      --superbatch 32 --epochs 1
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
(``scgib_tpu/cli.py``), with their flags and defaults.

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

Every verb takes ``--encoder GIN``, ``GCN``, ``GraphSAGE`` or
``Transformer``.  ``finetune`` and ``adapt`` take the reference's
whole-module torch pickle as ``--pretrained *.pt``
(``utils/reference_import.py``): its trained core is grafted in, and its
conv count overrides ``--num_layers``.

Data come from a ``.npz`` cache (``--cache``, ``data/cache.py``; written
by ``preprocess``), a reader (``--molnet_root``, ``--ogb_raw``,
``--smiles_csv``, ``--qm9_root``, ``--pcqm4mv2_root``, ``--peptides_root``,
``--zinc_root``, ``--tudataset_root``; ``--limit`` caps the graphs read) or
``--synthetic N`` molecules (``--synthetic_mode random`` or
``structured``), in the JAX verbs' order of precedence.  ``pretrain
--curriculum --stage_caches a.npz,b.npz,...`` trains one stage a cache.
``pretrain --superbatch K`` runs the wire superbatch loop: K batches a
uint8 buffer, prefetched to the device, K steps a call (one CUDA-graph
replay on the card).  ``preprocess`` writes a dataset's cache; ``download``
fetches a dataset's raw files (``data/download.py``).

The numerics: ``pretrain``, ``finetune``, ``eval`` and ``adapt`` take
``--gt_bwd twopass|merged``, ``--gt_bf16_dots``, ``--gt_dtype
float32|bfloat16`` and ``--compute_dtype float32|bfloat16``, the
counterparts of the JAX verbs' environment knobs ``SCGIB_GT_BWD_TWOPASS``,
``SCGIB_GT_BF16``, ``SCGIB_GT_ACT_BF16`` and ``SCGIB_COMPUTE_DTYPE``
(defaults: two-pass, off, float32, float32; saved in the run's config, and
a config without them means the defaults).  The JAX package's own
Transformer on a TPU is ``--encoder Transformer --gt_bwd merged
--gt_bf16_dots``.

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
from typing import Callable, List, Optional

import numpy as np
import torch

from .config import (DATASETS, PRETRAIN_STAGES, DomainAdaptConfig,
                     FinetuneConfig, ModelConfig, OptimConfig,
                     PretrainConfig, reference_split)
from .data.cache import load_dataset, save_dataset
from .data.loader import (GraphDataset, batch_iterator, plan_batches,
                          plan_capacities, superbatch_spec, wire_superbatches)
from .data.synthetic import random_dataset, structured_dataset
from .models.scgib import DomainAdaptModel, FinetuneModel, PretrainModel
from .train import checkpoint as ckpt
from .train.loops import (evaluate, run_domain_adaptation, run_finetune,
                          run_pretraining)
from .train.trainer import (TrainState, adam_l2, finetune_trainable_mask,
                            make_domainadapt_step, make_eval_fn,
                            make_finetune_step, make_pretrain_step,
                            make_pretrain_superbatch_step, masked_adam)
from .utils.device import resolve_device
from .utils.params import (from_jax_variables, init_flax_style_,
                           to_jax_variables)
from .utils.reference_import import (convert_to_pretrain_variables,
                                     load_reference_state)


def run_pretrain(synthetic: int = 1024, batch_size: int = 128,
                 steps: int = 5, lr: float = 1e-4,
                 weight_decay: float = 5e-5, seed: int = 7, device="cuda",
                 encoder: str = "GIN", num_layers: int = 4,
                 num_heads: int = 8, gt_bwd: str = "twopass",
                 log: Callable[[str], None] = print,
                 profiler=None, hidden: int = 64, d_transfer: int = 32,
                 k: int = 1, superbatch: int = 0,
                 compute_dtype: Optional[str] = None,
                 gt_bf16_dots: bool = False, gt_dtype=None,
                 **options) -> List[dict]:
    """Pack ``steps`` batches of ``batch_size`` graphs and train on them
    with ``make_pretrain_step`` (on the card the first step eager, then
    CUDA-graph replays).

    Returns one record per step: its three losses and its time in ms
    (host clock around the step, ended by a device synchronize; batches
    are packed and moved to the device beforehand).  ``gt_bwd`` is the
    graph transformer's attention backward, "twopass" or "merged".
    ``compute_dtype``, ``gt_bf16_dots`` and ``gt_dtype`` are the encoders'
    numerics (``PretrainModel``), float32 by default.
    ``options`` go to ``PretrainModel`` (``readout``, ``use_att``,
    ``kl_mode``, ``recons_type``, ``recons_impl``); ``k`` is the ego-net
    radius and the logM reconstruction's number of steps.  ``profiler``, a
    running ``torch.profiler.profile``, is stepped after every step.
    ``superbatch`` = K: the batches go as wire superbatches of K (one
    buffer each, copied to the device beforehand) through
    ``make_pretrain_superbatch_step``, one record a call of K steps (its
    last step's losses); ``steps`` must be a multiple of K."""
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
    if superbatch:
        if steps % superbatch:
            raise ValueError(f"{steps} steps are not superbatches of "
                             f"{superbatch}")
        n_epochs = -(-steps // len(plan_batches(ds, batch_size, caps)))
        spec = superbatch_spec(ds, batch_size, caps, superbatch,
                               logm_k=logm_k, epochs=n_epochs)
        batches = [(torch.from_numpy(buf).to(dev), fits)
                   for buf, _, fits in itertools.islice(wire_superbatches(
                       ds, batch_size, caps, superbatch, seed=seed,
                       logm_k=logm_k, byte_spec=spec, epochs=n_epochs),
                       steps // superbatch)]
    else:
        batches = [(g.to(dev), sub.to(dev)) for g, sub in itertools.islice(
            itertools.chain.from_iterable(epochs), steps)]

    feat_dim = ds.graphs[0].node_feat.shape[1]
    model = PretrainModel(feat_dim, hidden=hidden, d_transfer=d_transfer,
                          encoder=encoder, num_layers=num_layers,
                          num_heads=num_heads, gt_bwd=gt_bwd,
                          k_transition=k, compute_dtype=compute_dtype,
                          gt_bf16_dots=gt_bf16_dots, gt_dtype=gt_dtype,
                          **options)
    init_flax_style_(model, torch.Generator().manual_seed(seed))
    model.to(dev)
    optimizer = adam_l2(model, lr, weight_decay)
    step = (make_pretrain_superbatch_step(model, optimizer, spec)
            if superbatch else make_pretrain_step(model, optimizer))
    generator = torch.Generator(device=dev).manual_seed(seed + 1)

    records = []
    for i, (g, sub) in enumerate(batches):
        t0 = time.perf_counter()
        losses = step(g, sub, generator)
        if superbatch:
            losses = type(losses)(*(t[-1] for t in losses))
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


# --- the data --------------------------------------------------------------

# every verb's data flags (the supervised verbs add --tudataset_root)
_SOURCES = {
    "cache": ".npz dataset cache (data/cache.py format)",
    "molnet_root": "MoleculeNet root dir with raw CSVs (data/molnet.py)",
    "ogb_raw": "OGB graph-prop raw/ dir (flat CSV layout)",
    "smiles_csv": "generic SMILES+labels CSV",
    "qm9_root": "dir holding gdb9.sdf (+ gdb9.sdf.csv)",
    "pcqm4mv2_root": "dir holding PCQM4Mv2 raw/data.csv.gz",
    "peptides_root": "dir holding the LRGB peptides tables",
    "zinc_root": "dir holding ZINC <split>.pickle (benchmarking-gnns format)"}


def _build_dataset(args, num_tasks=None, feat_dim: int = 9) -> GraphDataset:
    """The verb's dataset: the JAX verbs' ``_build_dataset``, in their
    order of precedence (a cache that exists, then each reader, then
    ``--synthetic`` molecules from ``--seed``, with ``num_tasks`` labels
    and ``feat_dim`` features)."""
    from .data import molnet

    limit = getattr(args, "limit", 0) or None
    k = args.k
    if getattr(args, "cache", None) and os.path.exists(args.cache):
        return load_dataset(args.cache)
    if getattr(args, "tudataset_root", None):
        from .data.tudataset import load_tudataset

        return GraphDataset(load_tudataset(args.tudataset_root,
                                           args.dataset), k=k)
    if getattr(args, "molnet_root", None):
        graphs, skipped = molnet.load_moleculenet(args.molnet_root,
                                                  args.dataset, limit=limit)
        if skipped:
            print(f"skipped {len(skipped)} unparseable SMILES "
                  f"(reference behavior: exp_*BACE_BBBP.py:308-323)")
        return GraphDataset(graphs, k=k)
    if getattr(args, "ogb_raw", None):
        return GraphDataset(molnet.load_ogb_graphs(args.ogb_raw,
                                                   limit=limit), k=k)
    if getattr(args, "qm9_root", None):
        from .data.sdf import load_qm9

        graphs, skipped = load_qm9(args.qm9_root, limit=limit)
        if skipped:
            print(f"skipped {skipped} malformed SDF records")
        return GraphDataset(graphs, k=k)
    if getattr(args, "pcqm4mv2_root", None):
        graphs, skipped = molnet.load_pcqm4mv2(args.pcqm4mv2_root,
                                               limit=limit)
        if skipped:
            print(f"skipped {len(skipped)} unparseable SMILES")
        return GraphDataset(graphs, k=k)
    if getattr(args, "zinc_root", None):
        from .data.zinc import load_zinc

        return GraphDataset(load_zinc(args.zinc_root,
                                      split=getattr(args, "zinc_split",
                                                    "train"),
                                      limit=limit), k=k)
    if getattr(args, "peptides_root", None):
        which = ("struct" if "struct" in (args.dataset or "").lower()
                 else "func")
        graphs, skipped = molnet.load_peptides(args.peptides_root,
                                               which=which, limit=limit)
        if skipped:
            print(f"skipped {len(skipped)} unparseable SMILES")
        return GraphDataset(graphs, k=k)
    if getattr(args, "smiles_csv", None):
        graphs, skipped = molnet.load_smiles_csv(
            args.smiles_csv, label_cols=slice(1, None), limit=limit)
        if skipped:
            print(f"skipped {len(skipped)} unparseable SMILES")
        return GraphDataset(graphs, k=k)
    if args.synthetic:
        if getattr(args, "synthetic_mode", "random") == "structured":
            graphs = structured_dataset(args.synthetic, seed=args.seed,
                                        feat_dim=feat_dim)
        else:
            graphs = random_dataset(args.synthetic, seed=args.seed,
                                    feat_dim=feat_dim, num_tasks=num_tasks)
        return GraphDataset(graphs, k=k)
    raise SystemExit("no data: pass --cache <npz>, --molnet_root DIR, "
                     "--ogb_raw DIR, --smiles_csv FILE, "
                     "--tudataset_root DIR or --synthetic N")


def cmd_preprocess(args):
    """Writes the dataset's ``.npz`` cache to ``--out``; returns the
    dataset."""
    t0 = time.time()
    ds = _build_dataset(args)
    save_dataset(args.out, ds)
    print(f"wrote {len(ds)} graphs (k={ds.k}) to {args.out} "
          f"in {time.time() - t0:.1f}s")
    return ds


def cmd_download(args):
    """Fetches each ``--dataset``'s raw files under ``--root``; returns
    {dataset: files written}."""
    from .data.download import download_dataset

    out = {}
    for name in args.dataset:
        out[name] = download_dataset(name, args.root, base_url=args.base_url,
                                     force=args.force)
        print(f"{name}: {len(out[name])} file(s) under {args.root}")
        for w in out[name]:
            print(f"  {w}")
    return out


# --- the verb ----------------------------------------------------------------

def _args_config(args):
    return {k: v for k, v in vars(args).items() if k != "fn"}


# the numerics flags -> their defaults, the counterparts of the JAX verbs'
# knobs SCGIB_GT_BWD_TWOPASS, SCGIB_GT_BF16, SCGIB_GT_ACT_BF16 and
# SCGIB_COMPUTE_DTYPE; a config without them (a JAX checkpoint's, an older
# port one's) means these
NUMERICS = {"gt_bwd": "twopass", "gt_bf16_dots": False, "gt_dtype": "float32",
            "compute_dtype": "float32"}


def _numerics(cfg) -> dict:
    """The models' numerics arguments from a run's config (its args or a
    checkpoint's saved config): float32 is None to the models."""
    cfg = {**NUMERICS, **{k: cfg[k] for k in NUMERICS if k in cfg}}
    return dict(gt_bwd=cfg["gt_bwd"],
                gt_bf16_dots=bool(cfg["gt_bf16_dots"]),
                gt_dtype=(torch.bfloat16 if cfg["gt_dtype"] == "bfloat16"
                          else None),
                compute_dtype=(None if cfg["compute_dtype"] == "float32"
                               else cfg["compute_dtype"]))


def _model(args, feat_dim: int) -> PretrainModel:
    return PretrainModel(feat_dim, hidden=args.hidden,
                         d_transfer=args.d_transfer, encoder=args.encoder,
                         num_layers=args.num_layers, num_heads=args.num_heads,
                         readout=args.readout, use_att=bool(args.use_att),
                         recons_type=args.recons_type, kl_mode=args.kl_mode,
                         k_transition=args.k, **_numerics(vars(args)))


def _train(model, ds, args, seed: int, autosave):
    """One stage of ``run_pretraining`` with a fresh Adam and a fresh
    (captured, on the card) step, whose graphs go with it; with
    ``--superbatch K`` the superbatch step on the dataset's ``ByteSpec``."""
    caps = plan_capacities(ds, args.batch_size)
    optimizer = adam_l2(model, args.lr, args.weight_decay)
    state = TrainState(model, optimizer)
    logm_k = args.k if args.recons_type == "logM" else None
    spec = None
    if args.superbatch:
        spec = superbatch_spec(ds, args.batch_size, caps, args.superbatch,
                               logm_k=logm_k)
        step = make_pretrain_superbatch_step(model, optimizer, spec)
    else:
        step = make_pretrain_step(model, optimizer)
    return run_pretraining(
        step, state, ds, caps, args.batch_size, epochs=args.epochs,
        patience=args.patience, seed=seed, autosave_path=autosave or None,
        autosave_every=args.autosave_every, logm_k=logm_k,
        superbatch_k=args.superbatch, superbatch_spec=spec)[1]


def cmd_pretrain(args):
    """Returns the step records with ``--steps``, else the run's info (a
    list of per-stage records with ``--curriculum``)."""
    dev = resolve_device(args.device)
    if args.steps is not None:
        if not args.synthetic or any(getattr(args, n, None)
                                     for n in _SOURCES):
            raise SystemExit("--steps trains on --synthetic N molecules "
                             "only")
        return run_pretrain(
            synthetic=args.synthetic, batch_size=args.batch_size,
            steps=args.steps, lr=args.lr, weight_decay=args.weight_decay,
            seed=args.seed, device=dev, encoder=args.encoder,
            num_layers=args.num_layers, num_heads=args.num_heads,
            hidden=args.hidden, d_transfer=args.d_transfer, k=args.k,
            readout=args.readout, use_att=bool(args.use_att),
            kl_mode=args.kl_mode, recons_type=args.recons_type,
            superbatch=args.superbatch, **_numerics(vars(args)))
    if args.curriculum:
        return _run_curriculum(args, dev)

    ds = _build_dataset(args)
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


def _stage_data(args):
    """(name, dataset thunk) a curriculum stage: one a ``--stage_caches``
    path, else the synthetic stand-ins of ``PRETRAIN_STAGES`` (seeded
    ``--seed + stage``, with the stage's feature width), built only for a
    stage that trains."""
    if args.stage_caches:
        return [(os.path.basename(path), lambda path=path: load_dataset(path))
                for path in args.stage_caches.split(",")]
    if not args.synthetic:
        raise SystemExit("curriculum needs --stage_caches or --synthetic N")
    gen = (structured_dataset if args.synthetic_mode == "structured"
           else random_dataset)
    return [(name, lambda i=i, fd=fd: GraphDataset(
        gen(args.synthetic, seed=args.seed + i, feat_dim=fd), k=args.k))
        for i, (name, fd) in enumerate(PRETRAIN_STAGES)]


def _run_curriculum(args, dev):
    """The three-stage curriculum (exp_pretraining.py:101-141): each stage
    trains a fresh projection and head around the previous stage's best
    core; a stage whose checkpoint exists is skipped and its core carried
    on.  Returns one record per stage (``skipped``, ``path`` and, for a
    trained stage, ``info``)."""
    out_dir = os.path.dirname(args.out or "outputs/x") or "outputs"
    prev_core = None
    names, stages = [], []
    for stage_i, (name, data) in enumerate(_stage_data(args)):
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
        ds = data()
        feat_dim = ds.graphs[0].node_feat.shape[1]
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

def _spec(args):
    spec = DATASETS.get(args.dataset)
    if spec is None:
        raise SystemExit(f"unknown dataset {args.dataset!r}; "
                         f"known: {sorted(DATASETS)}")
    return spec


def _model_kwargs(cfg) -> dict:
    """The architecture and numerics options of a run's config (its args
    or a checkpoint's saved config)."""
    return dict(hidden=int(cfg["hidden"]), d_transfer=int(cfg["d_transfer"]),
                encoder=cfg["encoder"], num_layers=int(cfg["num_layers"]),
                num_heads=int(cfg["num_heads"]), readout=cfg["readout"],
                use_att=bool(int(cfg["use_att"])), **_numerics(cfg))


def _splits(ds: GraphDataset, spec, seed: int):
    """(train, val, test): ``ds`` shuffled with ``seed``, then the
    reference's prefix slices (exp_moleculenetBACE_BBBP.py:276,
    molecules.py:211-343)."""
    order = np.random.default_rng(seed).permutation(len(ds))
    return tuple(ds.subset(order[list(r)])
                 for r in reference_split(len(ds), spec))


def _pretrained(args):
    """The variables of ``--pretrained`` where the file exists, else None.
    A reference ``.pt`` pickle is imported (``utils/reference_import.py``),
    and its conv count overrides ``args.num_layers``, as in the JAX
    verbs."""
    if not (args.pretrained and os.path.exists(args.pretrained)):
        return None
    if not args.pretrained.endswith(".pt"):
        return ckpt.load_checkpoint(args.pretrained)[0]
    variables, meta = convert_to_pretrain_variables(
        load_reference_state(args.pretrained))
    if meta["num_convs"] != args.num_layers:
        print(f"imported checkpoint has {meta['num_convs']} conv layers; "
              f"overriding --num_layers {args.num_layers}")
        args.num_layers = meta["num_convs"]
    print(f"imported reference checkpoint (core depth "
          f"{meta['core_depth']}, {meta['num_convs']} convs)")
    return variables


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
    dev = resolve_device(args.device)
    spec = _spec(args)
    ds = _build_dataset(args, spec.num_tasks, spec.feat_dim)
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
    dev = resolve_device(args.device)
    spec = _spec(args)
    variables, meta = ckpt.load_checkpoint(args.checkpoint)
    cfg = {**vars(args), **{k: v for k, v in meta.get("config", {}).items()
                            if v is not None}}
    ds = _build_dataset(args, spec.num_tasks, spec.feat_dim)
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
    dev = resolve_device(args.device)
    ds = _build_dataset(args)
    caps = plan_capacities(ds, args.batch_size)
    pre_vars = _pretrained(args)          # may set args.num_layers
    model = _init(DomainAdaptModel(ds.graphs[0].node_feat.shape[1],
                                   **_model_kwargs(vars(args))),
                  args.seed, pre_vars, dev)
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
    _data_flags(sp)
    sp.add_argument("--synthetic_mode", default="random",
                    choices=["random", "structured"],
                    help="'structured': node features correlated with "
                         "local structure (data/synthetic.py)")
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
    sp.add_argument("--gt_bwd", default=NUMERICS["gt_bwd"],
                    choices=["twopass", "merged"],
                    help="the attention's backward (SCGIB_GT_BWD_TWOPASS "
                         "in the JAX verbs)")
    sp.add_argument("--gt_bf16_dots", action="store_true",
                    help="the attention's products on bf16 operands "
                         "(SCGIB_GT_BF16)")
    sp.add_argument("--gt_dtype", default=NUMERICS["gt_dtype"],
                    choices=["float32", "bfloat16"],
                    help="the transformer's dense tail (SCGIB_GT_ACT_BF16)")
    sp.add_argument("--compute_dtype", default=NUMERICS["compute_dtype"],
                    choices=["float32", "bfloat16"],
                    help="GIN's fused conv (SCGIB_COMPUTE_DTYPE)")
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


def _data_flags(sp):
    """The data flags ``preprocess`` shares with every verb."""
    for name, help in _SOURCES.items():
        sp.add_argument(f"--{name}", default=None, help=help)
    sp.add_argument("--synthetic", type=int, default=0,
                    help="generate N synthetic molecules")
    sp.add_argument("--zinc_split", default="train",
                    choices=["train", "val", "test"])
    sp.add_argument("--limit", type=int, default=0,
                    help="cap graphs loaded (real datasets only)")
    sp.add_argument("--k", type=int, default=1,
                    help="k-hop ego-net radius (--k_transition)")


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
                    help="K wire batches a device buffer, K steps a call "
                         "(0: one batch a step)")
    _autosave(sp, "full-train-state autosave path: resumes automatically "
                  "after preemption/crash")
    sp.add_argument("--stage_caches", default=None,
                    help="comma-separated stage .npz caches")
    sp.add_argument("--steps", type=int, default=None,
                    help="take N optimizer steps instead of the epoch loop")
    sp.set_defaults(fn=cmd_pretrain, **(_STEPS_DEFAULTS if steps else {}))

    sp = sub.add_parser("finetune", help="supervised fine-tuning")
    _common(sp, FinetuneConfig.optim, FinetuneConfig.epochs)
    _autosave(sp, "full-train-state autosave path prefix (per-repeat "
                  "suffix .repN)")
    sp.add_argument("--dataset", required=True)
    sp.add_argument("--tudataset_root", default=None,
                    help="directory holding raw TUDataset text files")
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
                    help="directory holding raw TUDataset text files")
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
                    help="directory holding raw TUDataset text files")
    _autosave(sp, "full-train-state autosave path")
    sp.set_defaults(fn=cmd_adapt)

    sp = sub.add_parser("preprocess", help="build a packed dataset cache")
    _data_flags(sp)
    sp.add_argument("--dataset", default=None,
                    help="dataset name for --molnet_root/--tudataset_root")
    sp.add_argument("--tudataset_root", default=None)
    sp.add_argument("--seed", type=int, default=42)
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_preprocess)

    sp = sub.add_parser(
        "download", help="fetch a dataset's raw upstream files into the "
                         "layout the readers expect")
    sp.add_argument("--dataset", required=True, action="append",
                    help="dataset name (repeatable); see "
                         "scgib_tpu_torch.data.download.REGISTRY")
    sp.add_argument("--root", required=True,
                    help="destination root directory")
    sp.add_argument("--base_url", default=None,
                    help="mirror base URL (air-gapped setups, tests)")
    sp.add_argument("--force", action="store_true",
                    help="re-fetch even if files exist")
    sp.set_defaults(fn=cmd_download)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if getattr(args, "steps", None) is not None:
        args = build_parser(steps=True).parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
