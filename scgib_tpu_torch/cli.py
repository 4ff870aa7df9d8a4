"""Command-line entry point: the ``pretrain`` verb.

  python -m scgib_tpu_torch.cli pretrain --synthetic 2000 --epochs 3
  python -m scgib_tpu_torch.cli pretrain --curriculum --synthetic 2000 \\
      --epochs 3 --autosave outputs/auto.msgpack --out outputs/x
  python -m scgib_tpu_torch.cli pretrain --synthetic 1024 --steps 5 \\
      [--encoder Transformer --num_layers 4 --num_heads 8]

Counterpart of the JAX package's ``cli.py pretrain`` (``scgib_tpu/cli.py:
141-311, 585-677``), with its flags and defaults: ``PretrainModel`` of
``--hidden`` / ``--d_transfer`` / ``--encoder`` / ``--num_layers`` /
``--num_heads`` / ``--readout`` / ``--use_att`` / ``--kl_mode`` /
``--recons_type`` / ``--k``, trained for ``--epochs`` with early stopping
after ``--patience`` epochs without a better loss, torch-style Adam with
coupled L2, the best epoch's weights saved to ``--out`` (default
``outputs/pretrain.msgpack``) in the JAX package's checkpoint format.
``--pretrained`` starts from a checkpoint; ``--autosave PATH`` writes the
whole training state every ``--autosave_every`` epochs and resumes from it
after a crash.  ``--curriculum`` runs the three stages (PCQM4Mv2 -> QM9 ->
mol-PCBA, synthetic stand-ins of feature width 9, 11, 9), each seeded
``--seed + stage``, carrying the core forward and skipping a stage whose
checkpoint exists in ``--out``'s directory.

Data come from ``--synthetic N`` molecules only.  The flags of the JAX verb
whose modules are not ported yet raise ``SystemExit`` naming the
``ROADMAP.md`` item that ports them: the other data sources and
``--synthetic_mode structured`` (Queue 1 item 12), ``--superbatch`` (item
14), ``--encoder GCN`` / ``GraphSAGE`` (item 6).

Two flags are the port's own: ``--device`` (``cuda``, the default, or
``cpu`` for the plain path) and ``--steps N``, which instead of the epoch
loop takes N optimizer steps on molecules of 10-30 atoms (the benchmark's
recipe) and prints each step's three losses and time (``run_pretrain``);
with it ``--synthetic`` defaults to 1024 and ``--seed`` to 7.
"""

from __future__ import annotations

import argparse
import itertools
import os
import time
from typing import Callable, List

import torch

from .config import PRETRAIN_STAGES
from .data.loader import GraphDataset, batch_iterator, plan_capacities
from .data.synthetic import random_dataset
from .models.scgib import PretrainModel
from .train import checkpoint as ckpt
from .train.loops import run_pretraining
from .train.trainer import TrainState, adam_l2, make_pretrain_step
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

# flags of the JAX verb whose modules are not ported yet -> ROADMAP.md item
_UNPORTED_SOURCES = ("cache", "molnet_root", "ogb_raw", "smiles_csv",
                     "qm9_root", "pcqm4mv2_root", "peptides_root",
                     "zinc_root", "stage_caches")


def _refuse_unported(args):
    for name in _UNPORTED_SOURCES:
        if getattr(args, name):
            raise SystemExit(f"--{name}: the dataset readers are not ported "
                             "yet (ROADMAP.md Queue 1 item 12); use "
                             "--synthetic N")
    if args.synthetic_mode != "random":
        raise SystemExit("--synthetic_mode structured: structured_dataset "
                         "is not ported yet (ROADMAP.md Queue 1 item 12)")
    if args.superbatch:
        raise SystemExit("--superbatch: the wire superbatch step is not "
                         "ported yet (ROADMAP.md Queue 1 item 14)")
    if args.encoder in ("GCN", "GraphSAGE"):
        raise SystemExit(f"--encoder {args.encoder}: not ported yet "
                         "(ROADMAP.md Queue 1 item 6); use GIN or "
                         "Transformer")


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


# --steps keeps the defaults it had before the epoch loop was ported
_STEPS_DEFAULTS = {"synthetic": 1024, "seed": 7}


def build_parser(steps: bool = False) -> argparse.ArgumentParser:
    """The verb's parser; ``steps=True`` gives ``--steps``' own defaults
    (``_STEPS_DEFAULTS``) to the flags it was not given."""
    p = argparse.ArgumentParser(prog="scgib_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("pretrain", help="self-supervised pretraining")
    # the JAX verb's flags and defaults (scgib_tpu/cli.py:585-677)
    for name in _UNPORTED_SOURCES[:-1]:
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
    sp.add_argument("--batch_size", type=int, default=128)
    sp.add_argument("--hidden", type=int, default=64)
    sp.add_argument("--d_transfer", type=int, default=32)
    sp.add_argument("--encoder", default="GIN",
                    choices=["GIN", "GCN", "GraphSAGE", "Transformer"])
    sp.add_argument("--num_layers", type=int, default=4,
                    help="GIN convs, or transformer layers - 1")
    sp.add_argument("--num_heads", type=int, default=8,
                    help="attention heads of the transformer")
    sp.add_argument("--readout", default="sum", choices=["sum", "s2s"])
    sp.add_argument("--use_att", type=int, default=1)
    sp.add_argument("--lr", type=float, default=1e-4)
    sp.add_argument("--weight_decay", type=float, default=5e-5)
    sp.add_argument("--epochs", type=int, default=100)
    sp.add_argument("--patience", type=int, default=50)
    sp.add_argument("--seed", type=int, default=42)
    sp.add_argument("--pretrained", default=None)
    sp.add_argument("--repeats", type=int, default=0,
                    help="fine-tuning only; ignored here")
    sp.add_argument("--out", default=None)
    sp.add_argument("--recons_type", default="adj", choices=["adj", "logM"])
    sp.add_argument("--kl_mode", default="corrected",
                    choices=["corrected", "reference"])
    sp.add_argument("--curriculum", action="store_true",
                    help="3-stage curriculum (exp_pretraining flow)")
    sp.add_argument("--superbatch", type=int, default=0,
                    help="not ported yet; 0 only")
    sp.add_argument("--autosave", default=None,
                    help="full-train-state autosave path: resumes "
                         "automatically after preemption/crash")
    sp.add_argument("--autosave_every", type=int, default=1,
                    help="autosave cadence in epochs")
    sp.add_argument("--stage_caches", default=None,
                    help="not ported yet (ROADMAP.md Queue 1 item 12)")
    # the port's own
    sp.add_argument("--steps", type=int, default=None,
                    help="take N optimizer steps instead of the epoch loop")
    sp.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain path")
    sp.set_defaults(fn=cmd_pretrain, **(_STEPS_DEFAULTS if steps else {}))
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.steps is not None:
        args = build_parser(steps=True).parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
