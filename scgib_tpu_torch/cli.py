"""Command-line entry point: ``pretrain`` on synthetic molecules.

  python -m scgib_tpu_torch.cli pretrain --synthetic 1024 --batch_size 128 \\
      --steps 5 --lr 1e-4 --weight_decay 5e-5 --device cuda \\
      [--encoder Transformer --num_layers 4 --num_heads 8]

Counterpart of the JAX package's ``cli.py pretrain`` without checkpoints,
curriculum or real datasets: it generates ``--synthetic`` molecules (10-30
atoms, the benchmark's recipe), extracts their 1-hop ego-nets, plans
padded capacities, packs batches and takes ``--steps`` optimizer steps of
``PretrainModel(9, hidden=64, d_transfer=32)`` (GIN encoders by default, or
graph transformers with ``--num_layers + 1`` layers of ``--num_heads``
heads) with torch-style Adam and coupled L2, printing the three losses of
each.
"""

from __future__ import annotations

import argparse
import itertools
import time
from typing import Callable, List

import torch

from .data.loader import GraphDataset, batch_iterator, plan_capacities
from .data.synthetic import random_dataset
from .models.scgib import PretrainModel
from .train.trainer import make_pretrain_step
from .utils.device import resolve_device
from .utils.params import init_flax_style_


def run_pretrain(synthetic: int = 1024, batch_size: int = 128,
                 steps: int = 5, lr: float = 1e-4,
                 weight_decay: float = 5e-5, seed: int = 7, device="cuda",
                 encoder: str = "GIN", num_layers: int = 4,
                 num_heads: int = 8, gt_bwd: str = "twopass",
                 log: Callable[[str], None] = print,
                 profiler=None) -> List[dict]:
    """Pack ``steps`` batches of ``batch_size`` graphs and train on them.

    Returns one record per step: its three losses and its time in ms
    (host clock around the step, ended by a device synchronize; batches
    are packed and moved to the device beforehand).  ``gt_bwd`` is the
    graph transformer's attention backward, "twopass" or "merged".
    ``profiler``, a running ``torch.profiler.profile``, is stepped after
    every step."""
    dev = resolve_device(device)
    ds = GraphDataset(random_dataset(synthetic, seed=seed, min_nodes=10,
                                     max_nodes=30), k=1)
    caps = plan_capacities(ds, batch_size)
    log(f"caps: nodes {caps.nodes} edges {caps.edges} graphs {caps.graphs} "
        f"sub_nodes {caps.sub_nodes} sub_edges {caps.sub_edges}")
    epochs = (batch_iterator(ds, batch_size, caps, seed=seed + e)
              for e in itertools.count())
    batches = [(g.to(dev), sub.to(dev)) for g, sub in
               itertools.islice(itertools.chain.from_iterable(epochs), steps)]

    feat_dim = ds.graphs[0].node_feat.shape[1]
    model = PretrainModel(feat_dim, hidden=64, d_transfer=32,
                          encoder=encoder, num_layers=num_layers,
                          num_heads=num_heads, gt_bwd=gt_bwd)
    init_flax_style_(model, torch.Generator().manual_seed(seed))
    model.to(dev)
    step = make_pretrain_step(model, torch.optim.Adam(
        model.parameters(), lr=lr, weight_decay=weight_decay))
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


def main(argv=None):
    p = argparse.ArgumentParser(prog="scgib_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("pretrain", help="self-supervised pretraining steps")
    sp.add_argument("--synthetic", type=int, default=1024,
                    help="number of synthetic molecules to generate")
    sp.add_argument("--batch_size", type=int, default=128)
    sp.add_argument("--steps", type=int, default=5)
    sp.add_argument("--lr", type=float, default=1e-4)
    sp.add_argument("--weight_decay", type=float, default=5e-5)
    sp.add_argument("--seed", type=int, default=7)
    sp.add_argument("--encoder", default="GIN",
                    choices=["GIN", "Transformer"])
    sp.add_argument("--num_layers", type=int, default=4,
                    help="GIN convs, or transformer layers - 1")
    sp.add_argument("--num_heads", type=int, default=8,
                    help="attention heads of the transformer")
    sp.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain path")
    args = p.parse_args(argv)
    run_pretrain(synthetic=args.synthetic, batch_size=args.batch_size,
                 steps=args.steps, lr=args.lr,
                 weight_decay=args.weight_decay, seed=args.seed,
                 device=args.device, encoder=args.encoder,
                 num_layers=args.num_layers, num_heads=args.num_heads)


if __name__ == "__main__":
    main()
