"""The reference's run of the steps it checks: from the seed's weights,
through the batches the program trained on, with the noise the program
drew (each step's generator state), to the losses, the first gradient as
the optimizer took it and the parameters after the last step; and its
evaluation of a model state."""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from . import model as M
from .pack import Batch


def draws(state: torch.Tensor, device):
    """``rand(shape)`` of a generator restored to ``state``: what the
    program's ``torch.rand`` calls drew from it, in the same order."""
    gen = torch.Generator(device=device)
    gen.set_state(state)
    return lambda shape: torch.rand(shape, generator=gen, device=device)


def follow(cfg: dict, head: str, weights: Dict[str, torch.Tensor],
           batches: Sequence[Batch], states: Sequence[torch.Tensor],
           lr: float, weight_decay: float, freeze: str = "none",
           num: M.Numerics = M.FLOAT64) -> dict:
    """Train ``len(batches)`` steps from ``weights``.  Returns ``losses``
    (per step a list: the pretraining terms, or the fine-tuning loss),
    ``first_grad`` (step 1's gradient as the optimizer took it, with L2,
    by trainable name), ``params`` (after the last step, every name) and
    ``trainable``."""
    device = batches[0].x.device
    params = {n: w.detach().to(device=device, dtype=num.dtype).clone()
              for n, w in weights.items()}
    names = M.trainable(cfg, head, freeze)
    adam = M.Adam(names, lr, weight_decay)
    losses: List[List[float]] = []
    first_grad = None
    for b, state in zip(batches, states):
        leaves = {n: t.detach().requires_grad_(n in names)
                  for n, t in params.items()}
        rand = draws(state, device)
        if head == "pretrain":
            terms = list(M.pretrain_losses(leaves, cfg, b, num, rand))
        else:
            terms = [M.bce(M.finetune_scores(leaves, cfg, b, num, rand,
                                             train=True), b.labels)]
        total = sum(terms)
        grads = torch.autograd.grad(total, [leaves[n] for n in names],
                                    allow_unused=True)
        grads = {n: (torch.zeros_like(leaves[n]) if g is None else g)
                 for n, g in zip(names, grads)}
        taken = adam.step(params, grads)
        if first_grad is None:
            first_grad = taken
        losses.append([float(t.detach()) for t in terms])
    return {"losses": losses, "first_grad": first_grad, "params": params,
            "trainable": names}


def evaluate(cfg: dict, state: Dict[str, torch.Tensor],
             batches: Sequence[Batch], seed: int,
             num: M.Numerics = M.FLOAT64) -> List[torch.Tensor]:
    """Eval-mode probabilities of each batch under ``state`` (parameters
    and the BatchNorms' running ``mean`` and ``var``), the gate's noise
    drawn from one generator seeded ``seed`` on the batches' device,
    batch after batch."""
    device = batches[0].x.device
    p = {n: t.to(device=device, dtype=num.dtype) for n, t in state.items()}
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(shape):
        return torch.rand(shape, generator=gen, device=device)

    def running(name):
        return p[f"{name}.mean"], p[f"{name}.var"]

    with torch.no_grad():
        return [M.finetune_scores(p, cfg, b, num, rand, train=False,
                                  running=running) for b in batches]
