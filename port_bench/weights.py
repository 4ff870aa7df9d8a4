"""Weights made from the seed, for the program and the reference alike.

One normal draw on the device from a ``torch.Generator`` seeded with the
run's seed fills every matrix, each scaled by 1 / sqrt(fan-in) (LeCun
normal); vectors start as the layers' defaults: 1 for a norm's scale, 0 for
a bias.  Float32, the type both configurations train in.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

SCALES = (".scale", ".ln1.weight", ".ln2.weight")


def make(shapes: List[Tuple[str, tuple]], seed: int, device
         ) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for _, s in shapes if len(s) == 2)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes:
        if len(shape) == 2:
            size = math.prod(shape)
            out[name] = flat[at:at + size].view(shape) / math.sqrt(shape[1])
            at += size
        elif name.endswith(SCALES):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def load_into(model: torch.nn.Module, weights: Dict[str, torch.Tensor]):
    """Copy ``weights`` into ``model``'s parameters in place; the two must
    name the same parameters with the same shapes."""
    params = dict(model.named_parameters())
    theirs = {n: tuple(p.shape) for n, p in params.items()}
    ours = {n: tuple(w.shape) for n, w in weights.items()}
    if theirs != ours:
        raise ValueError(
            "the program's parameters differ from the benchmark's: missing "
            f"{sorted(set(ours) - set(theirs))}, extra "
            f"{sorted(set(theirs) - set(ours))}, shapes "
            f"{sorted(n for n in ours if theirs.get(n, ours[n]) != ours[n])}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])
