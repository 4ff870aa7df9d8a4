"""Parameters: flax-default initialization and the bridge from a flax tree.

``from_jax_variables`` maps ``{"params": ..., "batch_stats": ...}`` of the
JAX package's ``PretrainModel`` — as nested dicts of NumPy arrays — onto the
port's ``state_dict`` names.  The module layout mirrors the flax tree, so
the map is mechanical: nested keys join with dots, a Dense ``kernel``
[in, out] becomes an ``nn.Linear`` ``weight`` [out, in], a LayerNorm
(``ln1``, ``ln2``) ``scale`` its ``weight``, and the BatchNorm running
``mean`` / ``var`` stay buffers of those names.  The graph transformer's
layers may come in either of the JAX package's layouts: ``layer{i}``, or
stacked along a leading axis under ``layers/layer`` (its ``SCGIB_GT_SCAN``
mode); and with one fused ``qkv`` Dense, or separate ``Q``, ``K``, ``V``
(``SCGIB_GT_FUSED_QKV=0``), which are concatenated [q | k | v] into the
port's ``qkv``.

``init_flax_style_`` gives the port's own init the flax defaults: lecun-normal
(truncated normal, fan-in scaling) Dense kernels and zero biases, LayerNorm
scale 1 and bias 0, so training from scratch starts from the same
distribution as in JAX.
"""

from __future__ import annotations

import math
import re
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

# flax's variance_scaling truncated normal: the std of a unit normal cut at
# +-2 is 0.8796..., so the untruncated std is divided by it
_TRUNC_STD = 0.87962566103423978


def _flatten(tree: Mapping, prefix: str = ""):
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            yield from _flatten(value, name + ".")
        else:
            yield name, np.asarray(value)


def _take(tree: Mapping, i: int) -> dict:
    """Entry ``i`` of every leaf's leading axis."""
    return {key: _take(value, i) if isinstance(value, Mapping)
            else np.asarray(value)[i] for key, value in tree.items()}


def _gt_layout(tree: Mapping) -> dict:
    """The graph transformer's layers as ``layer{i}`` with a fused
    ``qkv``, from either JAX layout."""
    out = {}
    for key, value in tree.items():
        if not isinstance(value, Mapping):
            out[key] = value
        elif key == "layers" and set(value) == {"layer"}:
            stacked = value["layer"]
            depth = len(next(_flatten(stacked))[1])
            for i in range(depth):
                out[f"layer{i}"] = _gt_layout(_take(stacked, i))
        else:
            out[key] = _gt_layout(value)
    if {"Q", "K", "V"} <= set(out):
        parts = [out.pop(name) for name in "QKV"]
        out["qkv"] = {leaf: np.concatenate([np.asarray(p[leaf])
                                            for p in parts], axis=-1)
                      for leaf in parts[0]}
    return out


def from_jax_variables(variables: Mapping) -> dict:
    """flax ``{"params", "batch_stats"}`` of NumPy arrays -> ``state_dict``
    (torch tensors) for the port's module of the same architecture."""
    state = {}
    for name, value in _flatten(_gt_layout(variables.get("params", {}))):
        name = re.sub(r"((?:^|\.)ln\d+)\.scale$", r"\1.weight", name)
        if name.endswith(".kernel"):
            state[name[:-len("kernel")] + "weight"] = torch.from_numpy(
                np.array(value.T))
        else:
            state[name] = torch.from_numpy(np.array(value))
    for name, value in _flatten(variables.get("batch_stats", {})):
        state[name] = torch.from_numpy(np.array(value))
    return state


@torch.no_grad()
def init_flax_style_(module: nn.Module,
                     generator: Optional[torch.Generator] = None):
    """Re-initialize every ``nn.Linear`` of ``module`` in place: kernel ~
    lecun-normal, bias = 0; every ``nn.LayerNorm`` to scale 1, bias 0.
    BatchNorm scales stay 1 and biases 0."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            std = math.sqrt(1.0 / m.in_features) / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return module
