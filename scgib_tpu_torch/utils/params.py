"""Parameters: flax-default initialization and the bridges to and from a
flax tree and an optax Adam state.

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
port's ``qkv``.  Set2Set's flax ``OptimizedLSTMCell`` keeps one Dense per
gate, ``ii if ig io`` (input, no bias) and ``hi hf hg ho`` (hidden, with
bias); the port's ``LSTMCell`` stacks them as rows [i, f, g, o] of
``weight_ih`` and ``weight_hh``, with the one bias ``bias_hh``.

``to_jax_variables`` is the inverse: it writes the layout the JAX package
writes by default (``layer{i}``, a fused ``qkv``).  ``adam_to_optax`` and
``load_adam_state`` carry ``torch.optim.Adam``'s state (``step``,
``exp_avg``, ``exp_avg_sq``) to and from optax's ``ScaleByAdamState``
(``count``, ``mu``, ``nu``), kernels transposed like the weights, over the
parameters the optimizer holds: all of them, or with a ``MaskedAdam`` (the
fine-tuning optimizer) the trainable ones, in the layout of the JAX
package's ``masked_tx`` (``optax.multi_transform`` of a "train" and a
"freeze" group, the "train" group's flat vectors over its leaves only).

``init_flax_style_`` gives the port's own init the flax defaults: lecun-normal
(truncated normal, fan-in scaling) Dense kernels and zero biases, LayerNorm
scale 1 and bias 0, so training from scratch starts from the same
distribution as in JAX.
"""

from __future__ import annotations

import math
import re
from typing import Iterable, Mapping, Optional, Tuple

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


GATES = "ifgo"      # the LSTM's gates, in torch's row order


def _port_layout(tree: Mapping) -> dict:
    """A flax tree in the port's module layout: the graph transformer's
    layers as ``layer{i}`` with a fused ``qkv`` (from either JAX layout),
    and an LSTM cell's per-gate Dense layers stacked."""
    out = {}
    for key, value in tree.items():
        if not isinstance(value, Mapping):
            out[key] = value
        elif key == "layers" and set(value) == {"layer"}:
            stacked = value["layer"]
            depth = len(next(_flatten(stacked))[1])
            for i in range(depth):
                out[f"layer{i}"] = _port_layout(_take(stacked, i))
        else:
            out[key] = _port_layout(value)
    if {"Q", "K", "V"} <= set(out):
        parts = [out.pop(name) for name in "QKV"]
        out["qkv"] = {leaf: np.concatenate([np.asarray(p[leaf])
                                            for p in parts], axis=-1)
                      for leaf in parts[0]}
    if {f"{kind}{gate}" for kind in "ih" for gate in GATES} <= set(out):
        ins = [out.pop(f"i{gate}") for gate in GATES]
        hid = [out.pop(f"h{gate}") for gate in GATES]
        out["weight_ih"] = np.concatenate([np.asarray(p["kernel"]).T
                                           for p in ins])
        out["weight_hh"] = np.concatenate([np.asarray(p["kernel"]).T
                                           for p in hid])
        out["bias_hh"] = np.concatenate([np.asarray(p["bias"]) for p in hid])
    return out


def _params_state(params: Mapping) -> dict:
    """A flax params tree (or a tree of the same shapes, such as Adam's
    moments) -> tensors under the port's parameter names."""
    state = {}
    for name, value in _flatten(_port_layout(params)):
        name = re.sub(r"((?:^|\.)ln\d+)\.scale$", r"\1.weight", name)
        if name.endswith(".kernel"):
            state[name[:-len("kernel")] + "weight"] = torch.from_numpy(
                np.array(value.T))
        else:
            state[name] = torch.from_numpy(np.array(value))
    return state


def from_jax_variables(variables: Mapping) -> dict:
    """flax ``{"params", "batch_stats"}`` of NumPy arrays -> ``state_dict``
    (torch tensors) for the port's module of the same architecture."""
    state = _params_state(variables.get("params", {}))
    for name, value in _flatten(variables.get("batch_stats", {})):
        state[name] = torch.from_numpy(np.array(value))
    return state


def _flax_entries(name: str, value: np.ndarray):
    """(flax path, array) of one port parameter: the inverse of
    ``_params_state`` for one name."""
    head, _, leaf = name.rpartition(".")
    if leaf in ("weight_ih", "weight_hh"):
        kind = "i" if leaf == "weight_ih" else "h"
        for gate, w in zip(GATES, np.split(value, 4)):
            yield f"{head}.{kind}{gate}.kernel", w.T
    elif leaf == "bias_hh":
        for gate, b in zip(GATES, np.split(value, 4)):
            yield f"{head}.h{gate}.bias", b
    elif leaf == "weight" and value.ndim == 2:
        yield f"{head}.kernel", value.T
    elif leaf == "weight":                     # LayerNorm
        yield f"{head}.scale", value
    else:
        yield name, value


def _host(t: torch.Tensor) -> np.ndarray:
    """A copy on the host (a snapshot: it never aliases the tensor)."""
    return np.array(t.detach().cpu().numpy())


def _nest(pairs: Iterable[Tuple[str, np.ndarray]]) -> dict:
    tree: dict = {}
    for path, value in pairs:
        *heads, leaf = path.split(".")
        node = tree
        for key in heads:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def flax_params(named: Iterable[Tuple[str, torch.Tensor]]) -> dict:
    """Tensors under the port's parameter names (the parameters, or
    tensors of their shapes) -> a flax params tree of NumPy arrays."""
    return _nest(entry for name, t in named
                 for entry in _flax_entries(name, _host(t)))


def to_jax_variables(model: nn.Module) -> dict:
    """The port module's ``{"params", "batch_stats"}`` as the JAX package's
    module of the same architecture names them (NumPy arrays)."""
    return {"params": flax_params(model.named_parameters()),
            "batch_stats": _nest((name, _host(b))
                                 for name, b in model.named_buffers())}


def sorted_leaves(tree: Mapping):
    """(path, leaf) in ``jax.tree_util.tree_leaves`` order: keys sorted at
    every level."""
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, Mapping):
            for path, leaf in sorted_leaves(value):
                yield (key,) + path, leaf
        else:
            yield (key,), value


def _flat(tree: Mapping) -> np.ndarray:
    return np.concatenate([np.ravel(np.asarray(leaf, np.float32))
                           for _, leaf in sorted_leaves(tree)])


def _unflat(vec: np.ndarray, template: Mapping) -> dict:
    """A flat vector in ``sorted_leaves`` order -> a tree shaped like
    ``template``."""
    pairs, i = [], 0
    for path, leaf in sorted_leaves(template):
        n = int(np.prod(leaf.shape))
        pairs.append((".".join(path), vec[i:i + n].reshape(leaf.shape)))
        i += n
    if i != vec.size:
        raise ValueError(f"flat optimizer vector of {vec.size} entries for "
                         f"a model of {i} parameters")
    return _nest(pairs)


def _optimized(model: nn.Module, optimizer: torch.optim.Optimizer):
    """(name, parameter) of the parameters ``optimizer`` holds, in
    ``model``'s order."""
    held = {id(p) for group in optimizer.param_groups
            for p in group["params"]}
    return [(n, p) for n, p in model.named_parameters() if id(p) in held]


def adam_to_optax(model: nn.Module, optimizer: torch.optim.Optimizer
                  ) -> dict:
    """``optimizer``'s Adam state as the opt_state of the JAX package's
    ``adam_l2`` (``trainer.py:77-144``): ``{"0": chain, "1": p_flat}``, the
    chain ``(add_decayed_weights, scale_by_adam, scale)`` with weight
    decay, ``(scale_by_adam, scale)`` without, and the moments and
    parameters as flat vectors in ``jax.tree_util.tree_leaves`` order.  A
    ``MaskedAdam``'s (``masked_tx``, ``trainer.py:510-517``) is that state
    over the trainable parameters, under ``inner_states`` / ``train`` /
    ``inner_state``, beside the empty state of the ``freeze`` group."""
    named = _optimized(model, optimizer)
    count, mu, nu = 0, [], []
    for name, p in named:
        state = optimizer.state.get(p, {})
        if state:
            count = int(state["step"])
        mu.append((name, state.get("exp_avg", torch.zeros_like(p))))
        nu.append((name, state.get("exp_avg_sq", torch.zeros_like(p))))
    adam = {"count": np.asarray(count, np.int32),
            "mu": _flat(flax_params(mu)), "nu": _flat(flax_params(nu))}
    if optimizer.param_groups[0]["weight_decay"]:
        chain = {"0": {}, "1": adam, "2": {}}
    else:
        chain = {"0": adam, "1": {}}
    state = {"0": chain, "1": _flat(flax_params(named))}
    if getattr(optimizer, "masked", False):
        return {"inner_states": {"freeze": {"inner_state": {}},
                                 "train": {"inner_state": state}}}
    return state


def _find_adam(tree: Mapping) -> Mapping:
    if {"count", "mu", "nu"} <= set(tree):
        return tree
    for value in tree.values():
        if isinstance(value, Mapping):
            found = _find_adam(value)
            if found is not None:
                return found
    return None


def load_adam_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                    opt_state: Mapping):
    """Set ``optimizer``'s Adam state from a JAX opt_state in any of the
    layouts the JAX package has written: per-leaf ``mu`` / ``nu`` trees
    (``optax.chain`` alone), flat vectors (``optax.flatten``), or flat
    vectors with the resident parameter vector (today's ``adam_l2``), each
    over the parameters the optimizer holds (under ``masked_tx``'s groups
    for a ``MaskedAdam``)."""
    adam = _find_adam(opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the opt_state")
    held = _optimized(model, optimizer)
    template = flax_params(held)
    moments = []
    for tree in (adam["mu"], adam["nu"]):
        if not isinstance(tree, Mapping):
            tree = _unflat(np.asarray(tree), template)
        moments.append(_params_state(tree))
    named = dict(held)
    if set(moments[0]) != set(named):
        raise ValueError("the Adam state does not match the model's "
                         f"parameters: {sorted(set(moments[0]) ^ set(named))}")
    step = float(np.asarray(adam["count"]))
    # capturable Adam (a CUDA-graph step) keeps its step count beside the
    # parameter; otherwise on the host, as Adam creates it
    on_device = optimizer.param_groups[0].get("capturable", False)
    for name, p in named.items():
        loaded = {"step": torch.tensor(step, device=p.device if on_device
                                       else "cpu"),
                  "exp_avg": moments[0][name].to(p.device, p.dtype),
                  "exp_avg_sq": moments[1][name].to(p.device, p.dtype)}
        state = optimizer.state.get(p)
        if state and set(state) == set(loaded):
            # in place: a captured step reads these very tensors
            with torch.no_grad():
                for key, value in loaded.items():
                    state[key].copy_(value)
        else:
            optimizer.state[p] = loaded


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor,
                  generator: Optional[torch.Generator] = None):
    """flax's default kernel init for a [out, in] weight: a normal of std
    sqrt(1 / in) truncated at 2 std (variance kept)."""
    std = math.sqrt(1.0 / weight.shape[1]) / _TRUNC_STD
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


@torch.no_grad()
def init_flax_style_(module: nn.Module,
                     generator: Optional[torch.Generator] = None):
    """Re-initialize every ``nn.Linear`` of ``module`` in place: kernel ~
    lecun-normal, bias = 0; every ``nn.LayerNorm`` to scale 1, bias 0; a
    module with a ``flax_init_`` method (the LSTM cell) by that method.
    BatchNorm scales stay 1 and biases 0."""
    for m in module.modules():
        if hasattr(m, "flax_init_"):
            m.flax_init_(generator)
        elif isinstance(m, nn.Linear):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return module
