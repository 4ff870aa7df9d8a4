"""Checkpoints in the JAX package's format.

Counterpart of ``scgib_tpu/train/checkpoint.py``.  A checkpoint is a msgpack
file of the flax variables tree (``{"params", "batch_stats"}``, arrays as
flax's ndarray extension) with a JSON sidecar ``<path>.json`` holding the
step and the run's config; the name comes from ``checkpoint_name``, and a
curriculum stage is skipped when its file ``exists``.  An autosave
(``save_train_state``) is the whole training state: the variables, the
optimizer state as optax's ``adam_l2`` lays it out, the step count, the
epoch, the JAX RNG key and the loop's bookkeeping under ``extra``.  Both
are written tmp-then-rename, so a kill mid-write leaves the previous file
whole.  The files are byte-compatible both ways: the JAX package's
``load_checkpoint`` / ``load_train_state`` read what the port writes, and
the port reads every checkpoint and autosave the JAX package has written
(``utils/params.py`` names the optimizer layouts, the fine-tuning
optimizer's masked one among them).  Encoding is the
port's own (``utils/msgpack_codec.py``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

from ..utils.msgpack_codec import packb, unpackb
from ..utils.params import adam_to_optax, from_jax_variables, load_adam_state


def checkpoint_name(prefix: str, datasets, encoder: str, hidden: int,
                    num_layers: int, k_transition: int) -> str:
    """Reference-style config-keyed name (exp_pretraining.py:103)."""
    ds = "_".join(datasets) if not isinstance(datasets, str) else datasets
    return f"{prefix}_{ds}_{encoder}_{hidden}_{num_layers}_{k_transition}"


def _write(path: str, blob: bytes):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


def save_checkpoint(path: str, variables: Mapping[str, Any],
                    config: Optional[Dict[str, Any]] = None,
                    step: int = 0) -> None:
    """``variables``: a flax-style tree of NumPy arrays
    (``TrainState.variables``, ``to_jax_variables``)."""
    _write(path, packb(dict(variables)))
    meta = {"step": int(step), "config": config or {}}
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=2, default=str)


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(variables, meta): the tree of NumPy arrays and the sidecar (empty
    without one).  ``from_jax_variables`` turns the tree into a
    ``state_dict``."""
    with open(path, "rb") as f:
        variables = unpackb(f.read())
    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return variables, meta


def exists(path: str) -> bool:
    return os.path.exists(path)


def save_train_state(path: str, state, epoch: int, rng,
                     extra: Optional[Dict[str, Any]] = None) -> None:
    """Autosave ``state`` (a ``train.trainer.TrainState``) after ``epoch``:
    everything a resumed run needs to continue as if never stopped.  ``rng``
    is the run's uint32[2] JAX key; the port's own generator state goes in
    ``extra``."""
    variables = state.variables
    payload = {
        "state": {"params": variables["params"],
                  "batch_stats": variables["batch_stats"],
                  "opt_state": adam_to_optax(state.model, state.optimizer),
                  "step": np.asarray(state.step, np.int32)},
        "epoch": int(epoch),
        "rng": np.asarray(rng, np.uint32),
        "extra": dict(extra or {}),
    }
    _write(path, packb(payload))


def load_train_state(path: str, state):
    """Restore an autosave into ``state`` in place (model, optimizer, step
    count).  Returns (epoch, rng, extra)."""
    with open(path, "rb") as f:
        payload = unpackb(f.read())
    saved = payload["state"]
    state.model.load_state_dict(from_jax_variables(
        {"params": saved["params"], "batch_stats": saved["batch_stats"]}))
    load_adam_state(state.model, state.optimizer, saved["opt_state"])
    state.step = int(saved["step"])
    return (int(payload["epoch"]), np.asarray(payload["rng"], np.uint32),
            payload.get("extra", {}))


def load_core_into(variables: Mapping[str, Any],
                   pretrained: Mapping[str, Any]) -> Dict[str, Any]:
    """Graft a pretrained model's ``core`` subtree (params and batch_stats)
    into other variables; the rest keeps its values (the curriculum's fresh
    projection and head each stage)."""
    out = dict(variables)
    for col in ("params", "batch_stats"):
        if col in variables and "core" in pretrained.get(col, {}):
            out[col] = {**variables[col], "core": pretrained[col]["core"]}
    return out
