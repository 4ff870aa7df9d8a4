"""Import the reference's whole-module torch pickles into a flax-layout tree.

Counterpart of ``scgib_tpu/utils/reference_import.py``.  The reference
checkpoints (``pre_training_v1_GIN_64_5_1.pt``) are ``torch.save(model)``
pickles of entire ``Mainmodel_continue`` modules whose class definitions
import DGL, which is not installed.  ``load_reference_state`` unpickles them
with *shell classes* standing in for every class that cannot be imported,
then walks the ``nn.Module`` ``_parameters`` / ``_buffers`` / ``_modules``
structure to a flat ``name -> numpy`` dict under torch's naming.

Curriculum nesting: each ``Mainmodel_continue`` wraps the previous stage at
``self.model``, but its forward trains the wrapped model's encoders while
its own stay at their random init (reference models.py:1167 against
models.py:1204).  So in a stage-N checkpoint the trained core lives one
level down (``model.Encoder1...``), and the outermost encoders are
untouched: their BatchNorm running statistics are still exactly (0, 1).
``convert_to_pretrain_variables`` therefore takes the core from the
shallowest nesting depth whose BatchNorms were updated (or a given depth).
It returns the JAX package's ``{"params", "batch_stats"}`` tree, which
``utils/params.py::from_jax_variables`` maps onto the port's modules like
any JAX checkpoint.
"""

from __future__ import annotations

import pickle
import types
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


class _Shell:
    """Stand-in for any class of the pickle that cannot be imported."""

    def __init__(self, *a, **k):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state


class _ShellUnpickler(pickle.Unpickler):
    """Substitutes a ``_Shell`` subclass for every class whose module
    cannot be imported (the reference's ``models`` module and all of
    DGL)."""

    _cache: Dict[Tuple[str, str], type] = {}

    def find_class(self, module: str, name: str):
        try:
            return super().find_class(module, name)
        except Exception:
            key = (module, name)
            if key not in self._cache:
                self._cache[key] = type(name, (_Shell,),
                                        {"__module__": module})
            return self._cache[key]


def _shell_pickle_module() -> types.ModuleType:
    mod = types.ModuleType("_shell_pickle")
    mod.Unpickler = _ShellUnpickler
    mod.load = pickle.load
    mod.__name__ = "pickle"
    return mod


def load_reference_state(path: str) -> Dict[str, np.ndarray]:
    """Flat ``name -> numpy array`` state of a whole-module reference
    pickle, torch naming (``model.Encoder1.ginlayers.0.apply_func.mlp.0.
    weight`` ...), buffers (BatchNorm running statistics) included.  The
    pickle holds whole modules, so it is loaded with ``weights_only=False``:
    load only a file you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False,
                     pickle_module=_shell_pickle_module())
    flat: Dict[str, np.ndarray] = {}

    def walk(o: Any, prefix: str) -> None:
        d = getattr(o, "__dict__", None)
        if d is None:
            return
        for store in ("_parameters", "_buffers"):
            for k, v in (d.get(store) or {}).items():
                if v is not None and hasattr(v, "detach"):
                    flat[prefix + k] = v.detach().cpu().numpy()
        for k, v in (d.get("_modules") or {}).items():
            if v is not None:
                walk(v, f"{prefix}{k}.")

    walk(obj, "")
    return flat


def nesting_depths(flat: Dict[str, np.ndarray]) -> int:
    """How many ``model.``-nested levels the checkpoint has."""
    depth = 0
    prefix = "model."
    while any(k.startswith(prefix) for k in flat):
        depth += 1
        prefix = "model." + prefix
    return depth


def bn_trained_at_depth(flat: Dict[str, np.ndarray], depth: int) -> bool:
    """True iff an encoder BatchNorm's running variance at this nesting
    depth differs from its init of 1, i.e. the encoders ran."""
    p = "model." * depth
    for enc in ("Encoder1", "Encoder2"):
        for k, v in flat.items():
            if (k.startswith(f"{p}{enc}.batch_norms.")
                    and k.endswith("running_var")
                    and not np.allclose(v, 1.0)):
                return True
    return False


def trained_core_depth(flat: Dict[str, np.ndarray]) -> int:
    """Shallowest nesting depth whose encoders were trained (0 if none)."""
    for depth in range(nesting_depths(flat) + 1):
        if bn_trained_at_depth(flat, depth):
            return depth
    return 0


def _t(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.T)


def _dense(flat, name: str) -> dict:
    return {"kernel": _t(flat[f"{name}.weight"]),
            "bias": flat[f"{name}.bias"]}


def convert_to_pretrain_variables(
        flat: Dict[str, np.ndarray], depth: Optional[int] = None,
        head_depth: int = 0) -> Tuple[Dict[str, Any], Dict[str, int]]:
    """The JAX package's ``PretrainModel`` variables from a reference state
    dict.

    ``depth``: the nesting level supplying the core (encoders, compressor,
    attention); by default the shallowest with trained BatchNorms.
    ``head_depth``: the level supplying ``transfer_d`` and the head MLP
    (the outermost object's, which its forward trains: 0).

    Returns (variables, meta), meta = {'core_depth', 'num_convs'}: give
    ``num_convs`` as the model's ``num_layers`` (the shipped artifact has 5
    convs although the released GIN class builds 4).  GIN cores only (the
    shipped artifact is GIN)."""
    if depth is None:
        depth = trained_core_depth(flat)
    cp = "model." * depth
    hp = "model." * head_depth
    params: Dict[str, Any] = {
        "transfer_d": {"kernel": _t(flat[f"{hp}transfer_d.weight"])},
        "head_mlp": {"Dense_0": _dense(flat, f"{hp}MLP.0"),
                     "Dense_1": _dense(flat, f"{hp}MLP.2")}}
    core_p: Dict[str, Any] = {}
    core_s: Dict[str, Any] = {}
    num_convs = 0
    for enc_ref, enc_ours in (("Encoder1", "encoder1"),
                              ("Encoder2", "encoder2")):
        ep: Dict[str, Any] = {}
        es: Dict[str, Any] = {}
        i = 0
        while f"{cp}{enc_ref}.ginlayers.{i}.apply_func.mlp.0.weight" in flat:
            base = f"{cp}{enc_ref}.ginlayers.{i}.apply_func.mlp"
            ep[f"conv{i}"] = {"Dense_0": _dense(flat, f"{base}.0"),
                              "Dense_1": _dense(flat, f"{base}.2")}
            bn = f"{cp}{enc_ref}.batch_norms.{i}"
            ep[f"bn{i}"] = {"scale": flat[f"{bn}.weight"],
                            "bias": flat[f"{bn}.bias"]}
            es[f"bn{i}"] = {"mean": flat[f"{bn}.running_mean"],
                            "var": flat[f"{bn}.running_var"]}
            i += 1
        if i == 0:
            raise ValueError(f"no GIN layers found at depth {depth} for "
                             f"{enc_ref}; is this a GIN checkpoint?")
        num_convs = i
        core_p[enc_ours] = ep
        core_s[enc_ours] = es
    core_p["compressor"] = {
        "fc1": _dense(flat, f"{cp}compressor.0"),
        "fc2": _dense(flat, f"{cp}compressor.3"),
        "bn": {"scale": flat[f"{cp}compressor.1.weight"],
               "bias": flat[f"{cp}compressor.1.bias"]}}
    core_s["compressor"] = {
        "bn": {"mean": flat[f"{cp}compressor.1.running_mean"],
               "var": flat[f"{cp}compressor.1.running_var"]}}
    core_p["attn_layer"] = _dense(flat, f"{cp}attn_layer")
    params["core"] = core_p
    return ({"params": params, "batch_stats": {"core": core_s}},
            {"core_depth": depth, "num_convs": num_convs})
