"""The pretraining loop: epochs, patience, the best weights, the NaN guard,
autosave and resume.

Counterpart of ``scgib_tpu/train/loops.py::run_pretraining`` (the
reference's patience-50 loop on the best train loss, exp_pretraining.py:
59-78).  Each epoch shuffles the dataset with ``seed + epoch`` through
``batch_iterator``, whose batches are the JAX package's bit for bit, and
logs the JAX package's line with the edges a second.  ``track_best`` keeps
a real snapshot of the best epoch's weights (the reference aliases the live
module, so it keeps the last; ``track_best=False``).  The compression noise
and the graph transformer's dropout come from one ``torch.Generator``, whose
state the autosave keeps, so that a resumed run on the CPU reaches the same
bits as one never stopped.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.loader import Capacities, GraphDataset, batch_iterator
from ..utils.profiling import StepTimer
from .checkpoint import load_train_state, save_train_state
from .trainer import TrainState


class NonFiniteLossError(RuntimeError):
    """An epoch's loss was NaN or infinite.  The stage halts at the first
    such epoch (a NaN epoch would otherwise read as "no improvement" and
    burn the patience on corrupted weights).  ``info`` holds the last
    healthy bookkeeping, ``best_variables`` included (None when
    ``track_best=False`` kept nothing trustworthy)."""

    def __init__(self, message: str, info: Optional[Dict] = None):
        super().__init__(message)
        self.info = info if info is not None else {}


def _guard_finite(epoch_loss: float, epoch: int, stage: str, info: Dict,
                  log: Optional[Callable[[str], None]]):
    if math.isfinite(epoch_loss):
        return
    if log:
        log(f"FATAL: non-finite {stage} loss {epoch_loss} at epoch "
            f"{epoch} — halting (healthy best is epoch "
            f"{info.get('best_epoch', -1)})")
    raise NonFiniteLossError(
        f"{stage} loss became non-finite at epoch {epoch}", info)


def jax_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as uint32[2], as JAX gives it without
    64-bit mode (the seed's low 32 bits): what an autosave's ``rng``
    holds."""
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def _restore_generator(generator: torch.Generator, rng: np.ndarray,
                       extra: Dict):
    """The port's autosave keeps the generator's state; a JAX autosave has
    none, and the generator is then seeded from its key's two words."""
    if extra.get("torch_rng") is not None:
        generator.set_state(torch.from_numpy(
            np.array(extra["torch_rng"], np.uint8)))
    else:
        generator.manual_seed((int(rng[0]) << 32) | int(rng[1]))


def run_pretraining(step_fn: Callable, state: TrainState, ds: GraphDataset,
                    caps: Capacities, batch_size: int, epochs: int,
                    patience: int = 50, seed: int = 42,
                    generator: Optional[torch.Generator] = None,
                    track_best: bool = True,
                    log: Optional[Callable[[str], None]] = print,
                    autosave_path: Optional[str] = None,
                    autosave_every: int = 1,
                    logm_k: Optional[int] = None
                    ) -> Tuple[TrainState, Dict]:
    """One pretraining stage.  ``step_fn(g, sub, generator) -> losses``
    (``make_pretrain_step`` of ``state``'s model and optimizer).  Returns
    (state, info): ``info['best_variables']`` are the best-train-loss
    weights as a flax tree, with ``best_loss``, ``best_epoch``, ``history``
    (the epoch losses) and ``throughput`` (this call's steps, wall time and
    edges/s).

    ``generator`` draws the noise (on the model's device; seeded with
    ``seed`` when not given).  ``autosave_path``: the whole state is
    written there every ``autosave_every`` epochs, and a run that finds an
    autosave resumes from the epoch after it, its best weights included."""
    device = next(state.model.parameters()).device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    rng = jax_key(seed)
    best_loss = float("inf")
    best_vars = None
    best_epoch = -1
    bad_epochs = 0
    start_epoch = 0
    history: List[float] = []
    timer = StepTimer()

    if autosave_path and os.path.exists(autosave_path):
        saved_epoch, rng, extra = load_train_state(autosave_path, state)
        _restore_generator(generator, rng, extra)
        start_epoch = saved_epoch + 1
        best_loss = float(extra.get("best_loss", best_loss))
        best_epoch = int(extra.get("best_epoch", best_epoch))
        bad_epochs = int(extra.get("bad_epochs", bad_epochs))
        history = [float(x) for x in np.asarray(extra.get("history", ()))]
        if track_best and extra.get("best_variables") is not None:
            best_vars = extra["best_variables"]
        if log:
            log(f"resumed autosave at epoch {saved_epoch} "
                f"(best {best_loss:.5f})")

    for epoch in range(start_epoch, epochs):
        total = 0.0
        nb = 0
        for g, sub in batch_iterator(ds, batch_size, caps, shuffle=True,
                                     seed=seed + epoch, logm_k=logm_k):
            n_edges = int(g.edge_mask.sum() + sub.edge_mask.sum())
            g, sub = g.to(device), sub.to(device)
            with timer.step(edges=n_edges, graphs=int(g.graph_mask.sum())):
                losses = step_fn(g, sub, generator)
                total += float(losses.total)     # waits for the device
            state.step += 1
            nb += 1
        epoch_loss = total / max(nb, 1)
        history.append(epoch_loss)
        if log:
            log(f"pretrain epoch {epoch}: loss {epoch_loss:.5f} "
                f"({timer.edges_per_s:.0f} edges/s)")
        _guard_finite(epoch_loss, epoch, "pretrain",
                      {"best_variables": best_vars, "best_loss": best_loss,
                       "best_epoch": best_epoch, "history": history,
                       "nonfinite_epoch": epoch,
                       "throughput": timer.summary()}, log)
        if epoch_loss < best_loss:
            best_loss = epoch_loss
            best_epoch = epoch
            bad_epochs = 0
            if track_best:
                best_vars = state.variables
        else:
            bad_epochs += 1
            if bad_epochs >= patience:
                if log:
                    log(f"early stop at epoch {epoch} (patience {patience})")
                break
        if autosave_path and (epoch + 1) % max(autosave_every, 1) == 0:
            extra = {"best_loss": best_loss, "best_epoch": best_epoch,
                     "bad_epochs": bad_epochs,
                     "history": np.asarray(history, np.float64),
                     "torch_rng": generator.get_state().numpy()}
            if best_vars is not None:
                extra["best_variables"] = best_vars
            save_train_state(autosave_path, state, epoch, rng, extra=extra)

    if best_vars is None:        # track_best=False: the last weights
        best_vars = state.variables
    return state, {"best_variables": best_vars, "best_loss": best_loss,
                   "best_epoch": best_epoch, "history": history,
                   "throughput": timer.summary()}
