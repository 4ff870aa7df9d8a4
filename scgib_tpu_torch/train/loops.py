"""The epoch loops: pretraining, supervised fine-tuning with
test-at-best-val selection, and domain adaptation, each with its patience,
NaN guard, autosave and resume; and evaluation.

Counterpart of ``scgib_tpu/train/loops.py``.  ``run_pretraining`` is the
reference's patience-50 loop on the best train loss (exp_pretraining.py:
59-78); ``run_finetune`` its fine-tuning script (exp_moleculenetBACE_BBBP.py:
151-195: the test metric at the best validation epoch, patience on the
train loss, a wall-clock cap, gradient accumulation in groups with the
ragged tail dropped); ``run_domain_adaptation`` its adaptation loop
(exp_moleculenetBACE_BBBP.py:66-84, patience 20); ``evaluate`` and
``PackedEval`` its epoch-accumulated evaluator (train_moleculenetBACE.py:
174-176), the metric taken on the host (``PackedEval`` packs its split
once and keeps it on the device).  Each epoch shuffles the dataset with
``seed + epoch`` through ``batch_iterator``, whose batches are the JAX
package's bit for bit, and logs the JAX package's line with the edges a
second.  The training batches of all three loops come from the native
flat packer, as the JAX package's loops pack them, and reach the device
through ``prefetch_to_device``: packed in a background thread, copied
from pinned buffers on a side stream.  With ``superbatch_k`` the
pretraining epoch is the JAX package's wire superbatch loop: K batches a
buffer (``wire_superbatches``, the native packer on a thread pool), the
buffer copied ahead of use, K steps a call of the superbatch step, one
host read of the losses a superbatch.  ``track_best`` keeps
a real snapshot of the best epoch's weights (the reference aliases the live
module, so it keeps the last; ``track_best=False``).  The compression noise
and the graph transformer's dropout come from one ``torch.Generator``, whose
state the autosave keeps, so that a resumed run on the CPU reaches the same
bits as one never stopped.
"""

from __future__ import annotations

import math
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import DatasetSpec
from ..data.loader import (Capacities, GraphDataset, batch_iterator,
                           prefetch_to_device, wire_superbatches)
from ..utils import metrics as M
from ..utils.device import resolve_device
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


def _counted(batches):
    """Each host pair with its real edges (graphs' and ego-nets') and
    graphs, counted before the pair leaves the host."""
    for g, sub in batches:
        yield (g, sub, int(g.edge_mask.sum() + sub.edge_mask.sum()),
               int(g.graph_mask.sum()))


def run_pretraining(step_fn: Callable, state: TrainState, ds: GraphDataset,
                    caps: Capacities, batch_size: int, epochs: int,
                    patience: int = 50, seed: int = 42,
                    generator: Optional[torch.Generator] = None,
                    track_best: bool = True,
                    log: Optional[Callable[[str], None]] = print,
                    autosave_path: Optional[str] = None,
                    autosave_every: int = 1,
                    logm_k: Optional[int] = None,
                    superbatch_k: int = 0,
                    superbatch_spec=None
                    ) -> Tuple[TrainState, Dict]:
    """One pretraining stage.  ``step_fn(g, sub, generator) -> losses``
    (``make_pretrain_step`` of ``state``'s model and optimizer); with
    ``superbatch_k`` = K, ``step_fn(buf, pool_fits, generator) -> losses``
    of K steps (``make_pretrain_superbatch_step`` with ``superbatch_spec``),
    each epoch's ragged tail group of fewer than K batches dropped.  Returns
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
        if superbatch_k:
            for buf, n_edges, pool_fits in prefetch_to_device(
                    wire_superbatches(ds, batch_size, caps, superbatch_k,
                                      shuffle=True, seed=seed + epoch,
                                      logm_k=logm_k,
                                      byte_spec=superbatch_spec),
                    size=3, device=device, host_stage=2):
                with timer.step(edges=n_edges,
                                graphs=batch_size * superbatch_k):
                    losses = step_fn(buf, pool_fits, generator)
                    # one host read a superbatch
                    total += float(np.sum(losses.total.cpu().numpy()))
                state.step += superbatch_k
                nb += superbatch_k
        else:
            for g, sub, n_edges, n_graphs in prefetch_to_device(
                    _counted(batch_iterator(ds, batch_size, caps,
                                            shuffle=True, seed=seed + epoch,
                                            logm_k=logm_k, use_flat=True)),
                    device=device):
                with timer.step(edges=n_edges, graphs=n_graphs):
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


# --- evaluation --------------------------------------------------------------

def _metric_fn(spec: DatasetSpec) -> Callable:
    if spec.metric == "rocauc":
        return lambda y, p: M.eval_rocauc(y, p)["rocauc"]
    if spec.metric == "ap":
        return lambda y, p: M.eval_ap(y, p)
    if spec.metric == "rmse":
        return lambda y, p: M.rmse(p, y)
    if spec.metric == "mae":
        return lambda y, p: M.mae(p, y)
    if spec.metric == "acc":
        def acc(y, p):
            return M.accuracy_tu(p, y) / max(len(np.atleast_1d(y)), 1)
        return acc
    raise ValueError(f"unknown metric {spec.metric}")


def _metric(spec: DatasetSpec, y: np.ndarray, p: np.ndarray) -> float:
    if spec.metric == "acc":
        return _metric_fn(spec)(y[:, 0], p)
    return _metric_fn(spec)(y, p)


def _targets(g) -> np.ndarray:
    """The real graphs' labels, NaN where missing."""
    gm = np.asarray(g.graph_mask)
    return np.where(np.asarray(g.label_mask)[gm], np.asarray(g.labels)[gm],
                    np.nan)


def _device(model) -> torch.device:
    return next(model.parameters()).device


class PackedEval:
    """A split packed once (in order) and kept on the model's device, for
    an evaluation every epoch; the labels the metric needs are kept on the
    host."""

    def __init__(self, ds: GraphDataset, caps: Capacities, batch_size: int,
                 spec: DatasetSpec, device="cuda"):
        device = resolve_device(device)
        self.spec = spec
        self.batches = []
        labels = []
        for g, sub in batch_iterator(ds, batch_size, caps, shuffle=False):
            labels.append(_targets(g))
            self.batches.append(((g.to(device), sub.to(device)),
                                 np.asarray(g.graph_mask)))
        self.y = np.concatenate(labels)

    def evaluate(self, eval_fn: Callable, seed: int = 0) -> float:
        """The metric of ``eval_fn``'s scores (``make_eval_fn`` of the
        model), the gate's noise drawn from a generator seeded ``seed``:
        the same model gives the same value every time."""
        gen = None
        scores = []
        for (g, sub), gm in self.batches:
            if gen is None:
                gen = torch.Generator(device=g.node_feat.device).manual_seed(
                    seed)
            scores.append(eval_fn(g, sub, gen).cpu().numpy()[gm])
        return _metric(self.spec, self.y, np.concatenate(scores))


def evaluate(eval_fn: Callable, ds: GraphDataset, caps: Capacities,
             batch_size: int, spec: DatasetSpec, device="cuda",
             seed: int = 0) -> float:
    """One evaluation of ``eval_fn`` over ``ds``: ``PackedEval``'s, packed
    for this call."""
    return PackedEval(ds, caps, batch_size, spec, device).evaluate(eval_fn,
                                                                  seed)


# --- fine-tuning and domain adaptation ---------------------------------------

def run_finetune(step_fn: Callable, eval_fn: Callable, state: TrainState,
                 train_ds: GraphDataset, val_ds: GraphDataset,
                 test_ds: GraphDataset, caps: Capacities, batch_size: int,
                 spec: DatasetSpec, epochs: int = 50, patience: int = 50,
                 wallclock_hours: float = 48.0, seed: int = 41,
                 generator: Optional[torch.Generator] = None,
                 log: Optional[Callable[[str], None]] = print,
                 autosave_path: Optional[str] = None,
                 autosave_every: int = 1) -> Dict:
    """Supervised fine-tuning with test-at-best-val selection.
    ``step_fn(g, sub, generator) -> loss`` (``make_finetune_step`` of
    ``state``'s model and optimizer, with ``spec.grad_accum``: groups of
    that many batches, the ragged tail group dropped); ``eval_fn``
    (``make_eval_fn``) scores val and test after every epoch (packed once,
    ``PackedEval``).  The run stops after ``patience`` epochs without a
    lower train loss, or past ``wallclock_hours``; it halts at the first
    non-finite epoch loss (``NonFiniteLossError``).  ``autosave_path``: the
    state and the selection bookkeeping are written every
    ``autosave_every`` epochs (and at a stop), and a run that finds an
    autosave resumes from the epoch after it.

    Returns ``best_val``, ``test_at_best_val``, ``best_epoch``, ``history``
    (loss, val, test per epoch), ``state`` and ``throughput``."""
    device = _device(state.model)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    rng = jax_key(seed)
    sign = 1.0 if spec.select == "max" else -1.0
    best_val = -float("inf")
    best_test = float("nan")
    best_epoch = -1
    best_loss = float("inf")
    bad_epochs = 0
    start_epoch = 0
    t_start = time.time()
    history: List[tuple] = []
    timer = StepTimer()
    accum = max(int(getattr(spec, "grad_accum", 1)), 1)

    val_eval = PackedEval(val_ds, caps, batch_size, spec, device)
    test_eval = PackedEval(test_ds, caps, batch_size, spec, device)

    if autosave_path and os.path.exists(autosave_path):
        saved_epoch, rng, extra = load_train_state(autosave_path, state)
        _restore_generator(generator, rng, extra)
        start_epoch = saved_epoch + 1
        best_val = float(extra.get("best_val", best_val))
        best_test = float(extra.get("best_test", best_test))
        best_epoch = int(extra.get("best_epoch", best_epoch))
        best_loss = float(extra.get("best_loss", best_loss))
        bad_epochs = int(extra.get("bad_epochs", bad_epochs))
        history = [tuple(row) for row in np.asarray(
            extra.get("history", np.zeros((0, 3)))).tolist()]
        if log:
            log(f"resumed autosave at epoch {saved_epoch} "
                f"(best val {best_val:.5f})")

    for epoch in range(start_epoch, epochs):
        total, nb = 0.0, 0
        pending, n_edges = [], 0
        for g, sub, edges, _ in prefetch_to_device(
                _counted(batch_iterator(train_ds, batch_size, caps,
                                        shuffle=True, seed=seed + epoch,
                                        use_flat=True)), device=device):
            n_edges += edges
            pending.append((g, sub))
            if len(pending) < accum:
                continue
            with timer.step(edges=n_edges):
                if accum > 1:
                    gs, subs = zip(*pending)
                    loss = step_fn(list(gs), list(subs), generator)
                else:
                    loss = step_fn(*pending[0], generator)
                total += float(loss)             # waits for the device
            pending, n_edges = [], 0
            state.step += 1
            nb += 1
        epoch_loss = total / max(nb, 1)
        _guard_finite(epoch_loss, epoch, "finetune",
                      {"best_val": best_val, "best_test": best_test,
                       "best_epoch": best_epoch, "history": history,
                       "nonfinite_epoch": epoch}, log)
        val = val_eval.evaluate(eval_fn)
        test = test_eval.evaluate(eval_fn)
        history.append((epoch_loss, val, test))
        if log:
            log(f"finetune epoch {epoch}: loss {epoch_loss:.5f} "
                f"val {val:.5f} test {test:.5f}")
        if sign * val > sign * best_val or best_epoch < 0:
            best_val, best_test, best_epoch = val, test, epoch
        stop = False
        if epoch_loss < best_loss:
            best_loss = epoch_loss
            bad_epochs = 0
        else:
            bad_epochs += 1
            if bad_epochs >= patience:
                stop = True
        if (time.time() - t_start) > wallclock_hours * 3600:
            stop = True
        if autosave_path and (stop or
                              (epoch + 1) % max(autosave_every, 1) == 0):
            save_train_state(autosave_path, state, epoch, rng, extra={
                "best_val": best_val, "best_test": best_test,
                "best_epoch": best_epoch, "best_loss": best_loss,
                "bad_epochs": bad_epochs,
                "history": np.asarray(history, np.float64),
                "torch_rng": generator.get_state().numpy()})
        if stop:
            break

    return {"best_val": best_val, "test_at_best_val": best_test,
            "best_epoch": best_epoch, "history": history, "state": state,
            "throughput": timer.summary()}


def run_domain_adaptation(step_fn: Callable, state: TrainState,
                          ds: GraphDataset, caps: Capacities,
                          batch_size: int, epochs: int = 50,
                          patience: int = 20, seed: int = 40,
                          generator: Optional[torch.Generator] = None,
                          log: Optional[Callable[[str], None]] = print,
                          autosave_path: Optional[str] = None,
                          autosave_every: int = 1
                          ) -> Tuple[TrainState, Dict]:
    """Unsupervised adaptation epochs on the downstream dataset's graphs
    (train_moleculenetBACE.py:17-52).  ``step_fn(g, sub, generator) ->
    loss`` (``make_domainadapt_step``).  Returns (state, info):
    ``best_variables`` (the best epoch's weights; after a resume, as in the
    JAX package, the final weights unless a later epoch improves on the
    restored best loss), ``best_loss``, ``history`` and ``throughput``."""
    device = _device(state.model)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    rng = jax_key(seed)
    best = float("inf")
    best_vars = None
    bad = 0
    start_epoch = 0
    history: List[float] = []
    timer = StepTimer()

    if autosave_path and os.path.exists(autosave_path):
        saved_epoch, rng, extra = load_train_state(autosave_path, state)
        _restore_generator(generator, rng, extra)
        start_epoch = saved_epoch + 1
        best = float(extra.get("best_loss", best))
        bad = int(extra.get("bad_epochs", bad))
        if log:
            log(f"resumed autosave at epoch {saved_epoch}")

    for epoch in range(start_epoch, epochs):
        total, nb = 0.0, 0
        for g, sub, n_edges, _ in prefetch_to_device(
                _counted(batch_iterator(ds, batch_size, caps, shuffle=True,
                                        seed=seed + epoch, use_flat=True)),
                device=device):
            with timer.step(edges=n_edges):
                total += float(step_fn(g, sub, generator))
            state.step += 1
            nb += 1
        epoch_loss = total / max(nb, 1)
        history.append(epoch_loss)
        if log:
            log(f"adapt epoch {epoch}: loss {epoch_loss:.5f}")
        _guard_finite(epoch_loss, epoch, "adapt",
                      {"best_variables": best_vars, "best_loss": best,
                       "nonfinite_epoch": epoch}, log)
        if epoch_loss < best:
            best = epoch_loss
            best_vars = state.variables
            bad = 0
        else:
            bad += 1
            if bad >= patience:
                break
        if autosave_path and (epoch + 1) % max(autosave_every, 1) == 0:
            save_train_state(autosave_path, state, epoch, rng, extra={
                "best_loss": best, "bad_epochs": bad,
                "torch_rng": generator.get_state().numpy()})
    if best_vars is None:
        best_vars = state.variables
    return state, {"best_variables": best_vars, "best_loss": best,
                   "history": history, "throughput": timer.summary()}
