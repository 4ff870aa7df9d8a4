"""The loops a cell drives, one for each kind of traffic.

``Pretrain`` with ``feed`` "stream" drives ``train/loops.py::
run_pretraining``, the ``pretrain`` verb's loop, one epoch a call over the
corpus with one generator: each batch packed on the host by the native
packer and fed by ``prefetch_to_device``.  With ``feed`` "resident" it packs
one epoch's batches in set-up, keeps them on the card and cycles them
through the captured step with one loss read a step, as the ``pretrain
--steps`` verb does; with ``read_every`` N and ``reads_behind`` B in the
traffic, the loss of every Nth step is read instead, B reads late, so that
the steps since stay queued on the card while the host waits.
``Finetune`` drives ``train/loops.py::run_finetune`` with its captured
step and evaluation, val and test scored after every epoch, for as many
epochs as fit the window (its own wall-clock cap), so that val and test
are packed once, as in a real run.

Every driver hands the program's loop a ``Recorder`` in place of its step
function: the same step, with a host timestamp at each call and, for the
steps the reference checks, the noise generator's state before and the
outputs after, Adam's first moments after the first and the parameters
after the last.  It changes nothing the step does.

Seeds: the molecules come from ``seed``, the weights from ``seed + 1``, the
program's noise generator from ``seed + 2``; epoch ``i`` of the run (set-up's
included) shuffles with ``seed + 3 + i``; a fine-tuning split permutes with
``seed + 4``.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from scgib_tpu_torch.config import DATASETS
from scgib_tpu_torch.data.loader import (Capacities, GraphDataset,
                                         batch_iterator)
from scgib_tpu_torch.graph.batching import GraphData
from scgib_tpu_torch.models.scgib import FinetuneModel, PretrainModel
from scgib_tpu_torch.train.loops import run_finetune, run_pretraining
from scgib_tpu_torch.train.trainer import (TrainState, adam_l2,
                                           finetune_trainable_mask,
                                           make_eval_fn, make_finetune_step,
                                           make_pretrain_step, masked_adam)

from . import molecules as mol
from . import trace, weights
from .counts import Stats
from .reference import model as ref_model


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _quiet(_line: str):
    """The loops' log, which formats its line and prints nothing."""


class Recorder:
    """The program's step, timed at each call; the first ``checked`` calls
    also keep what the reference compares."""

    def __init__(self, step: Callable, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer, device, checked: int):
        self.step, self.model, self.optimizer = step, model, optimizer
        self.device, self.checked = device, checked
        self.calls = 0
        self.annotate = False       # keep each call's wall-clock range
        self.ranges: List[tuple] = []
        self.times: List[float] = []
        self.states: List[torch.Tensor] = []
        self.outputs: list = []
        self.first_moments: Dict[str, torch.Tensor] = {}
        self.params_after: Dict[str, torch.Tensor] = {}

    def __call__(self, g, sub, generator=None):
        self.times.append(time.perf_counter())
        self.calls += 1
        check = self.calls <= self.checked
        if check:
            self.states.append(generator.get_state())
        if self.annotate:
            start = time.time_ns()
            out = self.step(g, sub, generator)
            self.ranges.append((start, time.time_ns()))
        else:
            out = self.step(g, sub, generator)
        if check:
            self.outputs.append(out)
            if self.calls == 1:
                _sync(self.device)
                state = self.optimizer.state
                self.first_moments = {
                    n: state[p]["exp_avg"].detach().clone()
                    for n, p in self.model.named_parameters()
                    if p in state and "exp_avg" in state[p]}
            if self.calls == self.checked:
                _sync(self.device)
                self.params_after = {
                    n: p.detach().clone()
                    for n, p in self.model.named_parameters()}
        return out

    def restart(self):
        """Start a new timed phase: forget the timestamps so far."""
        self.times = []
        self.ranges = []

    def host_ranges(self):
        """The traced stretch's host ranges, wall-clock ns: each call of
        the step, and the loop's time between two calls (its loss read,
        bookkeeping and wait for the next batch)."""
        out = [(trace.STEP, a, b) for a, b in self.ranges]
        return out + [(trace.BETWEEN, b, a) for (_, b), (a, _) in
                      zip(self.ranges, self.ranges[1:])]


class EvalRecorder:
    """The program's evaluation function; keeps the scores of its first
    ``checked`` calls and the model's state at the first."""

    def __init__(self, eval_fn: Callable, model: torch.nn.Module,
                 checked: int):
        self.eval_fn, self.model, self.checked = eval_fn, model, checked
        self.scores: List[torch.Tensor] = []
        self.state: Dict[str, torch.Tensor] = {}

    def __call__(self, g, sub, generator=None):
        if not self.state:
            self.state = {n: t.detach().clone()
                          for n, t in self.model.state_dict().items()}
        out = self.eval_fn(g, sub, generator)
        if len(self.scores) < self.checked:
            self.scores.append(out)
        return out


class Data:
    """A run's molecules, their sizes, the capacities and the program's
    dataset of them (its ego-nets extracted by the native library)."""

    def __init__(self, traffic: dict, seed: int, k: int, head: str):
        t0 = time.perf_counter()
        self.mols = mol.corpus(seed, traffic["molecules"], traffic["atoms"],
                               num_tasks=1 if head == "finetune" else None)
        self.table = mol.sizes(self.mols, k)
        self.caps = mol.capacities(self.table, traffic["batch_size"])
        self.port_caps = Capacities(self.caps.nodes, self.caps.edges,
                                    self.caps.graphs, self.caps.sub_nodes,
                                    self.caps.sub_edges)
        t1 = time.perf_counter()
        self.ds = GraphDataset([GraphData(m.senders, m.receivers, m.feat,
                                          m.label) for m in self.mols], k=k)
        self.seconds = {"molecules": t1 - t0,
                        "dataset": time.perf_counter() - t1}


def _model_kwargs(m: dict) -> dict:
    return dict(hidden=m["hidden"], d_transfer=m["d_transfer"],
                encoder=m["encoder"], num_layers=m["num_layers"],
                num_heads=m["num_heads"], readout=m["readout"],
                use_att=m["use_att"], gt_bwd=m.get("gt_bwd", "twopass"),
                compute_dtype=m.get("compute_dtype"),
                gt_bf16_dots=m.get("gt_bf16_dots", False),
                gt_dtype=(torch.bfloat16 if m.get("gt_dtype") == "bfloat16"
                          else None))


class _Driver:
    """Common set-up: the molecules, their sizes and the capacities, the
    program's dataset, and the seeds."""

    head = "pretrain"

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 data: Optional["Data"] = None):
        self.cfg = config["model"]
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.k = self.cfg["k"]
        self.bs = traffic["batch_size"]
        data = data or Data(traffic, seed, self.k, self.head)
        self.mols, self.table, self.caps = data.mols, data.table, data.caps
        self.port_caps, self.ds = data.port_caps, data.ds
        self.seconds = dict(data.seconds)
        t0 = time.perf_counter()
        self.weights = weights.make(
            ref_model.parameter_shapes(self.cfg, self.head), seed + 1,
            self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed + 2)
        self.seconds["weights"] = time.perf_counter() - t0
        self.epochs_run = 0
        self.checked_plans: List[np.ndarray] = []

    def next_shuffle(self) -> int:
        s = self.seed + 3 + self.epochs_run
        self.epochs_run += 1
        return s

    def stats(self, sel) -> Stats:
        t = self.table[sel].sum(0)
        return Stats(int(t[0]), int(t[1]), int(t[2]), int(t[3]), len(sel))


class Pretrain(_Driver):
    def __init__(self, config, traffic, seed, device, data=None):
        super().__init__(config, traffic, seed, device, data)
        opt_cfg = config["pretrain"]
        t0 = time.perf_counter()
        self.model = PretrainModel(
            self.cfg["in_dim"], recons_type=self.cfg["recons_type"],
            recons_impl=self.cfg["recons_impl"],
            kl_mode=self.cfg["kl_mode"], k_transition=self.k,
            **_model_kwargs(self.cfg)).to(self.device)
        weights.load_into(self.model, self.weights)
        self.seconds["model"] = time.perf_counter() - t0
        self.optimizer = adam_l2(self.model, opt_cfg["lr"],
                                 opt_cfg["weight_decay"])
        self.state = TrainState(self.model, self.optimizer)
        self.recorder = Recorder(make_pretrain_step(self.model,
                                                    self.optimizer),
                                 self.model, self.optimizer, self.device,
                                 traffic["checked_steps"])
        self.resident = traffic["feed"] == "resident"
        self.read_every = traffic.get("read_every", 1)
        self.reads_behind = traffic.get("reads_behind", 0)
        self.pending: collections.deque = collections.deque()
        self.batches = []
        self.steps_done = 0
        self.traced_stats: List[Stats] = []
        self.untraced: dict = {}
        self.seconds["step"] = time.perf_counter() - t0 - self.seconds["model"]
        if self.resident:
            t0 = time.perf_counter()
            shuffle = self.next_shuffle()
            self.resident_plan = mol.plan(self.table, self.bs, self.caps,
                                          True, shuffle)
            self.batches = [(g.to(self.device), sub.to(self.device))
                            for g, sub in batch_iterator(
                                self.ds, self.bs, self.port_caps,
                                shuffle=True, seed=shuffle, use_flat=True)]
            self.seconds["resident batches"] = time.perf_counter() - t0

    # one unit of work: an epoch of the loop, or one resident step
    def _epoch(self) -> List[np.ndarray]:
        shuffle = self.next_shuffle()
        run_pretraining(self.recorder, self.state, self.ds, self.port_caps,
                        self.bs, epochs=1, seed=shuffle,
                        generator=self.generator, log=_quiet)
        return mol.plan(self.table, self.bs, self.caps, True, shuffle)

    def _resident_step(self):
        i = self.steps_done % len(self.batches)
        g, sub = self.batches[i]
        losses = self.recorder(g, sub, self.generator)
        self.steps_done += 1
        if self.steps_done % self.read_every == 0:
            self.pending.append(losses.total)
            while len(self.pending) > self.reads_behind:
                float(self.pending.popleft())
        return self.resident_plan[i]

    def _drain(self):
        """Wait for every step sent, and read the losses still unread."""
        _sync(self.device)
        while self.pending:
            float(self.pending.popleft())

    def warm_up(self):
        if self.resident:
            for _ in range(self.traffic["warmup_cycles"] * len(self.batches)):
                sel = self._resident_step()
                if len(self.checked_plans) < self.traffic["checked_steps"]:
                    self.checked_plans.append(sel)
            self._drain()
            return
        for e in range(self.traffic["warmup_epochs"]):
            plans = self._epoch()
            if e == 0:
                self.checked_plans = plans[:self.traffic["checked_steps"]]

    def window(self, seconds: float) -> dict:
        """Train for ``seconds``: whole epochs of the loop, or resident
        steps, until the time is past; then send nothing more, and end on
        the wait for all that was sent."""
        rec = self.recorder
        rec.restart()
        graphs = 0
        while True:
            if self.resident:
                graphs += len(self._resident_step())
            else:
                graphs += sum(len(p) for p in self._epoch())
            if time.perf_counter() - rec.times[0] >= seconds:
                break
        if self.resident:
            self._drain()
        end = time.perf_counter()
        return {"starts": list(rec.times), "end": end, "graphs": graphs}

    def _stretch(self) -> List[Stats]:
        """The traced stretch's work: ``trace_steps`` resident steps or
        ``trace_epochs`` epochs; the stats of each step's batch."""
        if self.resident:
            out = [self.stats(self._resident_step())
                   for _ in range(self.traffic["trace_steps"])]
            self._drain()
            return out
        return [self.stats(p) for _ in range(self.traffic["trace_epochs"])
                for p in self._epoch()]

    def traced(self) -> trace.Trace:
        """The stretch once untraced, timed by the host clock (the
        profiler's own cost slows the host), then once traced."""
        t0 = time.perf_counter()
        stats = self._stretch()
        _sync(self.device)
        self.untraced = {"seconds": time.perf_counter() - t0,
                         "units": len(stats), "stats": stats}
        self.recorder.restart()
        self.recorder.annotate = True

        def work():
            self.traced_stats = self._stretch()
        return trace.record(work, self.device, self.recorder.host_ranges)

    def host_pack_ms(self) -> Optional[List[float]]:
        """Host ms of each batch of an epoch packed alone, as the loop's
        packing thread packs them (``batch_iterator(use_flat=True)``)."""
        if self.resident:
            return None
        out = []
        while len(out) < self.traffic["pack_samples"]:
            it = batch_iterator(self.ds, self.bs, self.port_caps,
                                shuffle=True, seed=self.next_shuffle(),
                                use_flat=True)
            while len(out) < self.traffic["pack_samples"]:
                t0 = time.perf_counter()
                if next(it, None) is None:
                    break
                out.append((time.perf_counter() - t0) * 1e3)
        return out

    def release(self):
        self.model = self.optimizer = self.state = None
        self.batches = []
        self.recorder.step = None


class Finetune(_Driver):
    head = "finetune"

    def __init__(self, config, traffic, seed, device, data=None):
        super().__init__(config, traffic, seed, device, data)
        opt_cfg = config["finetune"]
        self.spec = DATASETS[traffic["dataset_spec"]]
        n_train, n_val, n_test = traffic["split"]
        order = np.random.default_rng(seed + 4).permutation(len(self.mols))
        self.split_idx = (order[:n_train], order[n_train:n_train + n_val],
                          order[n_train + n_val:n_train + n_val + n_test])
        self.train_ds, self.val_ds, self.test_ds = (
            self.ds.subset(ix) for ix in self.split_idx)
        t0 = time.perf_counter()
        self.model = FinetuneModel(self.cfg["in_dim"], num_out=1,
                                   **_model_kwargs(self.cfg)).to(self.device)
        weights.load_into(self.model, self.weights)
        self.seconds["model"] = time.perf_counter() - t0
        self.optimizer = masked_adam(
            self.model, finetune_trainable_mask(self.model,
                                                opt_cfg["freeze"]),
            opt_cfg["lr"], opt_cfg["weight_decay"])
        self.state = TrainState(self.model, self.optimizer)
        self.recorder = Recorder(
            make_finetune_step(self.model, self.optimizer,
                               loss_type=opt_cfg["loss"]),
            self.model, self.optimizer, self.device,
            traffic["checked_steps"])
        self.eval_plans = [self._split_plan(i, False) for i in (1, 2)]
        self.evaluator = EvalRecorder(
            make_eval_fn(self.model), self.model,
            sum(len(p) for p in self.eval_plans))
        self.epoch_ends: List[float] = []
        self.untraced: dict = {}

    def _split_plan(self, which: int, shuffle: bool, seed: int = 0):
        """Plans of a split (0 train, 1 val, 2 test) as indices into the
        whole corpus."""
        ix = self.split_idx[which]
        return [ix[sel] for sel in mol.plan(self.table[ix], self.bs,
                                            self.caps, shuffle, seed)]

    def _run(self, epochs: int, seconds: Optional[float] = None):
        shuffle = self.seed + 3 + self.epochs_run
        hours = 48.0 if seconds is None else seconds / 3600.0

        def log(line):
            if line.startswith("finetune epoch"):
                self.epoch_ends.append(time.perf_counter())
                self.epochs_run += 1
        run_finetune(self.recorder, self.evaluator, self.state,
                     self.train_ds, self.val_ds, self.test_ds,
                     self.port_caps, self.bs, self.spec, epochs=epochs,
                     patience=1 << 30, wallclock_hours=hours, seed=shuffle,
                     generator=self.generator, log=log)
        return shuffle

    def warm_up(self):
        shuffle = self._run(self.traffic["warmup_epochs"])
        self.checked_plans = self._split_plan(0, True, shuffle)[
            :self.traffic["checked_steps"]]

    def window(self, seconds: float) -> dict:
        self.recorder.restart()
        self.epoch_ends = []
        self._run(1 << 30, seconds)
        return {"starts": list(self.recorder.times),
                "epoch_ends": list(self.epoch_ends)}

    def traced(self) -> trace.Trace:
        """Whole epochs, from the first step (past the loop's packing of
        val and test, which a run does once) to the last epoch's end: once
        untraced, timed by the host clock, then once traced."""
        self.recorder.restart()
        self.epoch_ends = []
        self._run(self.traffic["trace_epochs"])
        self.untraced = {"seconds": self.epoch_ends[-1]
                         - self.recorder.times[0],
                         "units": len(self.epoch_ends)}
        self.recorder.restart()
        self.recorder.annotate = True
        return trace.record(lambda: self._run(self.traffic["trace_epochs"]),
                            self.device, self.recorder.host_ranges
                            ).from_first(trace.STEP)

    def release(self):
        self.model = self.optimizer = self.state = None
        self.recorder.step = None
        self.evaluator.eval_fn = None


def make(config: dict, traffic: dict, seed: int, device, data=None):
    kinds = {"pretrain": Pretrain, "finetune": Finetune}
    return kinds[traffic["loop"]](config, traffic, seed, device, data)
