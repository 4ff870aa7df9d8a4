"""The training steps, the evaluation function and the train state.

Counterpart of ``scgib_tpu/train/trainer.py``: the pretraining step, its
scanned form and its superbatch form (``make_pretrain_step``,
``make_pretrain_scan_step``, ``make_pretrain_superbatch_step``: K steps on
the K batches of one wire buffer), the
supervised fine-tuning step with gradient accumulation
(``make_finetune_step``), the domain-adaptation step
(``make_domainadapt_step``), inference (``make_eval_fn``), the fine-tuning
freeze masks (``finetune_trainable_mask``) and ``TrainState``.  The JAX
package's ``adam_l2`` is torch-style Adam with L2 added to the gradient
before the moments; here that is ``torch.optim.Adam(weight_decay=wd)``
itself (coupled L2, not AdamW), built by ``adam_l2`` (``capturable`` on
the card).  Its ``masked_tx`` (Adam on the trainable parameters, zero
updates elsewhere) is ``masked_adam``: ``MaskedAdam`` holds the trainable
parameters only, and the frozen ones do not require a gradient.

Each JAX step is one jitted program.  Its counterpart on the card is a CUDA
graph of the whole step (``zero_grad``, forward, backward and
``optimizer.step()``; with gradient accumulation every batch's forward and
backward), captured once for each batch key and replayed for every later batch
of that key.  The key is what changes the captured work: each batch field's
shape and dtype, or its absence (a batch without a band takes the COO path, one
without labels has none to copy), and the batch's ``gt_fits`` and ``pool_fits``
flags, for each batch the step takes.  The first batch of a key trains in the
eager step (``pretrain_step_eager``, ``finetune_step_eager``,
``domainadapt_step_eager``) on a side stream, which is the warm-up capture
needs; the graph is captured right after it (capturing runs no kernel and
trains nothing), and the next batch of that key replays it, its fields copied
into the graph's input buffers first.  So every batch trains exactly once, in
order.  The generator that draws the noise is registered with each graph, so
the replays draw what the eager steps would have drawn and leave it in the same
state.  A capture that fails raises, naming the op that made it fail (an op
that reads the device back to the host is refused as it is dispatched); it
never falls back to the eager step.  The launch and branch counts
(``utils/counters.py``) tick once at capture, which takes them back; each
replay adds what its capture added, so they stay counts per optimizer step.
A step's graphs live as long as the step.  On the CPU the step is the eager
one.  ``donate`` has no counterpart.  While a ``torch.profiler`` session is
open, each call keeps its spans (``utils/profiling.py``):
``scgib.step``, of kind eager, capture or replay, and the parts of a replay
(``scgib.step.key``: the graph's lookup; ``.inputs``: the copies into the
input buffers, counted with their bytes; ``.replay``: ``graph.replay()``;
``.tally``: the counts' update, with the launches and branches of the
replay (``launch.<kernel>``, ``encoder.<branch>``, ``pool.<branch>``,
``recon.<branch>``, and ``gin_bwd.tiles`` and ``gin_bwd.overlapped``, the
fused GIN backward's row tiles and those whose gather ran under the
products of the tile before) and the band width of each of its batches
(``band_widths``, 0 for a batch on the COO path); ``.outputs``: the clones
of the outputs, counted); with no session open a call reads no clock and
keeps nothing.

``remat`` (``make_pretrain_step`` and ``make_pretrain_scan_step``, as in
the JAX package): the forward runs under ``torch.utils.checkpoint``
(non-reentrant), so the backward recomputes the activations it needs
instead of keeping them, inside the captured step too.  The recomputation
must see the first forward's noise and leave the BatchNorm statistics
alone: ``rand`` is ``_ReplayedDraws``, which hands the recomputation the
tensors the first forward drew (the compression noise and the dropout
masks; ``preserve_rng_state`` would restore only the global generators,
and a graph cannot capture a generator's ``get_state``), and the
recomputation runs inside ``layers.statistics_frozen`` (JAX returns
``batch_stats`` once, from the forward).  The step is then bitwise the
plain one.

The evaluation (``make_eval_fn``, the jitted ``make_eval_fn`` of the JAX
package) is captured the same way: one graph of the forward for each batch
key, the evaluation's mode (``live_noise``, and the model's train or eval
mode) and, with ``live_noise``, the BatchNorm updates and their undoing
inside it.  A graph reads the parameters at their addresses, so weights are
loaded into a model in place (``load_state_dict`` copies into its tensors),
never by replacing its tensors.  A call that passes another generator than
the one its graph was captured with (the evaluation seeds a fresh one each
time) lends the graph's generator that generator's state for the replay and
takes back the state the replay leaves, so the replay draws what the eager
form draws.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

from ..graph.container import GraphBatch, SubgraphBatch
from ..graph.wire import (from_wire_graph, from_wire_sub, index_wire,
                          unpack_bytes)
from ..models.layers import statistics_frozen
from ..models.losses import (bce_loss, bce_with_logits_loss,
                             cross_entropy_loss, mae_loss, rmse_loss)
from ..models.scgib import PretrainLosses, PretrainModel, uniform_draws
from ..utils import counters, profiling
from ..utils.params import to_jax_variables


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics), its optimizer
    (Adam's moments) and the count of optimizer steps taken: what the JAX
    package's ``TrainState`` holds.  The loop advances ``step``; the model
    and optimizer are updated in place."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    @property
    def variables(self) -> dict:
        """A snapshot of the model as a flax ``{"params", "batch_stats"}``
        tree of NumPy arrays."""
        return to_jax_variables(self.model)


def adam_l2(model: nn.Module, lr: float, weight_decay: float = 0.0
            ) -> torch.optim.Adam:
    """The JAX package's ``adam_l2``: torch's Adam with coupled L2, over
    ``model``'s parameters; ``capturable`` (its step count kept on the
    device, as a CUDA graph of the step needs) where they lie on the
    card."""
    on_card = next(model.parameters()).is_cuda
    return torch.optim.Adam(model.parameters(), lr=lr,
                            weight_decay=weight_decay, capturable=on_card)


class MaskedAdam(torch.optim.Adam):
    """``adam_l2`` over the trainable parameters only: the JAX package's
    ``masked_tx(adam_l2(...), mask)``, whose frozen leaves get zero
    updates.  Its checkpointed state takes the masked layout
    (``utils/params.py::adam_to_optax``)."""

    masked = True


def masked_adam(model: nn.Module, trainable: Sequence[str], lr: float,
                weight_decay: float = 0.0) -> MaskedAdam:
    """Freeze every parameter of ``model`` not named in ``trainable``
    (``requires_grad=False``) and return Adam with coupled L2 over the
    others (``capturable`` on the card)."""
    keep = set(trainable)
    params = []
    for name, p in model.named_parameters():
        p.requires_grad_(name in keep)
        if name in keep:
            params.append(p)
    return MaskedAdam(params, lr=lr, weight_decay=weight_decay,
                      capturable=params[0].is_cuda)


def finetune_trainable_mask(model: nn.Module, mode: str = "reference"
                            ) -> List[str]:
    """The names of the parameters that train, in ``named_parameters``
    order: the JAX package's mask, which replicates the reference's
    freeze-then-unfreeze loop (models.py:424-434).  Fresh heads (everything
    outside ``core``) always train.  ``reference``: only conv2 and bn2 of
    each pretrained encoder (the loop's last comparison re-freezes the
    rest; a graph transformer's ``layer{i}`` names match nothing, so its
    encoders stay frozen); ``paper``: convs and bns 2 and 3; ``all``: the
    whole core; ``frozen``: none of it.  Frozen BatchNorms still move their
    running statistics in train mode, as the JAX ``batch_stats`` do."""
    if mode not in ("reference", "paper", "all", "frozen"):
        raise ValueError(f"unknown freeze mode {mode!r}")
    wanted = ("conv2", "bn2") if mode == "reference" else (
        "conv2", "bn2", "conv3", "bn3")

    def decide(keys) -> bool:
        if "core" not in keys or mode == "all":
            return True
        if mode == "frozen":
            return False
        if not any(k in ("encoder1", "encoder2") for k in keys):
            return False
        return any(k in wanted for k in keys)

    return [name for name, _ in model.named_parameters()
            if decide(name.split("."))]


class _ReplayedDraws:
    """``rand`` of a checkpointed forward: the first forward draws from
    ``rand`` and keeps each draw; inside ``replaying`` (the recomputation)
    the same tensors come back in the same order."""

    def __init__(self, rand):
        self.rand = rand
        self.draws: List[torch.Tensor] = []
        self.at: Optional[int] = None

    def __call__(self, shape):
        if self.at is None:
            self.draws.append(self.rand(shape))
            return self.draws[-1]
        self.at += 1
        return self.draws[self.at - 1]

    @contextlib.contextmanager
    def replaying(self):
        self.at = 0
        try:
            yield
        finally:
            self.at = None


def remat_forward(model: nn.Module, g: GraphBatch, sub: SubgraphBatch,
                  rand) -> PretrainLosses:
    """``model(g, sub, rand=rand)`` under non-reentrant activation
    checkpointing (JAX's ``jax.checkpoint`` of the forward): its
    recomputation replays the first forward's draws and leaves the
    BatchNorm statistics alone (see the module's note)."""
    draws = _ReplayedDraws(rand)

    @contextlib.contextmanager
    def recomputation():
        with draws.replaying(), statistics_frozen(model):
            yield

    return checkpoint(lambda: model(g, sub, rand=draws), use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          recomputation()))


def pretrain_step_eager(model: PretrainModel,
                        optimizer: torch.optim.Optimizer, g: GraphBatch,
                        sub: SubgraphBatch,
                        generator: Optional[torch.Generator] = None,
                        remat: bool = False) -> PretrainLosses:
    """One eager step: total = KL + contrastive + reconstruction, one
    backward, one optimizer update.  The compression noise and the graph
    transformer's dropout masks come from ``generator`` (a
    ``torch.Generator`` on the batch's device), the counterpart of the JAX
    step's ``noise`` and ``dropout`` streams: other bits, the same
    distribution.  ``remat``: the forward under ``remat_forward``."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    rand = uniform_draws(generator, g.node_feat.device)
    losses = (remat_forward(model, g, sub, rand) if remat
              else model(g, sub, rand=rand))
    losses.total.backward()
    optimizer.step()
    return PretrainLosses(*(t.detach() for t in losses))


_FINETUNE_LOSSES = {
    "bce": lambda scores, y, m: bce_loss(scores, y, m),
    "bce_logits": lambda scores, y, m: bce_with_logits_loss(scores, y, m),
    "ce": lambda scores, y, m: cross_entropy_loss(scores, y[:, 0], m[:, 0]),
    "rmse": lambda scores, y, m: rmse_loss(scores, y, m),
    "mae": lambda scores, y, m: mae_loss(scores, y, m),
}


def label_mask(g: GraphBatch) -> torch.Tensor:
    """The labels a supervised loss takes: those present (``label_mask``)
    of the real graphs."""
    keep = g.graph_mask[:, None]
    return (g.label_mask & keep if g.label_mask is not None
            else keep.expand(g.labels.shape))


def finetune_loss(model: nn.Module, g: GraphBatch, sub: SubgraphBatch,
                  loss_type: str, rand) -> torch.Tensor:
    """The supervised loss of one batch: ``loss_type`` over the labels
    ``label_mask`` keeps."""
    scores = model(g, sub, rand=rand)
    return _FINETUNE_LOSSES[loss_type](scores, g.labels, label_mask(g))


def finetune_step_eager(model: nn.Module, optimizer: torch.optim.Optimizer,
                        batches: Sequence[Tuple[GraphBatch, SubgraphBatch]],
                        loss_type: str = "bce",
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    """One eager supervised step over ``batches`` (``grad_accum`` of them):
    each batch's forward and backward in order (the BatchNorm statistics
    move batch after batch, the noise is drawn batch after batch), the
    gradients summed and divided by their number, one optimizer update.
    Returns the mean loss.  Counterpart of the JAX step's ``lax.scan`` over
    a stacked group."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    total = None
    for g, sub in batches:
        loss = finetune_loss(model, g, sub, loss_type,
                             uniform_draws(generator, g.node_feat.device))
        loss.backward()
        total = loss.detach() if total is None else total + loss.detach()
    if len(batches) > 1:
        for group in optimizer.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    p.grad.div_(len(batches))
        total = total / len(batches)
    optimizer.step()
    return total


def domainadapt_step_eager(model: nn.Module,
                           optimizer: torch.optim.Optimizer, g: GraphBatch,
                           sub: SubgraphBatch,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
    """One eager domain-adaptation step: the model's forward is the
    loss."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    loss = model(g, sub, rand=uniform_draws(generator, g.node_feat.device))
    loss.backward()
    optimizer.step()
    return loss.detach()


class HostReadError(RuntimeError):
    """An op of the step reads the device back to the host."""


class CaptureGuard(TorchDispatchMode):
    """Raises ``HostReadError`` on the ops that read a tensor back to the
    host (``.item()``, ``bool()`` of a tensor, ``nonzero``, boolean
    masks, ``unique``), which a CUDA graph cannot capture, and keeps the
    name of the last op dispatched in ``last``."""

    _HOST_READS = ("aten::_local_scalar_dense", "aten::nonzero",
                   "aten::masked_select")

    def __init__(self):
        super().__init__()
        self.last = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        self.last = str(func)
        masked = name in ("aten::index", "aten::index_put",
                          "aten::index_put_") and any(
            isinstance(i, torch.Tensor) and i.dtype in (torch.bool,
                                                        torch.uint8)
            for i in (args[1] if len(args) > 1 else ()) or ())
        if (name in self._HOST_READS or masked
                or name.startswith(("aten::unique", "aten::_unique"))):
            raise HostReadError(f"{func} reads the device back to the host")
        return func(*args, **(kwargs or {}))


# --- the captured steps ------------------------------------------------------

def _fields(batch):
    return [(f.name, getattr(batch, f.name))
            for f in dataclasses.fields(batch)]


def batch_key(*batches) -> tuple:
    """What decides a step's captured work: every field's shape and dtype
    (None where absent) and the flags of each batch it takes."""
    return tuple(
        (name, (tuple(v.shape), v.dtype) if isinstance(v, torch.Tensor)
         else v)
        for batch in batches for name, v in _fields(batch))


def _input_buffers(batch):
    """A batch of the same fields whose tensors are fresh buffers."""
    return dataclasses.replace(batch, **{
        name: torch.empty_like(v) for name, v in _fields(batch)
        if isinstance(v, torch.Tensor)})


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    return type(out)(*(t.clone() for t in out))


_KEY, _INPUTS, _REPLAY, _TALLY, _OUTPUTS = profiling.STEP_PARTS


def _replay_counts(entry) -> Dict[str, dict]:
    """A replay's counts, by the part that makes them: a copy into each
    input buffer (and its bytes), the launches and branches its capture
    added and the band width of each batch (0 on the COO path), and a
    clone of each output."""
    _, buffers, out, added = entry
    inputs = [v for buf in buffers for _, v in _fields(buf)
              if isinstance(v, torch.Tensor)]
    tally = {f"{kind}.{name}": n for (kind, name), n in sorted(
        added.items(), key=repr) if kind != "route"}
    widths = tuple(b.band_width if b.band_col_off is not None else 0
                   for b in buffers
                   if isinstance(b, (GraphBatch, SubgraphBatch)))
    if widths:
        tally["band_widths"] = widths
    return {_INPUTS: {"copies": len(inputs),
                      "bytes": sum(v.nbytes for v in inputs)},
            _TALLY: tally,
            _OUTPUTS: {"clones": (1 if isinstance(out, torch.Tensor)
                                  else len(out))}}


def _pairs(batches):
    return list(zip(batches[::2], batches[1::2]))


@contextlib.contextmanager
def _lent(registered: torch.Generator, generator: torch.Generator):
    """Within: ``registered`` (a graph's generator) holds ``generator``'s
    state; after: ``generator`` holds the state ``registered`` was left
    in."""
    if registered is generator:
        yield
        return
    registered.set_state(generator.get_state())
    yield
    generator.set_state(registered.get_state())


class _CapturedSteps:
    """A step ``run(pairs, generator)`` over a list of (GraphBatch,
    SubgraphBatch) pairs, called as ``step(g, sub, generator=None)`` with
    one pair, or with sequences of batches for a step that takes several
    (gradient accumulation): eager on the CPU; on the card one CUDA graph
    for each batch key of all the batches and each value of ``mode()``
    (see the module's note).  ``run`` returns a tensor or a tuple of
    tensors, which each call returns a copy of.  ``optimizer``, where the
    step has one, has its gradients dropped before a capture; ``what``
    names the step in a capture's failure; ``capture_mode`` is the
    capture's ``capture_error_mode``."""

    capture_mode = "global"

    def __init__(self, run: Callable,
                 optimizer: Optional[torch.optim.Optimizer] = None,
                 mode: Callable[[], tuple] = tuple,
                 what: str = "the training step"):
        self.run = run
        self.optimizer = optimizer
        self.mode = mode
        self.what = what
        self.graphs: Dict[tuple, tuple] = {}
        self.generators: Dict[tuple, torch.Generator] = {}
        self.counts: Dict[tuple, Dict[str, dict]] = {}  # a replay's, by part

    def __call__(self, g, sub, generator: Optional[torch.Generator] = None):
        pairs = (list(zip(g, sub)) if isinstance(g, (list, tuple))
                 else [(g, sub)])
        return self._step(tuple(b for pair in pairs for b in pair),
                          generator)

    def _arg(self, batches):
        """``run``'s argument: the batches' (g, sub) pairs."""
        return _pairs(batches)

    def _step(self, batches: tuple, generator: Optional[torch.Generator]):
        # while a profiler session is open, the call's spans (see
        # utils/profiling.py); else None, and the call reads no clock
        spans = profiling.step_spans()
        dev = next(v for _, v in _fields(batches[0])
                   if isinstance(v, torch.Tensor)).device
        if dev.type != "cuda":
            out = self.run(self._arg(batches), generator)
            if spans is not None:
                spans.end("eager")
            return out
        if generator is None:
            generator = torch.cuda.default_generators[
                dev.index if dev.index is not None
                else torch.cuda.current_device()]
        key = batch_key(*batches) + self.mode()
        entry = self.graphs.get(key)
        if spans is not None:
            spans.part(_KEY)
        if entry is not None:
            with _lent(self.generators[key], generator):
                out = self._replay(entry, batches, spans)
            if spans is not None:
                spans.end("replay", self.counts[key])
            return out
        # the first batch of this key trains eagerly (the capture's
        # warm-up), then the graph is captured on input buffers of its shape
        buffers = tuple(_input_buffers(b) for b in batches)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            out = self.run(self._arg(batches), generator)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graphs[key] = self._capture(buffers, generator)
        self.counts[key] = _replay_counts(self.graphs[key])
        self.generators[key] = generator
        if spans is not None:
            spans.end("capture")
        return out

    def _capture(self, buffers, generator):
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        if self.optimizer is not None:
            self.optimizer.zero_grad(set_to_none=True)
        before = counters.snapshot()
        guard = CaptureGuard()
        try:
            with torch.cuda.graph(graph,
                                  capture_error_mode=self.capture_mode), \
                    guard:
                out = self.run(self._arg(buffers), generator)
        except RuntimeError as e:
            raise RuntimeError(f"capturing {self.what} failed at "
                               f"{guard.last}: {e}") from e
        after = counters.snapshot()
        added = {k: after.get(k, 0) - before.get(k, 0)
                 for k in set(after) | set(before)}
        added = {k: n for k, n in added.items() if n}
        counters.add(added, -1)               # the capture ran nothing
        return graph, buffers, out, added

    def _replay(self, entry, batches,
                spans: Optional[profiling.StepSpans] = None):
        """The graph replayed on ``batches``; ``spans``, where given, end a
        part after each of the four that follow the key's lookup."""
        graph, buffers, out, added = entry
        for buf, batch in zip(buffers, batches):
            for name, v in _fields(batch):
                if isinstance(v, torch.Tensor):
                    getattr(buf, name).copy_(v, non_blocking=True)
        if spans is not None:
            spans.part(_INPUTS)
        graph.replay()
        if spans is not None:
            spans.part(_REPLAY)
        counters.add(added)
        if spans is not None:
            spans.part(_TALLY)
        out = _clone(out)
        if spans is not None:
            spans.part(_OUTPUTS)
        return out


def make_pretrain_step(model: PretrainModel, optimizer: torch.optim.Optimizer,
                       remat: bool = False) -> Callable[..., PretrainLosses]:
    """``step(g, sub, generator=None) -> losses``: one optimizer step
    (``pretrain_step_eager``), a CUDA-graph replay on the card.
    ``remat``: the forward is recomputed in the backward (see the module's
    note)."""
    return _CapturedSteps(lambda pairs, gen: pretrain_step_eager(
        model, optimizer, *pairs[0], gen, remat=remat), optimizer)


def make_pretrain_scan_step(model: PretrainModel,
                            optimizer: torch.optim.Optimizer, n_inner: int,
                            remat: bool = False
                            ) -> Callable[..., PretrainLosses]:
    """``step(g, sub, generator=None) -> losses``: ``n_inner`` optimizer
    steps on the same batch, each with fresh noise from ``generator``, the
    losses stacked to [n_inner].  Counterpart of the JAX package's
    ``lax.scan`` of ``n_inner`` steps: on the card one graph of all
    ``n_inner`` steps, one launch for all of them.  ``remat`` as in
    ``make_pretrain_step``."""
    def run(pairs, gen):
        runs = [pretrain_step_eager(model, optimizer, *pairs[0], gen,
                                    remat=remat)
                for _ in range(n_inner)]
        return PretrainLosses(*(torch.stack(x) for x in zip(*runs)))
    return _CapturedSteps(run, optimizer)


@dataclasses.dataclass
class _Wire:
    """One superbatch on the device: its uint8 buffer
    (``data/loader.py::wire_superbatches``) and the pooling flag of all
    its K batches, which the buffer does not carry (``graph/wire.py``)."""

    buf: torch.Tensor
    pool_fits: bool


class _SuperbatchSteps(_CapturedSteps):
    """``step(buf, pool_fits, generator=None)``: ``run`` takes the
    superbatch's ``_Wire``; on the card one graph for each buffer size and
    flag, so at most two for a run's buffers."""

    def __call__(self, buf: torch.Tensor, pool_fits: bool,
                 generator: Optional[torch.Generator] = None):
        return self._step((_Wire(buf, bool(pool_fits)),), generator)

    def _arg(self, batches):
        return batches[0]


def make_pretrain_superbatch_step(model: PretrainModel,
                                  optimizer: torch.optim.Optimizer,
                                  byte_spec
                                  ) -> Callable[..., PretrainLosses]:
    """``step(buf, pool_fits, generator=None) -> losses``: K optimizer
    steps on the K batches of one wire superbatch, a uint8 device buffer
    laid out by ``byte_spec`` (``data/loader.py::superbatch_spec``).
    ``pool_fits``: whether every one of the K batches fits the banded
    pooling's window (``wire_superbatches`` yields it); where one does
    not, all K pool through the scatter branch, which is exact for any
    batch.  The buffer is unpacked into views, each wire pair decoded on
    the device and trained on in order (``pretrain_step_eager``, the noise
    drawn from the one generator), the losses stacked to [K].
    Counterpart of the JAX package's
    ``make_pretrain_superbatch_step(byte_spec=...)``: on the card one CUDA
    graph of the K steps for each value of the flag, one replay a
    superbatch, whose buffer is copied into the graph's input buffer
    first."""
    return _SuperbatchSteps(superbatch_run(
        byte_spec, lambda g, sub, gen: pretrain_step_eager(
            model, optimizer, g, sub, gen)), optimizer)


def superbatch_run(byte_spec, step: Callable) -> Callable:
    """``run(wire, gen)`` of a superbatch step: the buffer unpacked into
    views, each wire pair decoded on the device with the superbatch's
    pooling flag and trained on in order by ``step(g, sub, gen)``, the
    losses stacked to [K]."""
    def run(wire: _Wire, gen):
        gs, subs = unpack_bytes(wire.buf, byte_spec)
        runs = []
        for k in range(gs.n_nodes.shape[0]):
            g = from_wire_graph(index_wire(gs, k))
            sub = from_wire_sub(dataclasses.replace(
                index_wire(subs, k), pool_fits=wire.pool_fits))
            runs.append(step(g, sub, gen))
        return PretrainLosses(*(torch.stack(x) for x in zip(*runs)))
    return run


def make_finetune_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                       loss_type: str = "bce", grad_accum: int = 1
                       ) -> Callable[..., torch.Tensor]:
    """``step(g, sub, generator=None) -> loss``: one supervised optimizer
    step (``finetune_step_eager``), a CUDA-graph replay on the card.
    ``loss_type`` is one of the per-dataset losses (bce, bce_logits, ce,
    rmse, mae).  With ``grad_accum`` > 1, ``g`` and ``sub`` are sequences
    of that many batches (the JAX step's stacked group), whose gradients
    are averaged into one update; the graph is keyed by all of them."""
    if loss_type not in _FINETUNE_LOSSES:
        raise ValueError(f"unknown loss {loss_type!r}; "
                         f"one of {sorted(_FINETUNE_LOSSES)}")

    def run(pairs, gen):
        if len(pairs) != grad_accum:
            raise ValueError(f"the step accumulates {grad_accum} batches, "
                             f"got {len(pairs)}")
        return finetune_step_eager(model, optimizer, pairs, loss_type, gen)
    return _CapturedSteps(run, optimizer)


def make_domainadapt_step(model: nn.Module,
                          optimizer: torch.optim.Optimizer
                          ) -> Callable[..., torch.Tensor]:
    """``step(g, sub, generator=None) -> loss``: one domain-adaptation
    step (``domainadapt_step_eager``), a CUDA-graph replay on the card."""
    return _CapturedSteps(lambda pairs, gen: domainadapt_step_eager(
        model, optimizer, *pairs[0], gen), optimizer)


def make_eval_fn(model: nn.Module, live_noise: bool = False
                 ) -> Callable[..., torch.Tensor]:
    """``run(g, sub, generator=None) -> scores``, under
    ``torch.inference_mode()``; the model is left in the mode it was in.
    On the card a CUDA-graph replay (see the module's note); on the CPU
    the eager forward.

    ``live_noise=False``: eval mode (running BatchNorm statistics, no
    dropout) with the gate's noise still drawn from ``generator``, so a
    caller that seeds it the same way gets the same scores
    (``train/loops.py::evaluate`` seeds one per evaluation).
    ``live_noise=True``: the reference's evaluation, which never calls
    ``model.eval()`` (train_moleculenetBACE.py:112-176): train-mode
    statistics and dropout with fresh noise, the BatchNorm updates thrown
    away."""
    def forward(pairs, generator):
        (g, sub), = pairs
        was = model.training
        saved = ([b.clone() for b in model.buffers()] if live_noise
                 else None)
        try:
            with torch.inference_mode():
                model.train(live_noise)
                return model(g, sub, rand=uniform_draws(
                    generator, g.node_feat.device))
        finally:
            if saved is not None:
                with torch.no_grad():
                    for b, old in zip(model.buffers(), saved):
                        b.copy_(old)
            model.train(was)
    return _CapturedSteps(forward, mode=lambda: (live_noise, model.training),
                          what="the evaluation")
