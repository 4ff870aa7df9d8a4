"""The pretraining step, its scanned form, and the train state they advance.

Counterpart of ``scgib_tpu/train/trainer.py::make_pretrain_step``,
``make_pretrain_scan_step`` and ``TrainState``.  The JAX package's
``adam_l2`` is torch-style Adam with L2 added to the gradient before the
moments; here that is ``torch.optim.Adam(weight_decay=wd)`` itself (coupled
L2, not AdamW), built by ``adam_l2`` (``capturable`` on the card).

The JAX step is one jitted program.  Its counterpart on the card is a CUDA
graph of the whole step (``zero_grad``, forward, backward and
``optimizer.step()``), captured once for each batch key and replayed for
every later batch of that key.  The key is what changes the captured work:
each batch field's shape and dtype, or its absence (a batch without a band
takes the COO path), and the batch's ``gt_fits`` and ``pool_fits`` flags.
The first batch of a key trains in the eager step (``pretrain_step_eager``)
on a side stream, which is the warm-up capture needs; the graph is captured
right after it (capturing runs no kernel and trains nothing), and the next
batch of that key replays it, its fields copied into the graph's input
buffers first.  So every batch trains exactly once, in order.  The
generator that draws the noise is registered with each graph, so the
replays draw what the eager steps would have drawn and leave it in the same
state.  A capture that fails raises, naming the op that made it fail (an op
that reads the device back to the host is refused as it is dispatched); it
never falls back to the eager step.  The launch and branch counts tick once
at capture; each replay adds what its capture added, so they stay counts
per optimizer step.  A step's graphs live as long as the step.  On the CPU
the step is the eager one.  ``donate`` has no counterpart, and ``remat`` is
not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

from ..graph.container import GraphBatch, SubgraphBatch
from ..models import encoders
from ..models.scgib import PretrainLosses, PretrainModel, uniform_draws
from ..ops import pool
from ..ops.kernels import banded as kb
from ..ops.kernels import gt_flash as kg
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


def pretrain_step_eager(model: PretrainModel,
                        optimizer: torch.optim.Optimizer, g: GraphBatch,
                        sub: SubgraphBatch,
                        generator: Optional[torch.Generator] = None
                        ) -> PretrainLosses:
    """One eager step: total = KL + contrastive + reconstruction, one
    backward, one optimizer update.  The compression noise and the graph
    transformer's dropout masks come from ``generator`` (a
    ``torch.Generator`` on the batch's device), the counterpart of the JAX
    step's ``noise`` and ``dropout`` streams: other bits, the same
    distribution."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    losses = model(g, sub, rand=uniform_draws(generator, g.node_feat.device))
    losses.total.backward()
    optimizer.step()
    return PretrainLosses(*(t.detach() for t in losses))


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


# --- the counts a step ticks -------------------------------------------------

def _tally() -> Dict[Tuple[str, str], int]:
    """Every count the step ticks: the kernels' launches and the branch
    counts of the encoders and the pooling."""
    out = {("launch", k): v for k, v in
           {**kb.launch_counts(), **kg.launch_counts()}.items()}
    out.update({("encoder", k): v for k, v in encoders.branch_counts.items()})
    out.update({("pool", k): v for k, v in pool.branch_counts.items()})
    return out


def _add_tally(diff: Dict[Tuple[str, str], int], sign: int = 1):
    for (kind, name), n in diff.items():
        if kind == "launch":
            fn = getattr(kb, name) if name in kb.KERNELS else getattr(kg, name)
            fn.launches += sign * n
            continue
        counter = (encoders.branch_counts if kind == "encoder"
                   else pool.branch_counts)
        counter[name] += sign * n
        if counter[name] == 0:
            del counter[name]


# --- the captured steps ------------------------------------------------------

def _fields(batch):
    return [(f.name, getattr(batch, f.name))
            for f in dataclasses.fields(batch)]


def batch_key(g: GraphBatch, sub: SubgraphBatch) -> tuple:
    """What decides a batch's captured work: every field's shape and dtype
    (None where absent) and the flags."""
    return tuple(
        (name, (tuple(v.shape), v.dtype) if isinstance(v, torch.Tensor)
         else v)
        for batch in (g, sub) for name, v in _fields(batch))


def _input_buffers(batch):
    """A batch of the same fields whose tensors are fresh buffers."""
    return dataclasses.replace(batch, **{
        name: torch.empty_like(v) for name, v in _fields(batch)
        if isinstance(v, torch.Tensor)})


class _CapturedSteps:
    """``n_inner`` optimizer steps on one batch: eager on the CPU; on the
    card one CUDA graph for each batch key (see the module's note).
    ``stacked``: the losses stacked to [n_inner] (the scan step)."""

    def __init__(self, model, optimizer, n_inner: int, stacked: bool):
        self.model = model
        self.optimizer = optimizer
        self.n_inner = n_inner
        self.stacked = stacked
        self.graphs: Dict[tuple, tuple] = {}

    def _steps(self, g, sub, generator) -> PretrainLosses:
        runs = [pretrain_step_eager(self.model, self.optimizer, g, sub,
                                    generator) for _ in range(self.n_inner)]
        if not self.stacked:
            return runs[0]
        return PretrainLosses(*(torch.stack(x) for x in zip(*runs)))

    def __call__(self, g: GraphBatch, sub: SubgraphBatch,
                 generator: Optional[torch.Generator] = None
                 ) -> PretrainLosses:
        dev = g.node_feat.device
        if dev.type != "cuda":
            return self._steps(g, sub, generator)
        if generator is None:
            generator = torch.cuda.default_generators[
                dev.index if dev.index is not None
                else torch.cuda.current_device()]
        key = batch_key(g, sub)
        entry = self.graphs.get(key)
        if entry is not None:
            return self._replay(entry, g, sub)
        # the first batch of this key trains eagerly (the capture's
        # warm-up), then the graph is captured on input buffers of its shape
        buffers = (_input_buffers(g), _input_buffers(sub))
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            losses = self._steps(g, sub, generator)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graphs[key] = self._capture(buffers, generator)
        return losses

    def _capture(self, buffers, generator):
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        self.optimizer.zero_grad(set_to_none=True)
        before = _tally()
        guard = CaptureGuard()
        try:
            with torch.cuda.graph(graph), guard:
                out = self._steps(*buffers, generator)
        except RuntimeError as e:
            raise RuntimeError("capturing the pretraining step failed at "
                               f"{guard.last}: {e}") from e
        after = _tally()
        added = {k: after.get(k, 0) - before.get(k, 0)
                 for k in set(after) | set(before)}
        added = {k: n for k, n in added.items() if n}
        _add_tally(added, -1)                 # the capture ran nothing
        return graph, buffers, out, added

    def _replay(self, entry, g, sub) -> PretrainLosses:
        graph, buffers, out, added = entry
        for buf, batch in zip(buffers, (g, sub)):
            for name, v in _fields(batch):
                if isinstance(v, torch.Tensor):
                    getattr(buf, name).copy_(v, non_blocking=True)
        graph.replay()
        _add_tally(added)
        return PretrainLosses(*(t.clone() for t in out))


def make_pretrain_step(model: PretrainModel, optimizer: torch.optim.Optimizer
                       ) -> Callable[..., PretrainLosses]:
    """``step(g, sub, generator=None) -> losses``: one optimizer step
    (``pretrain_step_eager``), a CUDA-graph replay on the card."""
    return _CapturedSteps(model, optimizer, 1, stacked=False)


def make_pretrain_scan_step(model: PretrainModel,
                            optimizer: torch.optim.Optimizer, n_inner: int
                            ) -> Callable[..., PretrainLosses]:
    """``step(g, sub, generator=None) -> losses``: ``n_inner`` optimizer
    steps on the same batch, each with fresh noise from ``generator``, the
    losses stacked to [n_inner].  Counterpart of the JAX package's
    ``lax.scan`` of ``n_inner`` steps: on the card one graph of all
    ``n_inner`` steps, one launch for all of them."""
    return _CapturedSteps(model, optimizer, n_inner, stacked=True)

