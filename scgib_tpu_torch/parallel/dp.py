"""Data-parallel training over ``torch.distributed``.

Counterpart of ``scgib_tpu/parallel/dp.py``.  JAX runs one ``shard_map``
program over a ``('data',)`` mesh; here every rank is a process that runs
the same step on its own batch, and the mesh is a process group.

- Layout: the model and Adam's state are replicated, one copy a rank;
  each rank holds its own packed batch (JAX's per-device slice of a
  stacked batch: ``stack_batches`` + ``shard_batch`` give rank r slice r).
- The model is built with ``group=`` (the JAX models' ``axis_name``): the
  GIN BatchNorms synchronize (one all-reduce of (sum, sum of squares,
  count)), the contrastive denominator spans every rank's graphs (the
  columns gathered) and the losses are each rank's local numerator over
  the group's count (``models/losses.py``), so that summing the ranks'
  losses and gradients gives the union batch's.
- A step (``shard_step``): the forward and backward of the grouped model;
  the gradients **summed** over the ranks, flattened into one buffer and
  one all-reduce (not ``DistributedDataParallel``, which averages); the
  losses summed; the BatchNorm running statistics **averaged** (JAX's
  ``pmean``, which is what keeps ``SegmentBatchNorm``'s statistics
  replicated); one Adam update.  The collectives' gradients are
  ``parallel/collectives.py``'s.

Over NCCL a step is ``train/trainer.py``'s captured step: one CUDA graph
with its NCCL collectives inside, captured from the first batch of a key
after that batch trained eagerly.  Capture and replay must happen on every
rank at once (a collective being captured does not communicate), so each
call first agrees its batches' key over a host (gloo) group: the flags are
made the same on every rank (``pool_fits`` and ``gt_fits`` become True only
where they are True on every rank, and the branch they then take, the
scatter pooling or the wide attention geometry, is exact for any batch),
and a batch whose shapes differ from another rank's raises.  Over gloo,
which a graph cannot capture, the step is eager, on the CPU or the card.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, List, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..models.losses import _safe_log
from ..models.scgib import PretrainLosses, uniform_draws
from ..train import trainer
from .collectives import all_reduce_sum

DATA_AXIS = "data"


def make_mesh(group=None):
    """The process group the data-parallel steps reduce over (JAX's 1-D
    ``('data',)`` mesh): ``group``, or every process.  Over NCCL one
    warm-up all-reduce creates the communicator, which a CUDA-graph
    capture cannot."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "parallel.multihost.initialize_distributed first")
    group = group if group is not None else dist.group.WORLD
    if dist.get_backend(group) == "nccl":
        dist.all_reduce(torch.zeros(1, device="cuda"), group=group)
        torch.cuda.synchronize()
    return group


def _stack(values):
    first = values[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(values)
    if isinstance(first, np.ndarray):
        return np.stack(values)
    if first is None or isinstance(first, bool):
        if any(v is None for v in values):
            if any(v is not None for v in values):
                raise ValueError("stack_batches: a flag is None on some "
                                 "batches only")
            return None
        return all(values)
    if isinstance(first, int):          # a width: the same on every batch
        if any(v != first for v in values):
            raise ValueError("stack_batches: the batches' band widths "
                             "differ")
        return first
    raise TypeError(f"stack_batches: cannot stack {type(first).__name__}")


def stack_batches(batches: Sequence):
    """Stack per-rank batches (containers of tensors or NumPy arrays, or
    bare arrays such as wire buffers) on a new leading axis; a flag is
    True where it is True on every batch (see the module's note)."""
    first = batches[0]
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: _stack([getattr(b, f.name) for b in batches])
            for f in dataclasses.fields(first)})
    return _stack(list(batches))


def stack_batches_host(batches: Sequence, device="cuda"):
    """``stack_batches`` of host (NumPy) batches on the host, then one copy
    a field to ``device`` (one copy a field in place of one a field and
    batch)."""
    stacked = stack_batches(batches)
    if dataclasses.is_dataclass(stacked):
        return stacked.to(device)
    return torch.from_numpy(np.ascontiguousarray(stacked)).to(device)


def shard_batch(group, stacked):
    """This rank's slice of a stacked batch (JAX's ``device_put`` onto
    ``P('data')``): rank r takes slice r."""
    r = dist.get_rank(group)
    if dataclasses.is_dataclass(stacked):
        return dataclasses.replace(stacked, **{
            f.name: (v[r] if isinstance(v, (torch.Tensor, np.ndarray))
                     else v)
            for f in dataclasses.fields(stacked)
            for v in [getattr(stacked, f.name)]})
    return stacked[r]


# --- one rank's step ------------------------------------------------------------

def _sum_gradients(optimizer: torch.optim.Optimizer, group):
    """psum of the gradients: one flat buffer, one all-reduce."""
    grads = [p.grad for pg in optimizer.param_groups for p in pg["params"]
             if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    at = 0
    for g in grads:
        g.copy_(flat[at:at + g.numel()].view_as(g))
        at += g.numel()


@torch.no_grad()
def _average_buffers(model: nn.Module, group):
    """pmean of the BatchNorm running statistics."""
    bufs = [b for b in model.buffers() if b.is_floating_point()]
    flat = torch.cat([b.reshape(-1) for b in bufs])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    at = 0
    for b in bufs:
        b.copy_(flat[at:at + b.numel()].view_as(b))
        at += b.numel()


def _summed(t: torch.Tensor, group) -> torch.Tensor:
    t = t.detach().clone()
    dist.all_reduce(t, group=group)
    return t


def _update(model, optimizer, group):
    _sum_gradients(optimizer, group)
    _average_buffers(model, group)
    optimizer.step()


def dp_pretrain_step_eager(model: nn.Module,
                           optimizer: torch.optim.Optimizer, group,
                           *batch, generator=None) -> PretrainLosses:
    """One rank's eager DP pretraining step (see the module's note);
    returns the union batch's losses.  ``batch``: this rank's (g, sub),
    or for the node-sharded model (``parallel/sharded_scgib.py``) its
    slice of a ``ShardedPretrainBatch``: the same step, whose losses and
    gradients are each rank's share."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    losses = model(*batch, rand=uniform_draws(generator,
                                              batch[0].node_feat.device))
    losses.total.backward()
    out = _summed(torch.stack(tuple(losses)), group)
    _update(model, optimizer, group)
    return PretrainLosses(*out.unbind())


def bce_sum_count(scores: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor):
    """(sum, count) of BCE over probabilities, the logs clamped at -100
    (``losses.bce_loss``), for ``make_dp_finetune_step``."""
    labels = torch.nan_to_num(labels, nan=0.0)
    ll = -(labels * _safe_log(scores)
           + (1.0 - labels) * _safe_log(1.0 - scores))
    m = mask.to(ll.dtype)
    return (ll * m).sum(), m.sum()


def dp_finetune_step_eager(model: nn.Module,
                           optimizer: torch.optim.Optimizer, group,
                           loss_impl: Callable, g, sub,
                           generator=None) -> torch.Tensor:
    """One rank's eager DP supervised step: ``loss_impl``'s local sum over
    the group's count; returns the union batch's loss."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    scores = model(g, sub, rand=uniform_draws(generator, g.node_feat.device))
    total, count = loss_impl(scores, g.labels, trainer.label_mask(g))
    loss = total / all_reduce_sum(count, group).clamp_min(1.0)
    loss.backward()
    out = _summed(loss, group)
    _update(model, optimizer, group)
    return out


# --- the captured steps -----------------------------------------------------------

def _host_group(group):
    """A gloo group of the same ranks, for agreeing keys on the host."""
    if dist.get_backend(group) == "gloo":
        return group
    return dist.new_group(dist.get_process_group_ranks(group),
                          backend="gloo")


def _agree(host_group, items: List) -> List:
    """``items`` (batches or ``_Wire``s) with their bool flags made the
    same on every rank (True where True everywhere); raises where another
    rank's items differ in any shape, dtype, field or None flag."""
    flags = [(i, f.name) for i, b in enumerate(items)
             for f in dataclasses.fields(b)
             if isinstance(getattr(b, f.name), bool)]
    shape_key = repr([
        (f.name, (tuple(v.shape), str(v.dtype))
         if isinstance(v, torch.Tensor) else
         "flag" if isinstance(v, bool) else v)
        for b in items for f in dataclasses.fields(b)
        for v in [getattr(b, f.name)]])
    crc = zlib.crc32(shape_key.encode())
    v = torch.tensor([int(getattr(items[i], n)) for i, n in flags]
                     + [crc, -crc], dtype=torch.int64)
    dist.all_reduce(v, op=dist.ReduceOp.MIN, group=host_group)
    agreed = v.tolist()
    if agreed[-2] != -agreed[-1]:
        raise ValueError("the ranks' batches differ in shape or layout; "
                         "pack every rank's batch to the same capacities")
    items = list(items)
    for (i, name), val in zip(flags, agreed):
        if bool(val) != getattr(items[i], name):
            items[i] = dataclasses.replace(items[i], **{name: bool(val)})
    return items


class _DPSteps(trainer._CapturedSteps):
    """``_CapturedSteps`` whose batches' key is agreed across the ranks
    before each call; captured over NCCL only, in ``thread_local`` mode
    (the NCCL watchdog thread queries events while a graph is captured),
    and eager over gloo, which a graph cannot capture (CUDA tensors
    included: gloo stages them through the host)."""

    capture_mode = "thread_local"

    def __init__(self, run, optimizer, group):
        super().__init__(run, optimizer)
        self.group = group
        self.host_group = _host_group(group)

    def _step(self, batches, generator):
        batches = tuple(_agree(self.host_group, batches))
        if dist.get_backend(self.group) != "nccl":
            return self.run(self._arg(batches), generator)
        return super()._step(batches, generator)


class _DPSuperbatchSteps(_DPSteps, trainer._SuperbatchSteps):
    pass


def make_dp_pretrain_step(model: nn.Module,
                          optimizer: torch.optim.Optimizer, group
                          ) -> Callable[..., PretrainLosses]:
    """``step(g, sub, generator=None) -> losses``: one data-parallel
    optimizer step over ``group`` on this rank's batch; ``model`` built
    with ``group=group``.  The returned losses are the union batch's, the
    single-device step's on it."""
    return _DPSteps(lambda pairs, gen: dp_pretrain_step_eager(
        model, optimizer, group, *pairs[0], generator=gen), optimizer, group)


def make_dp_finetune_step(model: nn.Module,
                          optimizer: torch.optim.Optimizer, group,
                          loss_impl: Callable = bce_sum_count
                          ) -> Callable[..., torch.Tensor]:
    """``step(g, sub, generator=None) -> loss``: one data-parallel
    supervised step; ``loss_impl(scores, labels, mask)`` gives this rank's
    (sum, count) (``bce_sum_count``), and the loss is the sum over the
    group's count."""
    return _DPSteps(lambda pairs, gen: dp_finetune_step_eager(
        model, optimizer, group, loss_impl, *pairs[0], gen), optimizer,
        group)


def make_dp_superbatch_step(model: nn.Module,
                            optimizer: torch.optim.Optimizer, group,
                            byte_spec) -> Callable[..., PretrainLosses]:
    """``step(buf, pool_fits, generator=None) -> losses``: K data-parallel
    optimizer steps on the K wire batches of this rank's buffer (laid out
    by ``byte_spec``, ``data/loader.py::superbatch_spec``), each reduced
    as in ``make_dp_pretrain_step``; the losses stacked to [K].  The
    superbatch's one pooling flag is agreed across the ranks with its
    buffer's size."""
    return _DPSuperbatchSteps(trainer.superbatch_run(
        byte_spec, lambda g, sub, gen: dp_pretrain_step_eager(
            model, optimizer, group, g, sub, generator=gen)), optimizer, group)
