"""The collectives of the data-parallel and node-sharded models, with
gradients.

Counterpart of JAX's ``lax.psum``, ``lax.all_gather``, ``lax.ppermute``
and ``lax.pmax`` inside ``shard_map`` (``check_vma=False``).  The first two
transpose to a sum of the cotangents over the mesh axis:

- ``all_reduce_sum(x, group)``: the sum of ``x`` over the group's ranks;
  its backward all-reduces the cotangent.  That is what makes the
  reconstruction's ``tr(G_local · psum G)`` exact: each rank's G_i
  receives its own cotangent and, through the sum, every rank's, 2G in
  all.
- ``all_gather(x, group)``: the ranks' ``x`` concatenated on the first
  dimension in rank order (JAX's stacked [D, ...] reshaped to [D * n,
  ...]); its backward all-reduces the cotangent of the whole and takes
  this rank's rows.

The node-sharded path (``parallel/edge_partition.py``) adds ``ring_shift``
(ppermute by one rank either way round the ring; its backward is the shift
the other way) and ``all_reduce_max`` (pmax, which the JAX package takes
of stop-gradient values only, so it has no gradient).

Plain ``dist.all_reduce`` has no gradient, which would drop every
cross-rank term of the sync-BN statistics and of the global denominators;
``torch.distributed.nn.functional`` has these gradients but is deprecated.
Every rank must call each collective, forward and backward, in the same
order: the model's code path, not its data, fixes that order.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=ctx.group)
        return out, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = x.shape[0]
        ctx.rank = dist.get_rank(group)
        x = x.contiguous()
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=ctx.group)
        return out[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.psum(x, axis)``: the sum over the group, with its gradient."""
    return _AllReduceSum.apply(x, group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.all_gather(x, axis).reshape(-1, *x.shape[1:])``: the ranks'
    rows in rank order, with its gradient."""
    return _AllGather.apply(x, group)


def _peer(group, offset: int) -> int:
    """The global rank of the group rank ``offset`` places from this one,
    around the ring."""
    size = dist.get_world_size(group)
    return dist.get_global_rank(group if group is not None
                                else dist.group.WORLD,
                                (dist.get_rank(group) + offset) % size)


def _shift(x: torch.Tensor, shift: int, group) -> torch.Tensor:
    """One hop: ``x`` sent ``shift`` ranks on, the block of the rank
    ``shift`` behind received; the exchange is complete on return.  Over
    gloo the blocks travel through the host: gloo's point-to-point reads
    and writes host memory only (on an H100, ``dist.send`` of a CUDA tensor
    over gloo aborted its process: "writev ... Bad address"), so a tensor
    on the card is copied to the host to be sent and the received block
    copied back.  NCCL exchanges the card's tensors directly."""
    via_host = x.is_cuda and dist.get_backend(group) == "gloo"
    send = x.detach().to("cpu" if via_host else x.device,
                         memory_format=torch.contiguous_format)
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, _peer(group, shift), group),
           dist.P2POp(dist.irecv, recv, _peer(group, -shift), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(x.device) if via_host else recv


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift, group):
        ctx.shift = shift
        ctx.group = group
        return _shift(x, shift, group)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, -ctx.shift, ctx.group), None, None


def ring_shift(x: torch.Tensor, shift: int, group) -> torch.Tensor:
    """``lax.ppermute(x, axis, [(i, (i + shift) % S) for i in range(S)])``
    for ``shift`` +1 or -1: rank r's ``x`` goes to rank r + shift, and this
    rank receives rank r - shift's.  Its backward shifts the cotangent the
    other way (ppermute's transpose).  At world size 1 the permutation is
    the identity and nothing is sent (a rank cannot send to itself).  Each
    hop is one complete exchange, so at world size 2, where both
    directions reach the same rank, two hops' messages cannot cross."""
    if shift not in (1, -1):
        raise ValueError(f"ring_shift: shift {shift} is not +1 or -1")
    if dist.get_world_size(group) == 1:
        return x
    return _RingShift.apply(x, shift, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.pmax(x, axis)``: the elementwise max over the group, without a
    gradient (the JAX package takes it of stop-gradient values only)."""
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out
