"""The two collectives of the data-parallel model, with gradients.

Counterpart of JAX's ``lax.psum`` and ``lax.all_gather`` inside
``shard_map`` (``check_vma=False``), where each transposes to a sum of the
cotangents over the mesh axis:

- ``all_reduce_sum(x, group)``: the sum of ``x`` over the group's ranks;
  its backward all-reduces the cotangent.  That is what makes the
  reconstruction's ``tr(G_local · psum G)`` exact: each rank's G_i
  receives its own cotangent and, through the sum, every rank's, 2G in
  all.
- ``all_gather(x, group)``: the ranks' ``x`` concatenated on the first
  dimension in rank order (JAX's stacked [D, ...] reshaped to [D * n,
  ...]); its backward all-reduces the cotangent of the whole and takes
  this rank's rows.

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
