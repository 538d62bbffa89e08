"""Collectives with gradients, for tensor, data and sequence parallelism.

The JAX package never writes a collective: GSPMD inserts them from the
parameter shardings, and ``shard_map`` transposes its own.  Here the
modules call them, in Megatron's pairs (Shoeybi et al., 2019):

- :func:`copy_to_group`: identity forward, all-reduce backward.  Where a
  replicated activation enters a region whose ranks each compute a part
  (a column-parallel product, a rank's slice of the time axis), so that its
  gradient sums every rank's part.
- :func:`reduce_from_group`: all-reduce forward, identity backward.  Where
  each rank's partial sum (a row-parallel product, a loss numerator over
  its batch rows) becomes the replicated whole.
- :func:`gather_from_group`: all-gather forward, this rank's slice of the
  gradient backward.  For pieces whose gathered whole feeds replicated
  computation: every rank then holds the same, whole gradient.
- :func:`all_gather`: all-gather forward; backward sums the gradient over
  the ranks and keeps this rank's slice.  For pieces whose gathered whole
  feeds computation that differs between ranks.

They are built on ``all_reduce`` and ``all_gather`` (list form) only (and
``mesh.replicate`` on ``broadcast``), which gloo implements for CUDA tensors as well as CPU
ones, so one code path runs over gloo on the CPU, over gloo with two ranks
sharing one card, and over NCCL.  A ``None`` group, or one of a single
rank, makes each of them the identity.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over ``group`` (no gradient)."""
    if group_size(group) > 1:
        dist.all_reduce(t, group=group)
    return t


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather along ``dim`` (no gradient): the ranks' pieces in rank order."""
    x = x.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _my_slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = x.shape[dim] // group_size(group)
    return x.narrow(dim, group_rank(group) * n, n).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _my_slice(g, ctx.dim, ctx.group), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone(), ctx.group)
        return _my_slice(g, ctx.dim, ctx.group), None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _ReduceFrom.apply(x, group)


def gather_from_group(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _GatherFrom.apply(x, dim, group)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _AllGather.apply(x, dim, group)


def slice_of_group(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's contiguous slice along ``dim`` of a tensor replicated over
    ``group``; its gradient gathers every rank's slice."""
    return x if group_size(group) == 1 else _my_slice(copy_to_group(x, group), dim, group)


def global_mean(num: torch.Tensor, den: torch.Tensor, group=None) -> torch.Tensor:
    """``num / max(den, 1)`` with both summed over ``group`` first (the batch
    rows' data-parallel ranks): a loss normalised over the global batch, not
    a mean of per-rank means.  The numerator's gradient stays per rank, so
    the data-parallel sum of the gradients is the global batch's."""
    if group_size(group) > 1:
        num = reduce_from_group(num, group)
        den = all_reduce_(den.detach().clone(), group)
    return num / torch.clamp(den, min=1.0)
