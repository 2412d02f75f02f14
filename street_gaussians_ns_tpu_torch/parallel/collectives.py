"""The collectives of the sharded step (port-only: what `shard_map` and
its collectives give the JAX code), as `torch.autograd.Function`s:

  all_gather_tiled  concatenation along dim 0 in group order; its backward
                    is a reduce-scatter (each rank gets the sum over the
                    group of the cotangents of its own slice);
  psum              a sum over the group; its backward is a psum of the
                    cotangents;
  pmean             psum / group size;
  pmax              a max over the group, with no gradient.

Their adjoints make the gradient of J = sum over ranks of each rank's
loss / (data x model) the gradient of the mean over data rows of the
merged loss, however many ranks of a row compute a replicated term: this
is the seed JAX's shard_map transpose gives each device (a replicated
output's cotangent divided by the mesh size), and the sharded step
(parallel.sharded) seeds its backward with it.

Backends: NCCL, and gloo for CPU tensors, take the single-tensor
all-gather and reduce-scatter (`all_gather_single` / `reduce_scatter_
single`, named `all_gather_into_tensor` / `reduce_scatter_tensor` before
torch 2.13). Gloo has neither for CUDA tensors (two ranks that share one
card), so for those both are expressed explicitly: the all-gather as an
all-reduce (sum) of a zero buffer into which each rank writes its slice,
the reduce-scatter as an all-reduce followed by taking the local slice
(`allreduce_form`). Nothing switches backend.

A group of None (a world of one process) or of one rank makes no call:
every operation is then the identity. `broadcast` (the viewer's per-step
hand-off, parallel/trainer.py) goes over the default group; a world of one
process makes no call there either.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def allreduce_form(x: torch.Tensor, group) -> bool:
    """Whether the all-gather and the reduce-scatter of x over the group
    go through an all-reduce: gloo with a CUDA tensor."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


_all_gather_single = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def gather_tiled(x: torch.Tensor, group) -> torch.Tensor:
    """All-gather along dim 0 in group order, no gradient."""
    m = group_size(group)
    if m == 1:
        return x
    x = x.contiguous()
    n = x.shape[0]
    if allreduce_form(x, group):
        # Gloo on CUDA: an all-reduce of a zero buffer holding this
        # rank's slice.
        out = torch.zeros((m * n,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        r = group_rank(group)
        out[r * n:(r + 1) * n] = x
        if out.dtype == torch.bool:
            as_int = out.to(torch.uint8)
            dist.all_reduce(as_int, group=group)
            return as_int.to(torch.bool)
        dist.all_reduce(out, group=group)
        return out
    out = torch.empty((m * n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _all_gather_single(out, x, group=group)
    return out


def reduce_scatter_tiled(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group, then this rank's slice of dim 0."""
    m = group_size(group)
    if m == 1:
        return x
    x = x.contiguous()
    n = x.shape[0] // m
    r = group_rank(group)
    if allreduce_form(x, group):
        # Gloo on CUDA: an all-reduce, then the local slice.
        full = x.clone()
        dist.all_reduce(full, group=group)
        return full[r * n:(r + 1) * n].contiguous()
    out = torch.empty((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _reduce_scatter_single(out, x, group=group)
    return out


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: x reduced over the group (no gradient)."""
    if group_size(group) == 1:
        return x
    out = x.clone().contiguous()
    dist.all_reduce(out, op=op, group=group)
    return out


def broadcast(x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """x of rank src on every rank of the world, in place (no gradient).
    Gloo takes CPU tensors here: the caller keeps x on the CPU for it."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return x
    dist.broadcast(x, src=src)
    return x


class _AllGatherTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return gather_tiled(x, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_tiled(g, ctx.group), None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def all_gather_tiled(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-gather along dim 0 (backward: reduce-scatter)."""
    if group_size(group) == 1:
        return x
    return _AllGatherTiled.apply(x, group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum over the group (backward: psum)."""
    if group_size(group) == 1:
        return x
    return _Psum.apply(x, group)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    m = group_size(group)
    return x if m == 1 else psum(x, group) / m


def pmax(x: torch.Tensor, *groups) -> torch.Tensor:
    """Max over each group in turn, detached."""
    out = x.detach()
    for group in groups:
        out = all_reduce(out, group, op=dist.ReduceOp.MAX)
    return out
