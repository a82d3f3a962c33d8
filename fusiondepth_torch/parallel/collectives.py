"""The collectives of a data-parallel step.

JAX gets them from GSPMD: a batch-axis mean over a sharded batch is a
mean over the global batch, and the gradient psum comes with it. Here
they are explicit all-reduces over a data group (a
`torch.distributed` process group; None stands for a world of one, where
every function below is the identity):

  - `all_reduce_sum`, autograd-aware, for the reductions whose value must
    be global inside the step: the BatchNorm training statistics
    (`models/norm.py`) and the SI loss (`ops/losses.py`). Its backward
    sums the upstream gradients over the ranks, so the gradient of a
    global term reaches each rank's parameters W times;
  - `all_reduce_grads`, once per optimizer step: the sum of every rank's
    gradients divided by W. That is the mean over ranks of the local
    mean losses' gradients, and takes the factor W of the global terms
    out again;
  - `all_reduce_mean`, for the logged losses (detached);
  - `broadcast_module`, rank 0's parameters and buffers to every rank.

Gloo takes only all_reduce and broadcast for a CUDA tensor, so nothing
else runs here. No `DistributedDataParallel`: its autograd hooks do not
fit remat's non-reentrant checkpoint, the variants' unused parameters or
gradient accumulation without `no_sync`; overlapping the gradient
all-reduce with the backward is later work.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch
import torch.distributed as dist


def group_size(group) -> int:
    """The ranks of `group` (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    """This process's rank in `group` (0 for None)."""
    return 0 if group is None else dist.get_rank(group)


class _AllReduceSum(torch.autograd.Function):
    """torch.distributed.nn.functional.all_reduce's sum, without its
    deprecation."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of t over the ranks of `group`, differentiable: the gradient
    of t is the sum of the gradients of the result over the ranks."""
    if group_size(group) == 1:
        return t
    return _AllReduceSum.apply(t, group)


def _flat_by_dtype(tensors):
    by = {}
    for t in tensors:
        by.setdefault(t.dtype, []).append(t)
    return by.values()


def all_reduce_grads(params: Iterable[torch.nn.Parameter], group) -> None:
    """Replace every gradient by its mean over the ranks of `group`: one
    flattened all-reduce per dtype. A parameter without a gradient has
    none on every rank (the same code runs everywhere) and is skipped."""
    world = group_size(group)
    if world == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    for same in _flat_by_dtype(grads):
        flat = torch.cat([g.reshape(-1) for g in same])
        dist.all_reduce(flat, group=group)
        flat /= world
        for g, v in zip(same, flat.split([g.numel() for g in same])):
            g.copy_(v.view_as(g))


def all_reduce_mean(values: Dict[str, torch.Tensor],
                    group) -> Dict[str, torch.Tensor]:
    """{name: its mean over the ranks}, detached, for scalar tensors given
    in the same order on every rank."""
    world = group_size(group)
    if world == 1 or not values:
        return values
    names = list(values)
    flat = torch.stack([values[k].detach().to(torch.float64)
                        for k in names])
    dist.all_reduce(flat, group=group)
    flat /= world
    return {k: flat[i].to(values[k].dtype) for i, k in enumerate(names)}


def broadcast_module(module: torch.nn.Module, group,
                     src: int = 0) -> None:
    """Copy rank `src`'s parameters and buffers into every rank's module:
    one flattened broadcast per dtype."""
    if group_size(group) == 1:
        return
    tensors = [t.data for t in module.parameters()] + list(module.buffers())
    for same in _flat_by_dtype(tensors):
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.broadcast(flat, src=src, group=group)
        for t, v in zip(same, flat.split([t.numel() for t in same])):
            t.copy_(v.view_as(t))


def barrier(group, device: Optional[torch.device] = None) -> None:
    """Wait for every rank of `group`: an all-reduce of one value on
    `device` (the backends' barrier would guess the card)."""
    if group_size(group) == 1:
        return
    dist.all_reduce(torch.zeros(1, device=device), group=group)
