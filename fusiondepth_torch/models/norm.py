"""BatchNorm that folds normalisation into a per-channel affine, as
`fusiondepth_tpu/models/norm.py` does:

    A = scale * rsqrt(var + eps),  Bc = bias - mean * A,  y = x * A + Bc

Parameters are `weight` (the JAX `scale`) and `bias`; running statistics
are the buffers `running_mean` and `running_var` (the JAX `mean`/`var`).
The names are torchvision's, so its checkpoints load as they are.
`momentum` is in the JAX sense: running = m * running + (1 - m) * batch.

Under compute_dtype="bfloat16" (`fusiondepth_tpu/models/norm.py:48-94`)
the parameters and running statistics stay float32, the batch statistics
accumulate in float32 over the bf16 input, A and Bc are computed in
float32 and cast to the input's dtype, and the output is x * A + Bc in
that dtype.

`running_stats_held` suspends that update while training-mode BNs still
normalise with their batch statistics: the recompute of a checkpointed
forward (remat, `training/train_state.py::train_forward`) runs under it,
so the running statistics move once a step, as without remat.

`batch_stats_over` makes the training statistics batch-global in a
data-parallel step (`training/train_state.py::train_step`): GSPMD's
`jnp.mean` over a sharded batch is a mean over the global batch
(`fusiondepth_tpu/models/norm.py:66-84`), so the BNs all-reduce
[sum x, sum x^2, count] in the accumulation dtype over the data group and
divide by the global count. The running statistics then come out the same
on every rank. A recompute under remat runs the same all-reduces again,
in the same order on every rank. Without a group they are the local
batch's means.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from fusiondepth_torch.parallel.collectives import all_reduce_sum


@contextlib.contextmanager
def running_stats_held(module: nn.Module):
    """The training-mode BatchNorms of `module` skip their
    running-statistics update while this is open."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    before = [m.stats_held for m in bns]
    for m in bns:
        m.stats_held = True
    try:
        yield
    finally:
        for m, held in zip(bns, before):
            m.stats_held = held


@contextlib.contextmanager
def batch_stats_over(module: nn.Module, group):
    """The training-mode BatchNorms of `module` take their batch statistics
    over every rank of the data group `group` while this is open (None:
    over this process's batch)."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    before = [m.stats_group for m in bns]
    for m in bns:
        m.stats_group = group
    try:
        yield
    finally:
        for m, g in zip(bns, before):
            m.stats_group = g


class BatchNorm(nn.Module):
    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.stats_held = False  # see running_stats_held
        self.stats_group = None  # see batch_stats_over

    def affine(self, x: torch.Tensor):
        """(A, Bc), each (C,), in x's dtype. In training mode the statistics
        come from x (B, C, H, W), accumulated in float32 at least, and
        update the running ones; otherwise the running statistics are used
        and x is not read. Under `running_stats_held` the running
        statistics are left as they are; under `batch_stats_over` the
        statistics are those of the data group's global batch."""
        if self.training:
            acc = torch.promote_types(torch.float32, x.dtype)
            if self.stats_group is None:
                mean = x.mean(dim=(0, 2, 3), dtype=acc)
                mean2 = (x * x).mean(dim=(0, 2, 3), dtype=acc)
            else:
                mean, mean2 = self._global_moments(x, acc)
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            if not self.stats_held:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(m).add_((1 - m) * mean)
                    self.running_var.mul_(m).add_((1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        return inv.to(x.dtype), (self.bias - mean * inv).to(x.dtype)

    def _global_moments(self, x: torch.Tensor, acc: torch.dtype):
        """(mean x, mean x^2) per channel over the group's global batch."""
        C = x.shape[1]
        sums = all_reduce_sum(torch.cat([
            x.sum(dim=(0, 2, 3), dtype=acc),
            (x * x).sum(dim=(0, 2, 3), dtype=acc),
            torch.full((1,), x.numel() // C, dtype=acc, device=x.device)]),
            self.stats_group)
        return sums[:C] / sums[2 * C], sums[C:2 * C] / sums[2 * C]

    def forward(self, x: torch.Tensor, return_affine: bool = False):
        """x * A + Bc, or (A, Bc) with `return_affine` for a caller that
        fuses the affine into the next kernel (the encoder's layer1)."""
        a, b = self.affine(x)
        if return_affine:
            return a, b
        return x * a[:, None, None] + b[:, None, None]
