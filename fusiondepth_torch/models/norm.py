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
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn


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

    def affine(self, x: torch.Tensor):
        """(A, Bc), each (C,), in x's dtype. In training mode the statistics
        come from x (B, C, H, W), accumulated in float32 at least, and
        update the running ones; otherwise the running statistics are used
        and x is not read. Under `running_stats_held` the running
        statistics are left as they are."""
        if self.training:
            acc = torch.promote_types(torch.float32, x.dtype)
            mean = x.mean(dim=(0, 2, 3), dtype=acc)
            mean2 = (x * x).mean(dim=(0, 2, 3), dtype=acc)
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

    def forward(self, x: torch.Tensor, return_affine: bool = False):
        """x * A + Bc, or (A, Bc) with `return_affine` for a caller that
        fuses the affine into the next kernel (the encoder's layer1)."""
        a, b = self.affine(x)
        if return_affine:
            return a, b
        return x * a[:, None, None] + b[:, None, None]
