"""BatchNorm that folds normalisation into a per-channel affine, as
`fusiondepth_tpu/models/norm.py` does:

    A = scale * rsqrt(var + eps),  Bc = bias - mean * A,  y = x * A + Bc

Parameters are `weight` (the JAX `scale`) and `bias`; running statistics
are the buffers `running_mean` and `running_var` (the JAX `mean`/`var`).
The names are torchvision's, so its checkpoints load as they are.
`momentum` is in the JAX sense: running = m * running + (1 - m) * batch.
"""

from __future__ import annotations

import torch
from torch import nn


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

    def affine(self, x: torch.Tensor):
        """(A, Bc), each (C,). In training mode the statistics come from x
        (B, C, H, W) and update the running ones; otherwise the running
        statistics are used and x is not read."""
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            mean2 = (x * x).mean(dim=(0, 2, 3))
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean)
                self.running_var.mul_(m).add_((1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        return inv, self.bias - mean * inv

    def forward(self, x: torch.Tensor, return_affine: bool = False):
        """x * A + Bc, or (A, Bc) with `return_affine` for a caller that
        fuses the affine into the next kernel (the encoder's layer1)."""
        a, b = self.affine(x)
        if return_affine:
            return a, b
        return x * a[:, None, None] + b[:, None, None]
