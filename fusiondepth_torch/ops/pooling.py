"""The ResNet stem max-pool."""

from __future__ import annotations

import torch

from fusiondepth_torch.kernels import pool


def max_pool_3x3s2(x: torch.Tensor) -> torch.Tensor:
    """torch MaxPool2d(3, 2, padding=1) on (B, C, H, W): the hand-written
    kernel for a CUDA tensor, its plain version for a CPU tensor (see
    `fusiondepth_torch.kernels.pool`). Forward only: the tie-splitting
    gradient of the JAX version belongs to the training path."""
    return pool.maxpool3x3s2(x)
