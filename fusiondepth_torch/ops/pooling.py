"""The ResNet stem max-pool."""

from __future__ import annotations

import torch

from fusiondepth_torch.kernels import pool


def max_pool_3x3s2(x: torch.Tensor) -> torch.Tensor:
    """torch MaxPool2d(3, 2, padding=1) on (B, C, H, W) with the JAX
    package's tie-splitting gradient: the hand-written kernels for a CUDA
    tensor, their plain versions for a CPU tensor (see
    `fusiondepth_torch.kernels.pool`)."""
    return pool.maxpool3x3s2(x)
