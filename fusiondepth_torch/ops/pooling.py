"""The ResNet stem max-pool, and the refiner's 2x2 ceil-mode pool and
masked median (counterpart of `fusiondepth_tpu/ops/pooling.py`)."""

from __future__ import annotations

import torch

from fusiondepth_torch.kernels import pool


def max_pool_3x3s2(x: torch.Tensor) -> torch.Tensor:
    """torch MaxPool2d(3, 2, padding=1) on (B, C, H, W) with the JAX
    package's tie-splitting gradient: the hand-written kernels for a CUDA
    tensor, their plain versions for a CPU tensor (see
    `fusiondepth_torch.kernels.pool`)."""
    return pool.maxpool3x3s2(x)


def max_pool2x2_ceil(x: torch.Tensor) -> torch.Tensor:
    """NHWC (B, H, W, C) -> (B, ceil(H/2), ceil(W/2), C), max over 2x2
    windows, odd edges padded with -inf (ops/pooling.py:164-173). Its
    gradient (amax's) splits a tie evenly, as jnp.max's does; the refiner
    takes it through the stage-1 maps under train_entire_net."""
    B, H, W, C = x.shape
    Hp, Wp = -(-H // 2) * 2, -(-W // 2) * 2
    if (Hp, Wp) != (H, W):
        x = torch.nn.functional.pad(x, (0, 0, 0, Wp - W, 0, Hp - H),
                                    value=float("-inf"))
    return x.reshape(B, Hp // 2, 2, Wp // 2, 2, C).amax(dim=(2, 4))


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of x where mask, over all elements (batch included), as
    torch.median(x[mask]): the lower middle element for an even count;
    +inf when nothing is valid. Static-shaped, no host sync: invalid
    entries sort to +inf and the index comes from the valid count
    (ops/pooling.py:176-187)."""
    inf = torch.full((), float("inf"), dtype=x.dtype, device=x.device)
    flat = torch.where(mask, x, inf).reshape(-1)
    n = mask.sum()
    idx = torch.clamp((n - 1) // 2, min=0).reshape(1)
    return torch.sort(flat)[0].gather(0, idx)[0]
