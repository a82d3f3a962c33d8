"""Stem max-pool, MaxPool2d(3, 2, padding=1), NCHW, with the tie-splitting
gradient of the JAX package.

Kernels: `csrc/maxpool3x3s2.cu`. `maxpool3x3s2_fwd` replaces the TPU kernel
`fusiondepth_tpu/ops/pallas_pool.py::_pool_fwd` and `maxpool3x3s2_bwd` its
`_pool_bwd`. Both are bound by bytes and agree bit for bit with their plain
versions, NaN and ties included. Each has a float32 and a bfloat16 entry
point, picked by the dtype of x. `maxpool3x3s2` is the differentiable op.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fusiondepth_torch.kernels import LAUNCHES, build, check_cuda, \
    entry_dtype, entry_point, launch_key, on_card, wide


def maxpool3x3s2_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the forward: torch's own max pool (exact
    in any dtype)."""
    return F.max_pool2d(x, 3, 2, 1)


def maxpool3x3s2_bwd_plain(x: torch.Tensor, y: torch.Tensor,
                           g: torch.Tensor) -> torch.Tensor:
    """Plain version of the backward: each input pixel receives g / count
    from every window in which it equals the window's max y, count being
    the window's number of taps equal to y, pad taps -inf (as
    `fusiondepth_tpu/ops/pooling.py::_pool_even_bwd`). Not torch's
    autograd, which routes a tie to one argmax. A bfloat16 x, y, g is
    widened to float32, where the ties are compared and g / count summed,
    and dx rounded once to bfloat16 (`ops/pooling.py:123-158`)."""
    dtype = x.dtype
    x, y, g = wide(x), wide(y), wide(g)
    B, C, H, W = x.shape
    Ho, Wo = y.shape[2:]
    xp = F.pad(x, (1, 1, 1, 1), value=float("-inf"))
    eqs = {}
    count = torch.zeros_like(y)
    for dy in range(3):
        for dx in range(3):
            tap = xp[:, :, dy:dy + 2 * Ho:2, dx:dx + 2 * Wo:2]
            eqs[dy, dx] = tap == y
            count += eqs[dy, dx]
    gc = g / count.clamp(min=1.0)
    gp = torch.zeros_like(xp)
    for dy in range(3):
        for dx in range(3):
            gp[:, :, dy:dy + 2 * Ho:2, dx:dx + 2 * Wo:2] += torch.where(
                eqs[dy, dx], gc, 0.0)
    return gp[:, :, 1:H + 1, 1:W + 1].to(dtype)


def _out_shape(x):
    B, C, H, W = x.shape
    return B, C, (H - 1) // 2 + 1, (W - 1) // 2 + 1


def maxpool3x3s2_fwd(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, (H-1)//2 + 1, (W-1)//2 + 1). CPU tensors take
    the plain version; CUDA tensors take the kernel (float32 or bfloat16,
    contiguous)."""
    if x.device.type == "cpu":
        return maxpool3x3s2_plain(x)
    name = "maxpool3x3s2"
    dt = entry_dtype(name, x)
    check_cuda(name, dt, x=x)
    if x.dim() != 4 or 0 in x.shape:
        raise ValueError(f"maxpool3x3s2: expected non-empty (B, C, H, W), "
                         f"got {tuple(x.shape)}")
    B, C, H, W = x.shape
    y = torch.empty(_out_shape(x), device=x.device, dtype=x.dtype)
    with on_card(x) as stream:
        build.check(entry_point("fd_maxpool3x3s2_fwd", dt)(
            x.data_ptr(), y.data_ptr(), B, C, H, W, stream),
            "fd_maxpool3x3s2_fwd")
    LAUNCHES[launch_key(name, dt)] += 1
    return y


def maxpool3x3s2_bwd(x: torch.Tensor, y: torch.Tensor,
                     g: torch.Tensor) -> torch.Tensor:
    """dx (B, C, H, W) from the pool's input x, its output y and the
    cotangent g. H and W must be even (the JAX package's tie-split path;
    the trainer's sizes are multiples of 32). CPU tensors take the plain
    version; CUDA tensors take the kernel (float32 or bfloat16,
    contiguous)."""
    name = "maxpool3x3s2_bwd"
    if x.dim() != 4 or x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"{name}: the tie-splitting backward takes even "
                         f"H and W, got {tuple(x.shape)}")
    if tuple(y.shape) != _out_shape(x) or g.shape != y.shape:
        raise ValueError(f"{name}: y {tuple(y.shape)} and g "
                         f"{tuple(g.shape)} do not fit x {tuple(x.shape)}")
    if x.device.type == "cpu":
        return maxpool3x3s2_bwd_plain(x, y, g)
    dt = entry_dtype(name, x)
    check_cuda(name, dt, x=x, y=y, g=g)
    B, C, H, W = x.shape
    dx = torch.empty_like(x)
    with on_card(x) as stream:
        build.check(entry_point("fd_maxpool3x3s2_bwd", dt)(
            x.data_ptr(), y.data_ptr(), g.data_ptr(), dx.data_ptr(), B, C, H,
            W, stream), "fd_maxpool3x3s2_bwd")
    LAUNCHES[launch_key(name, dt)] += 1
    return dx


class _MaxPool3x3s2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = maxpool3x3s2_fwd(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return maxpool3x3s2_bwd(x, y, g.contiguous())


def maxpool3x3s2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(3, 2, padding=1) whose gradient splits ties equally, each
    pass through its kernel on a card (see maxpool3x3s2_fwd/_bwd)."""
    return _MaxPool3x3s2.apply(x)
