"""Stem max-pool, MaxPool2d(3, 2, padding=1), NCHW.

Kernel: `csrc/maxpool3x3s2.cu`, which replaces the TPU kernel
`fusiondepth_tpu/ops/pallas_pool.py::_pool_fwd`. It is bound by bytes (one
read of the input, a quarter-size write) and is bit-identical to the plain
version, NaN and ties included.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fusiondepth_torch.kernels import LAUNCHES, build, check_cuda_f32, \
    on_card


def maxpool3x3s2_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: torch's own max pool."""
    return F.max_pool2d(x, 3, 2, 1)


def maxpool3x3s2(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, (H-1)//2 + 1, (W-1)//2 + 1). CPU tensors take
    the plain version; CUDA tensors take the kernel (float32, contiguous)."""
    if x.device.type == "cpu":
        return maxpool3x3s2_plain(x)
    check_cuda_f32("maxpool3x3s2", x=x)
    if x.dim() != 4 or 0 in x.shape:
        raise ValueError(f"maxpool3x3s2: expected non-empty (B, C, H, W), "
                         f"got {tuple(x.shape)}")
    B, C, H, W = x.shape
    y = torch.empty((B, C, (H - 1) // 2 + 1, (W - 1) // 2 + 1),
                    device=x.device, dtype=x.dtype)
    with on_card(x) as stream:
        build.check(build.load().fd_maxpool3x3s2_fwd(
            x.data_ptr(), y.data_ptr(), B, C, H, W, stream),
            "fd_maxpool3x3s2_fwd")
    LAUNCHES["maxpool3x3s2"] += 1
    return y
