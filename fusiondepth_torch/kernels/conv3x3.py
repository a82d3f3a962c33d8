"""3x3 stride-1 convolutions of the depth path, NCHW, weights OIHW.

Kernels: `csrc/conv3x3.cu`, which replaces the TPU kernel
`fusiondepth_tpu/ops/pallas_fold_conv.py::_run_conv` in its two forward
uses:

- `conv3x3_reflect`: the decoder's ConvBlock / Conv3x3 head
  (`fold_conv3x3_pallas`): reflect pad addressed in the kernel, a virtual
  concat of one or two inputs, bias, optional ELU;
- `conv3x3_zero_act`: the encoder basic-block conv
  (`fold_conv3x3_zero_pallas`): zero pad, no bias, with the preceding BN
  affine + ReLU optionally applied to in-bounds input taps.

Both accumulate in fp32 on the CUDA cores and are bound by its issue rate
(see the note at the top of the source).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from fusiondepth_torch.kernels import LAUNCHES, build, check_cuda_f32, \
    on_card
from fusiondepth_torch.ops.padding import reflect_pad_hw


def _concat(x0, x1):
    return x0 if x1 is None else torch.cat([x0, x1], 1)


def conv3x3_reflect_plain(x0, weight, bias, x1=None, elu: bool = True):
    """Plain version: ReflectionPad2d(1) over cat([x0, x1]), conv, ELU."""
    y = F.conv2d(reflect_pad_hw(_concat(x0, x1), 1), weight, bias)
    return F.elu(y) if elu else y


def conv3x3_zero_act_plain(x, weight, scale=None, shift=None):
    """Plain version: conv3x3(relu(x * scale + shift), zero pad 1), or
    conv3x3(x) without scale/shift."""
    if scale is not None:
        x = torch.relu(x * scale[:, None, None] + shift[:, None, None])
    return F.conv2d(x, weight, padding=1)


def _check_shapes(name, x0, x1, weight, min_hw):
    if x0.dim() != 4 or 0 in x0.shape:
        raise ValueError(f"{name}: expected non-empty (B, C, H, W) input, "
                         f"got {tuple(x0.shape)}")
    B, C0, H, W = x0.shape
    if H < min_hw or W < min_hw:
        raise ValueError(f"{name}: H and W must be >= {min_hw}, got {H}x{W}")
    C1 = 0
    if x1 is not None:
        if x1.dim() != 4 or x1.shape[0] != B or x1.shape[2:] != x0.shape[2:]:
            raise ValueError(f"{name}: x1 {tuple(x1.shape)} does not match "
                             f"x0 {tuple(x0.shape)}")
        C1 = x1.shape[1]
    if weight.shape[1:] != (C0 + C1, 3, 3):
        raise ValueError(f"{name}: weight {tuple(weight.shape)} does not fit "
                         f"{C0 + C1} input channels")
    return B, C0, C1, H, W, weight.shape[0]


def conv3x3_reflect(x0: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, x1: Optional[torch.Tensor] = None,
                    elu: bool = True) -> torch.Tensor:
    """Reflect-pad 3x3 conv over the channel concat of x0 (B, C0, H, W) and
    optional x1 (B, C1, H, W), weight (Co, C0 + C1, 3, 3), bias (Co,),
    ELU when `elu`. CPU tensors take the plain version; CUDA tensors take
    the kernel (float32, contiguous), which never builds the concat."""
    if x0.device.type == "cpu":
        return conv3x3_reflect_plain(x0, weight, bias, x1, elu)
    name = "conv3x3_reflect"
    check_cuda_f32(name, x0=x0, x1=x1, weight=weight, bias=bias)
    B, C0, C1, H, W, Co = _check_shapes(name, x0, x1, weight, min_hw=2)
    if bias.shape != (Co,):
        raise ValueError(f"{name}: bias {tuple(bias.shape)}, expected ({Co},)")
    y = torch.empty((B, Co, H, W), device=x0.device, dtype=torch.float32)
    with on_card(x0) as stream:
        build.check(build.load().fd_conv3x3_reflect_fwd(
            x0.data_ptr(), C0, None if x1 is None else x1.data_ptr(), C1,
            weight.data_ptr(), bias.data_ptr(), y.data_ptr(), B, H, W, Co,
            int(elu), stream), "fd_conv3x3_reflect_fwd")
    LAUNCHES[name] += 1
    return y


def conv3x3_zero_act(x: torch.Tensor, weight: torch.Tensor,
                     scale: Optional[torch.Tensor] = None,
                     shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Zero-pad bias-free 3x3 conv of x (B, C, H, W) with weight
    (Co, C, 3, 3); with scale/shift (C,), of relu(x * scale + shift) with
    the pad still 0. CPU tensors take the plain version; CUDA tensors take
    the kernel (float32, contiguous)."""
    if (scale is None) != (shift is None):
        raise ValueError("conv3x3_zero_act: give both scale and shift or "
                         "neither")
    if x.device.type == "cpu":
        return conv3x3_zero_act_plain(x, weight, scale, shift)
    name = "conv3x3_zero_act"
    check_cuda_f32(name, x=x, weight=weight, scale=scale, shift=shift)
    B, C, _, H, W, Co = _check_shapes(name, x, None, weight, min_hw=1)
    if scale is not None and (scale.shape != (C,) or shift.shape != (C,)):
        raise ValueError(f"{name}: scale/shift must be ({C},)")
    y = torch.empty((B, Co, H, W), device=x.device, dtype=torch.float32)
    with on_card(x) as stream:
        build.check(build.load().fd_conv3x3_zero_act_fwd(
            x.data_ptr(), C, weight.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if shift is None else shift.data_ptr(),
            y.data_ptr(), B, H, W, Co, stream), "fd_conv3x3_zero_act_fwd")
    LAUNCHES[name] += 1
    return y
