"""Reflection padding for NCHW tensors."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def reflect_pad_hw(x: torch.Tensor, pad: int = 1) -> torch.Tensor:
    """Reflection-pad H and W by `pad` (torch ReflectionPad2d semantics:
    mirror excluding the edge pixel), as `fusiondepth_tpu.ops.padding`."""
    if pad == 0:
        return x
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")
