"""`Conv2d`: torch's convolution with its parameters cast to the input's
dtype at each call (counterpart of flax's `nn.Conv(dtype=...)`, which the
JAX package's modules use, e.g. `fusiondepth_tpu/models/resnet.py:63-71`).

Under compute_dtype="bfloat16" the parameters stay float32 and the conv
runs in bfloat16 (cuDNN's bf16 convolution on a card: bf16 operands,
float32 accumulation, a bf16 output); in float32 and float64 the cast is
the identity. The gradient of the cast brings each parameter's gradient
back to its own dtype. Parameter names and shapes are nn.Conv2d's.
"""

from __future__ import annotations

import torch
from torch import nn


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)
