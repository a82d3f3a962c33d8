"""Seeded initialisation of the port's modules.

Convolution kernels get flax's default `lecun_normal`: a normal truncated
at +-2 standard deviations, scaled so that its variance is 1 / fan_in.
Biases are 0 and BatchNorm starts at scale 1, shift 0. The numbers come
from an explicit `torch.Generator` and differ from JAX's for the same
seed: tests that compare the two packages carry the weights across
instead (`models/jax_weights.py`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

# the standard deviation of a unit normal truncated at +-2
_TRUNC2_STD = 0.87962566103423978
# erf(+-2 / sqrt(2)): the unit normal's CDF at +-2, mapped to (-1, 1)
_ERF2 = math.erf(2.0 / math.sqrt(2.0))


def lecun_normal_(module: nn.Module,
                  generator: Optional[torch.Generator] = None) -> None:
    """Re-initialise every nn.Conv2d under `module` in place. The
    truncated normal is drawn by inverting the normal CDF of a uniform
    sample (sqrt(2) * erfinv(u), u uniform on (-erf(sqrt 2), erf(sqrt
    2))): three passes over the weight, where nn.init.trunc_normal_ with a
    generator takes seconds for the four ResNet encoders."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                w = m.weight
                fan_in = w.shape[1] * w.shape[2] * w.shape[3]
                std = fan_in ** -0.5 / _TRUNC2_STD
                w.uniform_(-_ERF2, _ERF2, generator=generator)
                w.erfinv_().mul_(std * math.sqrt(2.0))
                w.clamp_(-2 * std, 2 * std)
                if m.bias is not None:
                    m.bias.zero_()
