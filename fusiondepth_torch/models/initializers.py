"""Seeded initialisation of the port's modules.

Convolution kernels get flax's default `lecun_normal`: a normal truncated
at +-2 standard deviations, scaled so that its variance is 1 / fan_in.
Biases are 0 and BatchNorm starts at scale 1, shift 0. The numbers come
from an explicit `torch.Generator` and differ from JAX's for the same
seed: tests that compare the two packages carry the weights across
instead (`models/jax_weights.py`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

# the standard deviation of a unit normal truncated at +-2
_TRUNC2_STD = 0.87962566103423978


def lecun_normal_(module: nn.Module,
                  generator: Optional[torch.Generator] = None) -> None:
    """Re-initialise every nn.Conv2d under `module` in place."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                w = m.weight
                fan_in = w.shape[1] * w.shape[2] * w.shape[3]
                std = fan_in ** -0.5 / _TRUNC2_STD
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
