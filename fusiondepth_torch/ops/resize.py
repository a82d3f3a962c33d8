"""Resizing for NCHW tensors."""

from __future__ import annotations

import torch


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, 2H, 2W) by pixel repetition."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
