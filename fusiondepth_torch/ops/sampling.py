"""Bilinear grid sampling (torch F.grid_sample semantics: border padding,
align_corners=False), counterpart of `fusiondepth_tpu/ops/sampling.py`,
in the port's planes layout with a leading axis of sources.

`grid_sample(sources, grids)` samples each source (n, B, C, H, W) at its
normalized coordinates (n, B, H, W, 2) and returns (n, B, C, H, W): one
call of the warp kernel (`ops/warp.py::warp_planes` with one scale) on a
card, its plain version on the CPU. The output has the sources' size, as
every caller's (the per-scale warps of the photometric loss) has.
Gradients flow to the grids only.
"""

from __future__ import annotations

import torch

from fusiondepth_torch.ops.warp import warp_planes


def grid_sample(sources: torch.Tensor, grids: torch.Tensor) -> torch.Tensor:
    """sources (n, B, C, H, W), grids (n, B, H, W, 2) -> (n, B, C, H, W)."""
    if grids.shape[:2] != sources.shape[:2] or \
            grids.shape[2:4] != sources.shape[3:]:
        raise ValueError(f"grids {tuple(grids.shape)} do not fit sources "
                         f"{tuple(sources.shape)}")
    return warp_planes(sources, grids[:, None])[:, 0]
