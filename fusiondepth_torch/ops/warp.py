"""Multi-warp bilinear sampling in planes layout, counterpart of
`fusiondepth_tpu/ops/warp.py`.

`warp_planes(sources, grids)` warps every source frame by every scale's
reprojection grid in one call:
  sources: (n_src, B, C, H, W)
  grids:   (n_src, n_scales, B, H, W, 2) normalized grid_sample coords
  returns: (n_src, n_scales, B, C, H, W)
with border padding and align_corners=False (torch F.grid_sample,
reference trainer.py:467-470). Gradients flow to the grids only.
"""

from __future__ import annotations

import torch

from fusiondepth_torch.kernels import warp as warp_kernel
from fusiondepth_torch.ops.planes import clip

BACKENDS = ("banded", "gather")


def pixel_coords(grids: torch.Tensor, H: int, W: int):
    """Normalized grid coords -> pixel coords (ix, iy), each
    (n, k, B, H, W), clamped to the image (border padding) as
    `fusiondepth_tpu/ops/warp.py:76-77` clips them (the gradient halved on
    the border, `ops/planes.py::clip`), in float32 at least: a
    bfloat16 grid is widened first, as the JAX wrapper casts it (:74-75,
    `ops/pallas_warp.py:485-486`)."""
    grids = grids.to(torch.promote_types(grids.dtype, torch.float32))
    ix = clip(((grids[..., 0] + 1.0) * W - 1.0) * 0.5, 0.0, W - 1)
    iy = clip(((grids[..., 1] + 1.0) * H - 1.0) * 0.5, 0.0, H - 1)
    return ix.contiguous(), iy.contiguous()


def warp_planes(sources: torch.Tensor, grids: torch.Tensor,
                backend: str = "banded") -> torch.Tensor:
    """Warp each source by each grid (shapes above) through the warp
    kernel on a card, its plain version on the CPU. Both of the JAX
    package's TPU backends ("banded", "gather") compute this function and
    select the same kernel here."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown warp backend {backend!r}")
    n, B, C, H, W = sources.shape
    if grids.shape[0] != n or grids.shape[2] != B:
        raise ValueError(f"grids {tuple(grids.shape)} do not fit sources "
                         f"{tuple(sources.shape)}")
    ix, iy = pixel_coords(grids, H, W)
    return warp_kernel.warp(ix, iy, sources.contiguous())


def warp_planes_plain(sources: torch.Tensor,
                      grids: torch.Tensor) -> torch.Tensor:
    """Plain version (`warp_planes_xla`): four corner gathers, differentiable
    by torch's autograd in both the sources and the grids."""
    H, W = sources.shape[-2:]
    ix, iy = pixel_coords(grids, H, W)
    return warp_kernel.warp_plain(ix, iy, sources)
