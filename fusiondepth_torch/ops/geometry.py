"""Backprojection and projection between depth maps and camera space
(reference layers.py:133-226; counterpart of
`fusiondepth_tpu/ops/geometry.py`). Point maps keep the JAX package's
layout, (B, H, W, 3), and pixel coordinates its (B, H, W, 2), which is
also grid_sample's grid layout. The contractions run in full float32."""

from __future__ import annotations

import torch


def pixel_grid(height: int, width: int, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Homogeneous pixel coordinates (H, W, 3): (x, y, 1) per pixel."""
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=dtype, device=device),
        torch.arange(width, dtype=dtype, device=device), indexing="ij")
    return torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)


def backproject_depth(depth: torch.Tensor,
                      inv_K: torch.Tensor) -> torch.Tensor:
    """Depth (B, H, W) or (B, H, W, 1), inv_K (B, 4, 4) -> camera points
    (B, H, W, 3) = depth * inv_K[:3, :3] @ (x, y, 1)."""
    if depth.dim() == 4:
        depth = depth[..., 0]
    B, H, W = depth.shape
    pix = pixel_grid(H, W, depth.dtype, depth.device)
    rays = torch.einsum("bij,hwj->bhwi", inv_K[:, :3, :3].to(depth.dtype),
                        pix)
    return rays * depth[..., None]


def project_3d(points: torch.Tensor, K: torch.Tensor, T: torch.Tensor,
               eps: float = 1e-7) -> torch.Tensor:
    """Camera points (B, H, W, 3) through pose T and intrinsics K (B, 4, 4)
    -> normalized sampling coordinates (B, H, W, 2) in [-1, 1]."""
    B, H, W, _ = points.shape
    P = (K @ T)[:, :3, :].to(points.dtype)
    # the products and the translation summed in float32 at least and
    # rounded once to the points' dtype, as XLA fuses the JAX package's
    # add into its einsum's output: under bfloat16 a rounding of the
    # product alone (~depth x 2^-9) would swamp the translation, the pose's
    # parallax, and with it the depth's gradient
    acc = torch.promote_types(points.dtype, torch.float32)
    cam = (torch.einsum("bij,bhwj->bhwi", P[:, :, :3].to(acc),
                        points.to(acc))
           + P[:, None, None, :, 3].to(acc)).to(points.dtype)
    xy = cam[..., :2] / (cam[..., 2:3] + eps)
    scale = torch.tensor([W - 1, H - 1], dtype=points.dtype,
                         device=points.device)
    return (xy / scale - 0.5) * 2.0


def cat_xy(depth: torch.Tensor, inv_K: torch.Tensor) -> torch.Tensor:
    """Normalized XYZ maps of the refiner's pseudo-3D input (reference
    layers.py:189-201, `fusiondepth_tpu/ops/geometry.py:60-70`): the
    backprojection of backproject_depth, then x / 30, y / 2,
    (z - 40) / 40. depth (B, H, W[, 1]) -> (B, H, W, 3)."""
    pts = backproject_depth(depth, inv_K)
    norm = torch.tensor([30.0, 2.0, 40.0], dtype=pts.dtype,
                        device=pts.device)
    shift = torch.tensor([0.0, 0.0, 40.0], dtype=pts.dtype,
                         device=pts.device)
    return (pts - shift) / norm
