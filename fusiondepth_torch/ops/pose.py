"""Axis-angle pose parameterization -> SE(3) matrices, batched
(reference layers.py:23-97; counterpart of `fusiondepth_tpu/ops/pose.py`).
The matrix products run in full float32 (TF32 is not used for matmuls
unless a caller turns it on)."""

from __future__ import annotations

import torch


def rot_from_axisangle(vec: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle vectors (..., 3) -> rotation matrices
    (..., 4, 4) (eps 1e-7 on the angle norm)."""
    angle = torch.linalg.norm(vec, dim=-1, keepdim=True)
    axis = vec / (angle + 1e-7)
    ca = torch.cos(angle)[..., 0]
    sa = torch.sin(angle)[..., 0]
    C = 1.0 - ca
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    xs, ys, zs = x * sa, y * sa, z * sa
    xC, yC, zC = x * C, y * C, z * C
    xyC, yzC, zxC = x * yC, y * zC, z * xC
    zeros = torch.zeros_like(ca)
    ones = torch.ones_like(ca)
    rot = torch.stack([
        x * xC + ca, xyC - zs, zxC + ys, zeros,
        xyC + zs, y * yC + ca, yzC - xs, zeros,
        zxC - ys, yzC + xs, z * zC + ca, zeros,
        zeros, zeros, zeros, ones,
    ], dim=-1)
    return rot.reshape(vec.shape[:-1] + (4, 4))


def _translation_matrix(t: torch.Tensor) -> torch.Tensor:
    """Translation vectors (..., 3) -> 4x4 matrices."""
    eye = torch.eye(4, dtype=t.dtype, device=t.device)
    eye = eye.expand(t.shape[:-1] + (4, 4))
    col = torch.cat([t, torch.ones_like(t[..., :1])], dim=-1)
    return torch.cat([eye[..., :3], col[..., None]], dim=-1)


def transformation_from_parameters(axisangle: torch.Tensor,
                                   translation: torch.Tensor,
                                   invert: bool = False) -> torch.Tensor:
    """(axisangle (..., 3), translation (..., 3)) -> SE(3) (..., 4, 4).
    invert=False: T @ R; invert=True: R^T @ T(-t)."""
    R = rot_from_axisangle(axisangle)
    t = translation
    if invert:
        R = R.transpose(-1, -2)
        t = -t
    T = _translation_matrix(t)
    return R @ T if invert else T @ R
