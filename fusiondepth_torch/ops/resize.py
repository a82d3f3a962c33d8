"""Resizing over the trailing (H, W) axes of NCHW or planes tensors
(counterpart of `fusiondepth_tpu/ops/resize.py`).

- `upsample2x_nearest`: pixel repetition (reference layers.py:229-232);
- `resize_bilinear`: torch F.interpolate(mode='bilinear',
  align_corners=False, antialias=False), two products with static
  interpolation matrices, as the JAX package computes it;
- `resize_antialias`: `jax.image.resize(method='bilinear', antialias=True)`,
  the in-step smoothness pyramid of the photometric loss. Its static
  matrices reproduce JAX's scale-and-translate triangle kernel, normalized
  per output sample; F.interpolate(antialias=True) weighs the borders
  differently;
- `resize_linear_np`: the host-side resize of one (H, W) numpy map with
  OpenCV's cv2.resize(INTER_LINEAR) semantics, where the JAX package calls
  cv2 (GDC, its evaluation and the GDC cache reader).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, 2H, 2W) by pixel repetition."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


@lru_cache(maxsize=64)
def interp_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) bilinear weights, align_corners=False: source coordinate
    (i + 0.5) * src / dst - 0.5, clamped. float32, as the JAX package
    builds it."""
    x = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    x = np.clip(x, 0.0, src - 1.0)
    x0 = np.clip(np.floor(x), 0, max(src - 2, 0)).astype(np.int64)
    w = x - x0
    M = np.zeros((dst, src), np.float32)
    M[np.arange(dst), x0] = 1.0 - w
    M[np.arange(dst), np.minimum(x0 + 1, src - 1)] += w
    return M


@lru_cache(maxsize=64)
def antialias_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) weights of jax.image.resize(bilinear, antialias=True):
    a triangle kernel widened by src / dst when downsampling, weights
    normalized per output sample (jax._src.image.scale.compute_weight_mat),
    in float64."""
    scale = dst / src
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(dst, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(src, dtype=np.float64)[:, None]
               ) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= src - 0.5)
    return np.where(inside[None, :], w, 0).T.copy()


_TENSORS = {}


def _matrix(kind, src: int, dst: int, like: torch.Tensor) -> torch.Tensor:
    """The static matrix as a tensor of `like`'s dtype on its device,
    made once per (kind, sizes, dtype, device)."""
    key = (kind, src, dst, like.dtype, like.device)
    if key not in _TENSORS:
        m = interp_matrix(src, dst) if kind == "bilinear" \
            else antialias_matrix(src, dst)
        _TENSORS[key] = torch.as_tensor(m, dtype=like.dtype,
                                        device=like.device)
    return _TENSORS[key]


def _resize(kind, x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    H, W = x.shape[-2:]
    if (H, W) == (height, width):
        return x
    My = _matrix(kind, H, height, x)   # (h, H)
    Mx = _matrix(kind, W, width, x)    # (w, W)
    return (My @ x) @ Mx.T


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize of (..., H, W) to (..., height, width), torch
    align_corners=False without antialias."""
    return _resize("bilinear", x, height, width)


def resize_linear_np(arr: np.ndarray, height: int, width: int) -> np.ndarray:
    """(H, W) float map -> (height, width) float32, as cv2.resize(arr,
    (width, height), interpolation=cv2.INTER_LINEAR): half-pixel centres,
    source coordinate (i + 0.5) * src / dst - 0.5 clamped to the image, two
    taps per axis, no antialias when shrinking. These are the weights of
    `interp_matrix`; the products run in float64 and round once."""
    arr = np.asarray(arr)
    if arr.ndim != 2:
        raise ValueError(f"resize_linear_np: expected (H, W), got "
                         f"{arr.shape}")
    H, W = arr.shape
    if (H, W) == (height, width):
        return arr.astype(np.float32)
    My = interp_matrix(H, height).astype(np.float64)
    Mx = interp_matrix(W, width).astype(np.float64)
    return (My @ arr.astype(np.float64) @ Mx.T).astype(np.float32)


def resize_antialias(x: torch.Tensor, height: int,
                     width: int) -> torch.Tensor:
    """Antialiased bilinear resize of (..., H, W), as
    jax.image.resize(..., method='bilinear', antialias=True)."""
    return _resize("antialias", x, height, width)
