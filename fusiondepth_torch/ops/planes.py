"""Photometric-loss building blocks in planes layout, (..., H, W)
(counterpart of `fusiondepth_tpu/ops/planes.py`; reference layers.py:
235-281 and trainer.py:476-488).

Planes are NCHW with any number of leading candidate axes, so the port's
NCHW tensors are planes already; `to_planes`/`from_planes` are the permutes
to and from the JAX package's NHWC.

`box3`, the reflect-padded 3x3 mean of SSIM, is two separable 3-tap sums,
each scaled by float32(1/3): the value the JAX package's banded
(H, H) / (W, W) matrices hold, so the two agree to summation order. On a
bfloat16 map it follows the JAX box3 at Precision.DEFAULT: the taps times
bfloat16(1/3), summed in float32 and rounded to bfloat16 after each pass.

The kinks take the JAX package's derivatives, which differ from torch's
where an argument sits exactly on one: |x| (`jabs`) has jnp.abs's
derivative +1 at 0 (torch.abs: 0), and the SSIM clip (`clip`) jnp.clip's,
halved on a bound (torch.clamp: all of it). Such ties are common under
bfloat16: warped and target pixels, or neighbouring disparities, that
round to the same bf16 value.

Under compute_dtype="bfloat16" the means that reduce a map to a number
accumulate in float32 and return float32 (`fusiondepth_tpu/ops/planes.py:
150-163`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from fusiondepth_torch.ops.resize import resize_bilinear

_C1 = 0.01**2
_C2 = 0.03**2
_THIRD = float(np.float32(1.0 / 3.0))
_THIRD_BF16 = float(torch.tensor(1.0 / 3.0, dtype=torch.bfloat16))


def _acc(t: torch.Tensor) -> torch.dtype:
    """The dtype a mean over t accumulates in: float32 at least."""
    return torch.promote_types(t.dtype, torch.float32)


def jabs(x: torch.Tensor) -> torch.Tensor:
    """|x| whose derivative at 0 is +1, as jnp.abs's (select(x >= 0))."""
    return torch.where(x >= 0, x, -x)


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip: min(max(x, lo), hi), whose gradient on a bound is halved
    (torch.maximum and jnp.maximum split a tie)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)),
                         x.new_tensor(hi))


def to_planes(nhwc: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) -> (..., C, H, W)."""
    return torch.movedim(nhwc, -1, -3)


def from_planes(planes: torch.Tensor) -> torch.Tensor:
    """(..., C, H, W) -> (..., H, W, C)."""
    return torch.movedim(planes, -3, -1)


def box3(x: torch.Tensor) -> torch.Tensor:
    """3x3 reflect-boundary box mean over the trailing (H, W) axes."""
    H, W = x.shape[-2:]
    p = F.pad(x.reshape(1, -1, H, W), (1, 1, 1, 1), mode="reflect")
    if x.dtype == torch.bfloat16:
        p = p.float() * _THIRD_BF16
        v = (p[..., :-2, :] + p[..., 1:-1, :] + p[..., 2:, :]).to(x.dtype)
        v = v.float() * _THIRD_BF16
        y = (v[..., :-2] + v[..., 1:-1] + v[..., 2:]).to(x.dtype)
        return y.reshape(x.shape)
    v = (p[..., :-2, :] + p[..., 1:-1, :] + p[..., 2:, :]) * _THIRD
    y = (v[..., :-2] + v[..., 1:-1] + v[..., 2:]) * _THIRD
    return y.reshape(x.shape)


def ssim_planes(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-pixel, per-channel SSIM loss map clip((1 - SSIM) / 2, 0, 1).
    pred (..., C, H, W); target broadcastable to it with fewer leading
    axes: its statistics are computed once and broadcast."""
    pt = pred * target
    mu_x, ex2, exy = box3(pred), box3(pred * pred), box3(pt)
    mu_y, ey2 = box3(target), box3(target * target)
    sigma_x = ex2 - mu_x * mu_x
    sigma_y = ey2 - mu_y * mu_y
    sigma_xy = exy - mu_x * mu_y
    n = (2 * mu_x * mu_y + _C1) * (2 * sigma_xy + _C2)
    d = (mu_x * mu_x + mu_y * mu_y + _C1) * (sigma_x + sigma_y + _C2)
    return clip((1 - n / d) / 2, 0.0, 1.0)


def reprojection_loss_planes(pred: torch.Tensor, target: torch.Tensor,
                             use_ssim: bool = True) -> torch.Tensor:
    """0.85 * SSIM + 0.15 * L1, channel-meaned: (..., C, H, W) ->
    (..., H, W)."""
    l1 = jabs(target - pred).mean(dim=-3)
    if not use_ssim:
        return l1
    return 0.85 * ssim_planes(pred, target).mean(dim=-3) + 0.15 * l1


def resize_planes(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize (align_corners=False, no antialias) of the trailing
    (H, W) axes."""
    return resize_bilinear(x, height, width)


def smoothness_planes(disp: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Edge-aware first-order smoothness; disp (..., H, W), img
    (..., C, H, W). Scalar."""
    gdx = jabs(disp[..., :, :-1] - disp[..., :, 1:])
    gdy = jabs(disp[..., :-1, :] - disp[..., 1:, :])
    gix = jabs(img[..., :, :-1] - img[..., :, 1:]).mean(-3)
    giy = jabs(img[..., :-1, :] - img[..., 1:, :]).mean(-3)
    acc = _acc(gdx)
    return ((gdx * torch.exp(-gix)).mean(dtype=acc)
            + (gdy * torch.exp(-giy)).mean(dtype=acc))


def normalized_smoothness_planes(disp: torch.Tensor,
                                 color: torch.Tensor) -> torch.Tensor:
    """Mean-normalized disparity smoothness (reference trainer.py:566-571)."""
    mean_disp = disp.mean(dim=(-2, -1), keepdim=True,
                          dtype=_acc(disp)).to(disp.dtype)
    return smoothness_planes(disp / (mean_disp + 1e-7), color)
