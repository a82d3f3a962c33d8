"""Loss pieces of the self-supervised objective (counterpart of
`fusiondepth_tpu/ops/losses.py` and `ops/ssim.py`; reference
trainer.py:476-589, layers.py:251-281): static-shape masking by weighted
means instead of boolean indexing, and the per-scale reprojection loss of
the reference formulation (v1_multiscale) in planes layout.

`reprojection_loss` with SSIM on takes the fused reprojection-loss op
(`kernels/reproj.py::reproj_loss`) for a CUDA tensor, and for a CPU one
the formula of the JAX package's ops/ssim.py: the 3x3 means are sums of
the reflect-padded taps divided by 9 in the tensor's dtype, where the
planes op's box3 (the kernel's plain version) scales each separable pass
by float32(1/3) as the JAX planes box3 does. The two agree to float32
rounding; in float64 only the division by 9 matches the JAX package's
v1_multiscale loss to its tests' bounds.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fusiondepth_torch.kernels import reproj as reproj_kernel
from fusiondepth_torch.ops.planes import clip, jabs
from fusiondepth_torch.parallel.collectives import all_reduce_sum

_C1 = 0.01**2
_C2 = 0.03**2


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-pixel, per-channel SSIM loss map clip((1 - SSIM) / 2, 0, 1) of
    x (..., C, H, W) and y of the same shape: reflect padding by 1, 3x3
    means (`fusiondepth_tpu/ops/ssim.py::ssim`)."""
    H, W = x.shape[-2:]
    stacked = torch.stack([x, y, x * x, y * y, x * y]).reshape(-1, 1, H, W)
    m = F.avg_pool2d(F.pad(stacked, (1, 1, 1, 1), mode="reflect"), 3, 1)
    mu_x, mu_y, ex2, ey2, exy = m.reshape((5,) + x.shape)
    sigma_x = ex2 - mu_x * mu_x
    sigma_y = ey2 - mu_y * mu_y
    sigma_xy = exy - mu_x * mu_y
    n = (2 * mu_x * mu_y + _C1) * (2 * sigma_xy + _C2)
    d = (mu_x * mu_x + mu_y * mu_y + _C1) * (sigma_x + sigma_y + _C2)
    return clip((1 - n / d) / 2, 0.0, 1.0)


def reprojection_loss(pred: torch.Tensor, target: torch.Tensor,
                      use_ssim: bool = True) -> torch.Tensor:
    """0.85 * SSIM + 0.15 * L1, channel-meaned, of each warped image
    pred (n, B, C, H, W) against target (B, C, H, W): (n, B, H, W)
    (reference trainer.py:476-488). Differentiable in `pred`."""
    if use_ssim and pred.device.type == "cuda":
        return reproj_kernel.reproj_loss(pred[:, None].contiguous(),
                                         target)[:, 0]
    l1 = jabs(target - pred).mean(dim=-3)
    if not use_ssim:
        return l1
    t = target.expand_as(pred)
    return 0.85 * ssim(pred, t).mean(dim=-3) + 0.15 * l1


def masked_mean(x: torch.Tensor, mask: torch.Tensor,
                eps: float = 1.0) -> torch.Tensor:
    """Mean of x over the entries where mask is nonzero."""
    w = mask.to(x.dtype)
    return (x * w).sum() / torch.clamp(w.sum(), min=eps)


def si_loss(depth: torch.Tensor, ref_depth: torch.Tensor,
            threshold: float = 5.0, si_var: float = 0.3, min_d: float = 1.0,
            max_d: float = 80.0, scale: float = 0.1,
            group=None) -> torch.Tensor:
    """Scale-invariant log loss of depth against sparse ref_depth.

    Valid pixels: ref > min_d, depth in (min_d, max_d), |depth - ref| <
    threshold. loss = sqrt(mean(d^2) - si_var * mean(d)^2) * scale over
    them, d = log(depth) - log(ref); 0 when no pixel is valid. Callers
    apply the reference's metric factor (depth * 26) first. Computed in
    float32 at least (a bfloat16 depth is widened first, as
    `fusiondepth_tpu/ops/losses.py:67-69` does). With a data group
    (`parallel/collectives.py`) the means are over the valid pixels of the
    global batch, as GSPMD computes them over a sharded one
    (`fusiondepth_tpu/ops/losses.py:76-85`): the count and both sums are
    all-reduced before the division and the sqrt (the mean over ranks of
    each rank's SI loss is another loss)."""
    acc = torch.promote_types(torch.promote_types(depth.dtype,
                                                  ref_depth.dtype),
                              torch.float32)
    depth, ref_depth = depth.to(acc), ref_depth.to(acc)
    valid = ((ref_depth > min_d) & (depth < max_d) & (depth > min_d)
             & (torch.abs(depth - ref_depth) < threshold))
    w = valid.to(depth.dtype)
    one = torch.ones((), dtype=depth.dtype, device=depth.device)
    d = torch.log(torch.where(valid, depth, one)) - \
        torch.log(torch.where(valid, ref_depth, one))
    n, sum_d2, sum_d = all_reduce_sum(
        torch.stack([w.sum(), (d * d * w).sum(), (d * w).sum()]),
        group).unbind()
    denom = torch.clamp(n, min=1.0)
    mean_d2 = sum_d2 / denom
    mean_d = sum_d / denom
    var = torch.clamp(mean_d2 - si_var * mean_d * mean_d, min=0.0)
    return torch.where(n > 0, torch.sqrt(var) * scale,
                       torch.zeros_like(var))
