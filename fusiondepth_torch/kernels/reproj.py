"""Fused SSIM + L1 reprojection loss of the photometric objective, with its
gradient to the warped images, planes layout.

Kernels: `csrc/reproj.cu`. `reproj_fwd` replaces the TPU kernel
`fusiondepth_tpu/ops/pallas_reproj.py::_fwd`, `reproj_bwd` its `_bwd`.
Per pixel, 0.85 * clip((1 - SSIM) / 2, 0, 1) + 0.15 * |warped - target|,
averaged over C, SSIM over reflect-padded 3x3 box means: the function of
`ops/planes.py::reprojection_loss_planes`, which is the plain version.
Unlike the TPU kernel, which needs H to be a multiple of its 16-row
blocks, the kernels take any H, W >= 2; the forward kernel takes at most
MAX_FWD_CHANNELS channels (the images are RGB). Bound by bytes.

Shapes: warped (n, k, B, C, H, W); target (B, C, H, W); the loss map
(n, k, B, H, W). `reproj_loss` is the differentiable op: the gradient goes
to `warped` only, since the target is an input frame.

bfloat16: every tensor bfloat16, the moments and the SSIM algebra in
float32 inside the kernels (as pallas_reproj.py:87-93), the map and the
warped cotangent rounded once to bfloat16.
"""

from __future__ import annotations

import torch

from fusiondepth_torch.kernels import LAUNCHES, build, check_cuda, \
    entry_dtype, entry_point, launch_key, on_card, wide
from fusiondepth_torch.ops.planes import reprojection_loss_planes

MAX_PLANES = 65535  # n * k * B: the kernels' grid z
MAX_FWD_CHANNELS = 4  # the forward kernel keeps every channel's windows


def reproj_plain(warped: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward: the SSIM + L1 map of
    `ops/planes.py::reprojection_loss_planes`, in float32 for bfloat16
    inputs and rounded once to their dtype."""
    return reprojection_loss_planes(wide(warped), wide(target)[None, None],
                                    True).to(warped.dtype)


def reproj_bwd_plain(warped: torch.Tensor, target: torch.Tensor,
                     g: torch.Tensor) -> torch.Tensor:
    """Plain version of the backward: d warped from the loss map's
    cotangent g (n, k, B, H, W), by autograd through the plain forward."""
    with torch.enable_grad():
        w = warped.detach().requires_grad_(True)
        (dw,) = torch.autograd.grad(reproj_plain(w, target.detach()), w, g)
    return dw


def _check(name, warped, target, max_channels=None):
    if warped.dim() != 6 or target.dim() != 4 or \
            warped.shape[2:] != target.shape or 0 in warped.shape:
        raise ValueError(f"{name}: warped {tuple(warped.shape)} does not fit "
                         f"target {tuple(target.shape)}")
    n, k, B, C, H, W = warped.shape
    if H < 2 or W < 2:
        raise ValueError(f"{name}: reflect padding needs H, W >= 2, got "
                         f"{H}x{W}")
    if n * k * B > MAX_PLANES:
        raise ValueError(f"{name}: {n * k * B} (n, k, B) planes, at most "
                         f"{MAX_PLANES}")
    if max_channels is not None and C > max_channels:
        raise ValueError(f"{name}: {C} channels, the kernel takes at most "
                         f"{max_channels}")
    return n, k, B, C, H, W


def reproj_fwd(warped: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The loss map (n, k, B, H, W). CPU tensors take the plain version;
    CUDA tensors take the kernel (float32 or bfloat16, contiguous)."""
    if warped.device.type == "cpu":
        return reproj_plain(warped, target)
    name = "reproj"
    dt = entry_dtype(name, warped)
    check_cuda(name, dt, warped=warped, target=target)
    n, k, B, C, H, W = _check(name, warped, target, MAX_FWD_CHANNELS)
    out = torch.empty((n, k, B, H, W), device=warped.device, dtype=dt)
    with on_card(warped) as stream:
        build.check(entry_point("fd_reproj_fwd", dt)(
            warped.data_ptr(), target.data_ptr(), out.data_ptr(), n * k, B,
            C, H, W, stream), "fd_reproj_fwd")
    LAUNCHES[launch_key(name, dt)] += 1
    return out


def reproj_bwd(warped: torch.Tensor, target: torch.Tensor,
               g: torch.Tensor) -> torch.Tensor:
    """d warped (n, k, B, C, H, W) from the cotangent g (n, k, B, H, W).
    CPU tensors take the plain version; CUDA tensors take the kernel
    (float32 or bfloat16, contiguous)."""
    if warped.device.type == "cpu":
        return reproj_bwd_plain(warped, target, g)
    name = "reproj_bwd"
    dt = entry_dtype(name, warped)
    check_cuda(name, dt, warped=warped, target=target, g=g)
    n, k, B, C, H, W = _check(name, warped, target)
    if g.shape != (n, k, B, H, W):
        raise ValueError(f"{name}: g {tuple(g.shape)} does not fit")
    dw = torch.empty_like(warped)
    with on_card(warped) as stream:
        build.check(entry_point("fd_reproj_bwd", dt)(
            warped.data_ptr(), target.data_ptr(), g.data_ptr(),
            dw.data_ptr(), n * k, B, C, H, W, stream), "fd_reproj_bwd")
    LAUNCHES[launch_key(name, dt)] += 1
    return dw


class _Reproj(torch.autograd.Function):
    @staticmethod
    def forward(ctx, warped, target):
        if target.requires_grad:
            raise ValueError("reproj_loss: the target gets no gradient (it "
                             "is an input frame); detach it")
        warped, target = warped.contiguous(), target.contiguous()
        ctx.save_for_backward(warped, target)
        return reproj_fwd(warped, target)

    @staticmethod
    def backward(ctx, g):
        warped, target = ctx.saved_tensors
        return reproj_bwd(warped, target, g.contiguous()), None


def reproj_loss(warped: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Differentiable in `warped`; see reproj_fwd and reproj_bwd."""
    return _Reproj.apply(warped, target)
