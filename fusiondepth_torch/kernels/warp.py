"""Bilinear multi-warp of the photometric loss (border padding,
align_corners=False) with its coordinate gradient, planes layout.

Kernels: `csrc/warp.cu`. `warp_fwd` replaces the TPU kernels
`fusiondepth_tpu/ops/pallas_warp.py::_warp_fwd` and
`ops/pallas_warp_gather.py::_warp_gather_fwd`, `warp_bwd` their backwards.
Unlike the TPU kernels, which clamp outside a +-128 px band, the kernel is
exact for every displacement. Bound by bytes.

Shapes: coordinates ix, iy (n_src, n_scales, B, H, W) in pixels, already
clamped to the image (ops/warp.py); sources (n_src, B, C, H, W); output
(n_src, n_scales, B, C, H, W). `warp` is the differentiable op: gradients
flow to the coordinates only, since the sources are input frames.

bfloat16: sources, output and cotangent bfloat16, the coordinates and
their gradients float32 (the JAX package casts the grids to float32 before
its kernel, pallas_warp.py:485-486); the sample is taken in float32 and
rounded once.
"""

from __future__ import annotations

import torch

from fusiondepth_torch.kernels import LAUNCHES, build, check_cuda, \
    entry_dtype, entry_point, launch_key, on_card, wide


def _taps(ix, iy, H, W):
    x0f, y0f = torch.floor(ix), torch.floor(iy)
    wx, wy = (ix - x0f)[:, :, :, None], (iy - y0f)[:, :, :, None]
    x0, y0 = x0f.long(), y0f.long()
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    return x0, y0, x1, y1, wx, wy


def _gather(sources, k, yi, xi):
    """sources (n, B, C, H, W) at flat taps (n, k, B, H, W) ->
    (n, k, B, C, H, W)."""
    n, B, C, H, W = sources.shape
    flat = sources.reshape(n, 1, B, C, H * W).expand(n, k, B, C, H * W)
    idx = (yi * W + xi).reshape(n, k, B, 1, H * W).expand(n, k, B, C, H * W)
    return torch.gather(flat, 4, idx).reshape(n, k, B, C, H, W)


def _corners(ix, iy, sources):
    H, W = sources.shape[-2:]
    k = ix.shape[1]
    x0, y0, x1, y1, wx, wy = _taps(ix, iy, H, W)
    v = [wide(_gather(sources, k, yi, xi))
         for yi, xi in ((y0, x0), (y0, x1), (y1, x0), (y1, x1))]
    return v, wx, wy


def warp_plain(ix: torch.Tensor, iy: torch.Tensor,
               sources: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward: four corner gathers per output pixel,
    the taps and weights of
    `fusiondepth_tpu/ops/warp.py::warp_planes_xla`, in float32 for
    bfloat16 sources and rounded once to their dtype."""
    (v00, v01, v10, v11), wx, wy = _corners(ix, iy, sources)
    return (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
            + v10 * (1 - wx) * wy + v11 * wx * wy).to(sources.dtype)


def warp_bwd_plain(ix: torch.Tensor, iy: torch.Tensor, sources: torch.Tensor,
                   g: torch.Tensor):
    """Plain version of the backward: (d ix, d iy), the cotangent g
    (n, k, B, C, H, W) times the derivative of the bilinear sample in x and
    in y, summed over C (in float32 for a bfloat16 g and sources)."""
    (v00, v01, v10, v11), wx, wy = _corners(ix, iy, sources)
    g = wide(g)
    gix = (g * ((v01 - v00) * (1 - wy) + (v11 - v10) * wy)).sum(3)
    giy = (g * ((v10 - v00) * (1 - wx) + (v11 - v01) * wx)).sum(3)
    return gix, giy


def _check(name, ix, iy, sources):
    if sources.dim() != 5 or ix.dim() != 5 or ix.shape != iy.shape or \
            ix.shape[0] != sources.shape[0] or \
            ix.shape[2] != sources.shape[1] or \
            ix.shape[3:] != sources.shape[3:] or 0 in ix.shape:
        raise ValueError(f"{name}: coordinates {tuple(ix.shape)} do not fit "
                         f"sources {tuple(sources.shape)}")
    N, K, B, H, W = ix.shape
    return N, K, B, sources.shape[2], H, W


def warp_fwd(ix: torch.Tensor, iy: torch.Tensor,
             sources: torch.Tensor) -> torch.Tensor:
    """The warped sources (n, k, B, C, H, W). CPU tensors take the plain
    version; CUDA tensors take the kernel (float32 coordinates, float32 or
    bfloat16 sources, contiguous)."""
    if ix.device.type == "cpu":
        return warp_plain(ix, iy, sources)
    name = "warp"
    dt = entry_dtype(name, sources)
    check_cuda(name, dt, ix=(ix, torch.float32), iy=(iy, torch.float32),
               sources=sources)
    N, K, B, C, H, W = _check(name, ix, iy, sources)
    out = torch.empty((N, K, B, C, H, W), device=ix.device, dtype=dt)
    with on_card(ix) as stream:
        build.check(entry_point("fd_warp_fwd", dt)(
            ix.data_ptr(), iy.data_ptr(), sources.data_ptr(), out.data_ptr(),
            N, K, B, C, H, W, stream), "fd_warp_fwd")
    LAUNCHES[launch_key(name, dt)] += 1
    return out


def warp_bwd(ix: torch.Tensor, iy: torch.Tensor, sources: torch.Tensor,
             g: torch.Tensor):
    """(d ix, d iy), each (n, k, B, H, W), from the cotangent g
    (n, k, B, C, H, W). CPU tensors take the plain version; CUDA tensors
    take the kernel (float32 coordinates, g and sources float32 or
    bfloat16, contiguous)."""
    if ix.device.type == "cpu":
        return warp_bwd_plain(ix, iy, sources, g)
    name = "warp_bwd"
    dt = entry_dtype(name, sources)
    check_cuda(name, dt, ix=(ix, torch.float32), iy=(iy, torch.float32),
               sources=sources, g=g)
    N, K, B, C, H, W = _check(name, ix, iy, sources)
    if g.shape != (N, K, B, C, H, W):
        raise ValueError(f"{name}: g {tuple(g.shape)} does not fit")
    gix = torch.empty_like(ix)
    giy = torch.empty_like(iy)
    with on_card(ix) as stream:
        build.check(entry_point("fd_warp_bwd", dt)(
            ix.data_ptr(), iy.data_ptr(), sources.data_ptr(), g.data_ptr(),
            gix.data_ptr(), giy.data_ptr(), N, K, B, C, H, W, stream),
            "fd_warp_bwd")
    LAUNCHES[launch_key(name, dt)] += 1
    return gix, giy


class _Warp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ix, iy, sources):
        if sources.requires_grad:
            raise ValueError("warp: the sources get no gradient (they are "
                             "input frames); detach them")
        ctx.save_for_backward(ix, iy, sources)
        return warp_fwd(ix, iy, sources)

    @staticmethod
    def backward(ctx, g):
        ix, iy, sources = ctx.saved_tensors
        gix, giy = warp_bwd(ix, iy, sources, g.contiguous())
        return gix, giy, None


def warp(ix: torch.Tensor, iy: torch.Tensor,
         sources: torch.Tensor) -> torch.Tensor:
    """Differentiable in ix and iy; see warp_fwd and warp_bwd."""
    return _Warp.apply(ix, iy, sources)
