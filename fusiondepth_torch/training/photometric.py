"""The self-supervised photometric objective: view synthesis + automask +
smoothness + scale-invariant LiDAR loss (reference trainer.py:425-596).

Counterpart of the planes formulation of
`fusiondepth_tpu/training/photometric.py` (`_generate_images_pred_planes`,
`_compute_losses_planes`): every full-resolution map is (candidates...,
B, C, H, W); the 8 (frame, scale) warps run as one call of the warp
kernel; the identity reprojection is computed once (it is
scale-invariant at full-res warping, reference trainer.py:515-528); the
per-pixel automask min runs over a leading candidate axis. With SSIM on,
the SSIM + L1 maps come from the fused reprojection-loss op
(`kernels/reproj.py`), whatever `pallas_reproj` says: the JAX package
gates its Pallas kernel behind that flag because the kernel needs H to be
a multiple of 16 (photometric.py:218-237), and the CUDA kernel takes any
H, W >= 2. The op's plain version, which CPU tensors take, is
`ops/planes.py::reprojection_loss_planes`; with no_ssim the L1 maps come
from it directly.

Not ported yet, and refused with NotImplementedError rather than computed
some other way: the v1_multiscale reference formulation, predictive_mask
and use_stereo.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from fusiondepth_torch.config import Config
from fusiondepth_torch.kernels import reproj as reproj_kernel
from fusiondepth_torch.ops.depth import disp_to_depth
from fusiondepth_torch.ops.geometry import backproject_depth, project_3d
from fusiondepth_torch.ops.losses import si_loss
from fusiondepth_torch.ops.planes import (
    normalized_smoothness_planes,
    reprojection_loss_planes,
    resize_planes,
    to_planes,
)
from fusiondepth_torch.ops.resize import resize_antialias
from fusiondepth_torch.ops.warp import warp_planes


def check_supported(cfg: Config) -> None:
    """Raise NotImplementedError for the loss options the port lacks."""
    unported = [f for f in ("v1_multiscale", "predictive_mask",
                            "use_stereo")
                if getattr(cfg, f)]
    if unported:
        raise NotImplementedError(
            f"{', '.join(unported)}: not ported to fusiondepth_torch yet; "
            "use the JAX package's trainer")


def build_color_pyramid(cfg: Config,
                        target_p: torch.Tensor) -> Dict[int, torch.Tensor]:
    """Frame-0 color (B, C, H, W) at each scale for the smoothness
    guidance: the in-step antialiased bilinear resize of
    `photometric._pyramid_planes`."""
    B, C, H, W = target_p.shape
    return {s: target_p if s == 0 else
            resize_antialias(target_p, H // 2**s, W // 2**s)
            for s in cfg.scales}


def generate_images_pred(cfg: Config, batch: Dict[str, torch.Tensor],
                         outputs: Dict[Any, Any]) -> Dict[Any, Any]:
    """Warp each source frame into frame 0's view at every scale (reference
    trainer.py:425-474, full-res warping). Adds ("depth", 0, s) (B, H, W),
    ("sample", f, s) (B, H, W, 2), and the planes tensors the loss reads:
    "warped_planes" (n, k, B, 3, H, W), "sources_planes" (n, B, 3, H, W),
    "target_planes" (B, 3, H, W)."""
    check_supported(cfg)
    fid = {f: i for i, f in enumerate(cfg.frame_ids)}
    H, W = cfg.height, cfg.width
    src_frames = list(cfg.frame_ids[1:])
    K, inv_K = batch["K"], batch["inv_K"]
    grids = {}
    for scale in cfg.scales:
        disp = resize_planes(outputs[("disp", scale)][..., 0], H, W)
        _, depth = disp_to_depth(disp, cfg.min_depth, cfg.max_depth)
        outputs[("depth", 0, scale)] = depth
        cam_points = backproject_depth(depth, inv_K)
        for f in src_frames:
            pix = project_3d(cam_points, K, outputs[("cam_T_cam", 0, f)])
            outputs[("sample", f, scale)] = pix
            grids[f, scale] = pix
    grid_stack = torch.stack([torch.stack([grids[f, s] for s in cfg.scales])
                              for f in src_frames])
    dtype = outputs[("disp", 0)].dtype
    sources_p = torch.stack([to_planes(batch["color"][:, fid[f]])
                             for f in src_frames]).to(dtype).contiguous()
    target_p = to_planes(batch["color"][:, 0]).to(dtype)
    warped = warp_planes(sources_p, grid_stack,
                         backend=cfg.pallas_warp_backend)
    outputs["warped_planes"] = warped
    outputs["sources_planes"] = sources_p
    outputs["target_planes"] = target_p
    return outputs


def reprojection_maps(warped: torch.Tensor, sources_p: torch.Tensor,
                      target_p: torch.Tensor, use_ssim: bool, automask: bool
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The reprojection loss maps of the warps, (n, k, B, H, W), and with
    `automask` those of the unwarped sources, (n, B, H, W): the fused op
    with SSIM on, the L1 planes op without."""
    if use_ssim:
        reproj_maps = reproj_kernel.reproj_loss(warped, target_p)
        identity_maps = reproj_kernel.reproj_loss(
            sources_p[:, None], target_p)[:, 0] if automask else None
    else:
        reproj_maps = reprojection_loss_planes(warped, target_p[None, None],
                                               False)
        identity_maps = reprojection_loss_planes(
            sources_p, target_p[None], False) if automask else None
    return reproj_maps, identity_maps


def compute_losses(cfg: Config, batch: Dict[str, torch.Tensor],
                   outputs: Dict[Any, Any],
                   noise: Optional[Sequence[torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
    """Multi-scale photometric + automask + smoothness + SI loss
    (reference trainer.py:490-596). The automask tie-break noise added to
    the identity losses at each scale is `noise[i]` for scale i when given
    (so a test can replay the JAX package's draws), else 1e-5 * N(0, 1)
    drawn from `generator` (reference trainer.py:549-551)."""
    check_supported(cfg)
    losses: Dict[str, torch.Tensor] = {}
    H, W = cfg.height, cfg.width
    automask = not cfg.disable_automasking
    use_ssim = not cfg.no_ssim
    warped = outputs["warped_planes"]
    sources_p = outputs["sources_planes"]
    target_p = outputs["target_planes"]

    reproj_maps, identity_maps = reprojection_maps(
        warped, sources_p, target_p, use_ssim, automask)
    pyr = build_color_pyramid(cfg, target_p)

    total = 0.0
    for si, scale in enumerate(cfg.scales):
        reproj = reproj_maps[:, si]
        if automask:
            identity = identity_maps
            if cfg.avg_reprojection:
                identity = identity.mean(dim=0, keepdim=True)
            if noise is not None:
                n = noise[si].to(identity.dtype)
            else:
                n = torch.randn(identity.shape, generator=generator,
                                device=identity.device,
                                dtype=identity.dtype) * 1e-5
            identity = identity + n
        if cfg.avg_reprojection:
            reproj = reproj.mean(dim=0, keepdim=True)
        combined = torch.cat([identity, reproj], 0) if automask else reproj
        # amin splits the gradient among tied minima, as jnp.min does
        to_optimise = combined[0] if combined.shape[0] == 1 \
            else combined.amin(dim=0)
        loss = to_optimise.mean()

        disp = outputs[("disp", scale)][..., 0]                # (B, Hs, Ws)
        smooth = normalized_smoothness_planes(disp, pyr[scale])
        loss = loss + cfg.disparity_smoothness * smooth / (2.0**scale)
        total = total + loss
        losses[f"loss/{scale}"] = loss

        if cfg.trainer_siloss and (cfg.trainer_siloss_all_scale
                                   or scale == 0):
            _, depth = disp_to_depth(resize_planes(disp, H, W),
                                     cfg.min_depth, cfg.max_depth)
            beam_depth = batch["four_beam"][..., 0] * 100.0
            # hard-coded metric scale (reference trainer.py:583)
            si = si_loss(depth * 26.0, beam_depth,
                         threshold=cfg.gdc_loss_threshold, si_var=cfg.si_var)
            total = total + si
            losses[f"loss/si_loss{scale}"] = si

    losses["loss"] = total / cfg.num_scales
    return losses
