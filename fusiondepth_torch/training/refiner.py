"""Stage 2: the refiner, which distils the offline GDC correction into a
feed-forward pseudo-3D refine decoder (counterpart of
`fusiondepth_tpu/training/refiner.py`; reference refiner.py:25-693 with
clone_gdc=True, refine_2d=True).

- The stage-1 nets (encoder, beam encoder, depth decoder, pose nets) are
  frozen: eval-mode BatchNorm, no gradient. With train_entire_net they
  take gradients (through the features, the poses and the pseudo-3D
  maps) and train with the refine decoder, their BatchNorm still in eval
  mode with its running statistics fixed (reference refiner.py:89-143).
- Per scale, a pseudo-3D input is built from the stage-1 disparity:
  median-ratio scaling to the 4-beam LiDAR inside the crop [78:190,
  23:617] (one ratio over the whole batch, no gradient through it), the
  re-normalized disparity (1/d - 0.01) / 9.9, the Cat_xy XYZ maps with
  per-scale intrinsics, and the 2-channel LiDAR (refiner.py:316-346).
- The trainable refine2d decoder (DepthDecoder with road, catxy, deep)
  takes the encoder and beam features and these maps.
- The loss is the stage-1 photometric / automask / smoothness objective on
  the refined disparities (the same reprojection maps as stage 1's
  `photometric.reprojection_maps`: the fused op, where the JAX package
  takes its unfused planes ops, the same function) plus a GDC-cloning SI
  loss against the cached inf_gdc depths (weight 0.008, x4 when on scale
  0 only, SI factor 10), over refine_iter gamma-weighted passes.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from fusiondepth_torch.config import Config
from fusiondepth_torch.models.depth_decoder import DepthDecoder
from fusiondepth_torch.models.fusion import FusionNets, model_dtype, \
    refuse_bf16
from fusiondepth_torch.models.resnet import RESNET_FEATURE_CHANNELS
from fusiondepth_torch.ops.depth import disp_to_depth
from fusiondepth_torch.ops.geometry import cat_xy
from fusiondepth_torch.ops.planes import (
    normalized_smoothness_planes,
    resize_planes,
)
from fusiondepth_torch.ops.pooling import masked_median, max_pool2x2_ceil
from fusiondepth_torch.training.photometric import (
    build_color_pyramid,
    generate_images_pred,
    reprojection_maps,
)

# the reference's 192x640-space crop window for median scaling
# (refiner.py:330-331, "375 1242" comment)
CROP = (78, 190, 23, 617)

# what the refiner's step reads from a batch (stereo_T for the frame "s")
REFINE_KEYS = ("color", "color_aug", "two_channel", "four_beam", "K",
               "inv_K", "inf_gdc", "stereo_T")


def crop_window(height: int, width: int):
    """The median-scaling crop, scaled proportionally from its 192x640
    definition (identical values at the reference resolution)."""
    r0, r1, c0, c1 = CROP
    return (int(r0 / 192 * height), int(r1 / 192 * height),
            int(c0 / 640 * width), int(c1 / 640 * width))


def refiner_si_loss(pred: torch.Tensor, target: torch.Tensor,
                    threshold: float, si_var: float) -> torch.Tensor:
    """SI loss with the refiner's constants (refiner.py:557-563):
    valid = target > 1e-3 & 1e-3 < pred < 80 & |pred - target| < threshold;
    sqrt(mean(d^2) - si_var mean(d)^2) * 10, d = log pred - log target,
    over the valid pixels; 0 when none is valid."""
    valid = ((target > 1e-3) & (pred < 80) & (pred > 1e-3)
             & (torch.abs(pred - target) < threshold))
    w = valid.to(pred.dtype)
    total = w.sum()
    n = torch.clamp(total, min=1.0)
    one = torch.ones((), dtype=pred.dtype, device=pred.device)
    d = torch.log(torch.where(valid, pred, one)) - \
        torch.log(torch.where(valid, target.to(pred.dtype), one))
    m2 = (d * d * w).sum() / n
    m1 = (d * w).sum() / n
    var = torch.clamp(m2 - si_var * m1 * m1, min=0.0)
    return torch.where(total > 0, torch.sqrt(var) * 10.0,
                       torch.zeros_like(var))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class RefinerNets(nn.Module):
    """The stage-1 bundle (`stage1`, frozen unless cfg.train_entire_net)
    and the trainable `refine2d` decoder, on `device`, initialised from
    `generator`."""

    def __init__(self, cfg: Config, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        refuse_bf16(cfg, "the refiner")
        self.cfg = cfg
        self.stage1 = FusionNets(cfg, device=device, generator=generator)
        self.stage1.requires_grad_(cfg.train_entire_net)
        self.refine2d = DepthDecoder(
            RESNET_FEATURE_CHANNELS[cfg.num_layers], scales=cfg.scales,
            road=True, catxy=cfg.catxy, deep=cfg.refine2d_deep,
            tanh_head=cfg.refine_offset, generator=generator)
        self.refine2d.to(device=device, dtype=model_dtype(cfg))

    def frozen_forward(self, batch: Dict[str, torch.Tensor],
                       poses: bool = True
                       ) -> Tuple[Dict[Any, Any], List[torch.Tensor],
                                  Optional[List[torch.Tensor]]]:
        """The stage-1 forward of the refiner (eval-mode BN; no gradient
        unless cfg.train_entire_net): (outputs, feats, beam_feats).
        outputs holds the NHWC disparities of the depth decoder (fed the
        beam features only with refine_depthnet_with_beam) and, with
        `poses`, the poses."""
        cfg, s1 = self.cfg, self.stage1
        s1.eval()
        with torch.set_grad_enabled(cfg.train_entire_net
                                    and torch.is_grad_enabled()):
            feats = s1.encoder(_nchw(batch["color_aug"][:, 0]))
            beam_feats = None
            if s1.beam_encoder is not None:
                beam_feats = s1.beam_encoder(
                    _nchw(batch["two_channel"][:, 0]))
            out = s1.depth(feats, beam_features=(
                beam_feats if cfg.refine_depthnet_with_beam else None))
            outputs = {k: _nhwc(v) for k, v in out.items()}
            if poses:
                outputs.update(s1.predict_poses(batch))
        return outputs, feats, beam_feats

    def build_pseudo3d(self, batch: Dict[str, torch.Tensor],
                       outputs: Dict[Any, torch.Tensor]
                       ) -> Dict[Any, torch.Tensor]:
        """{("disp", s): (B, H/2^s, W/2^s, 1 + 3 + 2)} NHWC: the rescaled
        disparity, the XYZ maps (catxy) and the 2-channel LiDAR
        (refiner.py:316-346). A gradient of the maps reaches the stage-1
        disparities (under train_entire_net) through the rescaled
        disparity and the XYZ maps, not through the median ratio, as in
        the JAX package (its stop_gradient, refiner.py:139)."""
        cfg = self.cfg
        H, W = cfg.height, cfg.width
        beam = batch["four_beam"]
        two_cha = batch["two_channel"][:, 0]
        disp_0 = outputs[("disp", 0)]

        r0, r1, c0, c1 = crop_window(H, W)
        crop = torch.zeros((1, H, W, 1), dtype=torch.bool, device=beam.device)
        crop[:, r0:r1, c0:c1] = True
        beam_mask = (beam > 0) & crop

        maps = {}
        for scale in cfg.scales:
            if cfg.refine_a0:
                disp = disp_0
                disp_0 = max_pool2x2_ceil(disp_0)
            else:
                disp = outputs[("disp", scale)]
            hs, ws = disp.shape[1], disp.shape[2]
            disp_full = resize_planes(disp[..., 0], H, W)[..., None]
            _, depth = disp_to_depth(disp_full, cfg.min_depth, cfg.max_depth)

            med_beam = masked_median(beam * 100.0, beam_mask)
            med_depth = masked_median(depth.detach(), beam_mask)
            ratio = med_beam / torch.clamp(med_depth, min=1e-6)
            # no beam returns in the crop -> keep depths unscaled
            ratio = torch.where(torch.isfinite(ratio), ratio,
                                torch.ones_like(ratio))
            depth = depth * ratio
            scaled_disp = (resize_planes((1.0 / depth)[..., 0], hs, ws)
                           - 0.01) / 9.9

            if scale != 0:
                two_cha = max_pool2x2_ceil(two_cha)
            parts = [scaled_disp[..., None]]
            if cfg.catxy:
                d = depth
                for _ in range(scale):
                    d = max_pool2x2_ceil(d)
                # per-scale intrinsics: K's u and v rows scaled to this
                # level, then inverted (reference mono_dataset.py:166-175)
                K_s = batch["K"].clone()
                K_s[:, 0, :] *= ws / W
                K_s[:, 1, :] *= hs / H
                parts.append(cat_xy(d, torch.linalg.inv(K_s)))
            parts.append(two_cha)
            maps[("disp", scale)] = torch.cat(parts, dim=-1)
        return maps

    def refine(self, feats: Sequence[torch.Tensor],
               beam_feats: Optional[Sequence[torch.Tensor]],
               depth_maps: Dict[Any, torch.Tensor]) -> Dict[Any, torch.Tensor]:
        """The refine2d decoder on the frozen features and the NHWC
        pseudo-3D maps; returns NHWC disparities."""
        out = self.refine2d(feats, beam_features=beam_feats,
                            depth_maps={k: _nchw(v)
                                        for k, v in depth_maps.items()})
        return {k: _nhwc(v) for k, v in out.items()}


def _refine_losses(cfg: Config, batch: Dict[str, torch.Tensor],
                   outputs: Dict[Any, Any],
                   noise: Optional[Sequence[torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None):
    """Photometric / automask / smoothness + GDC-clone SI loss of one pass
    (reference refiner.py:592-693, the JAX package's `_refine_losses`),
    planes layout. The automask noise at scale i is `noise[i]` when given,
    else 1e-5 * N(0, 1) from `generator`."""
    H, W = cfg.height, cfg.width
    total = 0.0
    metrics: Dict[str, torch.Tensor] = {}
    warped = outputs["warped_planes"]
    sources_p = outputs["sources_planes"]
    target_p = outputs["target_planes"]
    use_ssim = not cfg.no_ssim
    automask = not cfg.disable_automasking

    reproj_maps, identity_maps = reprojection_maps(
        warped, sources_p, target_p, use_ssim, automask)
    pyr = build_color_pyramid(cfg, target_p)

    for si, scale in enumerate(cfg.scales):
        disp = outputs[("disp", scale)][..., 0]
        reproj = reproj_maps[:, si]
        if automask:
            if noise is not None:
                n = noise[si].to(identity_maps.dtype)
            else:
                n = torch.randn(identity_maps.shape, generator=generator,
                                device=identity_maps.device,
                                dtype=identity_maps.dtype) * 1e-5
            combined = torch.cat([identity_maps + n, reproj], 0)
        else:
            combined = reproj
        to_optimise = combined[0] if combined.shape[0] == 1 \
            else combined.amin(dim=0)
        loss = to_optimise.mean()
        smooth = normalized_smoothness_planes(disp, pyr[scale])
        loss = loss + cfg.disparity_smoothness * smooth / (2.0**scale)
        total = total + loss
        metrics[f"loss/scale{scale}"] = loss

        if (not cfg.gdc_loss_only_on_scale_0) or scale == 0:
            gdc_out = batch["inf_gdc"][..., 0]
            _, depth = disp_to_depth(resize_planes(disp, H, W),
                                     cfg.min_depth, cfg.max_depth)
            gdc_loss = refiner_si_loss(depth, gdc_out, cfg.gdc_loss_threshold,
                                       cfg.si_var) * cfg.gdc_loss_weight
            if cfg.gdc_loss_only_on_scale_0:
                gdc_loss = gdc_loss * 4.0
            total = total + gdc_loss
            metrics[f"loss/gdc_scale{scale}"] = gdc_loss
    return total / cfg.num_scales, metrics


def refine_loss(cfg: Config, nets: RefinerNets,
                batch: Dict[str, torch.Tensor],
                noise: Optional[Sequence[Sequence[torch.Tensor]]] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, losses) of one refine batch (the JAX package's
    `make_refine_loss_fn`): the stage-1 forward and the pseudo-3D maps
    (without gradient unless cfg.train_entire_net), then refine_iter
    passes of the refine decoder,
    each pass's loss weighted by refine_iter_gama ** (n_iter - it).
    `noise[it][i]` replays the automask noise of pass it at scale i."""
    outputs, feats, beam_feats = nets.frozen_forward(batch)
    depth_maps = nets.build_pseudo3d(batch, outputs)
    total = 0.0
    losses: Dict[str, torch.Tensor] = {}
    n_iter = max(cfg.refine_iter, 1)
    gama_base = 1.0 if n_iter == 1 else cfg.refine_iter_gama
    for it in range(n_iter):
        refined = nets.refine(feats, beam_feats, depth_maps)
        for i in cfg.scales:
            outputs[("disp", i)] = refined[("disp", i)]
        outputs = generate_images_pred(cfg, batch, outputs)
        iter_loss, metrics = _refine_losses(
            cfg, batch, outputs, None if noise is None else noise[it],
            generator)
        total = total + iter_loss * gama_base ** (n_iter - it)
        for k, v in metrics.items():
            losses[f"iter{it}/{k}"] = v
    losses["loss"] = total
    return total, losses
