"""The self-supervised photometric objective: view synthesis + automask +
smoothness + scale-invariant LiDAR loss (reference trainer.py:425-596).

Counterpart of `fusiondepth_tpu/training/photometric.py`, in its two
formulations, dispatched on cfg.v1_multiscale as there:

- PLANES (`_generate_images_pred_planes`, `_compute_losses_planes`):
  every full-resolution map is (candidates..., B, C, H, W); the (frame,
  scale) warps run as one call of the warp kernel; the identity
  reprojection is computed once (it is scale-invariant at full-res
  warping, reference trainer.py:515-528); the per-pixel automask min runs
  over a leading candidate axis.
- REFERENCE (`generate_images_pred_reference`,
  `compute_losses_reference`): the reference's per-scale loop under
  v1_multiscale: each scale warps and scores at its own resolution,
  with K scaled to it and the frames resized to it. The JAX package
  computes it with `ops/sampling.py::grid_sample` and `ops/ssim.py`; here
  each scale's warps are one call of the same warp kernel
  (`ops/sampling.py`) and its maps one call of the same reprojection-loss
  op, since they compute the same functions. The maps stay in planes
  layout, (frames, B, H_s, W_s), where the JAX package concatenates them
  on a trailing axis. On the CPU the maps follow ops/ssim.py's formula
  (`ops/losses.py::reprojection_loss`), which the f64 tests hold at the
  JAX package's bounds.

With SSIM on, the SSIM + L1 maps come from the fused reprojection-loss op
(`kernels/reproj.py`), whatever `pallas_reproj` says: the JAX package
gates its Pallas kernel behind that flag because the kernel needs H to be
a multiple of 16 (photometric.py:218-237), and the CUDA kernel takes any
H, W >= 2. The op's plain version, which CPU tensors take, is
`ops/planes.py::reprojection_loss_planes`; with no_ssim the L1 maps come
from it directly.

The source frames are cfg.frame_ids[1:]: the temporal ones, warped by the
predicted poses, and under use_stereo "s", warped by batch["stereo_T"].
With the posecnn pose type the translation is rescaled by the mean
inverse depth (reference trainer.py:440-459). With predictive_mask (which
needs disable_automasking) the learned mask weights the reprojection maps
and 0.2 x its BCE toward 1 joins the loss (reference trainer.py:531-545).

Under data parallelism (`group`, a data group of W ranks, each holding
an equal W-th of the global batch or microbatch) the loss is the JAX
meshed step's, whose batch-axis means GSPMD takes over the global batch:
- the SI loss is over the valid pixels of the global batch
  (`ops/losses.py::si_loss` all-reduces its count and sums);
- the automask tie-break noise is drawn at the global batch's shape from
  the generator every rank seeds alike (or replayed at that shape), and
  each rank takes its own rows, so W ranks see the noise one process
  sees;
- every other reduction is a mean over the batch of equally sized
  shards, or stays inside a sample, and so stays local: the automask
  min's mean (`to_optimise.mean`) and the predictive mask's BCE
  (`_mask_bce`) are means over (B, H, W) and (B, h, w, c); the
  avg_reprojection means run over the candidate axis; the smoothness
  normalizes each image by its own mean before its mean over (B, H, W);
  posecnn's mean inverse depth is per sample. The gradient all-reduce
  (`parallel/collectives.py::all_reduce_grads`) averages such a term's
  gradients over the ranks, which is the gradient of its global mean.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from fusiondepth_torch.config import Config
from fusiondepth_torch.kernels import reproj as reproj_kernel
from fusiondepth_torch.ops.depth import disp_to_depth
from fusiondepth_torch.ops.geometry import backproject_depth, project_3d
from fusiondepth_torch.ops.losses import reprojection_loss, si_loss
from fusiondepth_torch.ops.planes import (
    normalized_smoothness_planes,
    reprojection_loss_planes,
    resize_planes,
    to_planes,
)
from fusiondepth_torch.ops.pose import transformation_from_parameters
from fusiondepth_torch.ops.resize import resize_antialias
from fusiondepth_torch.ops.sampling import grid_sample
from fusiondepth_torch.ops.warp import warp_planes
from fusiondepth_torch.parallel.collectives import group_rank, group_size


def pose_T(cfg: Config, batch: Dict[str, torch.Tensor],
           outputs: Dict[Any, Any], f, depth: torch.Tensor) -> torch.Tensor:
    """The (B, 4, 4) transform of source frame f (reference
    trainer.py:440-459): batch["stereo_T"] for "s"; for posecnn the pose
    rebuilt with its translation times the mean inverse depth (B, H, W)
    of the scale; else the predicted cam_T_cam."""
    if f == "s":
        return batch["stereo_T"]
    if cfg.pose_model_type == "posecnn":
        aa = outputs[("axisangle", 0, f)]
        t = outputs[("translation", 0, f)]
        mean_inv_depth = (1.0 / depth).mean(dim=(1, 2))
        return transformation_from_parameters(
            aa[:, 0, 0], t[:, 0, 0] * mean_inv_depth[:, None],
            invert=f < 0)
    return outputs[("cam_T_cam", 0, f)]


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
    """Warp each source frame into frame 0's view at every scale
    (reference trainer.py:425-474): the reference formulation under
    v1_multiscale, the planes one otherwise."""
    if cfg.v1_multiscale:
        return generate_images_pred_reference(cfg, batch, outputs)
    return _generate_images_pred_planes(cfg, batch, outputs)


def compute_losses(cfg: Config, batch: Dict[str, torch.Tensor],
                   outputs: Dict[Any, Any],
                   noise: Optional[Sequence[torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None,
                   group=None) -> Dict[str, torch.Tensor]:
    """Multi-scale photometric + automask + smoothness + SI loss
    (reference trainer.py:490-596), in the formulation that
    generate_images_pred took. The automask tie-break noise added to the
    identity maps at each scale is `noise[i]` for scale i when given (so
    that a test can replay the JAX package's draws; the shape of that
    scale's identity maps, candidates first, at the global batch), else
    1e-5 * N(0, 1) drawn from `generator` (reference trainer.py:549-551).
    `group` is the data group of a data-parallel step (module
    docstring)."""
    if cfg.v1_multiscale:
        return compute_losses_reference(cfg, batch, outputs, noise,
                                        generator, group)
    return _compute_losses_planes(cfg, batch, outputs, noise, generator,
                                  group)


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


def _tie_break(identity: torch.Tensor, noise, si: int, generator, group):
    """identity plus the scale's automask noise, drawn in float32 at least
    and cast to the maps' dtype (photometric.py:254). The noise has the
    global batch's shape (W times identity's batch axis, 1); this rank
    takes its rows."""
    world, b = group_size(group), identity.shape[1]
    shape = (identity.shape[0], b * world) + identity.shape[2:]
    if noise is None:
        noise = {si: torch.randn(
            shape, generator=generator, device=identity.device,
            dtype=torch.promote_types(identity.dtype, torch.float32)) * 1e-5}
    if tuple(noise[si].shape) != shape:
        raise ValueError(f"automask noise of shape {tuple(noise[si].shape)};"
                         f" the global batch's maps are {shape}")
    rank = group_rank(group)
    return identity + noise[si][:, rank * b:(rank + 1) * b].to(
        identity.dtype)


def _mask_bce(mask: torch.Tensor) -> torch.Tensor:
    """0.2 x the predictive mask's BCE toward 1 (reference
    trainer.py:541-545)."""
    return 0.2 * -torch.log(torch.clamp(mask, 1e-7, 1.0)).mean()


def _automask_min(identity, reproj, outputs, scale):
    """The per-pixel min over the candidates (identity maps first), with
    the automask's selection map under outputs["identity_selection/s"]
    (1 where a warp won)."""
    combined = torch.cat([identity, reproj], 0) if identity is not None \
        else reproj
    if combined.shape[0] == 1:
        return combined[0]
    # amin splits the gradient among tied minima, as jnp.min does
    to_optimise = combined.amin(dim=0)
    if identity is not None:
        outputs[f"identity_selection/{scale}"] = (
            combined.argmin(dim=0) >= identity.shape[0]).to(torch.float32)
    return to_optimise


def _si_term(cfg: Config, batch, disp: torch.Tensor,
             group) -> torch.Tensor:
    """The SI loss of the scale's disparity (B, H_s, W_s), upsampled to
    full resolution, against the K-beam LiDAR, over the data group's
    global batch."""
    _, depth = disp_to_depth(resize_planes(disp, cfg.height, cfg.width),
                             cfg.min_depth, cfg.max_depth)
    # hard-coded metric scale (reference trainer.py:583)
    return si_loss(depth * 26.0, batch["four_beam"][..., 0] * 100.0,
                   threshold=cfg.gdc_loss_threshold, si_var=cfg.si_var,
                   group=group)


def _finish_scale(cfg: Config, batch, outputs, losses, scale, loss,
                  color, total, group):
    """Add the smoothness and SI terms of one scale; returns the total."""
    disp = outputs[("disp", scale)][..., 0]                # (B, Hs, Ws)
    smooth = normalized_smoothness_planes(disp, color)
    loss = loss + cfg.disparity_smoothness * smooth / (2.0**scale)
    total = total + loss
    losses[f"loss/{scale}"] = loss
    if cfg.trainer_siloss and (cfg.trainer_siloss_all_scale or scale == 0):
        si = _si_term(cfg, batch, disp, group)
        total = total + si
        losses[f"loss/si_loss{scale}"] = si
    return total


# --------------------------------------------------------------------------
# planes formulation (default)
# --------------------------------------------------------------------------

def _generate_images_pred_planes(cfg: Config, batch, outputs):
    """Adds ("depth", 0, s) (B, H, W), ("sample", f, s) (B, H, W, 2), and
    the planes tensors the loss reads: "warped_planes" (n, k, B, 3, H, W),
    "sources_planes" (n, B, 3, H, W), "target_planes" (B, 3, H, W). The
    port's warp is exact for every displacement, so the stereo frame needs
    no wider band than the temporal ones (the JAX package's dyn384)."""
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
            pix = project_3d(cam_points, K,
                             pose_T(cfg, batch, outputs, f, depth))
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


def _compute_losses_planes(cfg: Config, batch, outputs, noise, generator,
                           group):
    losses: Dict[str, torch.Tensor] = {}
    H, W = cfg.height, cfg.width
    automask = not cfg.disable_automasking
    target_p = outputs["target_planes"]
    reproj_maps, identity_maps = reprojection_maps(
        outputs["warped_planes"], outputs["sources_planes"], target_p,
        not cfg.no_ssim, automask)
    pyr = build_color_pyramid(cfg, target_p)

    total = 0.0
    for si, scale in enumerate(cfg.scales):
        loss = 0.0
        reproj = reproj_maps[:, si]
        identity = None
        if automask:
            identity = identity_maps
            if cfg.avg_reprojection:
                identity = identity.mean(dim=0, keepdim=True)
            identity = _tie_break(identity, noise, si, generator, group)
        elif cfg.predictive_mask:
            # the JAX planes path weights every warp by the mask's first
            # channel (photometric.py:255-258)
            mask = outputs["predictive_mask"][("disp", scale)]
            reproj = reproj * resize_planes(mask[..., 0], H, W)[None]
            loss = loss + _mask_bce(mask)
        if cfg.avg_reprojection:
            reproj = reproj.mean(dim=0, keepdim=True)
        to_optimise = _automask_min(identity, reproj, outputs, scale)
        # float32 accumulation under bf16 (photometric.py:281-284)
        loss = loss + to_optimise.mean(
            dtype=torch.promote_types(to_optimise.dtype, torch.float32))
        total = _finish_scale(cfg, batch, outputs, losses, scale, loss,
                              pyr[scale], total, group)
    losses["loss"] = total / cfg.num_scales
    return losses


# --------------------------------------------------------------------------
# reference formulation (v1_multiscale)
# --------------------------------------------------------------------------

def frame_at_scale(cfg: Config, batch, frame_index: int,
                   scale: int) -> torch.Tensor:
    """Frame `frame_index`'s color (B, 3, H_s, W_s) at pyramid level
    `scale` (the antialiased resize of `_frame_at_scale`)."""
    color = to_planes(batch["color"][:, frame_index])
    if scale == 0:
        return color
    return resize_antialias(color, cfg.height // 2**scale,
                            cfg.width // 2**scale)


def generate_images_pred_reference(cfg: Config, batch, outputs):
    """The per-scale loop of reference trainer.py:425-474 under
    v1_multiscale: each scale warps at its own resolution, with K scaled
    to it and inverted. Adds ("depth", 0, s) and ("sample", f, s) at that
    resolution, and per scale the planes tensors the loss reads:
    ("warped_planes", s) (n, B, 3, h, w), ("sources_planes", s)
    (n, B, 3, h, w) and ("target_planes", s) (B, 3, h, w)."""
    fid = {f: i for i, f in enumerate(cfg.frame_ids)}
    src_frames = list(cfg.frame_ids[1:])
    dtype = outputs[("disp", 0)].dtype
    for scale in cfg.scales:
        disp = outputs[("disp", scale)][..., 0]
        hs, ws = disp.shape[-2:]
        K = batch["K"].clone()
        K[:, 0, :] *= ws / cfg.width
        K[:, 1, :] *= hs / cfg.height
        inv_K = torch.linalg.inv(K)
        _, depth = disp_to_depth(disp, cfg.min_depth, cfg.max_depth)
        outputs[("depth", 0, scale)] = depth
        cam_points = backproject_depth(depth, inv_K)
        grids = []
        for f in src_frames:
            pix = project_3d(cam_points, K,
                             pose_T(cfg, batch, outputs, f, depth))
            outputs[("sample", f, scale)] = pix
            grids.append(pix)
        sources = torch.stack([frame_at_scale(cfg, batch, fid[f], scale)
                               for f in src_frames]).to(dtype).contiguous()
        outputs[("warped_planes", scale)] = grid_sample(sources,
                                                        torch.stack(grids))
        outputs[("sources_planes", scale)] = sources
        outputs[("target_planes", scale)] = frame_at_scale(
            cfg, batch, 0, scale).to(dtype)
    return outputs


def compute_losses_reference(cfg: Config, batch, outputs, noise=None,
                             generator=None, group=None):
    """The per-scale loss loop of reference trainer.py:490-596 over the
    tensors of generate_images_pred_reference."""
    losses: Dict[str, torch.Tensor] = {}
    automask = not cfg.disable_automasking
    pyr = build_color_pyramid(cfg, to_planes(batch["color"][:, 0]).to(
        outputs[("disp", 0)].dtype))

    total = 0.0
    for si, scale in enumerate(cfg.scales):
        loss = 0.0
        target = outputs[("target_planes", scale)]
        reproj = reprojection_loss(outputs[("warped_planes", scale)],
                                   target, not cfg.no_ssim)  # (n, B, h, w)
        identity = None
        if automask:
            identity = reprojection_loss(outputs[("sources_planes", scale)],
                                         target, not cfg.no_ssim)
            if cfg.avg_reprojection:
                identity = identity.mean(dim=0, keepdim=True)
            identity = _tie_break(identity, noise, si, generator, group)
        elif cfg.predictive_mask:
            # one mask channel per source frame, at the scale's resolution
            mask = outputs["predictive_mask"][("disp", scale)]
            reproj = reproj * mask.movedim(-1, 0)
            loss = loss + _mask_bce(mask)
        if cfg.avg_reprojection:
            reproj = reproj.mean(dim=0, keepdim=True)
        to_optimise = _automask_min(identity, reproj, outputs, scale)
        loss = loss + to_optimise.mean()
        total = _finish_scale(cfg, batch, outputs, losses, scale, loss,
                              pyr[scale], total, group)
    losses["loss"] = total / cfg.num_scales
    return losses
