"""The model bundle: RGB ResNet encoder and the 2-channel LiDAR beam
encoder, fused additively into the U-Net depth decoder, and the pose
networks (a pose encoder over frame pairs, a beam-pose encoder over their
LiDAR, the pose decoder).

Counterpart of `fusiondepth_tpu/models/fusion.py::FusionNets` for
`forward_depth`, `predict_poses` (separate_resnet pose, frame pairs) and
`forward`. Batch contract, as in the JAX package (NHWC, `F` indexes
`cfg.frame_ids`):

  color_aug      (B, F, H, W, 3)   network input frames
  two_channel    (B, F, H, W, 2)   expanded-LiDAR 2-channel encoding
  four_beam      (B, H, W, 1)      sparse K-beam depth (meters / 100)

Values are tensors on the bundle's device (`training/infer_driver.py`
has `device_batch`). Outputs are NHWC like the JAX ones. In training mode
the BatchNorms use batch statistics and update their running statistics
in place.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from fusiondepth_torch.config import Config
from fusiondepth_torch.models.depth_decoder import DepthDecoder
from fusiondepth_torch.models.pose import PoseDecoder
from fusiondepth_torch.models.resnet import RESNET_FEATURE_CHANNELS, \
    ResnetEncoder
from fusiondepth_torch.ops.pose import transformation_from_parameters

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def model_dtype(cfg: Config) -> torch.dtype:
    """The port runs float32 (and float64 for the parity tests); its
    kernels take float32 only, so bfloat16 is refused for now."""
    if cfg.compute_dtype not in _DTYPES:
        raise NotImplementedError(
            f"compute_dtype={cfg.compute_dtype!r}: the port runs float32 "
            "or float64")
    return _DTYPES[cfg.compute_dtype]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class FusionNets(nn.Module):
    """The networks of one configuration, on `device`, initialised from
    `generator` (default: seeded 0) and left in eval mode. The TPU layout
    flags of the config (fold64_encoder, fold_stem, folded_seam,
    folded_decoder, s2d_stem, pack2_encoder, paired_encoders) are accepted
    and change nothing: they re-lay the same math out for the TPU.

    The pose networks are built for pose_model_type "separate_resnet" (the
    default); the "shared" and "posecnn" pose types are not ported yet, and
    predict_poses raises for them.

    `pose_depth` gives the pose and beam-pose encoders a ResNet depth of
    their own (default cfg.num_layers): the completor's
    completion_pose_num_layers split (reference completor.py:58-76)."""

    def __init__(self, cfg: Config, device=None,
                 generator: Optional[torch.Generator] = None,
                 pose_depth: Optional[int] = None):
        super().__init__()
        if cfg.height < 64 or cfg.width < 64:
            # the stride-32 map must be >= 2x2 for the reflect-pad convs
            raise ValueError(f"minimum resolution is 64x64, got "
                             f"{cfg.height}x{cfg.width}")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.pose_depth = pose_depth or cfg.num_layers
        enc_in = 3
        if cfg.cat_4beam_to_color:
            enc_in = 4
        elif cfg.cat2start:
            enc_in = 5
        self.encoder = ResnetEncoder(cfg.num_layers, enc_in,
                                     generator=generator)
        self.beam_encoder = None
        if cfg.beam_encoder:
            self.beam_encoder = ResnetEncoder(cfg.num_layers, 2,
                                              generator=generator)
        ch = RESNET_FEATURE_CHANNELS[cfg.num_layers]
        self.depth = DepthDecoder(ch, scales=cfg.scales, cat2end=cfg.cat2end,
                                  generator=generator)
        self.predictive_mask = None
        if cfg.predictive_mask:
            if not cfg.disable_automasking:
                raise ValueError("predictive_mask requires "
                                 "disable_automasking (reference "
                                 "trainer.py:118-120)")
            self.predictive_mask = DepthDecoder(
                ch, scales=cfg.scales,
                num_output_channels=len(cfg.frame_ids) - 1,
                generator=generator)
        self.pose_encoder = self.beam_encoder_pose = self.pose = None
        if cfg.use_pose_net and cfg.pose_model_type == "separate_resnet":
            n = cfg.num_pose_frames
            self.pose_encoder = ResnetEncoder(self.pose_depth, 3 * n,
                                              generator=generator)
            if cfg.beam_encoder:
                self.beam_encoder_pose = ResnetEncoder(
                    self.pose_depth, 2 * n, generator=generator)
            pose_ch = RESNET_FEATURE_CHANNELS[self.pose_depth][-1]
            self.pose = PoseDecoder(pose_ch, num_input_features=1,
                                    num_frames_to_predict_for=2,
                                    generator=generator)
        self.to(device=device, dtype=model_dtype(cfg))
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.encoder.conv1.weight.device

    def forward_depth(self, batch: Dict[str, torch.Tensor],
                      train: bool = False
                      ) -> Tuple[Dict, List[torch.Tensor]]:
        """Encoder (+ beam encoder) -> decoder disparities.

        Returns (outputs, feats): outputs {("disp", s): (B, H_s, W_s, 1)}
        (plus "predictive_mask", a dict of the same form, when configured);
        feats is the RGB encoder's NCHW pyramid. `train` selects batch
        statistics in the BatchNorms (and updates their running ones)."""
        cfg = self.cfg
        self.train(train)
        color0 = batch["color_aug"][:, 0]
        if cfg.cat_4beam_to_color:
            enc_in = torch.cat([color0, batch["four_beam"]], dim=-1)
        elif cfg.cat2start:
            enc_in = torch.cat([color0, batch["two_channel"][:, 0]], dim=-1)
        else:
            enc_in = color0
        feats = self.encoder(_nchw(enc_in))
        beam_feats = None
        if self.beam_encoder is not None:
            beam_feats = self.beam_encoder(_nchw(batch["two_channel"][:, 0]))
        two_ch = _nchw(batch["two_channel"][:, 0]) if cfg.cat2end else None
        out = self.depth(feats, two_channel=two_ch, beam_features=beam_feats)
        outputs = {k: _nhwc(v) for k, v in out.items()}
        if self.predictive_mask is not None:
            outputs["predictive_mask"] = {
                k: _nhwc(v) for k, v in self.predictive_mask(feats).items()}
        return outputs, feats

    def predict_poses(self, batch: Dict[str, torch.Tensor]
                      ) -> Dict[Any, torch.Tensor]:
        """Relative pose of each temporal source frame (reference
        trainer.py:321-388): {("axisangle", 0, f), ("translation", 0, f):
        (B, 2, 1, 3), ("cam_T_cam", 0, f): (B, 4, 4)}. As in the JAX
        package, all frame pairs go through the pose encoders in one pass,
        stacked on the batch axis, so training-mode BN statistics pool over
        the pairs (PARITY.md). Uses the BN mode the bundle is in."""
        cfg = self.cfg
        if self.pose is None or cfg.num_pose_frames != 2:
            raise NotImplementedError(
                f"pose_model_type={cfg.pose_model_type!r}, pose_model_input="
                f"{cfg.pose_model_input!r}: the port predicts poses with "
                "separate_resnet over frame pairs only")
        fid = {f: i for i, f in enumerate(cfg.frame_ids)}
        temporal = [f for f in cfg.frame_ids[1:] if f != "s"]
        pairs = [((f, 0) if f < 0 else (0, f)) for f in temporal]
        B = batch["color_aug"].shape[0]

        def stacked(key):
            return _nchw(torch.cat([torch.cat(
                [batch[key][:, fid[a]], batch[key][:, fid[b]]], dim=-1)
                for a, b in pairs], dim=0))

        last = self.pose_encoder(stacked("color_aug"))[-1]
        beam_last = None
        if self.beam_encoder_pose is not None:
            beam_last = self.beam_encoder_pose(stacked("two_channel"))[-1]
        aa, t = self.pose([last], beam_last_feature=beam_last)
        outputs = {}
        for pi, f in enumerate(temporal):
            aa_i, t_i = aa[pi * B:(pi + 1) * B], t[pi * B:(pi + 1) * B]
            outputs[("axisangle", 0, f)] = aa_i
            outputs[("translation", 0, f)] = t_i
            outputs[("cam_T_cam", 0, f)] = transformation_from_parameters(
                aa_i[:, 0, 0], t_i[:, 0, 0], invert=f < 0)
        return outputs

    def forward(self, batch: Dict[str, torch.Tensor],
                train: bool = True) -> Dict[Any, Any]:
        """Depth branch and, when the config uses a pose net, the poses
        (`fusiondepth_tpu/models/fusion.py::FusionNets.forward`). With
        `train` the BatchNorms use batch statistics and update their
        running ones in place."""
        outputs, _ = self.forward_depth(batch, train=train)
        if self.cfg.use_pose_net:
            outputs.update(self.predict_poses(batch))
        return outputs
