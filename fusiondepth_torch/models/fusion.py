"""The model bundle: RGB ResNet encoder and the 2-channel LiDAR beam
encoder, fused additively into the U-Net depth decoder, and the pose
networks.

Counterpart of `fusiondepth_tpu/models/fusion.py::FusionNets`:
`forward_depth`, `predict_poses` and `forward` for every pose type of the
JAX package:
- "separate_resnet": a pose encoder over the stacked frames and a
  beam-pose encoder over their LiDAR, then the pose decoder;
- "posecnn": PoseCNN over the stacked frames;
- "shared": the depth encoder runs over every frame in one pass
  (`shared_features`) and the pose decoder reads its last level;
with pose_model_input "pairs" (one pose per (earlier, later) pair with
frame 0) or "all" (every frame but "s" at once). Batch contract, as in
the JAX package (NHWC, `F` indexes `cfg.frame_ids`):

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
from fusiondepth_torch.models.pose import PoseCNN, PoseDecoder
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

    The beam-pose encoder exists whenever the beam encoder does, as in the
    JAX package's parameter tree, though only the separate_resnet pairs
    read it. With pose_model_input "all", "s" (the stereo frame) would
    count as a pose input at init but not in the forward, which the JAX
    package cannot init either: that combination raises ValueError.

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
        n = cfg.num_pose_frames
        if cfg.use_pose_net and cfg.pose_model_input == "all" \
                and "s" in cfg.frame_ids:
            raise ValueError(
                "pose_model_input='all' with the stereo frame 's': the pose "
                "nets would be built for it and never given it (the JAX "
                "package fails at init on this too)")
        if cfg.use_pose_net and cfg.pose_model_type == "separate_resnet":
            self.pose_encoder = ResnetEncoder(self.pose_depth, 3 * n,
                                              generator=generator)
        if cfg.beam_encoder:
            self.beam_encoder_pose = ResnetEncoder(
                self.pose_depth, 2 * n, generator=generator)
        if cfg.use_pose_net:
            if cfg.pose_model_type == "separate_resnet":
                self.pose = PoseDecoder(
                    RESNET_FEATURE_CHANNELS[self.pose_depth][-1],
                    num_input_features=1, num_frames_to_predict_for=2,
                    generator=generator)
            elif cfg.pose_model_type == "shared":
                self.pose = PoseDecoder(ch[-1], num_input_features=n,
                                        generator=generator)
            elif cfg.pose_model_type == "posecnn":
                self.pose = PoseCNN(n, generator=generator)
            else:
                raise ValueError(
                    f"unknown pose_model_type {cfg.pose_model_type!r}")
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
        return self._decode(batch, feats), feats

    def _decode(self, batch: Dict[str, torch.Tensor],
                feats: List[torch.Tensor]) -> Dict:
        """The beam encoder on frame 0's LiDAR, the depth decoder on
        `feats` and it, and the predictive-mask decoder on `feats`."""
        cfg = self.cfg
        beam_feats = None
        if self.beam_encoder is not None:
            beam_feats = self.beam_encoder(_nchw(batch["two_channel"][:, 0]))
        two_ch = _nchw(batch["two_channel"][:, 0]) if cfg.cat2end else None
        out = self.depth(feats, two_channel=two_ch, beam_features=beam_feats)
        outputs = {k: _nhwc(v) for k, v in out.items()}
        if self.predictive_mask is not None:
            outputs["predictive_mask"] = {
                k: _nhwc(v) for k, v in self.predictive_mask(feats).items()}
        return outputs

    def shared_features(self, batch: Dict[str, torch.Tensor]
                        ) -> Dict[Any, List[torch.Tensor]]:
        """pose_model_type "shared": every frame through the depth encoder
        in one pass of B x F frames, so training-mode BN statistics pool
        over the frames (reference trainer.py:276-287). Returns
        {frame id: NCHW pyramid}. Uses the BN mode the bundle is in."""
        color = batch["color_aug"]
        B, F = color.shape[:2]
        feats = self.encoder(_nchw(color.reshape((B * F,) + color.shape[2:])))
        return {f: [lvl.reshape((B, F) + lvl.shape[1:])[:, i]
                    for lvl in feats]
                for i, f in enumerate(self.cfg.frame_ids)}

    def predict_poses(self, batch: Dict[str, torch.Tensor],
                      features: Optional[Dict[Any, List[torch.Tensor]]] = None
                      ) -> Dict[Any, torch.Tensor]:
        """Relative pose of each temporal source frame (reference
        trainer.py:321-388): {("axisangle", 0, f), ("translation", 0, f):
        (B, n_pred, 1, 3), ("cam_T_cam", 0, f): (B, 4, 4)}; "s" gets
        none (its transform is the batch's stereo_T). `features` is
        `shared_features`' output, which the shared pose type reads.

        With pose_model_input "pairs", every (earlier, later) pair with
        frame 0 goes through the pose nets in one pass, stacked on the
        batch axis, and cam_T_cam is inverted for earlier frames. As in the
        JAX package the separate_resnet encoders' training-mode BN
        statistics then pool over the pairs (PARITY.md); the JAX package
        runs the posecnn and shared pairs one by one, which computes the
        same, since those nets have no BN. With "all", one pass over every
        frame but "s" predicts all the poses, nothing is inverted and no
        beam feature is used. Uses the BN mode the bundle is in."""
        cfg = self.cfg
        fid = {f: i for i, f in enumerate(cfg.frame_ids)}
        kind = cfg.pose_model_type
        B = batch["color_aug"].shape[0]
        outputs = {}
        if cfg.num_pose_frames != 2:
            frames = [f for f in cfg.frame_ids if f != "s"]
            if kind == "shared":
                aa, t = self.pose([features[f][-1] for f in frames])
            else:
                colors = _nchw(torch.cat(
                    [batch["color_aug"][:, fid[f]] for f in frames], dim=-1))
                if kind == "posecnn":
                    aa, t = self.pose(colors)
                else:
                    aa, t = self.pose([self.pose_encoder(colors)[-1]])
            for i, f in enumerate(cfg.frame_ids[1:]):
                if f == "s":
                    continue
                outputs[("axisangle", 0, f)] = aa
                outputs[("translation", 0, f)] = t
                outputs[("cam_T_cam", 0, f)] = \
                    transformation_from_parameters(aa[:, i, 0], t[:, i, 0])
            return outputs

        temporal = [f for f in cfg.frame_ids[1:] if f != "s"]
        if not temporal:
            return outputs
        pairs = [((f, 0) if f < 0 else (0, f)) for f in temporal]

        def stacked(key):
            return _nchw(torch.cat([torch.cat(
                [batch[key][:, fid[a]], batch[key][:, fid[b]]], dim=-1)
                for a, b in pairs], dim=0))

        if kind == "shared":
            aa, t = self.pose([torch.cat([features[p[j]][-1] for p in pairs])
                               for j in (0, 1)])
        elif kind == "posecnn":
            aa, t = self.pose(stacked("color_aug"))
        else:
            last = self.pose_encoder(stacked("color_aug"))[-1]
            beam_last = None
            if self.beam_encoder_pose is not None:
                beam_last = self.beam_encoder_pose(
                    stacked("two_channel"))[-1]
            aa, t = self.pose([last], beam_last_feature=beam_last)
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
        (`fusiondepth_tpu/models/fusion.py::FusionNets.forward`). With the
        shared pose type the depth decoder reads frame 0's levels of
        `shared_features`. With `train` the BatchNorms use batch
        statistics and update their running ones in place."""
        cfg = self.cfg
        if not cfg.use_pose_net:
            return self.forward_depth(batch, train=train)[0]
        if cfg.pose_model_type == "shared":
            self.train(train)
            per_frame = self.shared_features(batch)
            # frame 0's levels are strided views of the stacked pass; the
            # decoder's conv kernels take contiguous maps
            outputs = self._decode(batch, [f.contiguous()
                                           for f in per_frame[0]])
            outputs.update(self.predict_poses(batch, per_frame))
            return outputs
        outputs, _ = self.forward_depth(batch, train=train)
        outputs.update(self.predict_poses(batch))
        return outputs
