"""The depth branch of the model bundle: RGB ResNet encoder, the 2-channel
LiDAR beam encoder, fused additively into the U-Net depth decoder.

Counterpart of `fusiondepth_tpu/models/fusion.py::FusionNets` for
`forward_depth`; the pose networks and `predict_poses` come with the
training path. Batch contract, as in the JAX package (NHWC, `F` indexes
`cfg.frame_ids`):

  color_aug      (B, F, H, W, 3)   network input frames
  two_channel    (B, F, H, W, 2)   expanded-LiDAR 2-channel encoding
  four_beam      (B, H, W, 1)      sparse K-beam depth (meters / 100)

Values are tensors on the bundle's device (`training/infer_driver.py`
has `device_batch`). Outputs are NHWC like the JAX ones.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from fusiondepth_tpu.config import Config
from fusiondepth_torch.models.depth_decoder import DepthDecoder
from fusiondepth_torch.models.resnet import RESNET_FEATURE_CHANNELS, \
    ResnetEncoder

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
    """The depth networks of one configuration, on `device`, initialised
    from `generator` (default: seeded 0) and left in eval mode. The TPU
    layout flags of the config (fold64_encoder, fold_stem, folded_seam,
    folded_decoder, s2d_stem, pack2_encoder, paired_encoders) are accepted
    and change nothing: they re-lay the same math out for the TPU."""

    def __init__(self, cfg: Config, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.height < 64 or cfg.width < 64:
            # the stride-32 map must be >= 2x2 for the reflect-pad convs
            raise ValueError(f"minimum resolution is 64x64, got "
                             f"{cfg.height}x{cfg.width}")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
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
