"""Pose networks, NCHW (counterpart of `fusiondepth_tpu/models/pose.py`):

- PoseDecoder over encoder features (reference
  networks/pose_decoder.py:8-51): 1x1 squeeze -> ReLU -> two 3x3 convs
  with ReLU -> 1x1 to 6 * n_pred -> global mean -> 0.01 * (axisangle,
  translation);
- PoseCNN (reference networks/pose_cnn.py:7-44): seven stride-2 convs
  with ReLU over the channel-stacked frames, a 1x1 `pose_conv`, the global
  mean and the same 0.01 scale.

Their convs are plain zero-padded convolutions with bias, left to cuDNN
on a card as the JAX package leaves them to XLA. Module names are the
JAX package's (`squeeze`, `pose_0`..`pose_2`; `conv_0`..`conv_6`,
`pose_conv`), so `models/jax_weights.py` carries them both ways.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from fusiondepth_torch.models.initializers import lecun_normal_


class PoseDecoder(nn.Module):
    def __init__(self, num_ch_enc_last: int = 512,
                 num_input_features: int = 1,
                 num_frames_to_predict_for: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if num_frames_to_predict_for is None:
            num_frames_to_predict_for = num_input_features - 1
        self.n_pred = num_frames_to_predict_for
        self.squeeze = nn.Conv2d(num_ch_enc_last, 256, 1)
        self.pose_0 = nn.Conv2d(num_input_features * 256, 256, 3, 1, 1)
        self.pose_1 = nn.Conv2d(256, 256, 3, 1, 1)
        self.pose_2 = nn.Conv2d(256, 6 * self.n_pred, 1)
        lecun_normal_(self, generator)

    def forward(self, last_features: Sequence[torch.Tensor],
                beam_last_feature: Optional[torch.Tensor] = None):
        """last_features: the last encoder level of each input, (B, C, h, w);
        beam_last_feature, when given, is added to the single input first
        (reference :30-32). Returns (axisangle, translation), each
        (B, n_pred, 1, 3)."""
        if beam_last_feature is not None:
            feats = [last_features[0] + beam_last_feature]
        else:
            feats = list(last_features)
        out = torch.cat([torch.relu(self.squeeze(f)) for f in feats], 1)
        out = torch.relu(self.pose_0(out))
        out = torch.relu(self.pose_1(out))
        out = self.pose_2(out).mean(dim=(2, 3))
        out = 0.01 * out.reshape(-1, self.n_pred, 1, 6)
        return out[..., :3], out[..., 3:]


class PoseCNN(nn.Module):
    """Seven stride-2 convs on `num_input_frames` channel-stacked RGB
    frames -> the poses of the num_input_frames - 1 others, each
    (axisangle, translation) of shape (B, n - 1, 1, 3)."""

    SPECS = ((16, 7, 2, 3), (32, 5, 2, 2), (64, 3, 2, 1), (128, 3, 2, 1),
             (256, 3, 2, 1), (256, 3, 2, 1), (256, 3, 2, 1))

    def __init__(self, num_input_frames: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_pred = num_input_frames - 1
        ci = 3 * num_input_frames
        for i, (co, k, s, p) in enumerate(self.SPECS):
            setattr(self, f"conv_{i}", nn.Conv2d(ci, co, k, s, p))
            ci = co
        self.pose_conv = nn.Conv2d(ci, 6 * self.n_pred, 1)
        lecun_normal_(self, generator)

    def forward(self, x: torch.Tensor):
        """x: (B, 3 * num_input_frames, H, W)."""
        for i in range(len(self.SPECS)):
            x = torch.relu(getattr(self, f"conv_{i}")(x))
        out = 0.01 * self.pose_conv(x).mean(dim=(2, 3)).reshape(
            -1, self.n_pred, 1, 6)
        return out[..., :3], out[..., 3:]
