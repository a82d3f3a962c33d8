"""Pose decoder over the pose encoder's last feature, NCHW (reference
networks/pose_decoder.py:8-51; counterpart of
`fusiondepth_tpu/models/pose.py::PoseDecoder`).

1x1 squeeze -> ReLU -> two 3x3 convs with ReLU -> 1x1 to 6 * n_pred ->
global mean -> 0.01 * (axisangle, translation). Its convs are plain
zero-padded convolutions with bias, left to cuDNN on a card as the JAX
package leaves them to XLA. PoseCNN is not ported yet.
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
