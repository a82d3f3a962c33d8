"""ResNet encoder family (18/34/50/101/152) with the fusion first-conv
variants of the reference (resnet_encoder.py:53-103), NCHW.

Counterpart of `fusiondepth_tpu/models/resnet.py`, generic path. The TPU
layout flags (`fold64_encoder`, `fold_stem`, `s2d_stem`, `pack2_encoder`,
`paired_encoders`) only re-lay the same math out for the TPU and keep the
same parameters, so the port accepts them and computes the generic math.

Returns the 5-level pyramid [stem relu, layer1..layer4] with channels
RESNET_FEATURE_CHANNELS[depth]. Parameter names are torchvision's
(`layer1.0.conv1.weight`, `layer2.0.downsample.1.running_var`, ...), so a
torchvision checkpoint loads straight in (`models/pretrained.py`).
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from fusiondepth_torch.kernels import conv3x3
from fusiondepth_torch.models.initializers import lecun_normal_
from fusiondepth_torch.models.norm import BatchNorm
from fusiondepth_torch.ops.pooling import max_pool_3x3s2

RESNET_STAGES = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}

RESNET_FEATURE_CHANNELS = {
    18: (64, 64, 128, 256, 512),
    34: (64, 64, 128, 256, 512),
    50: (64, 256, 512, 1024, 2048),
    101: (64, 256, 512, 1024, 2048),
    152: (64, 256, 512, 1024, 2048),
}


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding=k // 2, bias=False)


def _affine(x, a, b):
    return x * a[:, None, None] + b[:, None, None]


class BasicBlock(nn.Module):
    """torchvision BasicBlock. With `fused` (layer1's stride-1 blocks) it
    runs as the JAX folded layer1 with its Pallas encoder conv does
    (`fusiondepth_tpu/models/resnet.py:309-328`): conv1 raw, bn1 as an
    affine + ReLU applied inside conv2's kernel to its input, then
    relu(c2 * a2 + b2 + x). Same parameters and math as the unfused block."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 fused: bool = False):
        super().__init__()
        self.conv1 = _conv(cin, features, 3, stride)
        self.bn1 = BatchNorm(features)
        self.conv2 = _conv(features, features, 3)
        self.bn2 = BatchNorm(features)
        self.downsample = None
        if stride != 1 or cin != features:
            self.downsample = nn.Sequential(_conv(cin, features, 1, stride),
                                            BatchNorm(features))
        if fused and self.downsample is not None:
            raise ValueError("the fused block is stride 1 without downsample")
        self.fused = fused

    def forward(self, x):
        if self.fused:
            c1 = conv3x3.conv3x3_zero_act(x, self.conv1.weight)
            a1, b1 = self.bn1(c1, return_affine=True)
            c2 = conv3x3.conv3x3_zero_act(c1, self.conv2.weight, a1, b1)
            a2, b2 = self.bn2(c2, return_affine=True)
            return torch.relu(_affine(c2, a2, b2) + x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + identity)


class Bottleneck(nn.Module):
    """torchvision Bottleneck (v1.5: the stride sits on the 3x3 conv)."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        out = 4 * features
        self.conv1 = _conv(cin, features, 1)
        self.bn1 = BatchNorm(features)
        self.conv2 = _conv(features, features, 3, stride)
        self.bn2 = BatchNorm(features)
        self.conv3 = _conv(features, out, 1)
        self.bn3 = BatchNorm(out)
        self.downsample = None
        if stride != 1 or cin != out:
            self.downsample = nn.Sequential(_conv(cin, out, 1, stride),
                                            BatchNorm(out))

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + identity)


class ResnetEncoder(nn.Module):
    """5-level ResNet feature pyramid over an NCHW image.

    in_channels: conv1 input width: 3 (RGB), 4 (cat4beam), 5 (cat2start),
      2 or 2N (beam encoders), 6 (refine encoder), 3N (pose encoder).
    normalize_input: apply (x - 0.45) / 0.225 first; the reference applies
      it to every encoder input, the 2-channel LiDAR included
      (resnet_encoder.py:94).
    """

    def __init__(self, depth: int = 18, in_channels: int = 3,
                 normalize_input: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.depth = depth
        self.in_channels = in_channels
        self.normalize_input = normalize_input
        bottleneck = depth > 34
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
        cin = 64
        for si, (width, n) in enumerate(zip((64, 128, 256, 512),
                                            RESNET_STAGES[depth])):
            blocks = []
            for bi in range(n):
                stride = 2 if si > 0 and bi == 0 else 1
                if bottleneck:
                    blocks.append(Bottleneck(cin, width, stride))
                    cin = 4 * width
                else:
                    blocks.append(BasicBlock(cin, width, stride,
                                             fused=si == 0))
                    cin = width
            self.add_module(f"layer{si + 1}", nn.Sequential(*blocks))
        lecun_normal_(self, generator)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        if self.normalize_input:
            x = (x - 0.45) / 0.225
        x = x.to(self.conv1.weight.dtype)
        y = torch.relu(self.bn1(self.conv1(x)))
        feats = [y]
        y = max_pool_3x3s2(y)
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            y = layer(y)
            feats.append(y)
        return feats
