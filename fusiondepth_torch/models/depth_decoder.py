"""U-Net depth decoder with the reference's LiDAR fusion hooks, NCHW.

Counterpart of `fusiondepth_tpu/models/depth_decoder.py`, generic path
(:200-234), which is the reference's networks/depth_decoder.py:6-96:
5 up-stages; stage i: upconv_i_0 -> nearest 2x upsample -> with the skip
(encoder feature i-1, plus the beam feature when given) -> upconv_i_1;
a sigmoid disparity head at every scale in `scales`; `cat2end` feeds the
2-channel LiDAR to the scale-0 head beside the features. `folded_decoder`
only re-lays this math out for the TPU, so the port computes it as is.

The refiner's hooks (the refine2d decoder of `training/refiner.py`):
`road` injects a pseudo-3D map (B, 3 [+3 with `catxy`], H_i, W_i) beside
the skip at every stage i in `scales`; `deep` makes every block two
stacked ConvBlocks, `a` (C -> C) then `b` (C -> features); `tanh_head`
replaces the sigmoid heads by tanh.

Every ConvBlock and disparity head is one call of the reflect-pad conv
kernel (`kernels/conv3x3.py`), which takes the skip concat
[upsampled, skip] as two inputs, so the concatenated tensor is never
built. Where a stage has three inputs (upsampled, skip and the refiner's
map), the skip and the map go to the kernel's second input through one
torch.cat.

`compute_dtype` (set by FusionNets; None: the parameters' dtype) is the
dtype the decoder runs in (`fusiondepth_tpu/models/depth_decoder.py:92-95,
126-129, 205-224`): its inputs and every conv weight are cast to it, the
biases stay float32 (the kernel adds them in float32, as the Pallas
kernel does), and the ELUs and heads output it.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from fusiondepth_torch.kernels import conv3x3
from fusiondepth_torch.models.initializers import lecun_normal_
from fusiondepth_torch.ops.resize import upsample2x_nearest

NUM_CH_DEC = (16, 32, 64, 128, 256)


class ConvBlock(nn.Module):
    """Reflect-pad 3x3 conv + bias, then ELU (reference layers.py:100-130);
    with elu=False the Conv3x3 disparity head. `conv` only holds the
    weight (Co, Ci, 3, 3) and bias; the kernel applies them."""

    def __init__(self, cin: int, cout: int, elu: bool = True):
        super().__init__()
        # no default init: the decoder's lecun_normal_ writes the weight
        # and zeroes the bias
        self.conv = nn.utils.skip_init(nn.Conv2d, cin, cout, 3)
        self.elu = elu

    def forward(self, x0: torch.Tensor,
                x1: Optional[torch.Tensor] = None) -> torch.Tensor:
        return conv3x3.conv3x3_reflect(x0, self.conv.weight.to(x0.dtype),
                                       self.conv.bias, x1, self.elu)


class DeepBlock(nn.Module):
    """Two stacked ConvBlocks (`deep`): a (cin -> cin), b (cin -> cout)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.a = ConvBlock(cin, cin)
        self.b = ConvBlock(cin, cout)

    def forward(self, x0: torch.Tensor,
                x1: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.b(self.a(x0, x1))


class DepthDecoder(nn.Module):
    def __init__(self, num_ch_enc: Sequence[int],
                 scales: Sequence[int] = (0, 1, 2, 3),
                 num_output_channels: int = 1, use_skips: bool = True,
                 cat2end: bool = False, road: bool = False,
                 catxy: bool = False, deep: bool = False,
                 tanh_head: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.scales = tuple(scales)
        self.use_skips = use_skips
        self.cat2end = cat2end
        self.road = road
        self.tanh_head = tanh_head
        self.compute_dtype: Optional[torch.dtype] = None
        block = DeepBlock if deep else ConvBlock
        map_ch = (3 + (3 if catxy else 0)) if road else 0
        for i in range(4, -1, -1):
            cin = num_ch_enc[-1] if i == 4 else NUM_CH_DEC[i + 1]
            self.add_module(f"upconv_{i}_0", block(cin, NUM_CH_DEC[i]))
            cin = NUM_CH_DEC[i]
            if use_skips and i > 0:
                cin += num_ch_enc[i - 1]
            if use_skips and i in self.scales:
                cin += map_ch
            self.add_module(f"upconv_{i}_1", block(cin, NUM_CH_DEC[i]))
            if i in self.scales:
                cin = NUM_CH_DEC[i] + (2 if i == 0 and cat2end else 0)
                self.add_module(f"dispconv_{i}", ConvBlock(
                    cin, num_output_channels, elu=False))
        lecun_normal_(self, generator)

    def forward(self, input_features: Sequence[torch.Tensor],
                two_channel: Optional[torch.Tensor] = None,
                beam_features: Optional[Sequence[torch.Tensor]] = None,
                depth_maps: Optional[Dict[tuple, torch.Tensor]] = None
                ) -> Dict[tuple, torch.Tensor]:
        """input_features: the 5-level NCHW pyramid, coarsest last;
        beam_features: the beam encoder's pyramid, added at every level;
        two_channel: (B, 2, H, W), read only with cat2end;
        depth_maps: {("disp", i): (B, 3 [+3], H/2^i, W/2^i)}, the road
        injections, required with road.
        Returns {("disp", s): (B, C, H/2^s, W/2^s)} for s in scales."""
        if self.road != (depth_maps is not None):
            raise ValueError("depth_maps are given exactly when the decoder "
                             "is built with road=True")
        dtype = self.compute_dtype or next(self.parameters()).dtype

        def level(i):
            f = input_features[i]
            if beam_features is not None:
                f = f + beam_features[i]
            return f.to(dtype)

        outputs = {}
        x = level(4)
        for i in range(4, -1, -1):
            x = getattr(self, f"upconv_{i}_0")(x)
            rest = [level(i - 1)] if self.use_skips and i > 0 else []
            if self.road and self.use_skips and i in self.scales:
                rest.append(depth_maps[("disp", i)].to(dtype))
            second = torch.cat(rest, 1) if len(rest) > 1 else \
                (rest[0] if rest else None)
            x = getattr(self, f"upconv_{i}_1")(upsample2x_nearest(x), second)
            if i in self.scales:
                extra = None
                if i == 0 and self.cat2end:
                    extra = two_channel.to(dtype)
                d = getattr(self, f"dispconv_{i}")(x, extra)
                outputs[("disp", i)] = torch.tanh(d) if self.tanh_head \
                    else torch.sigmoid(d)
        return outputs
