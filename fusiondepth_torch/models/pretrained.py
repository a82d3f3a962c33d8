"""ImageNet initialisation of the encoders (weights_init="pretrained").

As in `fusiondepth_tpu/models/pretrained.py` (reference
networks/resnet_encoder.py:33-50): every ResNet encoder starts from a
torchvision `resnet{depth}*.pth` found locally; conv1 keeps the torch
weights where the channel counts match (tiled and divided by N for a
multi-image input: the pose encoders) and its own init otherwise. The port's encoders use
torchvision's parameter names, so the checkpoint loads straight in. If no
checkpoint is found the encoder keeps its random init and a warning is
printed once.
"""

from __future__ import annotations

import glob
import os
import warnings
from typing import Dict, Optional

import torch

from fusiondepth_torch.config import Config
from fusiondepth_torch.models.resnet import ResnetEncoder


def find_checkpoint(depth: int, path: Optional[str] = None) -> Optional[str]:
    """Locate a torchvision-format ResNet-{depth} .pth checkpoint: `path`
    (a file, or a directory holding resnet{depth}*.pth), then the torch hub
    cache ($TORCH_HOME or ~/.cache/torch)/hub/checkpoints."""
    if path:
        if os.path.isfile(path):
            return path
        hits = sorted(glob.glob(os.path.join(path, f"resnet{depth}*.pth")))
        if hits:
            return hits[0]
    torch_home = os.environ.get(
        "TORCH_HOME", os.path.join(os.path.expanduser("~"), ".cache", "torch"))
    hits = sorted(glob.glob(
        os.path.join(torch_home, "hub", "checkpoints", f"resnet{depth}*.pth")))
    return hits[0] if hits else None


def _adapt_conv1(w: torch.Tensor, in_channels: int,
                 num_input_images: int) -> torch.Tensor:
    """The 3-channel ImageNet conv1 for a multi-image input: tiled across
    the N images and divided by N (resnet_encoder.py:46-49)."""
    if num_input_images > 1 and in_channels == 3 * num_input_images:
        w = torch.cat([w] * num_input_images, dim=1) / num_input_images
    return w


def load_pretrained_encoder(encoder: ResnetEncoder, pth_path: str,
                            num_input_images: int = 1) -> None:
    """Load a torchvision checkpoint into `encoder` in place."""
    sd = torch.load(pth_path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {k.replace("encoder.", ""): v for k, v in sd.items()
          if not k.startswith("fc.") and not k.endswith("num_batches_tracked")}
    conv1 = _adapt_conv1(sd["conv1.weight"], encoder.in_channels,
                         num_input_images)
    if conv1.shape[1] == encoder.in_channels:
        sd["conv1.weight"] = conv1
    else:  # fusion first-conv swap: keep this encoder's own conv1
        sd["conv1.weight"] = encoder.conv1.weight.detach()
    encoder.load_state_dict(sd)


def apply_pretrained(cfg: Config, nets) -> Dict[str, bool]:
    """Load ImageNet weights into every ResNet encoder of a FusionNets
    bundle: the depth and beam encoders, and the pose and beam-pose
    encoders, whose conv1 takes num_pose_frames images (tiled and divided
    by N where the channels match, fusiondepth_tpu/models/pretrained.py:
    75-84). Returns {encoder name: whether weights were found}."""
    applied = {}
    n_pose = cfg.num_pose_frames
    for name, n_imgs in (("encoder", 1), ("beam_encoder", 1),
                         ("pose_encoder", n_pose),
                         ("beam_encoder_pose", n_pose)):
        enc = getattr(nets, name, None)
        if enc is None:
            continue
        pth = find_checkpoint(enc.depth, cfg.pretrained_weights_path)
        applied[name] = pth is not None
        if pth is None:
            warnings.warn(
                f"weights_init='pretrained' but no resnet{enc.depth} "
                f"checkpoint found (looked in pretrained_weights_path="
                f"{cfg.pretrained_weights_path!r} and the torch hub cache); "
                f"encoders keep their random init", stacklevel=2)
            continue
        load_pretrained_encoder(enc, pth, n_imgs)
    return applied
