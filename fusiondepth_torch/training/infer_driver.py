"""Offline depth-map inference (reference inf_depth_map.py:23-182): run the
frozen stage-1 model over a split, unshuffled, and cache raw scale-0
disparities as inf_depth_{n}beam/{idx}_{side}.npy next to the data, for GDC
correction and refiner distillation. Counterpart of
`fusiondepth_tpu/training/infer_driver.py`.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from fusiondepth_tpu.config import Config
from fusiondepth_tpu.data.loader import DataLoader
from fusiondepth_torch.models.fusion import FusionNets
from fusiondepth_torch.models.pretrained import apply_pretrained
from fusiondepth_torch.training import checkpoint as ckpt

# what FusionNets.forward_depth reads; every one is an NHWC image
DEPTH_KEYS = ("color_aug", "two_channel", "four_beam")


def default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def device_batch(batch: Dict[str, object],
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """The depth branch's inputs of a host batch (numpy) as tensors on
    `device`: through pinned memory with a non-blocking copy when the
    device is a card."""
    out = {}
    for k in DEPTH_KEYS:
        if k not in batch:
            continue
        t = torch.from_numpy(np.ascontiguousarray(batch[k]))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out


def build_nets(cfg: Config, device: torch.device) -> FusionNets:
    """The stage-1 depth networks: seeded init, ImageNet encoders when
    weights_init="pretrained", then cfg.load_weights_folder if it exists."""
    nets = FusionNets(cfg, device=device,
                      generator=torch.Generator().manual_seed(0))
    if cfg.weights_init == "pretrained":
        apply_pretrained(cfg, nets)
    if cfg.load_weights_folder and os.path.exists(cfg.load_weights_folder):
        ckpt.load_checkpoint(cfg.load_weights_folder, nets)
    return nets


class Infer:
    def __init__(self, cfg: Config, datasets=None,
                 device: Optional[torch.device] = None,
                 nets: Optional[FusionNets] = None):
        self.cfg = cfg
        self.device = torch.device(device) if device else default_device()
        self.nets = nets if nets is not None else build_nets(cfg, self.device)
        self.datasets = datasets

    def out_folder(self) -> str:
        if self.cfg.random_sample > 0:
            return f"inf_depth_r{self.cfg.random_sample}"
        return f"inf_depth_{self.cfg.nbeams}beam"

    @torch.inference_mode()
    def infer(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Scale-0 disparity (B, H, W, 1) of one device batch."""
        return self.nets.forward_depth(batch, train=False)[0][("disp", 0)]

    def run_split(self, dataset, data_path: str) -> int:
        """Save one npy per frame; returns the number written."""
        loader = DataLoader(dataset, self.cfg.eval_batch_size, shuffle=False)
        n = 0
        for bi, batch in enumerate(loader):
            disp = self.infer(device_batch(batch, self.device)).cpu().numpy()
            for j in range(disp.shape[0]):
                index = bi * self.cfg.eval_batch_size + j
                folder, frame_index, side = dataset.parse_line(index)
                out_dir = os.path.join(data_path, folder, self.out_folder())
                os.makedirs(out_dir, exist_ok=True)
                # (1, 1, H, W) float32, the reference's tensor dump layout
                # (inf_depth_map.py:146-153)
                arr = disp[j, :, :, 0][None, None].astype(np.float32)
                np.save(os.path.join(
                    out_dir, f"{int(frame_index)}_{side}.npy"), arr)
                n += 1
        return n

    def run(self) -> None:
        if self.datasets is None:
            raise ValueError("construct with datasets or call run_split")
        for ds in self.datasets:
            self.run_split(ds, self.cfg.data_path)
