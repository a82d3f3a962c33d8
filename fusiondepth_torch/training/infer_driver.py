"""Offline depth-map inference (reference inf_depth_map.py:23-182): run the
frozen stage-1 model over a split, unshuffled, and cache raw scale-0
disparities as inf_depth_{n}beam/{idx}_{side}.npy next to the data, for GDC
correction and refiner distillation. Counterpart of
`fusiondepth_tpu/training/infer_driver.py`. Under compute_dtype="bfloat16"
the model writes bf16 disparities, cached as float32 as the JAX driver
stores them (`fusiondepth_tpu/training/infer_driver.py:59-61`).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from fusiondepth_torch.config import Config
from fusiondepth_torch.data.loader import DataLoader
from fusiondepth_torch.models.fusion import FusionNets
from fusiondepth_torch.models.pretrained import apply_pretrained
from fusiondepth_torch.training import checkpoint as ckpt

# what FusionNets.forward_depth reads; every one is an NHWC image
DEPTH_KEYS = ("color_aug", "two_channel", "four_beam")


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; when it is None, cuda:0, where every
    entry point runs unless its caller names a device. Raises without a
    card: the CPU is used only when a caller asks for it (device="cpu"),
    never as a silent stand-in."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "fusiondepth_torch runs on a CUDA card and none is available; "
            "pass device='cpu' to run on the CPU")
    return torch.device("cuda", 0)


def device_batch(batch: Dict[str, object], device: torch.device,
                 keys: Sequence[str] = DEPTH_KEYS,
                 dtype: Optional[torch.dtype] = None
                 ) -> Dict[str, torch.Tensor]:
    """The `keys` of a host batch (numpy) that it holds, as tensors on
    `device` (floating ones cast to `dtype` when given): through pinned
    memory with a non-blocking copy when the device is a card."""
    out = {}
    for k in keys:
        if k not in batch:
            continue
        t = torch.from_numpy(np.ascontiguousarray(batch[k]))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
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
        self.device = resolve_device(device)
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
            disp = self.infer(device_batch(batch, self.device)).float() \
                .cpu().numpy()
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
