"""The sparse-3D refiner: --refine_shallow, --refineUnet, --refine_deep
(counterpart of `fusiondepth_tpu/training/refiner3d.py`).

The reference declares these selectors (reference options.py:259-267) for
the MinkowskiEngine RefineNet family but no entry point of it builds the
nets (PARITY.md C17); the JAX package's refiner CLI runs them, and the
port follows the JAX package. Refiner3D freezes stage 1 as the 2-D
refiner does and trains a sparse voxel net (models/refine_net3d.py) to
emit a tanh disparity offset, distilling the cached GDC correction (the
clone_gdc SI objective, reference refiner.py:678-688).

Per sample: stage-1 disparity -> depth -> voxelize (fixed capacity) ->
voxel net (eval-mode BN) -> per-pixel offset gathered back to the image
-> refined disparity clip(disp + 0.1 tanh, 1e-4, 1). The JAX package
vmaps the samples; with the BN in eval mode they do not interact, so the
port loops over the batch.

Runs on one card (cuda:0 unless `device` names another; device="cpu" for
the tests), TF32 off. The optimizer is optax.adam(lr * batch / 8) over
the whole voxel net, its BN running statistics included (they take
gradients: models/refine_net3d.py), which is torch's Adam with eps 1e-8.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import torch

from fusiondepth_torch.config import Config
from fusiondepth_torch.data.loader import DataLoader
from fusiondepth_torch.data.prefetch import prefetch_to_device
from fusiondepth_torch.models.fusion import FusionNets, model_dtype, \
    refuse_bf16
from fusiondepth_torch.models.refine_net3d import (
    RefineNet3DDeep,
    RefineNet3DShallow,
    RefineNet3DUNet,
    _kernel_offsets,
    build_voxel_pyramid,
    depth_to_voxels,
    gather_rows,
    neighbor_table,
)
from fusiondepth_torch.ops.depth import disp_to_depth
from fusiondepth_torch.ops.planes import clip
from fusiondepth_torch.ops.pooling import masked_median
from fusiondepth_torch.training import checkpoint as ckpt
from fusiondepth_torch.training.infer_driver import device_batch, \
    resolve_device
from fusiondepth_torch.training.refiner import refiner_si_loss
from fusiondepth_torch.utils.logging import sec_to_hm_str

# tanh offset (in [-1, 1]) -> disparity delta; the sigmoid disparity lies
# in [0, 1], so 0.1 bounds the correction at 10% of the range
OFFSET_SCALE = 0.1

SELECTORS = ("refine_shallow", "refineUnet", "refine_deep")

# what the step reads from a batch: the stage-1 depth branch's inputs,
# the intrinsics and the GDC target
REFINE3D_KEYS = ("color_aug", "two_channel", "four_beam", "inv_K", "inf_gdc")


def select_refine_net3d(cfg: Config,
                        generator: Optional[torch.Generator] = None
                        ) -> Optional[torch.nn.Module]:
    """The voxel net the selector flags name, or None; more than one
    selector raises ValueError."""
    chosen = [f for f in SELECTORS if getattr(cfg, f)]
    if len(chosen) > 1:
        raise ValueError(f"at most one 3D refine selector, got {chosen}")
    if not chosen:
        return None
    if chosen[0] == "refine_shallow":
        return RefineNet3DShallow(generator=generator)
    if chosen[0] == "refine_deep":
        return RefineNet3DDeep(generator=generator)
    return RefineNet3DUNet(widths=(16, 32, 64, 64), generator=generator)


class Refiner3D:
    def __init__(self, cfg: Config, train_dataset=None, val_dataset=None,
                 voxel_size: float = 0.5, capacity: int = 16384,
                 device=None):
        refuse_bf16(cfg, "the sparse-3D refiner")
        self.net = select_refine_net3d(
            cfg, generator=torch.Generator().manual_seed(cfg.seed + 4))
        if self.net is None:
            raise ValueError(
                "set one of --refine_shallow/--refineUnet/--refine_deep")
        self.cfg = cfg
        self.voxel_size = voxel_size
        self.capacity = capacity
        self.is_unet = isinstance(self.net, RefineNet3DUNet)
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.dtype = model_dtype(cfg)

        # frozen stage 1, loaded as the 2-D refiner loads it
        self.stage1 = FusionNets(cfg, device=self.device,
                                 generator=torch.Generator().manual_seed(
                                     cfg.seed))
        if cfg.refine_load_weights_folder and os.path.exists(
                cfg.refine_load_weights_folder):
            ckpt.load_checkpoint(cfg.refine_load_weights_folder, self.stage1)
        else:
            print(f"WARNING: refine_load_weights_folder "
                  f"{cfg.refine_load_weights_folder!r} not found — the "
                  "frozen stage 1 keeps its random init")
        self.stage1.requires_grad_(False)

        self.net.to(device=self.device, dtype=self.dtype)
        # the scene flax initialises the net from (constant depth 10,
        # inv_K = I), run once: the tables and the net at this capacity
        with torch.no_grad():
            off = self._offsets(torch.full((cfg.height, cfg.width), 10.0,
                                           dtype=self.dtype,
                                           device=self.device),
                                torch.eye(4, dtype=self.dtype,
                                          device=self.device))[0]
        if off.shape != (capacity, 1):
            raise RuntimeError(f"voxel net output {tuple(off.shape)}")

        self.optimizer = torch.optim.Adam(
            self.net.parameters(),
            lr=cfg.learning_rate * (cfg.batch_size / 8.0), eps=1e-8)
        self.step = 0
        self._t0 = time.time()

    def _offsets(self, depth_hw: torch.Tensor, inv_K: torch.Tensor):
        """(per-voxel tanh offsets (V, 1), each pixel's voxel) of one
        (H, W) depth."""
        coords, feats, valid, p2v, keys = depth_to_voxels(
            depth_hw, inv_K, self.voxel_size, self.capacity)
        if self.is_unet:
            tables, c2p = build_voxel_pyramid(
                coords, keys, valid, len(self.net.widths) - 1, self.capacity)
            return self.net(feats, tables, c2p), p2v
        nb = neighbor_table(coords, keys, valid, _kernel_offsets(3))
        return self.net(feats, nb, valid), p2v

    def _refine_sample(self, depth_hw: torch.Tensor, disp_hw: torch.Tensor,
                       inv_K: torch.Tensor) -> torch.Tensor:
        """One sample: voxelize, voxel net, per-pixel offset, refined
        disparity (the dense gather of reference refine_net.py:96-111)."""
        off, p2v = self._offsets(depth_hw, inv_K)
        off_img = gather_rows(off[:, 0], p2v).reshape(depth_hw.shape)
        return clip(disp_hw + OFFSET_SCALE * off_img, 1e-4, 1.0)

    def _forward(self, batch: Dict[str, torch.Tensor]):
        """(refined disparity, refined depth), each (B, H, W), of a device
        batch."""
        cfg = self.cfg
        with torch.no_grad():
            outputs, _ = self.stage1.forward_depth(batch, train=False)
        disp = outputs[("disp", 0)][..., 0]
        _, depth = disp_to_depth(disp, cfg.min_depth, cfg.max_depth)
        refined_disp = torch.stack([
            self._refine_sample(d, s, k)
            for d, s, k in zip(depth, disp, batch["inv_K"])])
        _, refined_depth = disp_to_depth(refined_disp, cfg.min_depth,
                                         cfg.max_depth)
        return refined_disp, refined_depth

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The GDC-clone objective (reference refiner.py:678-688): the SI
        loss against the cached offline-GDC depth, after scaling the
        refined depth by the ratio of the medians (both under the target
        mask; no gradient through it; 1 where it is not finite)."""
        cfg = self.cfg
        _, refined_depth = self._forward(batch)
        target = batch["inf_gdc"][..., 0]
        tmask = target > 0
        with torch.no_grad():
            ratio = masked_median(target, tmask) / torch.clamp(
                masked_median(refined_depth, tmask), min=1e-6)
            ratio = torch.where(torch.isfinite(ratio), ratio,
                                torch.ones_like(ratio))
        si = refiner_si_loss(refined_depth * ratio, target,
                             cfg.gdc_loss_threshold, cfg.si_var)
        return si * cfg.gdc_loss_weight * 4.0

    def put_batch(self, batch) -> Dict[str, torch.Tensor]:
        """Host batch -> the step's inputs on the card, in the model
        dtype."""
        return device_batch(batch, self.device, REFINE3D_KEYS, self.dtype)

    def run_step(self, batch, on_device: bool = False) -> torch.Tensor:
        """One step of the voxel net; returns its loss (a tensor on the
        card)."""
        db = batch if on_device else self.put_batch(batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(db)
        loss.backward()
        self.optimizer.step()
        self.step += 1
        return loss.detach()

    @torch.inference_mode()
    def infer(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Refined disparity (B, H, W) of a device batch."""
        return self._forward(batch)[0]

    def run_epoch(self, epoch: int = 0) -> List[torch.Tensor]:
        """One pass over the train split; returns each step's loss."""
        cfg = self.cfg
        loader = DataLoader(self.train_dataset, cfg.batch_size, shuffle=True,
                            drop_last=True, num_workers=cfg.num_workers)
        losses = []
        for db in prefetch_to_device(loader, self.put_batch, size=2):
            losses.append(self.run_step(db, on_device=True))
            if self.step % cfg.log_frequency == 0:
                print(f"refine3d epoch {epoch} step {self.step} "
                      f"loss {float(losses[-1]):.4f} "
                      f"({sec_to_hm_str(time.time() - self._t0)})",
                      flush=True)
        return losses

    def train(self) -> None:
        for epoch in range(self.cfg.num_epochs):
            self.run_epoch(epoch)
