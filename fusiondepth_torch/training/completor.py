"""Depth-completion trainer (counterpart of
`fusiondepth_tpu/training/completor.py`; reference completor.py:28-888):
the stage-1 skeleton at full 352x1216 resolution over the KITTI completion
layout, with a completion_num_layers / completion_pose_num_layers encoder
split, SI (or L1) supervision against the sparse velodyne_raw input (with
the hard-coded depth * 26 metric factor, completor.py:701), and
best-checkpoint tracking by completion RMSE in millimetres.

Runs on one card (cuda:0 unless `device` names another; device="cpu" for
the tests) in the config's dtype, float32 by default with TF32 off, like
`training/trainer.py::Trainer`.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from fusiondepth_torch.config import Config
from fusiondepth_torch.data.loader import DataLoader
from fusiondepth_torch.data.prefetch import prefetch_to_device
from fusiondepth_torch.models.fusion import FusionNets, model_dtype
from fusiondepth_torch.models.pretrained import apply_pretrained
from fusiondepth_torch.ops.depth import disp_to_depth
from fusiondepth_torch.ops.losses import si_loss
from fusiondepth_torch.ops.resize import resize_bilinear
from fusiondepth_torch.training import checkpoint as ckpt
from fusiondepth_torch.training.infer_driver import (
    DEPTH_KEYS,
    device_batch,
    resolve_device,
)
from fusiondepth_torch.training.photometric import (
    compute_losses,
    generate_images_pred,
)
from fusiondepth_torch.training.train_state import check_stage1_default, \
    check_train_supported, train_step
from fusiondepth_torch.training.trainer import TRAIN_KEYS
from fusiondepth_torch.utils.logging import MetricLogger, sec_to_hm_str


def make_completion_optimizer(cfg: Config, nets: torch.nn.Module,
                              steps_per_epoch: int
                              ) -> Tuple[torch.optim.Adam,
                                         torch.optim.lr_scheduler.LambdaLR]:
    """Adam (eps 1e-8) at the RAW learning rate with StepLR(
    completion_scheduler_step_size, gamma=0.1) as optax's piecewise-constant
    schedule: x0.1 at each of three step boundaries. Unlike the stage-1
    `make_optimizer`, no batch-size rescaling of the lr (reference
    completor.py:121-123). Call the scheduler's step() after each optimizer
    step."""
    boundary = max(cfg.completion_scheduler_step_size, 1) * max(
        steps_per_epoch, 1)
    opt = torch.optim.Adam(nets.parameters(), lr=cfg.learning_rate, eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: 0.1 ** min(step // boundary, 3))
    return opt, sched


def completion_metrics(gt_m: np.ndarray, pred_m: np.ndarray,
                       eigen_crop: bool = False) -> Dict[str, float]:
    """rmse/mae in mm and irmse/imae in 1/km (reference
    evaluate_completion.py:31-48). Inputs in metres, valid where gt > 0.
    `eigen_crop` restricts to the completor's garg/eigen window
    [153:371, 44:1197] (reference completor.py:744-747)."""
    mask = gt_m > 0
    if eigen_crop:
        crop = np.zeros_like(mask)
        crop[153:371, 44:1197] = True
        mask &= crop
    gt = gt_m[mask]
    pred = np.clip(pred_m[mask], 1e-3, None)
    err_mm = (gt - pred) * 1000.0
    ierr_km = 1.0 / gt / 1e-3 - 1.0 / pred / 1e-3  # 1/km
    return {
        "rmse": float(np.sqrt((err_mm**2).mean())),
        "mae": float(np.abs(err_mm).mean()),
        "irmse": float(np.sqrt((ierr_km**2).mean())),
        "imae": float(np.abs(ierr_km).mean()),
    }


def completion_loss(cfg: Config, nets: FusionNets,
                    batch: Dict[str, torch.Tensor],
                    noise: Optional[Sequence[torch.Tensor]] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, losses) of one batch, the nets in training mode: the
    photometric objective with the trainer's SI term off, plus the
    completion SI (or L1) term against velodyne_raw at scale 0 (every
    scale with completion_siloss_all_scale), as `make_completion_loss_fn`.
    The automask noise is `compute_losses`'s (`noise=` replays given
    draws)."""
    H, W = cfg.height, cfg.width
    outputs = nets(batch, train=True)
    outputs = generate_images_pred(cfg, batch, outputs)
    losses = compute_losses(cfg.replace(trainer_siloss=False), batch,
                            outputs, noise=noise, generator=generator)
    total = losses["loss"] * cfg.num_scales  # undo the mean to re-add
    beam_depth = batch["four_beam"][..., 0] * 100.0
    for scale in cfg.scales:
        if not (cfg.completion_siloss_all_scale or scale == 0):
            continue
        disp = resize_bilinear(outputs[("disp", scale)][..., 0], H, W)
        _, depth = disp_to_depth(disp, cfg.min_depth, cfg.max_depth)
        depth = depth * 26.0  # reference completor.py:701
        if cfg.completion_siloss:
            si = si_loss(depth, beam_depth, threshold=cfg.gdc_loss_threshold,
                         si_var=cfg.si_var,
                         scale=cfg.completion_siloss_weight)
            total = total + si
            losses[f"loss/si_loss{scale}"] = si
        elif cfg.completion_l1loss:
            w = ((beam_depth > 1) & (depth < 80) & (depth > 1)).to(
                depth.dtype)
            l1 = (torch.abs(depth - beam_depth) * w).sum() / torch.clamp(
                w.sum(), min=1.0) * 0.001
            total = total + l1
            losses[f"loss/l1_loss{scale}"] = l1
    total = total / cfg.num_scales
    losses["loss"] = total
    return total, losses


class Completor:
    def __init__(self, cfg: Config, train_dataset=None, val_dataset=None,
                 device=None):
        # the reference forces full-res completion shapes (completor.py:31-34)
        if not cfg.completion_not_full_res:
            cfg = cfg.replace(height=352, width=1216)
        else:
            cfg = cfg.replace(height=192, width=640)
        cfg = cfg.replace(num_layers=cfg.completion_num_layers,
                          num_epochs=cfg.completion_num_epochs)
        check_train_supported(cfg)
        check_stage1_default(cfg, "the completor")
        if cfg.grad_accum_steps > 1:
            raise ValueError("completion takes whole-batch steps, as the "
                             "JAX completor does: grad_accum_steps must "
                             "be 1")
        self.cfg = cfg
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.dtype = model_dtype(cfg)
        self.nets = FusionNets(cfg, device=self.device,
                               generator=torch.Generator().manual_seed(
                                   cfg.seed),
                               pose_depth=cfg.completion_pose_num_layers)
        if cfg.weights_init == "pretrained":
            apply_pretrained(cfg, self.nets)
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset

        steps = (max(len(train_dataset) // cfg.batch_size, 1)
                 if train_dataset is not None else 1000)
        self.optimizer, self.scheduler = make_completion_optimizer(
            cfg, self.nets, steps)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 1)

        self.log_path = os.path.join(cfg.log_dir,
                                     cfg.model_name + "_completion")
        self.loggers = {m: MetricLogger(self.log_path, m, use_tb=False)
                        for m in ("train", "val")}
        self.best_rmse = float("inf")
        self.step = 0
        self._t0 = time.time()

    def put_batch(self, batch) -> Dict[str, torch.Tensor]:
        """Host batch -> the step's inputs on the card, in the model dtype."""
        return device_batch(batch, self.device, TRAIN_KEYS, self.dtype)

    def load(self, path: str) -> dict:
        """Load a checkpoint (a weights folder or a JAX `.npz`) into the
        nets; returns its meta dict."""
        return ckpt.load_checkpoint(path, self.nets)

    def save(self, tag: str) -> str:
        return ckpt.save_checkpoint(self.cfg, self.nets, tag, self.optimizer,
                                    self.scheduler, self.step)

    def run_step(self, batch, on_device: bool = False
                 ) -> Dict[str, torch.Tensor]:
        """One optimization step; returns its losses, detached (tensors on
        the card: reading them is the caller's sync point)."""
        db = batch if on_device else self.put_batch(batch)
        losses = train_step(self.cfg, self.nets, self.optimizer,
                            self.scheduler, db, self.generator,
                            loss_of=completion_loss)
        self.step += 1
        return losses

    def train(self) -> None:
        cfg = self.cfg
        for epoch in range(cfg.num_epochs):
            loader = DataLoader(self.train_dataset, cfg.batch_size,
                                shuffle=True, drop_last=True,
                                num_workers=cfg.num_workers)
            for db in prefetch_to_device(loader, self.put_batch, size=2):
                losses = self.run_step(db, on_device=True)
                if self.step % cfg.log_frequency == 0:
                    loss = float(losses["loss"])  # the sync point
                    print(f"completion epoch {epoch} step {self.step} "
                          f"loss {loss:.4f} "
                          f"({sec_to_hm_str(time.time() - self._t0)})",
                          flush=True)
                    self.loggers["train"].log_scalars(self.step,
                                                      {"loss": loss})
            self.validate(epoch)

    def predict_depth(self, batch) -> np.ndarray:
        """Metric depth (B, H, W) of a host batch, each image median-scaled
        to its sparse input as the reference eval does
        (evaluate_completion.py)."""
        db = device_batch(batch, self.device, DEPTH_KEYS, self.dtype)
        with torch.inference_mode():
            disp = self.nets.forward_depth(db, train=False)[0][("disp", 0)]
        disp = disp[..., 0].cpu().numpy()
        _, depth = disp_to_depth(disp, self.cfg.min_depth,
                                 self.cfg.max_depth)
        sparse = np.asarray(batch["four_beam"])[..., 0] * 100.0
        out = []
        for i in range(depth.shape[0]):
            m = sparse[i] > 0
            d = depth[i]
            if m.sum() > 0:
                d = d * (np.median(sparse[i][m]) / np.median(d[m]))
            out.append(d)
        return np.stack(out)

    def validate(self, epoch: int = 0) -> Optional[Dict[str, float]]:
        """Mean completion metrics over the val split; saves the weights
        under the "best_completion" tag when the RMSE improves."""
        if self.val_dataset is None:
            return None
        loader = DataLoader(self.val_dataset, self.cfg.eval_batch_size)
        rows = []
        for batch in loader:
            depth = self.predict_depth(batch)
            for i, gt in enumerate(batch.get("depth_gt", [])):
                rows.append(completion_metrics(
                    np.asarray(gt), depth[i],
                    eigen_crop=self.cfg.completion_eigen_crop))
        if not rows:
            return None
        metrics = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
        self.loggers["val"].log_scalars(self.step, metrics)
        print(f"completion val epoch {epoch} | " + " | ".join(
            f"{k} {v:.2f}" for k, v in metrics.items()), flush=True)
        if metrics["rmse"] < self.best_rmse:
            self.best_rmse = metrics["rmse"]
            self.save("best_completion")
        return metrics
