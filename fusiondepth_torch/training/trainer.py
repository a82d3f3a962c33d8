"""Stage-1 self-supervised trainer driver (counterpart of
`fusiondepth_tpu/training/trainer.py`; reference trainer.py:24-266 and its
val protocol :390-423).

Schedule semantics of the reference:
  num_epochs   = (8 * 17) // batch_size
  lr           = learning_rate * batch_size / 8
  StepLR step  = scheduler_step_size * 8 / batch_size (gamma 0.1)
and validation on the eigen test split after every epoch, with
best-AbsRel checkpointing.

Runs on one card (cuda:0 unless `device` names another; device="cpu" for
the tests) in the config's dtype, float32 by default with TF32 off, so
that float32 means float32 in cuDNN's convolutions too. The host feed
runs ahead of the step in a thread (data/prefetch.py) with pinned,
non-blocking uploads; losses are read back only every log_frequency steps.
Every stage-1 training variant of the JAX package trains here
(v1_multiscale, use_stereo, predictive_mask, the posecnn and shared pose
types, pose_model_input="all"); data parallelism (use_mesh, several
processes), remat and bfloat16 are not ported yet.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import torch

from fusiondepth_torch.config import Config
from fusiondepth_torch.data.loader import DataLoader
from fusiondepth_torch.data.prefetch import prefetch_to_device
from fusiondepth_torch.models.fusion import FusionNets, model_dtype
from fusiondepth_torch.models.pretrained import apply_pretrained
from fusiondepth_torch.training import checkpoint as ckpt
from fusiondepth_torch.training.evaluation import evaluate_disparities
from fusiondepth_torch.training.infer_driver import (
    DEPTH_KEYS,
    device_batch,
    resolve_device,
)
from fusiondepth_torch.training.train_state import (
    check_train_supported,
    make_optimizer,
    train_step,
)
from fusiondepth_torch.utils.logging import MetricLogger, sec_to_hm_str

TRAIN_KEYS = ("color", "color_aug", "two_channel", "four_beam", "K",
              "inv_K", "stereo_T")


class Trainer:
    def __init__(self, cfg: Config, train_dataset=None, val_dataset=None,
                 device=None):
        if cfg.use_mesh or cfg.num_processes > 1 \
                or cfg.coordinator_address:
            raise NotImplementedError(
                "use_mesh / multi-process training: the port trains on one "
                "card; data parallelism is not ported yet")
        cfg = cfg.replace(num_epochs=max((8 * 17) // cfg.batch_size, 1))
        if cfg.use_stereo and "s" not in cfg.frame_ids:
            # stereo adds the opposite-side frame (reference
            # trainer.py:63-64)
            cfg = cfg.replace(frame_ids=tuple(cfg.frame_ids) + ("s",))
        if cfg.height % 32 or cfg.width % 32:
            raise ValueError("height/width must be multiples of 32")
        check_train_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.dtype = model_dtype(cfg)

        self.nets = FusionNets(cfg, device=self.device,
                               generator=torch.Generator().manual_seed(
                                   cfg.seed))
        if cfg.weights_init == "pretrained":
            apply_pretrained(cfg, self.nets)
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        if train_dataset is None and cfg.dataset in ("kitti", "kitti_odom"):
            self._build_kitti_datasets()

        steps_per_epoch = (
            max(len(self.train_dataset) // cfg.batch_size, 1)
            if self.train_dataset is not None else 1000)
        self.optimizer, self.scheduler = make_optimizer(
            cfg, self.nets, steps_per_epoch)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 1)

        self.log_path = os.path.join(cfg.log_dir, cfg.model_name)
        self.loggers = {mode: MetricLogger(self.log_path, mode, use_tb=False)
                        for mode in ("train", "val")}
        self.loggers["train"].add_watch("loss", "nan",
                                        title="non-finite training loss")
        ckpt.save_options(cfg)

        self.step = 0
        if cfg.train_load_weights_folder:
            # resume restricted to --models_to_load, with the beam encoders
            # appended when they exist (reference trainer.py:725-730)
            to_load = list(cfg.models_to_load)
            if cfg.beam_encoder:
                to_load += ["beam_encoder", "beam_encoder_pose"]
            meta = ckpt.load_checkpoint(
                cfg.train_load_weights_folder, self.nets, self.optimizer,
                self.scheduler, models_to_load=to_load)
            self.step = int(meta.get("step", 0))
        self.best_absrel = float("inf")
        self.epoch = 0
        self._t_start = time.time()

    # ---- data ----

    def _build_kitti_datasets(self):
        from fusiondepth_torch.data.kitti_dataset import (
            KITTIOdomDataset,
            KITTIRAWDataset,
        )
        from fusiondepth_torch.data.kitti_io import readlines

        cfg = self.cfg
        cls = (KITTIOdomDataset if cfg.dataset == "kitti_odom"
               else KITTIRAWDataset)
        split_dir = os.path.join(os.path.dirname(__file__), "..", "..",
                                 "splits")
        train_files = readlines(
            os.path.join(split_dir, cfg.split, "train_files.txt"))
        test_files = readlines(
            os.path.join(split_dir, "eigen", "test_files.txt"))
        ext = ".png" if cfg.png else ".jpg"
        self.train_dataset = cls(cfg.data_path, train_files, cfg.height,
                                 cfg.width, cfg.frame_ids, is_train=True,
                                 img_ext=ext, cfg=cfg)
        # reference quirk kept on purpose: the val loader IS the eigen test
        # split (trainer.py:161-171)
        self.val_dataset = cls(cfg.data_path, test_files, cfg.height,
                               cfg.width, [0], is_train=False, img_ext=ext,
                               cfg=cfg)

    def _loader(self, dataset, shuffle: bool):
        return DataLoader(dataset, self.cfg.batch_size, shuffle=shuffle,
                          drop_last=shuffle, num_workers=self.cfg.num_workers)

    def put_batch(self, batch) -> Dict[str, torch.Tensor]:
        """Host batch -> the step's inputs on the card, in the model dtype."""
        return device_batch(batch, self.device, TRAIN_KEYS, self.dtype)

    # ---- training ----

    def run_step(self, batch,
                 on_device: bool = False) -> Dict[str, torch.Tensor]:
        """One train step; returns its losses (tensors on the card)."""
        db = batch if on_device else self.put_batch(batch)
        losses = train_step(self.cfg, self.nets, self.optimizer,
                            self.scheduler, db, generator=self.generator)
        self.step += 1
        return losses

    def run_epoch(self) -> List[torch.Tensor]:
        """One pass over the train split; returns each step's loss."""
        cfg = self.cfg
        loader = self._loader(self.train_dataset, shuffle=True)
        t_last, n_last = time.time(), 0
        step_losses = []
        for db in prefetch_to_device(loader, self.put_batch, size=2):
            losses = self.run_step(db, on_device=True)
            step_losses.append(losses["loss"])
            n_last += cfg.batch_size
            if self.step % cfg.log_frequency == 0:
                loss = float(losses["loss"])  # the sync point
                dt = time.time() - t_last
                eps = n_last / max(dt, 1e-9)
                print(f"epoch {self.epoch:3d} | step {self.step:6d} | "
                      f"loss {loss:.4f} | {eps:7.1f} ex/s | "
                      f"elapsed {sec_to_hm_str(time.time() - self._t_start)}",
                      flush=True)
                self.loggers["train"].log_scalars(
                    self.step, {"loss": loss, "examples_per_sec": eps})
                t_last, n_last = time.time(), 0
        return step_losses

    def save(self, tag: str) -> str:
        return ckpt.save_checkpoint(self.cfg, self.nets, tag, self.optimizer,
                                    self.scheduler, self.step)

    def train(self) -> None:
        for self.epoch in range(self.cfg.num_epochs):
            self.run_epoch()
            metrics = self.validate()
            if metrics and self.cfg.save_frequency > 0:
                self.save(f"{self.epoch}")

    # ---- validation (eigen protocol) ----

    def validate(self) -> Optional[Dict[str, float]]:
        if self.val_dataset is None:
            return None
        loader = self._loader(self.val_dataset, shuffle=False)
        disps, gts = [], []
        with torch.inference_mode():
            for batch in loader:
                db = device_batch(batch, self.device, DEPTH_KEYS)
                out = self.nets.forward_depth(db, train=False)[0]
                disps.extend(out[("disp", 0)][..., 0].float().cpu().numpy())
                gts.extend(batch.get("depth_gt", []))
        if not gts:
            return None
        metrics = evaluate_disparities(disps, gts)
        self.loggers["val"].log_scalars(self.step, metrics)
        print("val | " + " | ".join(
            f"{k} {v:.4f}" for k, v in metrics.items()), flush=True)
        if metrics["abs_rel"] < self.best_absrel:
            self.best_absrel = metrics["abs_rel"]
            self.save("best")
            self.save(f"absrel{int(metrics['abs_rel'] * 1e5)}")
        return metrics

